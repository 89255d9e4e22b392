"""Accuracy and time of the tensor-core attention (kernels #1 and #2,
``daspeech_torch/csrc/attention_tc.cuh``: the inference forward and the
backward) against the size of its accumulation groups, on one CUDA card.

The tensor cores' fp32 accumulation does not round to nearest: a long chain
of ``mma.sync`` into one accumulator gathers a biased error. The kernels
therefore sum ``kGroup`` = 4 k-steps (three MMAs each, 3xTF32) in a fresh
accumulator and fold them into the result with an fp32 add; 0 chains every
k-step in place. For each group size this script copies
``daspeech_torch/`` to ``build/tc_accumulation/<G>/`` with that value,
builds it (nvcc, as the package does), prints the kernels'
registers and spills, and then, at the kernel phase's training shapes, the
max abs error of out, dq, dk and dv against the plain version in fp32 and
in float64 (and of the fp32 plain version against float64), with the
median CUDA-event times of the forward and the backward. "out" is the
tensor-core (inference) forward's; the backward reads the statistics of
the fp32 training forward, as in training.

    python tools/torch_attention_accumulation.py [--groups 0 1 2 4 8]
"""

from __future__ import annotations

import argparse
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
DEFAULT = "constexpr int kGroup = 4;"
# [B, H, Tq, Tk, dropout, last row padded]: cell T's decoder self-attention,
# J-long's DAG decoder and FastSpeech 2 decoder, a fully padded row
SHAPES = ((80, 8, 240, 240, 0.1, False), (14, 8, 700, 700, 0.1, False),
          (14, 4, 1040, 1040, 0.0, False), (4, 4, 1040, 1040, 0.1, True))


def variant(group: int) -> Path:
    """A copy of the package whose kernels group ``group`` k-steps."""
    root = ROOT / "build" / "tc_accumulation" / str(group)
    shutil.rmtree(root, ignore_errors=True)
    shutil.copytree(ROOT / "daspeech_torch", root / "daspeech_torch",
                    ignore=shutil.ignore_patterns("__pycache__"))
    hdr = root / "daspeech_torch" / "csrc" / "tiles.cuh"
    text = hdr.read_text()
    if DEFAULT not in text:
        raise RuntimeError(f"{hdr}: no '{DEFAULT}' to replace")
    hdr.write_text(text.replace(DEFAULT, f"constexpr int kGroup = {group};"))
    return root


def measure(root: str) -> None:
    """Build the package at ``root`` and print its errors and times."""
    sys.path.insert(0, root)
    import numpy as np
    import torch

    from daspeech_torch.ops import _build
    from daspeech_torch.ops import fused_attention as fa

    built = _build.build()
    lines = built.ptxas.splitlines()
    for i, line in enumerate(lines):
        m = re.search(r"entry function '\w*?(attn_tc_\w+?_kernel)", line)
        if m:
            regs = next((x for x in lines[i + 1:i + 4] if "Used" in x), "")
            spill = next((x for x in lines[i + 1:i + 4] if "spill" in x), "")
            print(f"  {m.group(1)}: "
                  f"{regs.split(':')[-1].strip()}; {spill.strip()}")

    def cuda_ms(fn, reps=20, warm=3):
        for _ in range(warm):
            fn()
        times = []
        for _ in range(reps):
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            a.record()
            fn()
            b.record()
            b.synchronize()
            times.append(a.elapsed_time(b))
        return float(np.median(times))

    def err(a, b):
        return (a.double() - b.double()).abs().max().item()

    g = torch.Generator().manual_seed(0)

    def randn(*shape, scale=1.0):
        return (torch.randn(*shape, generator=g) * scale).cuda()

    for (B, H, Tq, Tk, p, padded) in SHAPES:
        q = randn(B, H, Tq, 64, scale=0.125)
        k, v = randn(B, H, Tk, 64), randn(B, H, Tk, 64)
        do = randn(B, H, Tq, 64)
        keep = torch.randint(Tk // 2, Tk + 1, (B,), generator=g)
        keep[0] = Tk
        if padded:
            keep[-1] = 0
        bias = torch.where(torch.arange(Tk)[None, :] >= keep[:, None],
                           fa.NEG, 0.0).float().cuda()
        seeds = (torch.randint(-2 ** 31, 2 ** 31, (B,), generator=g,
                               dtype=torch.int32).cuda() if p else None)
        out, st = fa.attention_hm_fwd_kernel(q, k, v, bias, 1.0, p, seeds,
                                             with_stats=True)
        got = (fa.attention_hm_fwd_kernel(q, k, v, bias, 1.0, p, seeds)[0],
               *fa.attention_hm_bwd_kernel(q, k, v, bias, out, st, do, 1.0,
                                           p, seeds))
        f32 = (fa.attention_hm_plain(q, k, v, bias, 1.0, p, seeds),
               *fa.attention_hm_bwd_plain(q, k, v, bias, do, 1.0, p, seeds))
        d = [x.double() for x in (q, k, v, bias, do)]
        f64 = (fa.attention_hm_plain(*d[:4], 1.0, p, seeds),
               *fa.attention_hm_bwd_plain(*d, 1.0, p, seeds))
        print(f"  [{B},{H},{Tq},64] kv_T={Tk} p={p}"
              + (" last row padded" if padded else ""))
        for name, a, b32, b64 in zip(("out", "dq", "dk", "dv"), got, f32,
                                     f64):
            print(f"    {name}: max |x| {b64.abs().max().item():.3g}; "
                  f"kernel vs plain {err(a, b32):.3g}, vs float64 "
                  f"{err(a, b64):.3g}; plain vs float64 {err(b32, b64):.3g}")
        fwd = cuda_ms(lambda: fa.attention_hm_fwd_kernel(
            q, k, v, bias, 1.0, p, seeds))
        bwd = cuda_ms(lambda: fa.attention_hm_bwd_kernel(
            q, k, v, bias, out, st, do, 1.0, p, seeds))
        print(f"    forward {fwd:.4f} ms, backward {bwd:.4f} ms", flush=True)
        del got, f32, f64, d
        torch.cuda.empty_cache()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--groups", type=int, nargs="+", default=[0, 1, 2, 4, 8])
    ap.add_argument("--child", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.child:
        measure(args.child)
        return 0
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"card: {smi}")
    rc = 0
    for group in args.groups:
        print(f"kGroup = {group}:", flush=True)
        rc |= subprocess.run([sys.executable, __file__, "--child",
                              str(variant(group))],
                             env={**os.environ, "PYTHONPATH": ""}).returncode
    return rc


if __name__ == "__main__":
    sys.exit(main())
