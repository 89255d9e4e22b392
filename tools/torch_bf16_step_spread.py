"""The joint J-long bf16 loss against the fp32 loss, over batch seeds, for
the rel-pos attention's (#5) bf16 kernel and its alternatives, on one CUDA
card.

``chip_smoke.py``'s bf16 phase holds the card's bf16 joint step (J-long's
shape at B = 1, dropout 0, GLAT 0, batch seed SEED + 42) within
max(2 |cpu_bf16 - cpu_fp32|, 2^-8 |loss|) of the CPU's fp32 loss. This
script reads how far that loss moves with the seed for each way of
computing #5 in bf16, to tell a kernel's error from the check's own spread:

- this tree's kernels (``csrc/relpos_bf16.cuh``);
- the same with #5's P·V in its other form (``kTermsRelPV`` flipped
  between one and two terms in a copy of the sources under
  ``build/pv_form/``);
- another tree's kernels (``--parent DIR``, e.g. a ``git archive`` of the
  parent commit under ``build/``), and this tree with only that tree's #5
  entry points;
- #5's plain bf16 version on the card (the other kernels this tree's).

Each loss is a forward of the criterion without gradients (the bf16
forward kernel computes the same output with or without statistics).

    python tools/torch_bf16_step_spread.py --parent build/parent \\
        [--seeds 42 43 44 45 46 47]
"""

from __future__ import annotations

import argparse
import copy
import shutil
import subprocess
import sys
import threading
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import torch  # noqa: E402

import chip_smoke as cs  # noqa: E402
from daspeech_torch.models import S2SConformerDAGFastSpeech2  # noqa: E402
from daspeech_torch.models.layers import set_dtype  # noqa: E402
from daspeech_torch.ops import _build  # noqa: E402
from daspeech_torch.ops import fused_relpos as fr  # noqa: E402

PV = "constexpr int kTermsRelPV = {};"


def pv_form_library():
    """(the other P·V form, a library built from a copy of the sources with
    it)."""
    src = ROOT / "daspeech_torch" / "csrc"
    text = (src / "relpos_bf16.cuh").read_text()
    ours = next(n for n in (1, 2) if PV.format(n) in text)
    other = 3 - ours
    out = ROOT / "build" / "pv_form"
    shutil.rmtree(out, ignore_errors=True)
    shutil.copytree(src, out / "csrc")
    (out / "csrc" / "relpos_bf16.cuh").write_text(
        text.replace(PV.format(ours), PV.format(other)))
    return other, out


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent", type=Path, required=True)
    ap.add_argument("--seeds", type=int, nargs="+",
                    default=[42, 43, 44, 45, 46, 47])
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 1

    other, pv_dir = pv_form_library()
    parent = args.parent.resolve()
    built = {}
    jobs = [threading.Thread(target=lambda: built.update(parent=_build.build(
                parent / "daspeech_torch" / "csrc",
                parent / "build" / "daspeech_torch"))),
            threading.Thread(target=lambda: built.update(pv=_build.build(
                pv_dir / "csrc", pv_dir / "out")))]
    for j in jobs:
        j.start()
    _build.build()
    ours = _build.library()
    for j in jobs:
        j.join()
    libs = {"parent": _build.load(built["parent"].path, strict=False),
            "pv": _build.load(built["pv"].path, strict=False)}

    def entry_from(lib_of):
        def entry(name, dtype):
            lib = lib_of(name)
            return getattr(lib, name if dtype == torch.float32
                           else f"{name}_bf16")
        return entry

    plain_fwd = (lambda q, k, v, a, e, bias, num_heads, sm_scale,
                 dropout_p=0.0, seeds=None, with_stats=False:
                 (fr.relpos_plain(q, k, v, a, e, bias, num_heads, sm_scale,
                                  dropout_p, seeds), None))
    variants = {
        "this tree": (lambda n: ours, None),
        f"P·V {other}-term": (lambda n: libs["pv"], None),
        "parent tree": (lambda n: libs["parent"], None),
        "this tree, #5 from the parent": (
            lambda n: libs["parent"] if "relpos" in n else ours, None),
        "#5's plain bf16 version": (lambda n: ours, plain_fwd)}

    jcfg, jno_drop = cs.joint_configs()
    model = cs.init_random_(S2SConformerDAGFastSpeech2(jcfg), cs.SEED)
    ref = S2SConformerDAGFastSpeech2(jno_drop)
    ref.load_state_dict(model.state_dict())
    _, S, T, M, dur = cs.JOINT_SHAPES["J-long"]
    loss_fn = cs.joint_loss_fn(jno_drop, 0.0)
    cpu = {dt: set_dtype(copy.deepcopy(ref), dt).train()
           for dt in (torch.float32, torch.bfloat16)}
    card = set_dtype(copy.deepcopy(ref), torch.bfloat16).cuda().train()

    def loss(m, batch):
        with torch.no_grad():
            return float(loss_fn(m, batch, torch.Generator().manual_seed(
                cs.SEED))[0])

    own_entry, own_fwd = _build.entry, fr.relpos_fwd_kernel
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip())
    for seed in args.seeds:
        batch = cs.make_joint_batch(1, S, T, M, dur, jno_drop,
                                    cs.SEED + seed, "cpu")
        dev = {k: v.cuda() for k, v in batch.items()}
        f32, b16 = loss(cpu[torch.float32], batch), loss(
            cpu[torch.bfloat16], batch)
        bar = max(2 * abs(b16 - f32), 2.0 ** -8 * abs(f32))
        line = [f"seed SEED + {seed}: CPU fp32 {f32:.6f}, |x - CPU fp32|: "
                f"CPU bf16 {abs(b16 - f32):.4f}, the check's bar {bar:.4f}"]
        for tag, (lib_of, fwd) in variants.items():
            _build.entry = entry_from(lib_of)
            fr.relpos_fwd_kernel = fwd or own_fwd
            try:
                line.append(f"{tag} {abs(loss(card, dev) - f32):.4f}")
            finally:
                _build.entry, fr.relpos_fwd_kernel = own_entry, own_fwd
        print("; ".join(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
