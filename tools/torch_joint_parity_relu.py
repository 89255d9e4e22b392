"""How far FastSpeech 2's ReLU kinks move the joint S2ST step's gradients
(``chip_smoke.py`` phase 6: B = 4, dropout 0, GLAT p = 0), against the
card-vs-CPU bar of 1e-3 of a gradient's norm.

For each strategy, against the CPU fp32 step (the plain versions), the
script prints the worst gradient difference (``chip_smoke.grad_errors``)
and FastSpeech 2's positional-embedding scales for:

- the card's step;
- CPU fp32 steps whose weights were each moved by one ulp (a random
  direction per element, a seed per run): what rounding alone does;

each as it runs, and again with the reference's side taken at every ReLU
unit that changed side at a tie (``chip_smoke.relu_sides``), with the
count of such units.

    python tools/torch_joint_parity_relu.py
"""

from __future__ import annotations

import copy
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
WATCH = ("tts.pos_emb_alpha", "tts.dec_pos_emb_alpha")
JITTER = 3             # CPU steps with weights moved by one ulp


def jittered(model, seed):
    """A copy of ``model`` with every weight moved by one ulp up or down."""
    out = copy.deepcopy(model)
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for p in out.parameters():
            up = torch.rand(p.shape, generator=g) < 0.5
            p.copy_(torch.where(up, torch.nextafter(p, p + 1),
                                torch.nextafter(p, p - 1)))
    return out


def main() -> int:
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(f"card: {smi}")
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from daspeech_torch.models import S2SConformerDAGFastSpeech2

    cfg, no_drop = cs.joint_configs()
    model = S2SConformerDAGFastSpeech2(no_drop)
    model.load_state_dict(cs.init_random_(S2SConformerDAGFastSpeech2(cfg),
                                          cs.SEED).state_dict())
    names = [n for n, _ in model.named_parameters()]
    _, S, T, M, dur = cs.JOINT_SHAPES["J"]
    batch = cs.make_joint_batch(cs.JOINT_PARITY_B, S, T, M, dur, cfg,
                                cs.SEED + 10, "cpu")

    for strategy in ("expect", "argmax"):
        loss_fn = cs.joint_loss_fn(no_drop, 0.0, strategy)

        def grads(m, dev, follow=None):
            b = {k: v.to(dev) for k, v in batch.items()}
            with cs.relu_sides(follow) as relus:
                _, g, _ = cs.loss_and_grads(copy.deepcopy(m).to(dev), b,
                                            cs.SEED, loss_fn)
            return [x.cpu() for x in g], relus

        ref, rec = grads(model, "cpu")
        runs = [("card", model, cs.DEVICE)] + [
            (f"CPU fp32, weights moved one ulp (seed {j})", jittered(model, j),
             "cpu") for j in range(JITTER)]
        for tag, m, dev in runs:
            for follow in (None, rec.sides):
                g, relus = grads(m, dev, follow)
                e = cs.grad_errors(g, ref)
                print(f"[{strategy}] {tag}"
                      + (f", the reference's side at {relus.ties} ReLU ties"
                         f" ({relus.far} farther out, of {relus.units})"
                         if follow else ", as it runs")
                      + f": worst {max(e):.3g} ({names[e.index(max(e))]})"
                      + "".join(f", {n} {e[names.index(n)]:.3g}"
                                for n in WATCH), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
