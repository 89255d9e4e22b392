"""Whether the joint S2ST step resumes bit for bit on the card with and
without torch's deterministic algorithms (``chip_smoke.py`` phase 13).

Runs ``chip_smoke.runtime_phase`` twice in one process, on the serving
phase's model (random weights from seed 0, the decoder shaped as the
serving phase shapes it): first as ``chip_smoke.py`` runs it (both
training runs under ``torch.use_deterministic_algorithms(True,
warn_only=True)`` and deterministic cuDNN), then with the default
algorithms. Each run logs its readings to stderr (the second with the
native collation engine already built, so its first data wait is a
collate and a copy alone) and prints one line to stdout: whether the
phase passed, or the check that failed. The default run is expected to
fail at the resume check when a kernel it picks sums in a run-dependent
order.

    python tools/torch_runtime_resume.py
"""

from __future__ import annotations

import contextlib
import subprocess
import sys
import time
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))

import chip_smoke as cs  # noqa: E402


def main() -> int:
    if not torch.cuda.is_available():
        print("torch_runtime_resume: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    from daspeech_torch.config import (DAGModelConfig, HiFiGANConfig,
                                       S2SModelConfig, VocabConfig)
    from daspeech_torch.models import (HiFiGANGenerator,
                                       S2SConformerDAGFastSpeech2)
    from daspeech_torch.ops import _build

    _build.library()
    cfg = S2SModelConfig(dag=DAGModelConfig(vocab=VocabConfig(size=128)))
    ctx = {"model_cpu": cs.shape_random_decoder_(cs.init_random_(
               S2SConformerDAGFastSpeech2(cfg), cs.SEED), cs.SEED)
               .eval().requires_grad_(False),
           "voc_cpu": cs.init_random_(HiFiGANGenerator(HiFiGANConfig()),
                                      cs.SEED + 1).eval().requires_grad_(
                                          False)}
    for mode, algorithms in (("deterministic", cs.deterministic),
                             ("default", contextlib.nullcontext)):
        cs.log(f"{mode} algorithms:")
        t0 = time.perf_counter()
        try:
            cs.runtime_phase(ctx, smi, algorithms)
            result = "passed"
        except AssertionError as e:
            result = f"failed: {e}"
        print(f"[{smi}] {mode} algorithms: runtime phase {result} "
              f"({time.perf_counter() - t0:.1f} s)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
