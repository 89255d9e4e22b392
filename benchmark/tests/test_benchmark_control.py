"""On the card: the control fails the cell's limits and the program passes
them, at the cell's widths on a shorter split. The control is the plain
reference computed in TF32 (the nearest precision below the
configuration's fp32 with TF32 off), put in the program's place."""

import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parents[2]))

import pytest  # noqa: E402

from benchmark.harness import core  # noqa: E402


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [2 ** 31 + 101, 2 ** 31 + 202, 2 ** 31 + 303])
def test_control_fails_and_program_passes(seed):
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the port's kernels run only there")
    c = core.cell("s2st-serve")
    c["workload"]["traffic"]["utterances"] = 120
    driver = core.load_module(core.BENCH_DIR / "drivers" / "serve.py",
                              "bench_driver_serve_control")
    out = driver.run(c, seed=seed, seconds=2.0, trace=False, device="cuda",
                     t0=time.perf_counter(), control=True)
    limits = c["workload"]["checks"]
    program = core.checks_line(out["readings"], limits)
    control = core.checks_line(out["control"], limits)
    assert core.passed(program), program
    assert not core.passed(control), control
