"""Readings that set a cell's limits: the program's compared numbers over
many seeds (the lower readings) and the control's (the upper readings),
in one process so that the set-up's kernel build is paid once.

    python benchmark/calibrate.py --workload <name> --seconds <s> \
        --seeds <n> [<n> ...] [--out <file.jsonl>]

For each seed it runs the cell as ``run.py`` does, with a window of
``--seconds``, and judges the kept batches twice: the program's outputs,
and the control's (the plain reference computed in TF32, the nearest
precision below the configuration's fp32 with TF32 off, put in the
program's place). One JSON line a seed goes to standard output and to
``--out``. The benchmark's own runs never run the control.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE.parent))

from benchmark.run import set_cache_dirs  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--out", default=None)
    args = p.parse_args(argv)
    set_cache_dirs()
    from benchmark.harness import core

    c = core.cell(args.workload)
    kind = core.require_devices(c["entry"]["chips"])
    driver = core.load_module(HERE / "drivers"
                              / f"{c['workload']['driver']}.py",
                              "bench_driver")
    for seed in args.seeds:
        t0 = time.perf_counter()
        out = driver.run(c, seed=seed, seconds=args.seconds, trace=False,
                         device="cuda", t0=t0, control=True)
        line = json.dumps({"workload": args.workload, "seed": seed,
                           "device": kind, "program": out["readings"],
                           "control": out["control"],
                           "values": out["values"]})
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
