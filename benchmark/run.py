"""Run one cell of the benchmark once and print its result line.

    python benchmark/run.py --workload <name> --seed <n> --seconds <s> \
        --trace <0|1>

With ``--trace 0`` the result holds the cell's end-to-end metrics, with
``--trace 1`` its per-layer metrics, the device's busy and window seconds
and a breakdown of the profiled stretch. Every run checks its served output
against the plain reference and prints the compared numbers beside their
limits, last on standard error and last in the result line. The run exits
non-zero, and prints no result, without the CUDA devices the cell asks for
or when JAX or the JAX package was loaded.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def set_cache_dirs() -> None:
    """Build and kernel caches at fixed paths inside the checkout (the
    program's own kernels build into ``build/daspeech_torch``)."""
    build = ROOT / "build"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(build / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(build / "triton")
    os.environ["USE_FLAX"] = "0"


def parse(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def main(argv=None) -> int:
    args = parse(argv)
    set_cache_dirs()
    sys.path.insert(0, str(ROOT))
    from benchmark.harness import core

    c = core.cell(args.workload)
    chips = c["entry"]["chips"]
    try:
        kind = core.require_devices(chips)
    except core.NoDevice as e:
        core.log(f"no result: {e}")
        return 2
    driver_kind = c["workload"]["driver"]
    driver = core.load_module(HERE / "drivers" / f"{driver_kind}.py",
                              f"bench_driver_{driver_kind}")
    out = driver.run(c, seed=args.seed, seconds=args.seconds,
                     trace=bool(args.trace), device="cuda", t0=T0)
    bad = core.forbidden_modules()
    if bad:
        core.log(f"no result: modules of JAX or the JAX package were "
                 f"loaded: {', '.join(bad)}")
        return 3
    checks = core.checks_line(out["readings"], c["workload"]["checks"])
    correct = (core.passed(checks) and out["failed"] == 0
               and out["attempted"] > 0)
    specs = c["per_layer"] if args.trace else c["end_to_end"]
    metrics = core.read_metrics(specs, out["values"],
                                out["record"] if args.trace else None)
    device = {"platform": "gpu", "kind": kind, "count": chips,
              "memory_peak_bytes": out["memory_peak_bytes"]}
    if args.trace:
        device["busy_s"] = out["busy_s"]
        device["window_s"] = out["window_s"]
    for name, ch in checks.items():
        core.log(f"check {name}: {ch['value']!r} (limit {ch['limit']!r})")
    print(core.result_line(correct, out["attempted"], out["failed"], metrics,
                           device, out.get("breakdown"), checks), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
