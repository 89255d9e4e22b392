"""One run of one cell: find the cell's files by name, check the device,
run the cell's driver, read the cell's metrics, check the process for JAX,
and print the result line.

Everything a cell needs is found by name: ``BENCHMARK.json`` names the
cell, ``workloads/<cell>.json`` its configuration, driver kind, traffic
and limits, ``configs/<config>.json`` the configuration, ``drivers/<kind>.py``
the code that runs it and ``metrics/<metric>.py`` the reader of each
per-layer metric.
"""

from __future__ import annotations

import importlib.util
import json
import math
import sys
from pathlib import Path
from types import ModuleType
from typing import Dict, List, Optional

BENCH_DIR = Path(__file__).resolve().parent.parent
ROOT = BENCH_DIR.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "daspeech_tpu")


class NoDevice(RuntimeError):
    """The machine lacks the devices the cell asks for."""


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_module(path: Path, name: str) -> ModuleType:
    """A module from a file of the benchmark, by path (metric and driver
    files are named after metrics and kinds, which may hold dots)."""
    spec = importlib.util.spec_from_file_location(name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def cell(name: str, bench: Optional[dict] = None) -> dict:
    """Everything about one cell: its ``BENCHMARK.json`` entry, workload
    file, configuration file, and the metrics it reports."""
    bench = bench if bench is not None else load_json(ROOT / "BENCHMARK.json")
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    conf = next(c for c in bench["configs"] if c["name"] == entry["config"])
    e2e = [m for m in bench["end_to_end"]
           if name in m.get("workloads", [name])]
    reported = {m["name"] for m in e2e}
    layer = [m for m in bench["per_layer"]
             if name in m.get("workloads", [name] if m["moves"] in reported
                              else [])]
    return {"entry": entry,
            "workload": load_json(BENCH_DIR / "workloads" / f"{name}.json"),
            "config": load_json(ROOT / conf["file"]),
            "end_to_end": e2e, "per_layer": layer}


def require_devices(n: int) -> str:
    """The name of device 0; raises :class:`NoDevice` unless CUDA is
    available with at least ``n`` devices."""
    import torch

    if not torch.cuda.is_available():
        raise NoDevice("torch.cuda.is_available() is false")
    if torch.cuda.device_count() < n:
        raise NoDevice(f"{torch.cuda.device_count()} CUDA devices, the cell "
                       f"needs {n}")
    return torch.cuda.get_device_name(0)


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name (before the first dot) is JAX's
    or the JAX package's."""
    return sorted({m for m in list(sys.modules)
                   if m.split(".", 1)[0] in FORBIDDEN})


def read_metrics(specs: List[dict], values: Dict[str, float],
                 record: Optional[dict] = None) -> Dict[str, dict]:
    """{name: {value, unit}} of each metric of ``specs``: an end-to-end
    metric from ``values``, a per-layer one from its reader
    ``metrics/<name>.py`` over ``record``. A metric with nothing to read is
    left out."""
    out = {}
    for m in specs:
        if record is None:
            v = values.get(m["name"])
        else:
            reader = load_module(BENCH_DIR / "metrics" / f"{m['name']}.py",
                                 "bench_metric_" + m["name"].replace(
                                     ".", "_").replace("-", "_"))
            v = reader.read(record)
        if v is not None and math.isfinite(v):
            out[m["name"]] = {"value": float(v), "unit": m["unit"]}
    return out


def checks_line(readings: Dict[str, float], limits: Dict[str, float]
                ) -> Dict[str, dict]:
    return {k: {"value": readings[k], "limit": limits[k]} for k in limits}


def passed(checks: Dict[str, dict]) -> bool:
    return all(c["value"] <= c["limit"] for c in checks.values())


def result_line(correct: bool, attempted: int, failed: int,
                metrics: Dict[str, dict], device: dict,
                breakdown: Optional[dict], checks: Dict[str, dict]) -> str:
    """The run's last line: correct, attempted, failed, metrics, device,
    the breakdown of a traced run, and the compared numbers last."""
    out = {"correct": correct, "attempted": attempted, "failed": failed,
           "metrics": metrics, "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    out["checks"] = checks
    return json.dumps(_strict(out), allow_nan=False)


def _strict(obj):
    """``obj`` with each non-finite float written as a string ("inf",
    "nan"), which strict JSON parsers accept."""
    if isinstance(obj, dict):
        return {k: _strict(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_strict(v) for v in obj]
    if isinstance(obj, float) and not math.isfinite(obj):
        return str(obj)
    return obj
