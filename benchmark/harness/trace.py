"""Device traces: profile a stretch of work, and read from its events the
device's busy time, the longest idle gaps with what the host was doing,
the operations that took most device time, and the device time of each
annotated call of a program op.

The attribution never reads a kernel's name: a device event belongs to the
call whose annotation range (``record_function``) holds the host launch
that the profiler links to it by its correlation id.
"""

from __future__ import annotations

import bisect
import contextlib
import functools
import json
import os
import tempfile
import time
from typing import Callable, Dict, List, Optional, Tuple

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
WINDOW = "bench.window"
OP_PREFIX = "bench.op:"
STAGE_PREFIX = "bench.stage:"


def profiled_events(fn: Callable[[], None]) -> Tuple[List[dict], float]:
    """The chrome-trace events of ``fn()`` run once under
    ``torch.profiler`` inside a ``bench.window`` range, and its wall time
    in seconds. The trace file is written to the temporary directory and
    removed once read."""
    from torch.profiler import ProfilerActivity, profile, record_function

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        with record_function(WINDOW):
            fn()
            torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.remove(path)
    return events, wall


def device_events(events: List[dict]) -> List[dict]:
    return [e for e in events if e.get("cat") in DEVICE_CATS
            and "dur" in e]


def busy_intervals(dev: List[dict]) -> List[Tuple[float, float]]:
    """The union of the device events' intervals (µs), in order."""
    out: List[List[float]] = []
    for s, e in sorted((ev["ts"], ev["ts"] + ev["dur"]) for ev in dev):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def busy_s(events: List[dict]) -> float:
    """Seconds in which some operation ran on the device."""
    return sum(e - s for s, e in busy_intervals(device_events(events))) / 1e6


def _window(events: List[dict]) -> Optional[Tuple[float, float]]:
    for e in events:
        if e.get("name") == WINDOW and e.get("cat") == "user_annotation":
            return e["ts"], e["ts"] + e["dur"]
    return None


def top_device_ops(events: List[dict], n: int = 10) -> List[list]:
    """[[name, seconds]] of the device operations that took most time."""
    by: Dict[str, float] = {}
    for e in device_events(events):
        name = e["name"][:120]
        by[name] = by.get(name, 0.0) + e["dur"] / 1e6
    return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]


def idle_gaps(events: List[dict], n: int = 10) -> List[list]:
    """[[what the host was doing, seconds]] of the device's idle time in
    the window, summed by the host's innermost stage and operator at the
    start of each gap, the largest first."""
    win = _window(events)
    busy = busy_intervals(device_events(events))
    if win is None or not busy:
        return []
    gaps, t = [], win[0]
    for s, e in busy:
        if s > t:
            gaps.append((t, s))
        t = max(t, e)
    if win[1] > t:
        gaps.append((t, win[1]))
    host = sorted((e for e in events
                   if e.get("cat") in ("cpu_op", "user_annotation")
                   and "dur" in e and e.get("name") != WINDOW),
                  key=lambda e: e["ts"])
    starts = [e["ts"] for e in host]
    by: Dict[str, float] = {}
    for g0, g1 in gaps:
        stage, op = "", ""
        for e in host[:bisect.bisect_right(starts, g0)]:
            if e["ts"] + e["dur"] <= g0:
                continue
            if e["name"].startswith(STAGE_PREFIX):
                stage = e["name"][len(STAGE_PREFIX):]
            elif e.get("cat") == "cpu_op":
                op = e["name"]
        name = "/".join(x for x in (stage, op or "host python") if x)
        by[name] = by.get(name, 0.0) + (g1 - g0) / 1e6
    return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]


def op_device_s(events: List[dict]) -> Dict[int, float]:
    """{call index: device seconds} of every ``bench.op:<index>`` range:
    the device events whose host launches lie inside it."""
    ranges = sorted(((e["ts"], e["ts"] + e["dur"], e.get("tid"),
                      int(e["name"][len(OP_PREFIX):]))
                     for e in events if e.get("cat") == "user_annotation"
                     and e.get("name", "").startswith(OP_PREFIX)),
                    key=lambda r: r[0])
    starts = [r[0] for r in ranges]
    owner: Dict[int, int] = {}
    for e in events:
        corr = (e.get("args") or {}).get("correlation")
        if e.get("cat") not in ("cuda_runtime", "cuda_driver") or corr is None:
            continue
        # op ranges do not nest: the launch's range, if any, is the last
        # one to start before it
        i = bisect.bisect_right(starts, e["ts"]) - 1
        if i >= 0:
            s, t, tid, idx = ranges[i]
            if e["ts"] <= t and tid == e.get("tid"):
                owner[corr] = idx
    out: Dict[int, float] = {}
    for e in device_events(events):
        corr = (e.get("args") or {}).get("correlation")
        if corr in owner:
            idx = owner[corr]
            out[idx] = out.get(idx, 0.0) + e["dur"] / 1e6
    return out


class _Shape:
    """What counting needs of a large tensor argument: its shape and
    sizes, without keeping the tensor alive."""

    def __init__(self, t: torch.Tensor):
        self.shape = tuple(t.shape)
        self._numel, self._size = t.numel(), t.element_size()

    def numel(self) -> int:
        return self._numel

    def element_size(self) -> int:
        return self._size


KEEP_NUMEL = 1 << 16       # smaller tensors (biases, lengths) are kept


def _summary(a):
    if isinstance(a, torch.Tensor) and a.numel() > KEEP_NUMEL:
        return _Shape(a)
    return a


class OpRecorder:
    """Wraps functions of the program's op modules so that each call runs
    inside a ``bench.op:<index>`` range and what counting needs of its
    arguments is kept; :meth:`restore` puts the originals back."""

    def __init__(self):
        self.calls: List[Tuple[str, Callable, tuple, dict]] = []
        self._saved: List[Tuple[object, str, Callable]] = []
        self.active = False

    def wrap(self, module, attr: str, name: str, count: Callable) -> None:
        from torch.profiler import record_function

        orig = getattr(module, attr)

        def wrapped(*args, **kwargs):
            if not self.active:
                return orig(*args, **kwargs)
            idx = len(self.calls)
            self.calls.append((name, count,
                               tuple(_summary(a) for a in args),
                               {k: _summary(v) for k, v in kwargs.items()}))
            with record_function(f"{OP_PREFIX}{idx}"):
                return orig(*args, **kwargs)

        # the op's own attributes (its launch counters) go with it
        functools.update_wrapper(wrapped, orig)
        self._saved.append((module, attr, orig))
        setattr(module, attr, wrapped)

    def restore(self) -> None:
        for module, attr, orig in reversed(self._saved):
            setattr(module, attr, orig)
        self._saved.clear()

    def counted(self, device_s: Dict[int, float]) -> List[list]:
        """[[op name, flops, bytes, device seconds]] of each call that the
        trace attributed device time to."""
        out = []
        for idx, (name, count, args, kwargs) in enumerate(self.calls):
            if device_s.get(idx, 0.0) > 0.0:
                flops, nbytes = count(*args, **kwargs)
                out.append([name, flops, nbytes, device_s[idx]])
        return out


@contextlib.contextmanager
def stage(name: str):
    """A ``bench.stage:<name>`` range for the profiler."""
    from torch.profiler import record_function

    with record_function(STAGE_PREFIX + name):
        yield
