"""Spans and counters of the port, on the profiler's clock.

``with span(name):`` marks a stretch of work and ``count(name, n)`` adds
to a counter. Both record while :func:`enable` is in force or while a
``torch.profiler`` session records on the calling thread; otherwise a span
is one check that returns a shared no-op object (no ``record_function``,
no CUDA event, no allocation). A recorded span:

- opens a ``record_function(name)`` range, so that the profiler's chrome
  trace holds it on the device trace's clock;
- takes its host time from ``time.perf_counter_ns()`` and, once CUDA is
  initialised in the process, records a pair of CUDA events on the current
  stream for its device time;
- knows its parent span (per thread: the prefetch producer collates on its
  own) and the number of its root span, its ``call``: the spans of one
  ``generate()`` share that number.

Nothing here reads a device value or synchronises but :func:`snapshot`,
which synchronises once when an event is still pending. A span's events
are resolved earlier, when a later span ends and ``query()`` finds them
done.

The registry keeps, for the latest session, the totals of each span name
(calls, host ms, device ms, self ms), each counter, and the last
:data:`KEEP_SPANS` spans. A span's self time is its duration minus its
children's, on the device clock when it and all its children have device
times and on the host clock otherwise. A session starts at each
:func:`enable` and :func:`profile`, and at the first span or counter that
finds recording on after :func:`disable` or after a check on its thread
that found recording off. So the snapshot after a profiled stretch holds
exactly that stretch.

:func:`profile` is the one exporter: a chrome trace of a stretch, with
recording on. The hand-written ops keep their launch counters as function
attributes (``launches``); :func:`snapshot` reads them as they stand.
"""

from __future__ import annotations

import collections
import threading
import time
from pathlib import Path
from typing import Dict, List

import torch

KEEP_SPANS = 4096          # spans kept in full; totals cover every span

_enabled = False           # the switch: enable() / disable()
_session = 0               # the number of the latest session
_ended = -1                # a session that disable() ended
# per thread: ``off``, the session in which the thread last found recording
# off; ``stack``, its open spans
_tls = threading.local()
_profiling = torch._C._autograd._profiler_enabled
_timed = torch.cuda.is_initialized       # spans take CUDA events


class _NoSpan:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


_NO_SPAN = _NoSpan()


def span(name: str):
    """A context manager that records ``name`` while recording is on."""
    if _enabled or _profiling():
        return _Span(name)
    _tls.off = _session
    return _NO_SPAN


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` while recording is on."""
    if _enabled or _profiling():
        _REG.add(name, n)
    else:
        _tls.off = _session


def enable() -> None:
    """Turn recording on and start a new session."""
    global _enabled
    _REG.new_session()
    _enabled = True


def disable() -> None:
    """Turn the switch off; the session stays readable by
    :func:`snapshot`, and the next span that records starts a new one. A
    profiler that records on this thread keeps recording on."""
    global _enabled, _ended
    _enabled = False
    if not _profiling():
        _ended = _session


class _Record:
    __slots__ = ("session", "id", "name", "parent", "call", "thread",
                 "start_ns", "host_ms", "device_ms", "self_ms", "events",
                 "children")


class _Span:
    __slots__ = ("name", "rec", "rf", "ev0", "t0")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.rec = _REG.open(self.name)
        self.rf = torch.autograd.profiler.record_function(self.name)
        self.rf.__enter__()
        self.ev0 = None
        if _timed():
            self.ev0 = torch.cuda.Event(enable_timing=True)
            self.ev0.record()
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        ev1 = None
        if self.ev0 is not None:
            ev1 = torch.cuda.Event(enable_timing=True)
            ev1.record()
        t1 = time.perf_counter_ns()
        self.rf.__exit__(*exc)
        rec = self.rec
        rec.start_ns = self.t0
        rec.host_ms = (t1 - self.t0) / 1e6
        rec.events = None if ev1 is None else (self.ev0, ev1)
        _REG.close(rec)
        return False


class _Registry:
    """The latest session's spans and counters (module docstring)."""

    def __init__(self):
        self.lock = threading.Lock()
        self._reset()

    def _reset(self):
        self.t0_ns = time.perf_counter_ns()
        self.next_id = 0
        self.next_call = 0
        self.totals: Dict[str, List[float]] = {}
        self.has_device: Dict[str, bool] = {}
        self.counters: Dict[str, int] = {}
        self.recent: collections.deque = collections.deque(maxlen=KEEP_SPANS)
        self.pending: collections.deque = collections.deque()

    def new_session(self):
        global _session
        with self.lock:
            _session += 1
            self._reset()

    def _check_live(self):
        """Start a new session when :func:`disable` ended the current one
        or this thread last found recording off in it: a new stretch of
        recording has begun."""
        if _session in (_ended, getattr(_tls, "off", None)):
            self.new_session()
        _tls.off = None

    def add(self, name: str, n: int):
        self._check_live()
        with self.lock:
            self.counters[name] = self.counters.get(name, 0) + n

    @staticmethod
    def _stack() -> list:
        st = getattr(_tls, "stack", None)
        if st is None:
            st = _tls.stack = []
        return st

    def open(self, name: str) -> _Record:
        self._check_live()
        st = self._stack()
        rec = _Record()
        with self.lock:
            rec.session, rec.id = _session, self.next_id
            self.next_id += 1
            parent = st[-1] if st and st[-1].session == rec.session else None
            if parent is None:
                rec.call = self.next_call
                self.next_call += 1
            else:
                rec.call = parent.call
        rec.name, rec.thread = name, threading.get_ident()
        rec.parent = parent
        rec.device_ms = rec.self_ms = None
        rec.children = []
        st.append(rec)
        return rec

    def close(self, rec: _Record):
        st = self._stack()
        if st and st[-1] is rec:
            st.pop()
        with self.lock:
            if rec.session != _session:
                return
            if rec.parent is not None:
                rec.parent.children.append(rec)
            t = self.totals.setdefault(rec.name, [0, 0.0, 0.0, 0.0])
            t[0] += 1
            t[1] += rec.host_ms
            self.recent.append(rec)
            self.pending.append(rec)
            self._resolve(wait=False)

    def _resolve(self, wait: bool):
        """Resolve the pending spans in the order they ended (so each
        span's children before it) while their events are done; with
        ``wait`` all of them, after the caller's synchronize."""
        while self.pending:
            rec = self.pending[0]
            if rec.events is not None:
                ev0, ev1 = rec.events
                if not (wait or ev1.query()):
                    return
                rec.device_ms = ev0.elapsed_time(ev1)
                rec.events = None
            self.pending.popleft()
            kids = rec.children
            if rec.device_ms is not None and all(
                    k.device_ms is not None for k in kids):
                rec.self_ms = rec.device_ms - sum(k.device_ms for k in kids)
            else:
                rec.self_ms = rec.host_ms - sum(k.host_ms for k in kids)
            rec.children = []
            t = self.totals[rec.name]
            if rec.device_ms is not None:
                t[2] += rec.device_ms
                self.has_device[rec.name] = True
            t[3] += rec.self_ms

    def snapshot(self) -> dict:
        with self.lock:
            if any(r.events is not None for r in self.pending):
                torch.cuda.synchronize()
            self._resolve(wait=True)
            spans = {
                n: {"calls": int(t[0]), "host_ms": t[1],
                    "device_ms": t[2] if self.has_device.get(n) else None,
                    "self_ms": t[3]}
                for n, t in self.totals.items()}
            recent = [{"id": r.id, "name": r.name,
                       "parent": None if r.parent is None else r.parent.id,
                       "call": r.call, "thread": r.thread,
                       "start_ms": (r.start_ns - self.t0_ns) / 1e6,
                       "host_ms": r.host_ms, "device_ms": r.device_ms,
                       "self_ms": r.self_ms} for r in self.recent]
            return {"session": _session, "spans": spans,
                    "counters": dict(self.counters), "recent": recent,
                    "launches": launches()}


_REG = _Registry()


def snapshot() -> dict:
    """The latest session: ``spans`` {name: {calls, host_ms, device_ms
    (None without CUDA events), self_ms}}, ``counters`` {name: n},
    ``recent`` (the last :data:`KEEP_SPANS` spans in the order they ended:
    id, name, parent id, call, thread, start_ms from the session's start,
    host_ms, device_ms, self_ms), ``session`` (its number) and
    ``launches`` (the ops' launch counters as they stand). With recording
    off it counts as a check that found it off."""
    if not (_enabled or _profiling()):
        _tls.off = _session
    return _REG.snapshot()


def launch_counters() -> dict:
    """name -> the op wrapper whose ``launches`` counts that kernel."""
    from daspeech_torch.ops import dag_kernels as dk
    from daspeech_torch.ops import fused_attention as fa
    from daspeech_torch.ops import fused_ffn as ff
    from daspeech_torch.ops import fused_links as fl
    from daspeech_torch.ops import fused_mrf as fm
    from daspeech_torch.ops import fused_relpos as fr

    return {"fused_attention_packed": fa.fused_attention_packed,
            "fused_extract_links": fl.fused_extract_links,
            "fused_attention_relpos": fr.fused_attention_relpos,
            "dag_loss_forward": dk.dag_loss_forward_kernel,
            "dag_best_alignment": dk.dag_best_alignment_kernel,
            "fused_attention_packed_bwd": fa.attention_bwd_kernel,
            "fused_attention_relpos_bwd": fr.relpos_bwd_kernel,
            "fused_extract_links_bwd": fl.links_bwd_kernel,
            "fused_attention": fa.fused_attention,
            "fused_attention_bwd": fa.attention_hm_bwd_kernel,
            "mrf_level": fm.mrf_level,
            "fused_ffn": ff.ffn_fwd_kernel,
            "fused_ffn_bwd": ff.ffn_bwd_kernel,
            "fused_attention_full_bias": fa.attention_fb_fwd_kernel,
            "fused_attention_full_bias_bwd": fa.attention_fb_bwd_kernel}


def launches() -> Dict[str, int]:
    """{kernel: launches} of every hand-written op, read from its
    wrapper's ``launches`` attribute."""
    return {n: w.launches for n, w in launch_counters().items()}


def table(snap: dict) -> str:
    """The snapshot as text: a line per span (calls, host ms, device ms,
    self ms), then a line per counter and per launched kernel."""
    lines = [f"{'span':<24} {'calls':>7} {'host ms':>11} {'device ms':>11} "
             f"{'self ms':>11}"]
    for n, s in sorted(snap["spans"].items()):
        dev = ("-" if s["device_ms"] is None
               else f"{s['device_ms']:.3f}")
        lines.append(f"{n:<24} {s['calls']:>7} {s['host_ms']:>11.3f} "
                     f"{dev:>11} {s['self_ms']:>11.3f}")
    for n, v in sorted(snap["counters"].items()):
        lines.append(f"{n:<24} {v:>7}")
    for n, v in sorted(snap["launches"].items()):
        if v:
            lines.append(f"launches {n:<15} {v:>7}")
    return "\n".join(lines)


class profile:
    """``with profile(directory, device):`` traces the stretch under
    ``torch.profiler`` (the CPU, and the card when ``device`` is a CUDA
    device), with recording on in a new session, and writes the chrome
    trace to ``directory/name``. :meth:`start` and :meth:`stop` do the
    same for a stretch that is no ``with`` block."""

    def __init__(self, directory, device, name: str = "trace.json"):
        self.path = Path(directory) / name
        self.device = torch.device(device)
        self.prof = None

    def start(self) -> "profile":
        from torch.profiler import ProfilerActivity
        from torch.profiler import profile as torch_profile

        acts = [ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        self.prof = torch_profile(activities=acts)
        self.prof.__enter__()
        enable()
        return self

    def stop(self) -> None:
        self.prof.__exit__(None, None, None)
        disable()
        self.path.parent.mkdir(parents=True, exist_ok=True)
        self.prof.export_chrome_trace(str(self.path))
        self.prof = None

    def __enter__(self) -> "profile":
        return self.start()

    def __exit__(self, *exc):
        self.stop()
        return False
