"""The program's own spans and counters (``daspeech_torch.telemetry``),
for the per-layer metrics that read them.

The program records while a ``torch.profiler`` session records, so after
a ``--trace 1`` run its latest session is the run's profiled stretch:
the same batches that ``serve.device_idle`` and ``serve.kern_roofline``
read. A program without the registry gives None, as a session without the
name does.
"""

from __future__ import annotations

from typing import Optional


def snapshot() -> Optional[dict]:
    """The program's latest session, or None when it keeps none."""
    try:
        from daspeech_torch import telemetry
    except ImportError:
        return None
    return telemetry.snapshot()


def span(name: str) -> Optional[dict]:
    """{calls, host_ms, device_ms, self_ms} of the span ``name`` in the
    latest session, or None."""
    snap = snapshot()
    s = None if snap is None else snap["spans"].get(name)
    return s if s and s["calls"] else None


def counter(name: str) -> Optional[int]:
    """The counter ``name`` in the latest session, or None."""
    snap = snapshot()
    return None if snap is None else snap["counters"].get(name)
