"""Mean device ms per batch of the outputs' copies to the host (the
program's ``results.d2h`` span: tokens, lengths, mel, mel lengths and
waveform, each a ``.cpu()`` into pageable memory). Its start event fires
when the vocoder's work ends, so this is the device's time on the copies
and the gaps between them. It reads the program's own registry for the
profiled stretch (``harness/program_spans.py``), not the ``record``; None
when the registry holds no such span, or no device time for it."""

from benchmark.harness.program_spans import span


def read(record):
    s = span("results.d2h")
    if s is None or s["device_ms"] is None:
        return None
    return s["device_ms"] / s["calls"]
