"""Mean host ms per batch of ``BucketBatcher.collate`` (the program's
``data.collate`` span): reading a batch's utterances and padding them in
numpy, between the device's batches. It reads the program's own registry
for the profiled stretch (``harness/program_spans.py``), not the
``record``; None when the registry holds no such span."""

from benchmark.harness.program_spans import span


def read(record):
    s = span("data.collate")
    return None if s is None else s["host_ms"] / s["calls"]
