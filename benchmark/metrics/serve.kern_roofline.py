"""The program's hand-written ops' share of their roofline, in %: the sum
over the profiled calls of each call's least time (``counts.ops``, from its
arguments) over the sum of the device time its launches took."""

from benchmark.counts.ops import bound_s


def read(record):
    calls = record.get("op_calls") or []
    device = sum(c[3] for c in calls)
    if not calls or device <= 0:
        return None
    least = sum(bound_s(c[1], c[2], record["peak_flops"],
                        record["peak_bytes"]) for c in calls)
    return 100.0 * least / device
