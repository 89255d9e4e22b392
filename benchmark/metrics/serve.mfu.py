"""The whole ``generate()``'s share of the chip's peak, in %: the
operations the window's batches needed (``counts.s2st``, at each
utterance's own lengths) over their wall time, against the published peak
of the cell's compute dtype."""


def read(record):
    if not record.get("flops") or not record.get("timed_s"):
        return None
    return 100.0 * record["flops"] / record["timed_s"] / record["peak_flops"]
