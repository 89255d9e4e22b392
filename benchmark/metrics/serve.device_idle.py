"""The share of the profiled stretch of the window, in %, in which no
operation ran on the device."""


def read(record):
    if not record.get("window_s") or not record.get("busy_s"):
        return None
    return 100.0 * (1.0 - record["busy_s"] / record["window_s"])
