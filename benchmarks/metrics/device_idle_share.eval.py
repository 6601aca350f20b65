"""Share of the profiled sub-window's wall time in which no operation
(kernel, copy or set) ran on the device, in %."""


def read(record):
    s = record.get("trace_summary")
    if not s or not s["window_s"]:
        return None
    return 100.0 * (1.0 - s["busy_s"] / s["window_s"])
