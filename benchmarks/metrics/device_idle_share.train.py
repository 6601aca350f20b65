"""Share of the profiled sub-window's wall time in which no operation
(kernel, copy or set) ran on the device, in %; over several chips, over
the ranks' summed busy and window seconds (``busy_by_rank``: each rank
profiles the same steps)."""


def read(record):
    s = record.get("trace_summary")
    busy = record.get("busy_by_rank") or (
        [(s["busy_s"], s["window_s"])] if s else [])
    window = sum(w for _, w in busy)
    if not window:
        return None
    return 100.0 * (1.0 - sum(b for b, _ in busy) / window)
