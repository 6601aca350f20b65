"""The 90th percentile of the wall time between consecutive step
completions in the window (from the window's start for the first); a
device-loop group counts once, at its wall time over K.  In a traced run
the intervals that overlap the profiled sub-window and its reduction are
left out: the profiler's overhead is not the program's."""

from benchmarks.harness import quantile


def read(record):
    lo, hi = record.get("trace_span") or (None, None)
    prev = record["window"][0]
    per_step = []
    for t_done, _, steps in record["done"]:
        if lo is None or t_done <= lo or prev >= hi:
            per_step.append((t_done - prev) / steps * 1e3)
        prev = t_done
    return quantile(per_step, 0.9) if per_step else None
