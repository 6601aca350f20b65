"""The 90th percentile, over every step of the window, of the wall time
between consecutive step completions (from the window's start for the
first); a device-loop group counts once, at its wall time over K."""

from benchmarks.harness import quantile


def read(record):
    prev = record["window"][0]
    per_step = []
    for t_done, _, steps in record["done"]:
        per_step.append((t_done - prev) / steps * 1e3)
        prev = t_done
    return quantile(per_step, 0.9) if per_step else None
