"""Model FLOPs per sample (``flop_per_sample``: forward and backward from
the cell's shapes, recomputation not counted) times the traced run's
samples per second, over the H100's 989 TFLOP/s of dense bf16 a chip, in
%.  The rate leaves out the profiled sub-window and its reduction, whose
profiler overhead is not the program's; over several chips it is every
rank's samples (``done_by_rank``) over as many chips' peak."""

from benchmarks.work import BF16_FLOP_PER_S


def traced_rate(record):
    start, end = record["window"]
    lo, hi = record.get("trace_span") or (end, end)
    runs = record.get("done_by_rank") or [record["done"]]
    samples = sum(n for done in runs for t, n, _ in done
                  if not lo < t <= hi)
    seconds = (end - start) - (min(hi, end) - max(lo, start))
    return samples / seconds if seconds > 0 else None


def read(record):
    rate = traced_rate(record)
    if not rate:
        return None
    chips = len(record.get("done_by_rank") or [None])
    return (100.0 * record["flop_per_sample"] * rate
            / (chips * BF16_FLOP_PER_S))
