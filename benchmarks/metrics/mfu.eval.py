"""Model FLOPs per caption (``flop_per_sample``: the prefill and K beams'
T-1 cached steps from the cell's shapes) times the traced run's
captions per second, over the H100's 989 TFLOP/s of dense bf16, in %.
The rate leaves out the profiled sub-window and its reduction, whose
profiler overhead is not the program's."""

from benchmarks.work import BF16_FLOP_PER_S


def traced_rate(record):
    start, end = record["window"]
    lo, hi = record.get("trace_span") or (end, end)
    samples = sum(n for t, n, _ in record["done"] if not lo < t <= hi)
    seconds = (end - start) - (min(hi, end) - max(lo, start))
    return samples / seconds if seconds > 0 else None


def read(record):
    rate = traced_rate(record)
    if not rate:
        return None
    return 100.0 * record["flop_per_sample"] * rate / BF16_FLOP_PER_S
