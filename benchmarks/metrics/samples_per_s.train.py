"""The eager cell's rate: samples whose optimizer step completed in the
window, over the window's seconds, read in the traced run and leaving out
the profiled sub-window and its reduction (``mfu.train``'s traced rate)."""

import os

from benchmarks import harness


def read(record):
    path = os.path.join(harness.BENCH, "metrics", "mfu.train.py")
    return harness._load(path, "benchmarks.metrics.mfu_train").traced_rate(
        record)
