"""CUDA runtime and driver calls that put work on the device per decode
batch, in the profiled sub-window's host-side trace (the counting of
``launches_per_step.train``)."""

from benchmarks import harness


def read(record):
    return harness.metric_reader("launches_per_step.train")(record)
