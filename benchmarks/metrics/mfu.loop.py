"""``mfu.train`` read in the device-loop cell, where it moves
``loop_samples_per_s``."""

from benchmarks import harness


def read(record):
    return harness.metric_reader("mfu.train")(record)
