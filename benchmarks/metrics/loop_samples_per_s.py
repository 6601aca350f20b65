"""Samples whose optimizer step completed inside the window, over the
window's seconds, through the device loop: a group of K steps counts
K x B when its losses are in hand."""

from benchmarks import harness


def read(record):
    return harness.metric_reader("train_samples_per_s")(record)
