"""Seconds from the process's start to the window's start: imports, the
inputs and the feature store, weights, the kernels' build or load, and
the warm-up steps."""


def read(record):
    return record["setup_s"]
