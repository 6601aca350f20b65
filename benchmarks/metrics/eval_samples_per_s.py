"""Captions (or answers) whose tokens reached the host inside the window,
over the window's seconds."""


def read(record):
    start, end = record["window"]
    return sum(samples for _, samples, _ in record["done"]) / (end - start)
