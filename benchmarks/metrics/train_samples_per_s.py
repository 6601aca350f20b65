"""Samples whose optimizer step completed inside the window, over the
window's seconds (a device-loop group counts K x B); loader waits and
every stall included."""


def read(record):
    start, end = record["window"]
    return sum(samples for _, samples, _ in record["done"]) / (end - start)
