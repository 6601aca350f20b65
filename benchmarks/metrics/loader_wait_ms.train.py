"""Mean host ms a training step waits on the loader's next batch (the
benchmark's span around the loader's iterator), over the window."""

import statistics


def read(record):
    waits = record["spans"].get("loader")
    return statistics.fmean(waits) * 1e3 if waits else None
