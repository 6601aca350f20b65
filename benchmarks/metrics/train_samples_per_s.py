"""Samples whose optimizer step completed inside the window, over the
window's seconds (a device-loop group counts K x B); over several chips,
every rank's samples (``done_by_rank``); loader waits and every stall
included."""


def read(record):
    start, end = record["window"]
    runs = record.get("done_by_rank") or [record["done"]]
    return sum(samples for done in runs for _, samples, _ in done) / (
        end - start)
