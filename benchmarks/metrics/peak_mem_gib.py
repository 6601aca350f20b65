"""torch.cuda.max_memory_allocated() over the whole process, set-up and
window, read once the window has closed (before the reference runs)."""


def read(record):
    return record["memory_peak_bytes"] / 2 ** 30
