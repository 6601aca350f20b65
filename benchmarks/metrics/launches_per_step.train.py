"""CUDA runtime and driver calls that put work on the device (kernel and
graph launches, copies, sets) per optimizer step, in the profiled
sub-window's host-side trace: the host's dispatch work."""

LAUNCH_CALLS = ("launchkernel", "graphlaunch", "memcpy", "memset",
                "launchcooperativekernel")


def count_launches(ev):
    lo, hi = ev["window"]
    return sum(1 for name, s, _ in ev["runtime"]
               if lo <= s < hi and any(c in name.lower()
                                       for c in LAUNCH_CALLS))


def read(record):
    steps = record.get("profiled_steps")
    if not steps:
        return None
    return count_launches(record["trace"]) / steps
