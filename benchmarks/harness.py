"""What every cell's run shares: the manifest and the files it names, the
run's context (seed, window, spans), the profiled sub-window and its
reduction, and the checks that a run ends with.

Everything that belongs to one configuration, traffic mix or metric is a
file of its own, found by the name ``BENCHMARK.json`` gives it:
``configs/<config>.json``, ``traffic/<traffic>.json`` (which names its
driver, ``drivers/<kind>.py``) and ``metrics/<metric>.py``.
"""

from __future__ import annotations

import contextlib
import gzip
import importlib.util
import json
import os
import sys
import time
from typing import Dict, List, Optional

BENCH = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH)
# top-level modules no run may hold once its window has closed
FORBIDDEN = ("jax", "jaxlib", "flax", "optax", "orbax", "vlp_tpu")


def load_json(path: str):
    with open(path) as f:
        return json.load(f)


def manifest() -> dict:
    return load_json(os.path.join(ROOT, "BENCHMARK.json"))


def workload(man: dict, name: str) -> dict:
    for w in man["workloads"]:
        if w["name"] == name:
            return w
    raise SystemExit(f"no workload {name!r} in BENCHMARK.json")


def config(man: dict, name: str) -> dict:
    for c in man["configs"]:
        if c["name"] == name:
            return load_json(os.path.join(ROOT, c["file"]))
    raise SystemExit(f"no config {name!r} in BENCHMARK.json")


def traffic(name: str) -> dict:
    return load_json(os.path.join(BENCH, "traffic", name + ".json"))


def _load(path: str, modname: str):
    spec = importlib.util.spec_from_file_location(modname, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def driver(kind: str):
    return _load(os.path.join(BENCH, "drivers", kind + ".py"),
                 f"benchmarks.drivers.{kind}")


def metric_reader(name: str):
    """``metrics/<name>.py``'s ``read(record) -> float or None``."""
    return _load(os.path.join(BENCH, "metrics", name + ".py"),
                 "benchmarks.metrics." + name.replace(".", "_")).read


def metrics_of(man: dict, cell: str, traced: bool) -> List[dict]:
    """The metrics a run of ``cell`` reports: its end-to-end metrics
    untraced, its per-layer metrics traced."""
    group = man["per_layer" if traced else "end_to_end"]
    return [m for m in group if cell in m.get("workloads", [cell])]


def forbidden_modules() -> List[str]:
    """Forbidden top-level modules held by this process (whole names:
    ``vlp_tpu_torch`` is not ``vlp_tpu``)."""
    tops = {m.split(".")[0] for m in list(sys.modules)}
    return sorted(tops & set(FORBIDDEN))


def process_start() -> float:
    """This process's start on the ``time.monotonic`` clock (Linux
    ``/proc``; the import of this module elsewhere)."""
    try:
        with open("/proc/self/stat") as f:
            ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            up = float(f.read().split()[0])
        age = up - ticks / os.sysconf("SC_CLK_TCK")
        return time.monotonic() - age
    except (OSError, ValueError, IndexError):
        return _IMPORTED


_IMPORTED = time.monotonic()


class Context:
    """One run, or one rank's part of it: what the cell's driver module
    reads (configuration, traffic, seed, window length, trace flag, a
    private directory for its inputs; over several chips the rank, the
    world, the ranks' shared ``team`` and the rank's ``dist``) and what it
    reports back through ``record``.  One chip: rank 0 of a world of one,
    no team and no group."""

    def __init__(self, name: str, cfg: dict, traffic_: dict, seed: int,
                 seconds: float, traced: bool, workdir: str, device=None,
                 rank: int = 0, world: int = 1, team=None, dist=None):
        import torch
        self.device = torch.device(device or "cuda:0")
        self.rank, self.world, self.team, self.dist = rank, world, team, dist
        self.name, self.cfg, self.traffic = name, cfg, traffic_
        self.seed, self.seconds = seed, seconds
        self.workdir = workdir
        self.t_start = process_start()
        self.window = None               # (start, end), time.monotonic
        self.spans: Dict[str, List[float]] = {}
        self.record: dict = {}
        # also read the control and the planted faults (calibration only)
        self.controls = False
        self.marks = [("start", self.t_start), ("torch", time.monotonic())]
        self.profiler = SubWindow(traffic_.get("trace_after", 3),
                                  traffic_.get("trace_steps", 10),
                                  workdir, rank) if traced else None
        self.beat()

    def mark(self, name: str) -> None:
        """The end of a set-up phase (reported on standard error)."""
        self.marks.append((name, time.monotonic()))
        self.beat()

    def beat(self) -> None:
        """Over several chips, tell the launcher's watchdog that this rank
        is making progress in set-up (nothing on one chip)."""
        if self.team is not None:
            self.team.beat(self.rank)

    def open_window(self) -> float:
        """Start the window (over several chips, once every rank is ready,
        at rank 0's start)."""
        self.mark("warm-up")
        t0 = (time.monotonic() if self.team is None
              else self.team.open_window(self.rank))
        self.window = (t0, t0 + self.seconds)
        self.record["setup_s"] = t0 - self.t_start
        return t0

    @property
    def window_end(self) -> float:
        return self.window[1]

    def window_over(self, t: float) -> bool:
        """Whether a step that completed at ``t`` ends the run: past the
        window, and no profiled sub-window left open (its steps, counted
        in no end-to-end metric, run to its end)."""
        return t > self.window[1] and not (self.profiler is not None
                                           and self.profiler.active)

    def agree(self, go: bool) -> bool:
        """Whether every rank takes another step: rank 0's ``go`` (the
        others' is not read); one chip: ``go``."""
        return go if self.team is None else self.team.agree(self.rank, go)

    def leave_group(self) -> None:
        """Tear down the ranks' process group, on every rank together once
        the window's last exchange is over (nothing on one chip)."""
        if self.dist is not None:
            self.dist.destroy()

    @contextlib.contextmanager
    def span(self, name: str):
        """A benchmark-side span around a call into one layer: host
        seconds kept per name, and a ``bench.<name>`` range in the trace
        while the sub-window is profiled."""
        rf = (self.profiler.range("bench." + name)
              if self.profiler is not None and self.profiler.active
              else contextlib.nullcontext())
        t0 = time.monotonic()
        with rf:
            yield
        self.spans.setdefault(name, []).append(time.monotonic() - t0)

    def step_begin(self, i: int) -> None:
        """Before the window's i-th step (or group, or batch)."""
        if self.profiler is not None:
            self.profiler.begin(i)

    def step_end(self, i: int) -> None:
        if self.profiler is not None:
            self.profiler.end(i)


def sync(device) -> None:
    """Wait for the device's queued work (nothing on the CPU)."""
    import torch
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def memory_peak(device) -> int:
    import torch
    return (torch.cuda.max_memory_allocated(device)
            if device.type == "cuda" else 0)


def release(device) -> None:
    import gc

    import torch
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()


class SubWindow:
    """``torch.profiler`` over the window's steps ``after`` ..
    ``after + count - 1``: synchronised at both ends, the trace exported
    and reduced to its device activities, runtime calls and the
    benchmark's ranges when it stops."""

    def __init__(self, after: int, count: int, workdir: str, rank: int = 0):
        self.after, self.count, self.workdir = after, count, workdir
        self.rank = rank
        self.prof = None
        self.active = False
        self.events: Optional[dict] = None
        self.span_t = None          # (start, stop incl. reduction), monotonic
        self._outer = None

    def range(self, name: str):
        from torch.profiler import record_function
        return record_function(name)

    def begin(self, i: int) -> None:
        if i != self.after or self.events is not None:
            return
        import torch
        from torch.profiler import ProfilerActivity, profile
        torch.cuda.synchronize()
        self.span_t = [time.monotonic(), None]
        self.prof = profile(activities=[ProfilerActivity.CPU,
                                        ProfilerActivity.CUDA])
        self.prof.__enter__()
        self._outer = self.range("bench.profiled")
        self._outer.__enter__()
        self.active = True

    def end(self, i: int) -> None:
        if not self.active or i != self.after + self.count - 1:
            return
        import torch
        torch.cuda.synchronize()
        self._outer.__exit__(None, None, None)
        self.prof.__exit__(None, None, None)
        self.active = False
        path = os.path.join(self.workdir, f"trace.{self.rank}.json")
        self.prof.export_chrome_trace(path)
        self.prof = None
        self.events = reduce_trace(path)
        os.remove(path)
        self.span_t[1] = time.monotonic()


DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
RUNTIME_CATS = ("cuda_runtime", "cuda_driver")


def reduce_trace(path: str) -> dict:
    """A chrome trace as lists of (name, start_us, dur_us): the device's
    activities, the host's CUDA runtime/driver calls and the benchmark's
    ranges; and the profiled range itself."""
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        raw = json.load(f)
    evs = raw["traceEvents"] if isinstance(raw, dict) else raw
    out = {"device": [], "runtime": [], "ranges": [], "window": None}
    for e in evs:
        if e.get("ph") != "X":
            continue
        cat, name = e.get("cat", ""), e.get("name", "")
        t = (name, float(e["ts"]), float(e.get("dur", 0.0)))
        if cat in DEVICE_CATS:
            out["device"].append(t + (cat,))
        elif cat in RUNTIME_CATS:
            out["runtime"].append(t)
        elif cat == "user_annotation" and name.startswith("bench."):
            if name == "bench.profiled":
                out["window"] = (t[1], t[1] + t[2])
            else:
                out["ranges"].append(t)
    if out["window"] is None:
        print("trace: no bench.profiled range; the sub-window is taken as "
              "the span of its device and runtime events", file=sys.stderr)
        spans = [(s, s + d) for _, s, d, *_ in out["device"] + out["runtime"]]
        out["window"] = (min(a for a, _ in spans), max(b for _, b in spans))
    return out


def busy_intervals(events, lo: float, hi: float):
    """The union of device activity intervals inside [lo, hi], sorted."""
    ivs = sorted((max(s, lo), min(s + d, hi)) for _, s, d, *_ in events
                 if s + d > lo and s < hi)
    out = []
    for s, e in ivs:
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def device_summary(ev: dict) -> dict:
    """busy and window seconds of the profiled range, and the breakdown:
    the device operations that took most time, and the longest idle gaps
    named by the benchmark's range open on the host when each began."""
    lo, hi = ev["window"]
    busy = busy_intervals(ev["device"], lo, hi)
    busy_us = sum(e - s for s, e in busy)
    per_op: Dict[str, float] = {}
    for name, s, d, _ in ev["device"]:
        if lo <= s < hi:
            per_op[name] = per_op.get(name, 0.0) + d
    ops = sorted(per_op.items(), key=lambda kv: -kv[1])[:10]
    gaps = []
    edges = [lo] + [x for iv in busy for x in iv] + [hi]
    for s, e in zip(edges[0::2], edges[1::2]):
        if e > s:
            gaps.append((s, e - s))
    gaps.sort(key=lambda g: -g[1])

    def host_at(t):
        best = None
        for name, s, d in ev["ranges"]:
            if s <= t < s + d and (best is None or s > best[1]):
                best = (name, s)
        return best[0][len("bench."):] if best else "other"

    idle = [[host_at(s), d / 1e6] for s, d in gaps[:10]]
    return {"busy_s": busy_us / 1e6, "window_s": (hi - lo) / 1e6,
            "breakdown": {"device_ops": [[n[:120], d / 1e6] for n, d in ops],
                          "idle_gaps": idle}}


def kernel_time_ms(ev: dict, patterns, exclude=()) -> float:
    """Summed device ms of the profiled range's kernels whose name holds
    one of ``patterns`` and none of ``exclude``."""
    lo, hi = ev["window"]
    total = 0.0
    for name, s, d, cat in ev["device"]:
        if cat != "kernel" or not (lo <= s < hi):
            continue
        low = name.lower()
        if any(p in low for p in patterns) and not any(
                x in low for x in exclude):
            total += d
    return total / 1e3


def setup_summary(marks) -> str:
    """One line: the seconds of each set-up phase."""
    parts = [f"{b[0]} {b[1] - a[1]:.2f}" for a, b in zip(marks, marks[1:])]
    return "setup (s): " + ", ".join(parts)


def window_summary(record) -> str:
    """One line on the window's pace: items completed, the rate in each
    half of the window, and the median and 90th percentile interval."""
    start, end = record["window"]
    mid = (start + end) / 2
    done = record["done"]
    halves = [sum(n for t, n, _ in done if t <= mid),
              sum(n for t, n, _ in done if t > mid)]
    prev, gaps = start, []
    for t, _, steps in done:
        gaps.append((t - prev) / steps * 1e3)
        prev = t
    if not gaps:
        return "window: nothing completed"
    return (f"window: {len(done)} completions, rate by half "
            f"{halves[0] / (mid - start):.2f} / {halves[1] / (end - mid):.2f}"
            f" a second, interval median {quantile(gaps, 0.5):.2f} ms, "
            f"p90 {quantile(gaps, 0.9):.2f} ms, max {max(gaps):.2f} ms")


def quantile(values: List[float], q: float) -> float:
    """The q-quantile with linear interpolation between order statistics."""
    v = sorted(values)
    if not v:
        raise ValueError("no values")
    x = q * (len(v) - 1)
    i = int(x)
    return v[i] if i + 1 >= len(v) else v[i] + (x - i) * (v[i + 1] - v[i])
