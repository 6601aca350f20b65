"""The program's own spans (``vlp_tpu_torch.tracing``) in one run of a
cell: the per-layer numbers they give, and the profiled sub-window's idle
gaps named by the program span the host was in.

    python3 benchmarks/spans.py --workload coco-cap-train --seed 7 \\
        --seconds 30

runs the cell as ``run.py --trace 1`` does (the same driver, window and
profiled sub-window), with the program's spans recorded from the
window's start to the driver's end, and prints one JSON object as its
last line.  ``--profile 0`` leaves the sub-window out, as ``--trace 0``
does: the host numbers and the rate without the profiler's cost, and
no device numbers.  The line holds:

- ``rate``: the cell's items a second outside the profiled sub-window
  (``mfu.*``'s rate; the whole window's with ``--profile 0``);
- ``metrics``: the cell's span metrics (:data:`CELL_METRICS`), each a
  mean per step, group or batch over the window's iterations outside the
  sub-window, or a count; ``host_ms`` and ``calls``: every span's mean
  host ms a call and its calls per iteration; ``upload_gb_per_s``; ``bench_ms``: the mean
  ms of each of the benchmark's own spans outside the sub-window;
- ``runtime_ms``: host ms per profiled iteration inside the longest
  CUDA runtime calls (a blocking call shows there);
- ``device_ms_by_span``: device ms per profiled iteration of the
  kernels, copies and sets whose launch call lies in each program range
  (the innermost open on the launching thread, or, for a thread with no
  range open, such as autograd's, on the thread of the ``bench.``
  ranges);
- ``idle_gaps`` (the ten longest, named ``<bench range>/<program
  range>`` at their start) and ``idle_by_span`` (all idle seconds of the
  sub-window, split over the ranges open on the host while they
  lasted);
- ``per_layer``: the cell's per-layer metrics of ``BENCHMARK.json``,
  read from this run's record as ``run.py --trace 1`` reads them;
- ``correct`` and ``checks``, as ``run.py`` reports them.

The metrics' definitions are the functions below, each over the recorded
spans and the reduced trace, so that a metric file of the benchmark can
read them once its drivers record the spans (``PERF.md``, section 7).
"""

from __future__ import annotations

import argparse
import bisect
import contextlib
import gzip
import json
import os
import sys
import tempfile
import time
from typing import Dict, List, Optional, Sequence

_HERE = os.path.dirname(os.path.abspath(__file__))
_ROOT = os.path.dirname(_HERE)
if _ROOT not in sys.path:
    sys.path.insert(0, _ROOT)

from benchmarks import harness  # noqa: E402
from benchmarks import run as runner  # noqa: E402

# the span of each kind of cell that is one iteration (step, group, batch)
ITERATION = {"train": "optim.step", "train_loop": "loop.replay",
             "decode": "decode.dispatch"}


def _metric(name: str):
    """The module of ``metrics/<name>.py`` (for its helpers)."""
    return harness._load(os.path.join(harness.BENCH, "metrics", name + ".py"),
                         "benchmarks.metrics." + name.replace(".", "_"))


# the runtime calls that put work on the device, as launches_per_step.* has them
LAUNCH_CALLS = _metric("launches_per_step.train").LAUNCH_CALLS


# ---------------------------------------------------------------------
# host numbers, from the spans kept in memory
# ---------------------------------------------------------------------

def outside(spans, window, sub) -> list:
    """The spans that began in ``window`` and outside the profiled
    sub-window ``sub`` (both (start, end) on ``time.monotonic``)."""
    lo, hi = (int(x * 1e9) for x in window)
    slo, shi = (int(x * 1e9) for x in sub) if sub else (hi, hi)
    return [s for s in spans
            if lo <= s.start_ns < hi and not slo <= s.start_ns < shi]


def mean_ms(spans, name: str) -> Optional[float]:
    """Mean host ms of the spans ``name`` (None without one): a mean per
    step, group or batch for a span each iteration makes once, whatever
    iteration the window's end cuts."""
    got = [s.end_ns - s.start_ns for s in spans if s.name == name]
    return sum(got) / len(got) / 1e6 if got else None


def self_ms(spans, name: str) -> Optional[float]:
    """Mean host ms of the self time of the spans ``name``."""
    from vlp_tpu_torch.tracing import self_ns
    own = self_ns(spans)
    got = [own[s.id] for s in spans if s.name == name]
    return sum(got) / len(got) / 1e6 if got else None


def offcpu_share(spans, names: Sequence[str]) -> Optional[float]:
    """1 - the thread's CPU time over the wall time of the spans
    ``names``, in %: where the calling thread waited (the GIL, a sync)."""
    got = [s for s in spans if s.name in names]
    wall = sum(s.end_ns - s.start_ns for s in got)
    if not wall:
        return None
    return 100.0 * (1.0 - sum(s.cpu_ns for s in got) / wall)


def count(spans, name: str) -> int:
    return sum(s.name == name for s in spans)


# ---------------------------------------------------------------------
# device numbers, from the profiled sub-window's trace
# ---------------------------------------------------------------------

def reduce_program(path: str) -> dict:
    """A chrome trace as lists of tuples: ``ranges`` (name, start_us,
    dur_us, tid) of every ``user_annotation``, the benchmark's and the
    program's; ``runtime`` (name, start_us, dur_us, tid, correlation) of
    every CUDA runtime and driver call, and ``launches``, those that put
    work on the device; ``device`` (name, start_us, dur_us, category,
    correlation); and the ``window``, the ``bench.profiled`` range."""
    opener = gzip.open if path.endswith(".gz") else open
    with opener(path, "rt") as f:
        raw = json.load(f)
    evs = raw["traceEvents"] if isinstance(raw, dict) else raw
    out = {"ranges": [], "runtime": [], "launches": [], "device": [],
           "window": None}
    for e in evs:
        if e.get("ph") != "X":
            continue
        cat, name = e.get("cat", ""), e.get("name", "")
        ts, dur = float(e["ts"]), float(e.get("dur", 0.0))
        corr = (e.get("args") or {}).get("correlation")
        if cat == "user_annotation":
            if name == "bench.profiled":
                out["window"] = (ts, ts + dur)
            else:
                out["ranges"].append((name, ts, dur, e.get("tid")))
        elif cat in harness.RUNTIME_CATS:
            call = (name, ts, dur, e.get("tid"), corr)
            out["runtime"].append(call)
            if any(c in name.lower() for c in LAUNCH_CALLS):
                out["launches"].append(call)
        elif cat in harness.DEVICE_CATS:
            out["device"].append((name, ts, dur, cat, corr))
    return out


def _innermost(ranges, t: float, bench: bool) -> Optional[str]:
    """The innermost of ``ranges`` open at ``t``, among the benchmark's
    (``bench``) or the program's: the latest start, then the shortest."""
    best = None
    for name, s, d, _ in ranges:
        if name.startswith("bench.") == bench and s <= t < s + d and (
                best is None or (s, -d) > best[1]):
            best = (name, (s, -d))
    return best[0] if best else None


def _main_tid(ev: dict):
    """The thread of the benchmark's ranges (the one that profiles)."""
    tids = [tid for name, *_, tid in ev["ranges"]
            if name.startswith("bench.")]
    return max(set(tids), key=tids.count) if tids else None


def device_ms_by_span(ev: dict, same_thread_only=False) -> Dict[str, float]:
    """Device ms in the window of the work each program range launched:
    a launch call belongs to the innermost program range open on its own
    thread, else (unless ``same_thread_only``) to the innermost open on
    the benchmark's thread; "other" where none is."""
    lo, hi = ev["window"]
    main = _main_tid(ev)
    by_tid: Dict[object, list] = {}
    for r in ev["ranges"]:
        by_tid.setdefault(r[3], []).append(r)
    owner = {}
    for _, s, _, tid, corr in ev["launches"]:
        name = _innermost(by_tid.get(tid, ()), s, False)
        if name is None and not same_thread_only and tid != main:
            name = _innermost(by_tid.get(main, ()), s, False)
        owner[corr] = name or "other"
    out: Dict[str, float] = {}
    for _, s, d, _, corr in ev["device"]:
        if lo <= s < hi:
            k = owner.get(corr, "other")
            out[k] = out.get(k, 0.0) + d / 1e3
    return out


def runtime_ms(ev: dict, top: int = 8) -> Dict[str, float]:
    """Host ms in the window inside each CUDA runtime or driver call, the
    ``top`` longest in all: a call that blocks (a synchronisation, a
    pageable copy, a launch into a full queue) shows here."""
    lo, hi = ev["window"]
    out: Dict[str, float] = {}
    for name, s, d, *_ in ev["runtime"]:
        if lo <= s < hi:
            out[name] = out.get(name, 0.0) + d / 1e3
    return dict(sorted(out.items(), key=lambda kv: -kv[1])[:top])


def optimizer_device_ms(ev: dict) -> Optional[float]:
    """Device ms per profiled step of the work launched (same thread) in
    an ``optim.step`` range."""
    steps = sum(r[0] == "optim.step" for r in ev["ranges"])
    if not steps:
        return None
    return device_ms_by_span(ev, same_thread_only=True).get(
        "optim.step", 0.0) / steps


def idle(ev: dict) -> dict:
    """The window's idle gaps: the ten longest named ``<bench>/<program>``
    by the innermost ranges open on the benchmark's thread at their
    start, and every idle second split over the ranges open on that
    thread while it lasted."""
    lo, hi = ev["window"]
    busy = harness.busy_intervals(ev["device"], lo, hi)
    edges = [lo] + [x for iv in busy for x in iv] + [hi]
    gaps = [(s, e) for s, e in zip(edges[0::2], edges[1::2]) if e > s]
    main = _main_tid(ev)
    mine = [r for r in ev["ranges"] if r[3] == main]
    # the host's state between consecutive range bounds is constant
    bounds = sorted({lo, hi} | {x for _, s, d, _ in mine
                               for x in (s, s + d)})

    def label(t):
        bench = _innermost(mine, t, True)
        prog = _innermost(mine, t, False)
        head = bench[len("bench."):] if bench else "other"
        return head + ("/" + prog if prog else "")

    labels = [label((a + b) / 2) for a, b in zip(bounds, bounds[1:])]
    by_span: Dict[str, float] = {}
    for s, e in gaps:
        i = max(bisect.bisect_right(bounds, s) - 1, 0)
        while i < len(labels) and bounds[i] < e:
            a, b = max(bounds[i], s), min(bounds[i + 1], e)
            if b > a:
                by_span[labels[i]] = by_span.get(labels[i], 0.0) + \
                    (b - a) / 1e6
            i += 1
    longest = sorted(gaps, key=lambda g: g[1] - g[0], reverse=True)[:10]
    return {"idle_gaps": [[label(s), (e - s) / 1e6] for s, e in longest],
            "idle_by_span": dict(sorted(by_span.items(),
                                        key=lambda kv: -kv[1]))}


# ---------------------------------------------------------------------
# the metrics of each cell
# ---------------------------------------------------------------------

def cell_metrics(kind: str, spans, ev: Optional[dict],
                 window) -> Dict[str, Optional[float]]:
    """The span metrics of a cell whose driver is ``kind``: ``spans`` are
    those outside the sub-window (:func:`outside`), ``window`` the whole
    window's, ``ev`` the sub-window's trace (:func:`reduce_program`).
    Every span read here is made once a step, group or batch."""
    if kind == "train":
        out = {"upload_host_ms.train": mean_ms(spans, "io.upload"),
               "forward_host_ms.train": mean_ms(spans, "step.forward"),
               "backward_host_ms.train": mean_ms(spans, "step.backward"),
               "optimizer_host_ms.train": mean_ms(spans, "optim.step"),
               "optimizer_device_ms.train": (optimizer_device_ms(ev)
                                             if ev else None),
               "host_offcpu_share.train": offcpu_share(
                   spans, ("step.forward", "optim.step"))}
    elif kind == "train_loop":
        out = {"host_wait_ms.loop": mean_ms(spans, "io.wait"),
               "graph_captures.loop": (float(count(window, "loop.capture"))
                                       if count(window, "loop.replay")
                                       else None)}
    else:
        out = {"beam_host_ms.eval": self_ms(spans, "decode.dispatch"),
               "backtrace_host_ms.eval": mean_ms(spans, "decode.backtrace"),
               "host_wait_ms.eval": mean_ms(spans, "io.wait"),
               "host_offcpu_share.eval": offcpu_share(
                   spans, ("decode.dispatch",))}
    return out


CELL_METRICS = {k: sorted(cell_metrics(k, [], None, [])) for k in ITERATION}


# ---------------------------------------------------------------------
# one traced run with the program's spans
# ---------------------------------------------------------------------

class ProgramSubWindow(harness.SubWindow):
    """The benchmark's sub-window that also keeps the trace's program
    ranges, runtime calls and correlation ids (:func:`reduce_program`):
    ``SubWindow.end`` with that reduction added."""

    program: Optional[dict] = None

    def end(self, i: int) -> None:
        if not self.active or i != self.after + self.count - 1:
            return
        import torch
        torch.cuda.synchronize()
        self._outer.__exit__(None, None, None)
        self.prof.__exit__(None, None, None)
        self.active = False
        path = os.path.join(self.workdir, "trace.json")
        self.prof.export_chrome_trace(path)
        self.prof = None
        self.events = harness.reduce_trace(path)
        self.program = reduce_program(path)
        os.remove(path)
        self.span_t[1] = time.monotonic()


class SpanContext(harness.Context):
    """A traced run's context whose window records the program's spans,
    and whose benchmark spans keep their times."""

    def __init__(self, *a, **kw):
        super().__init__(*a, **kw)
        if self.profiler is not None:
            self.profiler = ProgramSubWindow(
                self.traffic.get("trace_after", 3),
                self.traffic.get("trace_steps", 10), self.workdir)
        self.recorder = contextlib.ExitStack()
        self.program_spans: List = []
        self.bench_times: Dict[str, List] = {}

    def open_window(self) -> float:
        from vlp_tpu_torch import tracing
        t0 = super().open_window()
        self.program_spans = self.recorder.enter_context(tracing.recording())
        return t0

    @contextlib.contextmanager
    def span(self, name: str):
        t0 = time.monotonic()
        with super().span(name):
            yield
        self.bench_times.setdefault(name, []).append((t0, time.monotonic()))


def summarize(kind: str, ctx: SpanContext) -> dict:
    """The numbers of a finished run of a cell whose driver is ``kind``
    (the module docstring lists them)."""
    rec, window = ctx.record, ctx.window
    sub = ctx.profiler.span_t if ctx.profiler else None
    spans = outside(ctx.program_spans, window, sub)
    whole = outside(ctx.program_spans, window, None)
    it = ITERATION[kind]
    names = sorted({s.name for s in spans})
    n_it = count(spans, it)
    host = {n: mean_ms(spans, n) for n in names}
    calls = {n: count(spans, n) / n_it for n in names} if n_it else {}
    up = [s for s in spans if s.name == "io.upload"]
    up_s = sum(s.end_ns - s.start_ns for s in up) / 1e9
    bench = {}
    for name, times in ctx.bench_times.items():
        kept = [b - a for a, b in times if window[0] <= a < window[1]
                and not (sub and sub[0] <= a < sub[1])]
        if kept:
            bench[name] = sum(kept) / len(kept) * 1e3
    ev = ctx.profiler.program if ctx.profiler else None
    out = {"rate": _metric("mfu.train").traced_rate(rec),
           "metrics": cell_metrics(kind, spans, ev, whole),
           "host_ms": host, "calls": calls,
           "upload_gb_per_s": (sum(s.n for s in up) / up_s / 1e9
                               if up_s else None),
           "bench_ms": bench, "iterations": n_it}
    if ev is not None:
        profiled = sum(r[0] == it for r in ev["ranges"])
        out["runtime_ms"] = {k: v / profiled
                             for k, v in runtime_ms(ev).items()
                             } if profiled else {}
        out["device_ms_by_span"] = {
            k: v / profiled for k, v in sorted(device_ms_by_span(ev).items(),
                                              key=lambda kv: -kv[1])
        } if profiled else {}
        out.update(idle(ev))
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--profile", type=int, choices=(0, 1), default=1,
                   help="0: no profiled sub-window (host numbers only)")
    args = p.parse_args(argv)

    man = harness.manifest()
    wl = harness.workload(man, args.workload)
    cfg = harness.config(man, wl["config"])
    traffic = harness.traffic(wl["traffic"])
    runner._cache_env()
    import torch
    if not torch.cuda.is_available():
        print("spans.py needs a CUDA device", file=sys.stderr)
        return 2
    drv = harness.driver(traffic["driver"])
    with tempfile.TemporaryDirectory(prefix="vlp-spans-") as work:
        torch.cuda.set_device(0)
        ctx = SpanContext(args.workload, cfg, traffic, args.seed,
                          args.seconds, bool(args.profile), work, "cuda:0")
        with ctx.recorder:
            drv.run(ctx)
    rec = ctx.record
    rec["spans"], rec["window"] = ctx.spans, ctx.window
    layer = {}
    if ctx.profiler is not None:
        if ctx.profiler.events is None:
            print("the profiled sub-window never closed", file=sys.stderr)
            return 4
        rec["trace"] = ctx.profiler.events
        rec["trace_span"] = ctx.profiler.span_t
        rec["trace_summary"] = harness.device_summary(ctx.profiler.events)
        layer = {m["name"]: harness.metric_reader(m["name"])(rec)
                 for m in harness.metrics_of(man, args.workload, True)}
    checks = rec["checks"]
    out = {"workload": args.workload, "seed": args.seed,
           "device": torch.cuda.get_device_name(0),
           "correct": (bool(checks) and rec["failed"] == 0
                       and all(c["value"] <= c["limit"] for c in checks)),
           **summarize(traffic["driver"], ctx), "per_layer": layer,
           "checks": {c["name"]: c["value"] for c in checks}}
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
