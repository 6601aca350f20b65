"""Run one cell of the benchmark once and print its result.

    python3 benchmarks/run.py --workload coco-cap-train --seed 7 \\
        --seconds 30 --trace 0

Untraced (``--trace 0``) the result's metrics are the cell's end-to-end
metrics; traced (``--trace 1``), its per-layer metrics, read from a
profiled sub-window and the benchmark's spans.  The last line of standard
output is one JSON object (``correct``, ``attempted``, ``failed``,
``metrics``, ``device``, with ``--trace 1`` ``breakdown``, and ``checks``
last: each number compared beside its limit); the same checks are the
last lines of standard error.  It exits non-zero, printing no result,
without enough CUDA devices, or if a JAX module is loaded once the window
has closed.  A cell on more than one chip runs one rank a chip
(``launch.py``): this process is rank 0 and prints the result; a rank that
fails or hangs ends the run non-zero, with no result.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

_HERE = os.path.dirname(os.path.abspath(__file__))
_ROOT = os.path.dirname(_HERE)
if _ROOT not in sys.path:
    sys.path.insert(0, _ROOT)

from benchmarks import harness, launch  # noqa: E402


def _cache_env() -> None:
    """Build and kernel caches at fixed paths inside the checkout, so a
    second run finds every kernel built (the port's own CUDA build lives
    in ``vlp_tpu_torch/_build``)."""
    cache = os.path.join(_ROOT, ".cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(cache, "torch_ext")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(cache, "triton")


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    man = harness.manifest()
    wl = harness.workload(man, args.workload)
    cfg = harness.config(man, wl["config"])
    traffic = harness.traffic(wl["traffic"])
    _cache_env()
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < wl["chips"]:
        print(f"{args.workload} needs {wl['chips']} CUDA device(s); "
              f"torch.cuda.is_available()={torch.cuda.is_available()}, "
              f"device_count={torch.cuda.device_count()}", file=sys.stderr)
        return 2
    return execute(man, wl, cfg, traffic, args.seed, args.seconds,
                   bool(args.trace))


def execute(man: dict, wl: dict, cfg: dict, traffic: dict, seed: int,
            seconds: float, traced: bool, device_type: str = "cuda",
            hook=None) -> int:
    """One run of the cell ``wl`` on its chips, its result printed;
    returns the exit code.  ``device_type`` "cpu" and ``hook`` are the
    tests': tiny runs on the CPU, ranks over gloo, a fault planted."""
    import torch
    with tempfile.TemporaryDirectory(prefix="vlp-bench-") as work:
        ctx = launch.run_cell(wl["name"], cfg, traffic, seed, seconds,
                              traced, work, device_type=device_type,
                              world=wl["chips"], hook=hook)
    rec = ctx.record
    rec["spans"] = ctx.spans
    rec["window"] = ctx.window
    if ctx.profiler is not None:
        if ctx.profiler.events is None:
            print("the profiled sub-window never closed: the window held "
                  "too few steps", file=sys.stderr)
            return 4
        rec["trace"] = ctx.profiler.events
        rec["trace_span"] = ctx.profiler.span_t
        rec["trace_summary"] = harness.device_summary(ctx.profiler.events)
    loaded = harness.forbidden_modules()
    if loaded:
        print(f"forbidden modules loaded: {', '.join(loaded)}",
              file=sys.stderr)
        return 3

    metrics = {}
    for m in harness.metrics_of(man, wl["name"], traced):
        value = harness.metric_reader(m["name"])(rec)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    checks = rec["checks"]
    correct = (bool(checks) and rec["failed"] == 0
               and all(c["value"] <= c["limit"] for c in checks))
    platform, kind = (("gpu", torch.cuda.get_device_name(0))
                      if device_type == "cuda" else ("cpu", "cpu"))
    device = {"platform": platform, "kind": kind, "count": wl["chips"],
              "memory_peak_bytes": rec["memory_peak_bytes"]}
    out = {"correct": correct, "attempted": rec["attempted"],
           "failed": rec["failed"], "metrics": metrics, "device": device}
    if traced:
        summary = rec["trace_summary"]
        # averaged over the chips used
        busy = rec.get("busy_by_rank") or [(summary["busy_s"],
                                            summary["window_s"])]
        device["busy_s"] = sum(b for b, _ in busy) / len(busy)
        device["window_s"] = sum(w for _, w in busy) / len(busy)
        out["breakdown"] = summary["breakdown"]
    out["checks"] = {c["name"]: {"value": c["value"], "limit": c["limit"]}
                     for c in checks}
    print(harness.setup_summary(ctx.marks), file=sys.stderr)
    print(harness.window_summary(rec), file=sys.stderr)
    for c in checks:
        print(f"check {c['name']}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr)
    sys.stdout.flush()
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
