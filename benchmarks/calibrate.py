"""Readings that set a cell's limits: the program's checked numbers over
many seeds (the lower readings), and on some of them the control's (the
plain reference in fp8 in the program's place) and the planted faults'
(the upper readings), all in one process.

    python3 benchmarks/calibrate.py --workload coco-cap-train \\
        --seeds 1,2,3 --control-seeds 1,2 --seconds 2 --out readings.jsonl

Each seed is a whole run of the cell (set-up, a short window, the
comparison) without the end-to-end metrics, on the cell's chips
(``launch.py``: over several, the ranks are spawned anew for each seed);
one JSON line per seed.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import tempfile

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if _ROOT not in sys.path:
    sys.path.insert(0, _ROOT)

from benchmarks import harness, launch  # noqa: E402


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--control-seeds", default="")
    p.add_argument("--seconds", type=float, default=2.0)
    p.add_argument("--out", default="")
    args = p.parse_args(argv)
    man = harness.manifest()
    wl = harness.workload(man, args.workload)
    cfg = harness.config(man, wl["config"])
    traffic = harness.traffic(wl["traffic"])
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < wl["chips"]:
        print(f"calibration needs {wl['chips']} CUDA device(s)",
              file=sys.stderr)
        return 2
    torch.cuda.set_device(0)
    controls = {int(s) for s in args.control_seeds.split(",") if s}
    for seed in (int(s) for s in args.seeds.split(",")):
        with tempfile.TemporaryDirectory(prefix="vlp-calib-") as work:
            torch.cuda.reset_peak_memory_stats()
            ctx = launch.run_cell(args.workload, cfg, traffic, seed,
                                  args.seconds, False, work,
                                  world=wl["chips"],
                                  controls=seed in controls)
        rec = ctx.record
        line = json.dumps({
            "workload": args.workload, "seed": seed,
            "checks": {c["name"]: c["value"] for c in rec["checks"]},
            "control": rec.get("control"), "setup_s": rec["setup_s"],
            "memory_peak_bytes": rec["memory_peak_bytes"]})
        print(line, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
        del ctx, rec
        harness.release(torch.device("cuda:0"))
    return 0


if __name__ == "__main__":
    sys.exit(main())
