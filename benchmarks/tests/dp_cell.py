"""The data-parallel driver at a tiny size on the CPU, its ranks over
gloo, through ``run.py``'s ``execute`` with no look for a card:
``coco-cap-train``'s cell and traffic, run by ``drivers/train_dp.py`` on
``--ranks`` ranks, each with its own loader over its share of the
examples:

    python benchmarks/tests/dp_cell.py --fault none --ranks 2 --seconds 6

prints the run's result line (``--controls``: the checks and the
control's and faults' readings instead); ``--fault`` names the hook of
``dp_faults.py`` that every rank runs before the driver."""

import argparse
import json
import os
import sys
import tempfile

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
sys.path[:0] = [ROOT, HERE]

import dp_faults  # noqa: E402
from conftest import TINY, TINY_TRAFFIC  # noqa: E402

from benchmarks import harness, launch, run  # noqa: E402

CELL = "coco-cap-train"


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--fault", default="none")
    p.add_argument("--ranks", type=int, default=2)
    p.add_argument("--seed", type=int, default=3000000017)
    p.add_argument("--seconds", type=float, default=6.0)
    p.add_argument("--controls", action="store_true")
    args = p.parse_args(argv)
    man = harness.manifest()
    wl = dict(harness.workload(man, CELL), chips=args.ranks)
    tr = dict(harness.traffic(wl["traffic"]), driver="train_dp",
              **TINY_TRAFFIC)
    hook = getattr(dp_faults, args.fault)
    if not args.controls:
        return run.execute(man, wl, dict(TINY), tr, args.seed, args.seconds,
                           False, device_type="cpu", hook=hook)
    with tempfile.TemporaryDirectory() as work:
        ctx = launch.run_cell(CELL, dict(TINY), tr, args.seed, args.seconds,
                              False, work, device_type="cpu",
                              world=args.ranks, controls=True, hook=hook)
    rec = ctx.record
    print(json.dumps({"checks": rec["checks"], "control": rec["control"]}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
