"""run.py's refusals: no result without a card."""

import os
import subprocess
import sys

import pytest

from benchmarks import harness


def test_exits_nonzero_without_a_card():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = subprocess.run(
        [sys.executable, "benchmarks/run.py", "--workload", "coco-cap-train",
         "--seed", "3000000000", "--seconds", "1", "--trace", "0"],
        capture_output=True, text=True, cwd=harness.ROOT, timeout=300)
    assert out.returncode != 0
    assert out.stdout.strip() == ""
    assert "CUDA" in out.stderr


def test_unknown_workload_is_refused():
    out = subprocess.run(
        [sys.executable, "benchmarks/run.py", "--workload", "no-such-cell",
         "--seed", "1", "--seconds", "1"],
        capture_output=True, text=True, cwd=harness.ROOT, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""


@pytest.mark.cuda
def test_a_short_run_on_the_card(card):
    out = subprocess.run(
        [sys.executable, "benchmarks/run.py", "--workload", "coco-cap-beam5",
         "--seed", "4000000001", "--seconds", "3", "--trace", "0"],
        capture_output=True, text=True, cwd=harness.ROOT, timeout=900,
        env=dict(os.environ))
    assert out.returncode == 0, out.stderr[-2000:]
    import json
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] is True
    assert res["device"]["platform"] == "gpu"
