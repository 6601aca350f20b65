"""The launcher and the data-parallel driver on the CPU: their ranks over
gloo at a tiny size (``dp_cell.py``, one process a run, so that a fault
planted in every rank stays in that run): a sound run is correct and
counts every rank's work; a rank killed in the window ends the run
non-zero, with no result, well inside ``launch.JOIN_S``; each fault a
data-parallel cell can have (a step that leaves the state unchanged,
half of each batch, the exchange between the ranks left out, one rank's
gradient left out of it) and the control come out not correct; the
watchdog's rules; the readers that sum or average over the ranks."""

import json
import os
import queue
import signal
import subprocess
import sys
import time

import pytest

from benchmarks import harness, launch

CELL = os.path.join(os.path.dirname(__file__), "dp_cell.py")


def _cell(*args, timeout=600):
    out = subprocess.run([sys.executable, CELL, *args], capture_output=True,
                         text=True, cwd=harness.ROOT, timeout=timeout)
    assert out.returncode == 0, out.stderr[-4000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def _failing(res):
    return [n for n, c in res["checks"].items() if c["value"] > c["limit"]]


def test_two_ranks_are_correct_and_counted():
    res = _cell("--ranks", "2", "--seconds", "5")
    assert res["correct"] is True and _failing(res) == []
    assert res["device"]["count"] == 2
    # every step is taken by both ranks, and counted for both
    assert res["attempted"] > 0 and res["attempted"] % 2 == 0
    assert res["failed"] == 0
    assert set(res["metrics"]) == {"peak_mem_gib", "setup_s"}


@pytest.mark.parametrize("fault, fails", [
    ("state_unchanged", "change_gap"),
    ("half_batch", "grad_gap"),
    ("no_exchange", "grad_gap"),
    ("rank_left_out", "grad_gap"),
])
def test_a_fault_underneath_fails(fault, fails):
    res = _cell("--fault", fault, "--seconds", "3")
    assert res["correct"] is False and fails in _failing(res)


def test_control_and_faults_in_the_references_place_fail():
    """The control (the reference in fp8 in the program's place) and the
    faults read by the reference put in its place each fail a number."""
    res = _cell("--controls", "--seconds", "3")
    limits = {c["name"]: c["limit"] for c in res["checks"]}
    assert all(c["value"] <= c["limit"] for c in res["checks"])
    assert set(res["control"]) == {"fp8", "half_batch", "no_exchange",
                                   "rank_left_out"}
    for kind, got in res["control"].items():
        assert any(got[n] > limits[n] for n in got), kind


def test_a_killed_rank_ends_the_run(tmp_path):
    err_path = tmp_path / "err"
    with open(err_path, "w") as err:
        proc = subprocess.Popen(
            [sys.executable, CELL, "--ranks", "2", "--seconds", "300"],
            stdout=subprocess.PIPE, stderr=err, text=True, cwd=harness.ROOT)
    try:
        deadline = time.monotonic() + 300
        while "window: open" not in err_path.read_text():
            assert proc.poll() is None, err_path.read_text()[-3000:]
            assert time.monotonic() < deadline
            time.sleep(0.2)
        pid = int(next(line.split("pid ")[1] for line in
                       err_path.read_text().splitlines()
                       if line.startswith("rank 1: pid ")))
        time.sleep(1.0)
        os.kill(pid, signal.SIGKILL)
        killed = time.monotonic()
        out, _ = proc.communicate(timeout=launch.JOIN_S + 30)
        took = time.monotonic() - killed
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert proc.returncode != 0
    assert out.strip() == ""
    assert took < launch.JOIN_S


class _Proc:
    def __init__(self, exitcode=None):
        self.exitcode = exitcode


class _Shared:
    def __init__(self, world, t0, beats):
        self.results = queue.Queue()
        self.t0 = type("V", (), {"value": t0})()
        self.beats = beats


def _watch(world, t0=0.0, beats=None, procs=None, t_spawn=995.0):
    """A launcher's watchdog state, read at ``now`` = 1000 in the tests:
    by default spawned 5 s before, in set-up, no rank's beat yet."""
    w = launch.Launcher.__new__(launch.Launcher)
    w.world, w.results, w.t_spawn = world, {}, t_spawn
    w.team = _Shared(world, t0, beats or [0.0] * world)
    w.procs = procs or {r: _Proc() for r in range(1, world)}
    return w


def test_watchdog_rules():
    now = 1000.0
    ok = {"attempted": 1, "failed": 0, "done": [], "memory_peak_bytes": 0,
          "forbidden": []}
    # set-up: every rank alive and beating, or just spawned
    assert _watch(2).fault(now) is None
    beats = [now - 5, now - launch.JOIN_S + 5]
    assert _watch(2, t_spawn=now - 900, beats=beats).fault(now) is None
    # set-up: a rank with no beat since the spawn, or none for too long
    late = _watch(2, t_spawn=now - launch.JOIN_S - 1, beats=[now - 1, 0.0])
    assert "rank 1 has made no progress in set-up" in late.fault(now)
    beats = [now - launch.JOIN_S - 1, now - 1]
    stuck = _watch(2, t_spawn=now - 900, beats=beats).fault(now)
    assert "rank 0 has made no progress in set-up" in stuck
    # a rank that ended without its result, or reported an error
    w = _watch(2, procs={1: _Proc(-9)})
    assert "exit code -9" in w.fault(now)
    w = _watch(2, procs={1: _Proc(0)})
    w.team.results.put((1, ok))
    assert w.fault(now) is None
    w = _watch(2)
    w.team.results.put((1, {"error": "Traceback: boom"}))
    assert "boom" in w.fault(now)
    w = _watch(2)
    w.team.results.put((1, dict(ok, forbidden=["jax"])))
    assert "jax" in w.fault(now)
    # in the window: a rank whose last step is too long ago; 0 is out
    beats = [now - 1, now - launch.JOIN_S - 1, 0.0]
    assert "rank 1" in _watch(3, t0=now - 200, beats=beats).fault(now)
    beats = [now - 1, now - 2, 0.0]
    assert _watch(3, t0=now - 200, beats=beats).fault(now) is None


def test_readers_over_ranks():
    """``mfu.train`` and ``device_idle_share.train`` read a one-chip
    record as before and a record of several ranks over all of them."""
    mfu = harness.metric_reader("mfu.train")
    idle = harness.metric_reader("device_idle_share.train")
    done = [(0.5 * i, 64, 1) for i in range(1, 21)]
    one = {"window": (0.0, 10.0), "done": done, "flop_per_sample": 1e12,
           "trace_summary": {"busy_s": 0.6, "window_s": 2.0}}
    assert mfu(one) == pytest.approx(100.0 * 1e12 * 128 / 989e12)
    assert idle(one) == pytest.approx(70.0)
    two = dict(one, done_by_rank=[done, done],
               busy_by_rank=[(0.6, 2.0), (1.0, 2.0)])
    assert mfu(two) == pytest.approx(mfu(one))
    assert idle(two) == pytest.approx(60.0)


def test_set_up_marks_beat(tmp_path):
    """A rank's context beats for the watchdog when it is made and at each
    set-up mark, and no more once the window has opened."""
    import multiprocessing

    team = launch.Team(2, multiprocessing.get_context("spawn"))
    ctx = harness.Context("coco-cap-train", {}, {}, 1, 1.0, False,
                          str(tmp_path), "cpu", rank=1, world=2, team=team)
    first = team.beats[1]
    assert first > 0.0 and team.beats[0] == 0.0
    time.sleep(0.01)
    ctx.mark("inputs")
    assert team.beats[1] > first
    team.t0.value, team.beats[1] = time.monotonic(), 0.0
    ctx.mark("late")
    assert team.beats[1] == 0.0
