"""One run of a cell on its chips.

One chip: the cell's driver runs in this process on ``cuda:0``, with no
process and no group besides.  More than one: rank 0 stays in this
process on ``cuda:0`` and owns the window, the profiled sub-window and the
record; ranks 1..N-1 are spawned (``torch.multiprocessing``'s spawn
context), one a chip on ``cuda:1..N-1``.  The ranks form one process
group (NCCL on the card; gloo on the CPU, in the tests), rendezvousing
through a ``FileStore`` in the run's work directory, and each runs the
driver with a ``harness.Context`` that carries its rank, the world, the
ranks' :class:`Team` and its ``Dist``.

The :class:`Team` is what the ranks share besides the group: a barrier at
which rank 0 opens the window and, after each step, says whether the
ranks take another; each rank's last beat; a queue for the spawned ranks'
results.  Rank 0 sums ``attempted`` and ``failed`` over the ranks, takes
the largest ``memory_peak_bytes``, and keeps each rank's completions
(``done_by_rank``) and, traced, each rank's device busy and window
seconds (``busy_by_rank``).

No run waits forever on a rank.  A watchdog thread in rank 0's process
ends the run (every spawned rank killed, exit code 5, no result) when a
spawned rank ends before it has handed in its result or reports an error,
when a rank has made no progress for ``JOIN_S`` seconds, or when the
results are not all in ``JOIN_S`` seconds after rank 0's part has ended.
Progress is a beat: in set-up, at each of its marks (the context's
creation once the group has formed, inputs, store, model) and after each
set-up step; in the window, at each step.  A first run's kernel build
falls inside the first set-up step: that phase took 41.5 s with the
build against 2.3-3.0 s without it, over four H100s, so ``JOIN_S``
leaves it about three times that.  A spawned rank whose parent has died
ends itself.
"""

from __future__ import annotations

import os
import queue
import sys
import threading
import time
import traceback
from datetime import timedelta
from typing import Callable, Dict, Optional

from benchmarks import harness

JOIN_S = 120.0     # a rank that makes no progress this long ends the run
SETUP_S = 1100.0   # the group's and the barrier's own timeout: a backstop
POLL_S = 0.5
ABORT_CODE = 5


def rank_device(device_type: str, rank: int):
    import torch
    return (torch.device("cuda", rank) if device_type == "cuda"
            else torch.device("cpu"))


def run_cell(name: str, cfg: dict, traffic: dict, seed: int,
             seconds: float, traced: bool, workdir: str, *,
             device_type: str = "cuda", world: int = 1,
             controls: bool = False,
             hook: Optional[Callable[[], None]] = None):
    """Run the cell's driver on ``world`` ranks and return rank 0's
    ``harness.Context``, its record merged over the ranks.  ``controls``:
    rank 0 also reads the control and the planted faults (calibration).
    ``hook``, a module-level function, runs in every rank before the
    driver (the tests plant faults with it)."""
    import torch
    if world == 1:
        dev = rank_device(device_type, 0)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        ctx = harness.Context(name, cfg, traffic, seed, seconds, traced,
                              workdir, dev)
        ctx.controls = controls
        if hook is not None:
            hook()
        harness.driver(traffic["driver"]).run(ctx)
        return ctx
    spec = dict(name=name, cfg=cfg, traffic=traffic, seed=seed,
                seconds=seconds, traced=traced, workdir=workdir,
                device_type=device_type, hook=hook)
    ranks = Launcher(world, spec)
    dist = None
    try:
        dev = rank_device(device_type, 0)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        dist = form_group(0, world, workdir, dev)
        ctx = harness.Context(name, cfg, traffic, seed, seconds, traced,
                              workdir, dev, rank=0, world=world,
                              team=ranks.team, dist=dist)
        ctx.controls = controls
        if hook is not None:
            hook()
        harness.driver(traffic["driver"]).run(ctx)
        ranks.finish(ctx)
    finally:
        ranks.stop()
        if dist is not None:
            dist.destroy()
    return ctx


def form_group(rank: int, world: int, workdir: str, device):
    """This rank's place in the run's process group: NCCL on the card,
    gloo on the CPU, met through a ``FileStore`` in ``workdir``."""
    import torch.distributed as tdist

    from vlp_tpu_torch.parallel import Dist
    backend = "nccl" if device.type == "cuda" else "gloo"
    store = tdist.FileStore(os.path.join(workdir, "rendezvous"), world)
    tdist.init_process_group(backend, store=store, rank=rank,
                             world_size=world,
                             timeout=timedelta(seconds=SETUP_S))
    return Dist(rank=rank, world=world, device=device, backend=backend)


class Team:
    """What the ranks of one run share: made by rank 0, handed to each
    spawned rank."""

    def __init__(self, world: int, mp):
        self.world = world
        self.barrier = mp.Barrier(world)
        self.go = mp.RawValue("b", 1)
        self.t0 = mp.RawValue("d", 0.0)        # the window's start
        # each rank's last beat; 0 before its first and after the window
        self.beats = mp.RawArray("d", world)
        self.results = mp.Queue()

    def beat(self, rank: int) -> None:
        """A set-up phase of ``rank`` has ended (the window's beats are
        ``agree``'s)."""
        if self.t0.value == 0.0:
            self.beats[rank] = time.monotonic()

    def open_window(self, rank: int) -> float:
        """Wait for every rank to be ready; the window starts at rank 0's
        clock then (``time.monotonic`` is the machine's, not the
        process's)."""
        self.barrier.wait(SETUP_S)
        if rank == 0:
            now = time.monotonic()
            self.t0.value = now
            for r in range(self.world):
                self.beats[r] = now
            print(f"window: open on {self.world} ranks", file=sys.stderr,
                  flush=True)
        self.barrier.wait(JOIN_S)
        return self.t0.value

    def agree(self, rank: int, go: bool) -> bool:
        """After a step: rank 0's ``go`` on every rank.  Rank 0 writes it
        again only after the next step, whose exchange every rank has to
        join after reading it."""
        if rank == 0:
            self.go.value = int(go)
        self.beats[rank] = time.monotonic()
        self.barrier.wait(JOIN_S)
        go = bool(self.go.value)
        if not go:
            self.beats[rank] = 0.0
        return go


class Launcher:
    """Rank 0's side: spawns ranks 1..N-1, watches them, collects and
    merges their results, and stops them."""

    def __init__(self, world: int, spec: dict):
        import torch.multiprocessing as tmp
        mp = tmp.get_context("spawn")
        self.world = world
        self.team = Team(world, mp)
        self.procs = {}
        for r in range(1, world):
            p = mp.Process(target=rank_main, args=(r, self.team, spec),
                           name=f"rank{r}", daemon=True)
            p.start()
            print(f"rank {r}: pid {p.pid}", file=sys.stderr, flush=True)
            self.procs[r] = p
        self.t_spawn = time.monotonic()
        self.results: Dict[int, dict] = {}
        self._lock = threading.Lock()
        self._halt = threading.Event()
        self._watch = threading.Thread(target=self._watchdog, daemon=True,
                                       name="rank-watchdog")
        self._watch.start()

    def _watchdog(self) -> None:
        while not self._halt.wait(POLL_S):
            self._check()

    def _check(self) -> None:
        with self._lock:
            fault = self.fault(time.monotonic())
        if fault is not None:
            self.abort(fault)

    def fault(self, now: float) -> Optional[str]:
        """Why the run cannot go on, or None."""
        # exits first: a rank's result is in the queue before it exits
        ended = {r: p.exitcode for r, p in self.procs.items()
                 if p.exitcode is not None}
        while True:
            try:
                r, res = self.team.results.get_nowait()
            except queue.Empty:
                break
            self.results[r] = res
        for r, res in sorted(self.results.items()):
            if "error" in res:
                return f"rank {r} failed:\n{res['error']}"
            if res["forbidden"]:
                return (f"rank {r} holds forbidden modules: "
                        f"{', '.join(res['forbidden'])}")
        for r, code in sorted(ended.items()):
            if r not in self.results:
                return (f"rank {r} ended (exit code {code}) before handing "
                        "in its result")
        in_setup = self.team.t0.value == 0.0
        for r in range(self.world):
            beat = self.team.beats[r]
            if in_setup:
                beat = max(beat, self.t_spawn)
                if now - beat > JOIN_S:
                    return (f"rank {r} has made no progress in set-up for "
                            f"{now - beat:.0f} s")
            elif beat > 0.0 and now - beat > JOIN_S:
                return (f"rank {r} has not reached its next step for "
                        f"{now - beat:.0f} s")
        return None

    def abort(self, why: str) -> None:
        """End the run: kill every spawned rank, then this process."""
        print(f"ranks: {why}", file=sys.stderr, flush=True)
        for p in self.procs.values():
            if p.is_alive():
                p.kill()
        for p in self.procs.values():
            p.join(10)
        sys.stderr.flush()
        os._exit(ABORT_CODE)

    def finish(self, ctx) -> None:
        """Wait for the spawned ranks' results (``JOIN_S`` at most) and
        merge them into rank 0's record."""
        deadline = time.monotonic() + JOIN_S
        while True:
            self._check()
            with self._lock:
                if len(self.results) == self.world - 1:
                    break
            if time.monotonic() > deadline:
                self.abort(f"the ranks' results were not all in {JOIN_S:.0f}"
                           " s after rank 0's part ended")
            time.sleep(POLL_S)
        self._halt.set()
        self._watch.join()
        for r, p in self.procs.items():
            p.join(JOIN_S)
            if p.is_alive():
                self.abort(f"rank {r} did not end after handing in its "
                           "result")
        merge(ctx.record, [rank_result(ctx)]
              + [self.results[r] for r in range(1, self.world)])

    def stop(self) -> None:
        """Stop every spawned rank still running (after a fault in rank
        0), and wait until each has ended."""
        self._halt.set()
        for p in self.procs.values():
            if p.is_alive():
                p.terminate()
        for p in self.procs.values():
            p.join(10)
            if p.is_alive():
                p.kill()
                p.join()


def rank_result(ctx) -> dict:
    """What one rank hands to rank 0 once its part has ended."""
    rec = ctx.record
    out = {k: rec[k] for k in ("attempted", "failed", "done",
                               "memory_peak_bytes")}
    prof = ctx.profiler
    if prof is not None and prof.events is not None:
        s = harness.device_summary(prof.events)
        out["busy"] = [s["busy_s"], s["window_s"]]
    out["forbidden"] = harness.forbidden_modules()
    return out


def merge(record: dict, results) -> None:
    """Rank 0's record over the ranks' ``results`` (rank 0's first)."""
    record["attempted"] = sum(r["attempted"] for r in results)
    record["failed"] = sum(r["failed"] for r in results)
    record["memory_peak_bytes"] = max(r["memory_peak_bytes"]
                                      for r in results)
    record["done_by_rank"] = [r["done"] for r in results]
    if all("busy" in r for r in results):
        record["busy_by_rank"] = [r["busy"] for r in results]


def _exit_with_parent() -> None:
    import multiprocessing
    parent = multiprocessing.parent_process()
    if parent is not None:
        parent.join()
        os._exit(3)


def rank_main(rank: int, team: Team, spec: dict) -> None:
    """A spawned rank: its group, its context, the driver, its result."""
    threading.Thread(target=_exit_with_parent, daemon=True).start()
    import torch
    try:
        dev = rank_device(spec["device_type"], rank)
        if dev.type == "cuda":
            torch.cuda.set_device(dev)
        dist = form_group(rank, team.world, spec["workdir"], dev)
        ctx = harness.Context(spec["name"], spec["cfg"], spec["traffic"],
                              spec["seed"], spec["seconds"], spec["traced"],
                              spec["workdir"], dev, rank=rank,
                              world=team.world, team=team, dist=dist)
        if spec["hook"] is not None:
            spec["hook"]()
        harness.driver(spec["traffic"]["driver"]).run(ctx)
        team.results.put((rank, rank_result(ctx)))
    except BaseException:
        team.results.put((rank, {"error": traceback.format_exc()}))
        raise
