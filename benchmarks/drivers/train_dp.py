"""Data-parallel fine-tuning, one process a chip, as the train CLI runs it
over a group: each rank its own ``TrainLoader`` over its share of the
examples, its batch copied to its card, ``make_dp_train_step``'s step
(forward, backward, the gradients' mean all-reduced over the group,
BertAdam) and the ranks' mean loss read on the host, which ends the step.
Closed loop on every rank; after each step rank 0 says whether the ranks
take another (``ctx.agree``), so that all of them stop together.  The
traffic's ``batch_size`` is a rank's: the train CLI's
``--train_batch_size`` over the world size.

``correct``: rank 0 alone, once the window has closed and the group is
torn down, compares its readings of the first three steps (the mean loss,
the all-reduced gradient the optimizer took, the change after three)
with the plain reference fed the union of the ranks' batches."""

from __future__ import annotations

import math
import sys
import time

from benchmarks import harness, training, work
from benchmarks.reference import data as ref_data

CHECK_STEPS = 3     # the reference follows the first three steps


def run(ctx) -> None:
    from vlp_tpu_torch.cli.decode import to_device
    dev = ctx.device
    tr = ctx.traffic
    main = ctx.rank == 0
    prog = training.Program(ctx, dev, dist=ctx.dist)
    B = tr["batch_size"]
    n = 0                                   # optimizer steps taken

    def one_step(batch):
        nonlocal n
        tbatch = to_device(batch, dev)
        metrics = prog.step(tbatch, training.step_seed(prog.seeds, n), 0.0)
        n += 1
        return float(metrics["loss"])

    # set-up: the first steps through the window's own call and feed
    readings = {"losses": []}
    for k in range(tr["setup_steps"]):
        _, _, batch = next(prog.batches)
        readings["losses"].append(one_step(batch))
        if main and k == 0:
            readings["moment"] = prog.moment_norms()
        if main and k + 1 == CHECK_STEPS:
            readings["change"] = prog.change_norms()
        ctx.beat()
    readings["losses"] = readings["losses"][:CHECK_STEPS]
    harness.sync(dev)
    ctx.spans.clear()

    done, metas, failed = [], [], 0
    t0 = ctx.open_window()
    i = 0
    while True:
        ctx.step_begin(i)
        with ctx.span("loader"):
            _, _, batch = next(prog.batches)
        if ctx.profiler is not None and ctx.profiler.active:
            metas.append(training.batch_meta(batch))
        with ctx.span("step"):
            loss = one_step(batch)
        t_done = time.monotonic()
        ctx.step_end(i)
        if t_done <= ctx.window_end:
            done.append((t_done, B, 1))
            failed += not math.isfinite(loss)
        with ctx.span("agree"):
            go = ctx.agree(not ctx.window_over(t_done))
        if not go:
            break
        i += 1
    harness.sync(dev)
    peak = harness.memory_peak(dev)
    inp, seeds, t_total = prog.inputs, prog.seeds, prog.t_total
    prog.close()
    del prog
    ctx.leave_group()
    harness.release(dev)
    ctx.record.update(attempted=len(done), failed=failed, done=done,
                      window_start=t0, memory_peak_bytes=peak)
    if not main:
        return

    if ctx.profiler is not None and ctx.profiler.events is not None:
        print("nccl ms a step: " + nccl_by_name(ctx.profiler.events,
                                                len(metas)), file=sys.stderr)
    ref = training.reference_readings(ctx, dev, seeds, inp, t_total,
                                      CHECK_STEPS, moment_after=1,
                                      world=ctx.world)
    checks = training.compare(readings, ref, tr["limits"], "grad_gap")
    if ctx.controls:
        ctx.record["control"] = training.controls(
            ctx, dev, seeds, inp, t_total, CHECK_STEPS, 1, ref, "grad_gap",
            world=ctx.world)
    ctx.record.update(
        checks=checks, profiled_steps=len(metas),
        profiled_samples=B * len(metas),
        attn_bound_ms=training.attention_bound_ms(ctx.cfg, metas),
        flop_per_sample=work.train_flop_per_sample(
            ctx.cfg, tr["task"], ref_data.seq_len(ctx.cfg)))


def nccl_by_name(ev: dict, steps: int) -> str:
    """The profiled NCCL kernels' device ms a step, by name (for the
    reader of standard error: which collective the time is in)."""
    lo, hi = ev["window"]
    by: dict = {}
    for name, s, d, cat in ev["device"]:
        if cat == "kernel" and lo <= s < hi and "nccl" in name.lower():
            key = name.split("(")[0]
            by[key] = by.get(key, 0.0) + d / 1e3 / max(steps, 1)
    return ", ".join(f"{k} {v:.3f}" for k, v in sorted(
        by.items(), key=lambda kv: -kv[1]))
