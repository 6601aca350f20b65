"""Eager fine-tuning, one dispatch a step, as the train CLI runs it at
world size 1: ``TrainLoader`` over the packed fp16 store, the batch copied
to the card, ``make_dp_train_step``'s step (forward, backward, BertAdam),
and the loss read on the host, which ends the step.  Closed loop: the next
step starts when the last one's loss is in hand."""

from __future__ import annotations

import math
import time

from benchmarks import harness, training, work
from benchmarks.reference import data as ref_data

CHECK_STEPS = 3     # the reference follows the first three steps


def run(ctx) -> None:
    from vlp_tpu_torch.cli.decode import to_device
    dev = ctx.device
    tr = ctx.traffic
    prog = training.Program(ctx, dev)
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
        if k == 0:
            readings["moment"] = prog.moment_norms()
        if k + 1 == CHECK_STEPS:
            readings["change"] = prog.change_norms()
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
        if ctx.window_over(t_done):
            break
        i += 1
    harness.sync(dev)
    peak = harness.memory_peak(dev)
    inp, seeds, t_total = prog.inputs, prog.seeds, prog.t_total
    prog.close()
    del prog
    harness.release(dev)

    ref = training.reference_readings(ctx, dev, seeds, inp, t_total,
                                      CHECK_STEPS, moment_after=1)
    checks = training.compare(readings, ref, tr["limits"], "grad_gap")
    if ctx.controls:
        ctx.record["control"] = training.controls(
            ctx, dev, seeds, inp, t_total, CHECK_STEPS, 1, ref, "grad_gap")
    ctx.record.update(
        attempted=len(done), failed=failed, done=done, window_start=t0,
        memory_peak_bytes=peak, checks=checks, profiled_steps=len(metas),
        profiled_samples=B * len(metas),
        attn_bound_ms=training.attention_bound_ms(ctx.cfg, metas),
        flop_per_sample=work.train_flop_per_sample(
            ctx.cfg, tr["task"], ref_data.seq_len(ctx.cfg)))
