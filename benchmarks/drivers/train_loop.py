"""Fine-tuning through the device loop (``--device_loop_steps K``), as the
train CLI runs it at world size 1: the loader writes K batches' features
into a pinned staging slab, one copy takes the group to the card, the K
optimizer steps run as one CUDA-graph replay (``make_dp_multi_step``), and
a group's losses are read on the host after the next group is launched.
A group completes when its losses are in hand."""

from __future__ import annotations

import math
import time

from benchmarks import harness, training, work
from benchmarks.reference import data as ref_data


def run(ctx) -> None:
    from vlp_tpu_torch.host_copy import fetch, fetched
    dev = ctx.device
    tr = ctx.traffic
    K = tr["loop_steps"]
    prog = training.Program(ctx, dev, loop_k=K)
    B = tr["batch_size"]
    state = {"steps": 0}

    def launch():
        """Take the next K batches and launch their group; returns the
        batches' meta and the group's fetch."""
        pending = []
        while len(pending) < K:
            with ctx.span("loader"):
                _, b, batch = next(prog.batches)
            pending.append((b, batch))
        with ctx.span("step"):
            grp = pending[0][0] // K
            slot = grp % prog.staging.n_slots
            prog.staging.stack(slot, [batch for _, batch in pending])
            n = state["steps"]
            seeds = [training.step_seed(prog.seeds, n + i) for i in range(K)]
            staged = prog.staging.upload(slot)
            metrics = prog.step(staged, seeds, 0.0)
            handle = fetch(metrics)
        state["steps"] += K
        return [training.batch_meta(b) for _, b in pending], handle

    def drain(handle):
        return [float(x) for x in fetched(handle)["loss"]]

    # set-up: the first group (the capture and its first replay), read
    # before anything else runs, then the warm-up groups
    _, first = launch()
    losses = drain(first)
    readings = {"losses": losses, "moment": prog.moment_norms(),
                "change": prog.change_norms()}
    for _ in range(tr["setup_groups"]):
        drain(launch()[1])
    harness.sync(dev)
    ctx.spans.clear()

    done, metas, failed = [], [], 0
    t0 = ctx.open_window()
    t_prev = t0
    in_flight = None
    i = 0
    while True:
        ctx.step_begin(i)
        profiled = ctx.profiler is not None and ctx.profiler.active
        meta, handle = launch()
        if profiled:
            metas.extend(meta)
        if in_flight is not None:
            with ctx.span("collect"):
                got = drain(in_flight[1])
            t_done = time.monotonic()
            if t_done <= ctx.window_end:
                done.append((t_done, K * B, K))
                failed += sum(not math.isfinite(x) for x in got)
            t_prev = t_done
        ctx.step_end(i)
        in_flight = (meta, handle)
        if ctx.window_over(t_prev):
            break
        i += 1
    drain(in_flight[1])
    harness.sync(dev)
    peak = harness.memory_peak(dev)
    inp, seeds, t_total = prog.inputs, prog.seeds, prog.t_total
    prog.close()
    del prog
    harness.release(dev)

    ref = training.reference_readings(ctx, dev, seeds, inp, t_total, K,
                                      moment_after=K)
    checks = training.compare(readings, ref, tr["limits"], "moment_gap")
    if ctx.controls:
        ctx.record["control"] = training.controls(
            ctx, dev, seeds, inp, t_total, K, K, ref, "moment_gap")
    ctx.record.update(
        attempted=sum(d[2] for d in done), failed=failed, done=done,
        window_start=t0, memory_peak_bytes=peak, checks=checks,
        profiled_steps=len(metas), profiled_samples=B * len(metas),
        attn_bound_ms=training.attention_bound_ms(ctx.cfg, metas),
        flop_per_sample=work.train_flop_per_sample(
            ctx.cfg, tr["task"], ref_data.seq_len(ctx.cfg)))
