"""Kimi-VL-A3B's language model (one EP8 chip's share) fine-tuned on
captions through the device loop, as the train CLI runs a configuration
whose ``model_type`` is "kimi_vl": the loader writes K batches' features
into a pinned staging slab, one copy takes the group to the card, the K
optimizer steps (BertAdam, then the routers' bias update) run as one
CUDA-graph replay (``make_dp_multi_step``), and a group's losses are read
on the host after the next group is launched.  A group completes when its
losses are in hand.

Set-up reads what ``correct`` compares: the routing of step 1 (an eager
forward of its batch before any step), the losses of the first two groups
and, after them, BertAdam's first moment and the weights' change; the
plain reference (``reference/kimi_vl.py``) is fed the same batches once
the window has closed, in blocks of sequences.  The held experts' row
counters are read once after the window (one sync), and in a traced run
also at both ends of the profiled groups."""

from __future__ import annotations

import math
import os
import statistics
import time

import numpy as np
import torch

from benchmarks import harness
from benchmarks import inputs as inputs_lib
from benchmarks import training, work_kimi
from benchmarks.reference import data as ref_data
from benchmarks.reference import kimi_vl as ref
from benchmarks.reference import optim as ref_optim


class Program(training.Program):
    """``training.Program``'s objects with the Kimi-VL model in VLPModel's
    place: the same inputs, store, loader, staging, BertAdam and device
    loop; weights from ``reference.kimi_vl.make_weights``."""

    def __init__(self, ctx, device, loop_k: int):
        from vlp_tpu_torch import configure_precision
        from vlp_tpu_torch import optim as optim_lib
        from vlp_tpu_torch import train_step as ts
        from vlp_tpu_torch.data.dataset import CaptionExample
        from vlp_tpu_torch.data.example_builder import TrainExampleBuilder
        from vlp_tpu_torch.data.loader import TrainLoader
        from vlp_tpu_torch.models.kimi_vl import KimiVLConfig, KimiVLModel
        from vlp_tpu_torch.parallel import Dist
        from vlp_tpu_torch.parallel.dp_step import make_dp_multi_step
        cfg, tr = ctx.cfg, ctx.traffic
        configure_precision()
        self.seeds = training.run_seeds(ctx.seed)
        self.inputs = inp = inputs_lib.make_inputs(
            cfg, tr, self.seeds["inputs"], device)
        ctx.mark("inputs")
        self.store = training.write_store(
            inp, cfg, os.path.join(ctx.workdir, "features.vlps"))
        ctx.mark("store")
        examples = [CaptionExample(inputs_lib.image_key(int(img)), toks,
                                   image_id=int(img))
                    for img, toks in zip(inp.example_image,
                                         inp.example_tokens)]
        kcfg = KimiVLConfig.from_dict(cfg)
        builders = [TrainExampleBuilder(
            kcfg.vlp_config(), inp.vocab_index, mode=m,
            mask_prob=tr["mask_prob"], vis_mask_prob=0.0,
            new_segment_ids=True) for m in ("s2s", "bi")]
        B = self.B = tr["batch_size"]
        self.K = loop_k
        self.staging = ts.GroupStaging(
            ts.staging_layout(builders[0], examples[0], self.store), loop_k,
            B, device, prefetch=training.PREFETCH)
        self.loader = TrainLoader(
            examples, self.store, builders, [tr["s2s_prob"], tr["bi_prob"]],
            batch_size=B, num_workers=tr["num_workers"],
            prefetch=training.PREFETCH, seed=inp.loader_seed,
            feature_slabs=self.staging.feature_slabs())
        with torch.device(device):
            self.model = KimiVLModel(kcfg)
        w = ref.make_weights(cfg, self.seeds["weights"], device)
        self.model.load_state_dict(w, strict=False)
        self.start = {n: t.cpu() for n, t in w.items()}
        del w
        ctx.mark("model")
        self.t_total = len(self.loader) * tr["num_train_epochs"]
        self.optimizer = optim_lib.BertAdam(
            dict(self.model.named_parameters()), tr["learning_rate"],
            warmup=tr["warmup_proportion"], t_total=self.t_total,
            schedule="warmup_linear", weight_decay=tr["weight_decay"])
        self.step = make_dp_multi_step(self.model, self.optimizer,
                                       Dist(device=device), K=loop_k,
                                       task="img2txt")
        self.batches = self._batches()

    def rows(self) -> np.ndarray:
        """int64 [MoE layers, held]: the held experts' row counters (a
        sync)."""
        return np.asarray(self.model.read_rows_per_expert())


def on_device(batch, device):
    return {k: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for k, v in batch.items()}


def run(ctx) -> None:
    from vlp_tpu_torch.host_copy import fetch, fetched
    dev = ctx.device
    tr = ctx.traffic
    K = tr["loop_steps"]
    prog = Program(ctx, dev, K)
    B = prog.B
    state = {"steps": 0}

    def take():
        pending = []
        while len(pending) < K:
            with ctx.span("loader"):
                _, b, batch = next(prog.batches)
            pending.append((b, batch))
        return pending

    def launch(pending):
        """Launch the group of ``pending`` batches; returns their meta and
        the group's fetch."""
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

    # set-up: step 1's routing, the first check_groups groups (the capture
    # and its replays) read before anything else runs, then the warm-up
    first = take()
    routes = [s.cpu() for s in prog.model.selections(on_device(first[0][1],
                                                               dev))]
    losses = drain(launch(first)[1])
    for _ in range(tr["check_groups"] - 1):
        losses += drain(launch(take())[1])
    readings = {"losses": losses, "moment": prog.moment_norms(),
                "change": prog.change_norms()}
    for _ in range(tr["setup_groups"]):
        drain(launch(take())[1])
    harness.sync(dev)
    for m in prog.model.moe_layers:
        m.rows.zero_()
    ctx.spans.clear()

    done, metas, failed = [], [], 0
    prof_rows = []
    t0 = ctx.open_window()
    t_prev = t0
    in_flight = None
    i = 0
    while True:
        ctx.step_begin(i)
        profiled = ctx.profiler is not None and ctx.profiler.active
        if profiled and not prof_rows:
            prof_rows.append(prog.rows())     # the profiler synced
        meta, handle = launch(take())
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
        if profiled and not ctx.profiler.active:
            prof_rows.append(prog.rows())     # the profiler synced
        in_flight = (meta, handle)
        if ctx.window_over(t_prev):
            break
        i += 1
    drain(in_flight[1])
    harness.sync(dev)
    peak = harness.memory_peak(dev)
    window_rows = prog.rows()
    inp, seeds, t_total = prog.inputs, prog.seeds, prog.t_total
    prog.close()
    del prog
    harness.release(dev)

    n_steps = K * tr["check_groups"]
    refr = reference_readings(ctx, dev, seeds, inp, t_total, n_steps)
    checks = compare(readings, routes, refr, tr["limits"])
    if ctx.controls:
        # the control (the reference in fp8) and the fault (rows past a
        # capacity factor of 1.0 dropped) in the program's place
        ctx.record["control"] = {}
        for name, kw in (("fp8", dict(precision="fp8")),
                         ("capacity", dict(capacity_factor=1.0))):
            got = reference_readings(ctx, dev, seeds, inp, t_total, n_steps,
                                     **kw)
            ctx.record["control"][name] = {
                c["name"]: c["value"] for c in compare(
                    got, got["routes"], refr, dict.fromkeys(tr["limits"], 0))}
    cfg = ctx.cfg
    L = ref_data.seq_len(cfg)
    record = dict(
        attempted=sum(d[2] for d in done), failed=failed, done=done,
        window_start=t0, memory_peak_bytes=peak, checks=checks,
        rows_per_expert=window_rows.tolist(),
        profiled_steps=len(metas), profiled_samples=B * len(metas),
        flop_per_sample=work_kimi.train_flop_per_sample(cfg, L))
    if len(prof_rows) == 2 and metas:
        prefix = cfg["len_vis_input"] + 2
        H = cfg["num_attention_heads"]
        record["mla_bound_ms"] = sum(
            cfg["num_hidden_layers"] * (
                work_kimi.mla_fwd_ms(B, L, H, m["mode"], m["text_end"],
                                     prefix)
                + work_kimi.mla_bwd_ms(B, L, H, m["mode"], m["text_end"],
                                       prefix)) for m in metas)
        rows = (prof_rows[1] - prof_rows[0]).sum(axis=1)
        record["gmm_bound_ms"] = sum(
            work_kimi.expert_products_ms(int(r), cfg, len(metas))
            for r in rows)
    ctx.record.update(record)


# ---------------------------------------------------------------------
# the plain reference and the comparison
# ---------------------------------------------------------------------

def reference_readings(ctx, dev, seeds, inp, t_total: int, n_steps: int,
                       precision: str = "fp32",
                       capacity_factor=None) -> dict:
    """The reference's losses of the first ``n_steps`` steps, step 1's
    clipped gradient norms and routing, and after ``n_steps`` BertAdam's
    first moment (over 1 - beta1) and the weights' change, from the
    program's starting weights and batches.  A step runs in blocks of
    ``reference_block`` sequences, their gradients summed; its bias
    update and balance loss take the whole step's picks.  ``precision``
    "fp8" is the control; ``capacity_factor`` 1.0 the fault of an expert
    layer that drops rows."""
    cfg, tr = ctx.cfg, ctx.traffic
    ref.no_tf32()
    q = ref.Precision(precision)
    W = ref.make_weights(cfg, seeds["weights"], dev)
    names = list(W)
    W = {n: t.clone().requires_grad_() for n, t in W.items()}
    start = {n: t.detach().clone() for n, t in W.items()}
    biases = {n: torch.zeros(cfg["n_routed_experts"], device=dev)
              for n in ref.bias_names(cfg)}
    opt = ref_optim.BertAdam({n: W[n] for n in names}, tr["learning_rate"],
                             tr["warmup_proportion"], t_total,
                             tr["weight_decay"])
    block = tr["reference_block"]
    losses, grad1, routes = [], None, None
    for k in range(n_steps):
        host = ref_data.train_batch(inp, cfg, tr, epoch=0, batch_index=k)
        batch = {n: torch.from_numpy(np.asarray(v)).to(dev)
                 for n, v in host.items()}
        B = batch["input_ids"].shape[0]
        wt = float(batch["masked_weights"].sum())
        grads, load, loss, sel = None, None, 0.0, []
        for lo in range(0, B, block):
            part = {n: v[lo:lo + block] for n, v in batch.items()}
            out = ref.forward(W, cfg, part, biases, q=q, weight_total=wt,
                              seqs_total=B, capacity_factor=capacity_factor)
            g = dict(zip(names, torch.autograd.grad(
                out["loss"], [W[n] for n in names], allow_unused=True)))
            loss += float(out["loss"].detach())
            grads = g if grads is None else {
                n: training._plus(grads[n], g[n]) for n in names}
            load = out["load"] if load is None else {
                n: load[n] + out["load"][n] for n in load}
            if k == 0:
                sel.append(out["selections"])
            del out, g
        taken = opt.step(grads)
        ref.update_biases(cfg, biases, load)
        losses.append(loss)
        if k == 0:
            grad1 = {n: float(torch.linalg.vector_norm(t))
                     for n, t in taken.items()}
            routes = [torch.cat([s[n] for s in sel]).cpu() for n in biases]
        del taken, grads
    moment = {n: float(torch.linalg.vector_norm(m)) / (1 - ref_optim.B1)
              for n, m in opt.m.items()}
    change = {n: float(torch.linalg.vector_norm(W[n].detach() - start[n]))
              for n in names}
    return {"losses": losses, "grad1": grad1, "moment": moment,
            "change": change, "routes": routes}


def compare(prog: dict, routes, refr: dict, limits: dict):
    """``training.compare``'s loss, moment and change gaps, and the share
    of step 1's (token, expert) picks ``routes`` (one [T, k] a MoE layer),
    over the layers, that the reference does not pick
    (``route_mismatch``)."""
    out = training.compare(prog, refr, limits, "moment_gap")
    mismatch = statistics.fmean(ref.selection_mismatch(a, b)
                                for a, b in zip(routes, refr["routes"]))
    out.append({"name": "route_mismatch", "value": mismatch,
                "limit": limits["route_mismatch"]})
    return out
