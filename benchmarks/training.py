"""What the training cells share: their inputs, the program's objects
built as the train CLI builds them (packed fp16 store, ``TrainLoader``,
``VLPModel``, ``BertAdam``, the data-parallel step over the run's ranks,
one on one chip), the readings set-up takes of the first steps, and the
comparison of those readings with the plain reference.

The first steps go through the window's own call and feed: set-up builds
one model and optimizer, drives them through the first steps, reads the
loss of each step, the optimizer's first moment after its first
observable state, and the parameters' change, and hands the same objects
to the window.
"""

from __future__ import annotations

import itertools
import os
import statistics
from typing import Dict, List, Optional

import numpy as np
import torch

from benchmarks import inputs as inputs_lib
from benchmarks import weights as weights_lib
from benchmarks import work
from benchmarks.reference import data as ref_data
from benchmarks.reference import model as ref_model
from benchmarks.reference import optim as ref_optim
from benchmarks.reference import philox

PREFETCH = 4          # the train CLI's loader prefetch
# VLPConfig fields a configuration file sets
CONFIG_FIELDS = (
    "vocab_size", "hidden_size", "num_hidden_layers", "num_attention_heads",
    "intermediate_size", "hidden_act", "hidden_dropout_prob",
    "attention_probs_dropout_prob", "max_position_embeddings",
    "type_vocab_size", "relax_projection", "initializer_range",
    "label_smoothing", "len_vis_input", "vis_feat_dim", "vis_cls_dim",
    "vis_pe_dim", "max_len_b", "max_pred", "num_answers", "dtype")
# reference gradients under this share of the median leaf's are round-off
ROUNDOFF_SHARE = 1e-3


def program_config(cfg: dict, **over):
    from vlp_tpu_torch.config import VLPConfig
    kw = {k: cfg[k] for k in CONFIG_FIELDS if k in cfg}
    kw.update(over)
    return VLPConfig(**kw)


def run_seeds(seed: int) -> Dict[str, int]:
    """The seeds a run derives from ``--seed``: inputs, weights, dropout."""
    ss = np.random.SeedSequence((seed, 0))
    a, b, c = (int(x) for x in ss.generate_state(3, np.uint64))
    return {"inputs": a % 2 ** 62, "weights": b % 2 ** 62, "dropout": c}


def step_seed(seeds: Dict[str, int], n: int) -> int:
    """The dropout seed of the run's n-th optimizer step (from 0)."""
    return philox.step_seed(seeds["dropout"], n)


def write_store(inp, cfg: dict, path: str):
    from vlp_tpu_torch.data.native_store import PackedFeatureStore, pack_store
    keys = inp.keys()
    index = {k: i for i, k in enumerate(keys)}
    pack_store(path, keys,
               lambda k: (inp.feat[index[k]], inp.cls[index[k]],
                          inp.bbox[index[k]]),
               n_regions=cfg["len_vis_input"], feat_dim=cfg["vis_feat_dim"],
               cls_dim=cfg["vis_cls_dim"], bbox_dim=6, dtype=np.float16)
    return PackedFeatureStore(path)


class Program:
    """The program's training objects for one rank of a run, as the train
    CLI builds them.  ``dist`` is the rank's place in the data-parallel
    group (default: a world of one, no group): rank 0 makes the inputs and
    writes the store, the others open it once it is written; each rank's
    loader reads its share of the examples."""

    def __init__(self, ctx, device, loop_k: int = 0, dist=None):
        from vlp_tpu_torch import configure_precision
        from vlp_tpu_torch import optim as optim_lib
        from vlp_tpu_torch import train_step as ts
        from vlp_tpu_torch.data.dataset import CaptionExample
        from vlp_tpu_torch.data.example_builder import TrainExampleBuilder
        from vlp_tpu_torch.data.loader import TrainLoader
        from vlp_tpu_torch.models.model import VLPModel
        from vlp_tpu_torch.parallel import Dist
        from vlp_tpu_torch.parallel.dp_step import (make_dp_multi_step,
                                                    make_dp_train_step)
        from vlp_tpu_torch.data.native_store import PackedFeatureStore
        cfg, tr = ctx.cfg, ctx.traffic
        dist = dist or Dist(device=device)
        configure_precision()
        task = tr["task"]
        vqa = task == "vqa2"
        self.seeds = run_seeds(ctx.seed)
        self.inputs = inputs_lib.make_inputs(cfg, tr, self.seeds["inputs"],
                                             device, images=dist.is_main)
        inp = self.inputs
        ctx.mark("inputs")
        path = os.path.join(ctx.workdir, "features.vlps")
        if dist.is_main:
            self.store = write_store(inp, cfg, path)
            dist.barrier()
        else:
            dist.barrier()
            self.store = PackedFeatureStore(path)
        ctx.mark("store")
        examples = []
        for e, (img, toks) in enumerate(zip(inp.example_image,
                                            inp.example_tokens)):
            ex = CaptionExample(inputs_lib.image_key(int(img)), toks,
                                image_id=int(img))
            if vqa:
                ex.ans_scores = inp.ans_scores[e]
            examples.append(ex)
        vcfg = program_config(cfg)
        builders = [TrainExampleBuilder(
            vcfg, inp.vocab_index, mode=m, mask_prob=tr["mask_prob"],
            vis_mask_prob=0.0, new_segment_ids=True, load_vqa_ann=vqa)
            for m in ("s2s", "bi")]
        B = tr["batch_size"]
        self.K = loop_k
        if loop_k:
            self.staging = ts.GroupStaging(
                ts.staging_layout(builders[0], examples[0], self.store),
                loop_k, B, device, prefetch=PREFETCH)
            slab_kw = dict(feature_slabs=self.staging.feature_slabs())
        else:
            slab_kw = dict(feature_slab_slots=PREFETCH + 2 + 1)
        self.loader = TrainLoader(
            examples, self.store, builders, [tr["s2s_prob"], tr["bi_prob"]],
            batch_size=B, num_workers=tr["num_workers"], prefetch=PREFETCH,
            seed=inp.loader_seed, process_index=dist.dp_index,
            process_count=dist.dp_world, **slab_kw)
        steps_per_epoch = len(self.loader)
        with torch.device(device):
            self.model = VLPModel(vcfg, with_vqa=vqa)
        w = weights_lib.make_weights(cfg, vqa, self.seeds["weights"], device)
        self.model.load_state_dict(weights_lib.program_state(w))
        dist.broadcast_params(self.model)
        # the starting weights, kept on the host for rank 0's change reading
        self.start = ({n: t.cpu() for n, t in w.items()} if dist.is_main
                      else None)
        del w
        ctx.mark("model")
        self.optimizer = optim_lib.BertAdam(
            dict(self.model.named_parameters()), tr["learning_rate"],
            warmup=tr["warmup_proportion"],
            t_total=steps_per_epoch * tr["num_train_epochs"],
            schedule="warmup_linear", weight_decay=tr["weight_decay"])
        if loop_k:
            self.step = make_dp_multi_step(self.model, self.optimizer, dist,
                                           K=loop_k, task=task)
        else:
            self.step = make_dp_train_step(self.model, self.optimizer, dist,
                                           task=task)
        self.t_total = steps_per_epoch * tr["num_train_epochs"]
        self.batches = self._batches()

    def _batches(self):
        """(epoch, batch index, batch) through consecutive epochs; with a
        device loop an epoch's tail of fewer than K batches is dropped, as
        the train CLI drops it.  Closing this generator closes the epoch's
        own, whose ``finally`` stops its producer and joins it."""
        for epoch in itertools.count():
            n = len(self.loader)
            usable = n - n % self.K if self.K else n
            batches = self.loader.epoch(epoch)
            try:
                for b, batch in enumerate(batches):
                    if b < usable:
                        yield epoch, b, batch
            finally:
                batches.close()

    def moment_norms(self) -> Dict[str, float]:
        """Per weight: the norm of BertAdam's first moment over (1 - beta1),
        the gradient it took when it has taken one."""
        return {n: float(torch.linalg.vector_norm(m)) / (1 - ref_optim.B1)
                for n, m in self.optimizer.m.items()}

    def change_norms(self) -> Dict[str, float]:
        """Per weight: the norm of its change since the start (host)."""
        return {n: float(torch.linalg.vector_norm(
                    p.detach().cpu() - self.start[n]))
                for n, p in self.model.named_parameters()}

    def close(self):
        """Stop the loader, its producer joined, and only then unmap the
        store it reads."""
        self.batches.close()
        self.store.close()


def batch_meta(batch) -> dict:
    return {"mode": np.asarray(batch["mode"]).tolist(),
            "text_end": np.asarray(batch["text_end"]).tolist()}


def attention_bound_ms(cfg: dict, metas: List[dict]) -> float:
    """The least time of one K1 (dropout) forward and one K2 backward per
    layer for each step whose batch meta is in ``metas``."""
    L = ref_data.seq_len(cfg)
    H = cfg["num_attention_heads"]
    P = cfg["len_vis_input"] + 2
    total = 0.0
    for m in metas:
        B = len(m["mode"])
        total += cfg["num_hidden_layers"] * (
            work.attention_fwd_ms(B, L, H, m["mode"], m["text_end"], P)
            + work.attention_bwd_ms(B, L, H, m["mode"], m["text_end"], P))
    return total


# ---------------------------------------------------------------------
# the plain reference and the comparison
# ---------------------------------------------------------------------

def reference_readings(ctx, dev, seeds, inp, t_total: int, n_steps: int,
                       moment_after: int, precision: str = "fp32",
                       fault: Optional[str] = None, world: int = 1) -> dict:
    """The reference's losses of the first ``n_steps`` steps, the clipped
    gradient norms of step 1, the first moment's norms after
    ``moment_after`` steps (over 1 - beta1: after one step, the gradient
    the optimizer took) and the weights' change norms after
    ``n_steps``, over ``world`` data-parallel ranks: a step's gradient is
    the mean of the ranks' gradients, each over its rank's batch under its
    rank's dropout seed, and its loss the mean of theirs, one rank's batch
    at a time.  ``precision`` "fp8" is the control; ``fault`` a fault put
    in the program's place: "half_batch" leaves half of each batch out and
    takes the mean over the rest, "no_exchange" steps on rank 0's gradient
    alone (no all-reduce), "rank_left_out" leaves the last rank's gradient
    out of the sum that the mean divides."""
    cfg, tr = ctx.cfg, ctx.traffic
    ref_model.no_tf32()
    q = ref_model.Precision(precision)
    vqa = tr["task"] == "vqa2"
    W = weights_lib.make_weights(cfg, vqa, seeds["weights"], dev)
    names = list(W)
    W = {n: t.clone().requires_grad_() for n, t in W.items()}
    start = {n: t.detach().clone() for n, t in W.items()}
    opt = ref_optim.BertAdam({n: W[n] for n in names}, tr["learning_rate"],
                             tr["warmup_proportion"], t_total,
                             tr["weight_decay"])
    ranks = range(1 if fault == "no_exchange" else world)
    summed = [r for r in ranks if not (fault == "rank_left_out"
                                       and r == world - 1)]
    losses, grad1, moment = [], None, None
    for k in range(n_steps):
        step_losses, grads = [], None
        for r in ranks:
            host = ref_data.train_batch(inp, cfg, tr, epoch=0, batch_index=k,
                                        rank=r, world=world)
            if fault == "half_batch":
                host = {n: v[:len(v) // 2] for n, v in host.items()}
            batch = {n: torch.from_numpy(np.asarray(v)).to(dev)
                     for n, v in host.items()}
            seed = step_seed(seeds, k)
            if world > 1:
                seed = philox.step_seed(seed, r)
            loss = ref_model.train_loss(W, cfg, batch, task=tr["task"],
                                        seed=seed, q=q)
            g = ref_model.grads(loss, W, names)
            step_losses.append(float(loss.detach()))
            del loss, batch
            if r in summed:
                grads = g if grads is None else {
                    n: _plus(grads[n], g[n]) for n in names}
            del g
        if len(ranks) > 1:
            grads = {n: None if x is None else x / world
                     for n, x in grads.items()}
        taken = opt.step(grads)
        losses.append(statistics.fmean(step_losses))
        if k == 0:
            grad1 = {n: float(torch.linalg.vector_norm(g))
                     for n, g in taken.items()}
        if k + 1 == moment_after:
            moment = {n: float(torch.linalg.vector_norm(m))
                      / (1 - ref_optim.B1) for n, m in opt.m.items()}
        del taken, grads
    change = {n: float(torch.linalg.vector_norm(W[n].detach() - start[n]))
              for n in names}
    return {"losses": losses, "grad1": grad1, "moment": moment,
            "change": change}


def _plus(a: Optional[torch.Tensor], b: Optional[torch.Tensor]):
    return b if a is None else a if b is None else a + b


def worst_leaf_gap(prog: Dict[str, float], ref: Dict[str, float],
                   names) -> float:
    """The largest gap between a leaf's norms, over the reference's norm
    of that leaf or of the median leaf, whichever is larger."""
    med = statistics.median(ref[n] for n in ref)
    return max(abs(prog[n] - ref[n]) / max(ref[n], med, 1e-30)
               for n in names)


def compare(prog: dict, ref: dict, limits: dict, moment_name: str
            ) -> List[dict]:
    """The numbers that decide ``correct``, each beside its limit."""
    med = statistics.median(ref["grad1"].values())
    moved = [n for n, g in ref["grad1"].items()
             if g >= ROUNDOFF_SHARE * med]
    loss_gap = max(abs(a - b) / abs(b)
                   for a, b in zip(prog["losses"], ref["losses"]))
    out = [{"name": "loss_gap", "value": loss_gap,
            "limit": limits["loss_gap"]},
           {"name": moment_name,
            "value": worst_leaf_gap(prog["moment"], ref["moment"],
                                    ref["moment"]),
            "limit": limits[moment_name]},
           {"name": "change_gap",
            "value": worst_leaf_gap(prog["change"], ref["change"], moved),
            "limit": limits["change_gap"]}]
    return out


def controls(ctx, dev, seeds, inp, t_total: int, n_steps: int,
             moment_after: int, ref: dict, moment_name: str,
             world: int = 1) -> dict:
    """The checks' numbers of the control (the reference in fp8 in the
    program's place) and of the planted faults (half of each batch; over
    more than one rank, the exchange left out and one rank's gradient left
    out of it), each against the float32 reference ``ref``."""
    no_limits = {"loss_gap": 0, moment_name: 0, "change_gap": 0}
    kinds = [("fp8", dict(precision="fp8")),
             ("half_batch", dict(fault="half_batch"))]
    if world > 1:
        kinds += [("no_exchange", dict(fault="no_exchange")),
                  ("rank_left_out", dict(fault="rank_left_out"))]
    out = {}
    for name, kw in kinds:
        got = reference_readings(ctx, dev, seeds, inp, t_total, n_steps,
                                 moment_after, world=world, **kw)
        out[name] = {c["name"]: c["value"]
                     for c in compare(got, ref, no_limits, moment_name)}
    return out
