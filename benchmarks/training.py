"""What the training cells share: their inputs, the program's objects
built as the train CLI builds them (packed fp16 store, ``TrainLoader``,
``VLPModel``, ``BertAdam``, the data-parallel step at world size 1), the
readings set-up takes of the first steps, and the comparison of those
readings with the plain reference.

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
from typing import Dict, List

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
    """The program's training objects for one run, as the train CLI builds
    them at world size 1."""

    def __init__(self, ctx, device, loop_k: int = 0):
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
        cfg, tr = ctx.cfg, ctx.traffic
        configure_precision()
        task = tr["task"]
        vqa = task == "vqa2"
        self.seeds = run_seeds(ctx.seed)
        self.inputs = inputs_lib.make_inputs(cfg, tr, self.seeds["inputs"],
                                             device)
        inp = self.inputs
        ctx.mark("inputs")
        self.store = write_store(inp, cfg, os.path.join(ctx.workdir,
                                                        "features.vlps"))
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
            seed=inp.loader_seed, **slab_kw)
        steps_per_epoch = len(self.loader)
        with torch.device(device):
            self.model = VLPModel(vcfg, with_vqa=vqa)
        w = weights_lib.make_weights(cfg, vqa, self.seeds["weights"], device)
        self.model.load_state_dict(weights_lib.program_state(w))
        # the starting weights, kept on the host for the change reading
        self.start = {n: t.cpu() for n, t in w.items()}
        del w
        ctx.mark("model")
        self.optimizer = optim_lib.BertAdam(
            dict(self.model.named_parameters()), tr["learning_rate"],
            warmup=tr["warmup_proportion"],
            t_total=steps_per_epoch * tr["num_train_epochs"],
            schedule="warmup_linear", weight_decay=tr["weight_decay"])
        dist = Dist(device=device)
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
        the train CLI drops it."""
        for epoch in itertools.count():
            n = len(self.loader)
            usable = n - n % self.K if self.K else n
            for b, batch in enumerate(self.loader.epoch(epoch)):
                if b < usable:
                    yield epoch, b, batch

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
                       half_batch: bool = False) -> dict:
    """The reference's losses of the first ``n_steps`` steps, the clipped
    gradient norms of step 1, the first moment's norms after
    ``moment_after`` steps (over 1 - beta1: after one step, the gradient
    the optimizer took) and the weights' change norms after
    ``n_steps``.  ``precision`` "fp8" is the control; ``half_batch`` the
    fault that leaves half of each batch out and takes the mean over the
    rest."""
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
    losses, grad1, moment = [], None, None
    for k in range(n_steps):
        host = ref_data.train_batch(inp, cfg, tr, epoch=0, batch_index=k)
        if half_batch:
            host = {n: v[:len(v) // 2] for n, v in host.items()}
        batch = {n: torch.from_numpy(np.asarray(v)).to(dev)
                 for n, v in host.items()}
        loss = ref_model.train_loss(W, cfg, batch, task=tr["task"],
                                    seed=step_seed(seeds, k), q=q)
        taken = opt.step(ref_model.grads(loss, W, names))
        losses.append(float(loss.detach()))
        if k == 0:
            grad1 = {n: float(torch.linalg.vector_norm(g))
                     for n, g in taken.items()}
        if k + 1 == moment_after:
            moment = {n: float(torch.linalg.vector_norm(m))
                      / (1 - ref_optim.B1) for n, m in opt.m.items()}
        del loss, taken, batch
    change = {n: float(torch.linalg.vector_norm(W[n].detach() - start[n]))
              for n in names}
    return {"losses": losses, "grad1": grad1, "moment": moment,
            "change": change}


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
             moment_after: int, ref: dict, moment_name: str) -> dict:
    """The checks' numbers of the control (the reference in fp8 in the
    program's place) and of the half-batch fault, each against the
    float32 reference ``ref``."""
    no_limits = {"loss_gap": 0, moment_name: 0, "change_gap": 0}
    out = {}
    for name, kw in (("fp8", dict(precision="fp8")),
                     ("half_batch", dict(half_batch=True))):
        got = reference_readings(ctx, dev, seeds, inp, t_total, n_steps,
                                 moment_after, **kw)
        out[name] = {c["name"]: c["value"]
                     for c in compare(got, ref, no_limits, moment_name)}
    return out
