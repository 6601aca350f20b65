"""End-to-end learnability check on a synthetic clustered captioning task
(counterpart of ``tools/e2e_synthetic.py``).

Images belong to one of C clusters; each cluster has a fixed 4-word
caption, and its region features are drawn around a cluster centroid.  A
model trained through the real pipeline (``TrainLoader`` -> device-loop
steps, ``train_step.make_multi_step`` -> greedy decode -> native CIDEr)
must learn the mapping: CIDEr approaches 10 (identical captions), while
an untrained model scores ~0.

    python -m vlp_tpu_torch.cli.e2e_synthetic --device cpu
    python -m vlp_tpu_torch.cli.e2e_synthetic          # on cuda
    python -m vlp_tpu_torch.cli.e2e_synthetic --batch 64 --steps 40 \
        --scst_steps 40                                 # chip_smoke phase 8

``--scst_steps N`` adds a self-critical phase after the (deliberately
partial) MLE phase: SCST (``scst.SCSTTrainer``: greedy and sampled
rollouts, the CIDEr reward, the replay's policy gradient) must raise
greedy-decode CIDEr, with a fresh BertAdam at ``--scst_lr``.  The rule,
as the JAX tool's: trained CIDEr > max(1, untrained + 1) with a falling
loss, and with SCST also CIDEr after > before + 0.25.  Prints PASS or
FAIL; exits 1 on FAIL.

The configuration follows the device:

* ``cpu``: the JAX tool's tiny model (hidden 64, 2 layers, 4 heads, FFN
  128, 10 regions of 32 features, ``max_len_b`` 6), fp32, through the
  kernels' plain versions; the JAX tool's learning rates, 2e-3 for MLE
  and 1e-4 for SCST.
* ``cuda``: bert-base widths (the ``VLPConfig`` defaults: hidden 768,
  12 layers, 12 heads, FFN 3072, 100 regions of 2,048 features and 1,601
  class dims, ``max_len_b`` 20, so L = 128 and T = 20), bf16, through the
  hand-written kernels, which take heads of 64 only (the tiny model's are
  16 wide), all 12 layers.  The MLE lr is :data:`CARD_LR`, 5e-5: the
  JAX tool's 2e-3 is for the tiny model; on the card 2e-4 and 4e-4
  diverged, 1e-4 ended anywhere from 3.5 to 8.5 CIDEr in three runs, and
  2e-5 to 5e-5 reached 10 in each of six runs of 60 steps or more
  (``PERF.md``).  ``--scst_lr`` defaults to :data:`CARD_SCST_LR`, 2e-6
  (1e-4, 1e-5 and 3e-6 collapsed the greedy policy there), and SCST
  needs a partial MLE phase to have room to raise CIDEr, as
  ``chip_smoke.py`` runs it.  The region features are kept in fp16 on
  the host.

Both keep the JAX tool's 56-token vocabulary, its dropout (0.1) and its
seeds: the loaders' (1 and 2), the initialisation's (0), the steps'
(one 64-bit seed a group, ``step_seed(7, steps done)``, one a step
within it) and the SCST steps' (``step_seed(11, step)``).  Each image's
features are drawn once, from ``default_rng(1000 + i)`` as the JAX tool
draws them, and kept.

``main(argv)`` returns the run's numbers (and the trained model and the
task, to score it further).
"""

from __future__ import annotations

import argparse
import gc
import sys
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List

import numpy as np
import torch

from vlp_tpu_torch import configure_precision
from vlp_tpu_torch import train_step as ts
from vlp_tpu_torch.cli.decode import resolve_device, to_device
from vlp_tpu_torch.cli.train import scst_decode_batch
from vlp_tpu_torch.config import VLPConfig
from vlp_tpu_torch.data.dataset import CaptionExample
from vlp_tpu_torch.data.example_builder import (DecodeExampleBuilder,
                                                TrainExampleBuilder, collate,
                                                featurize_regions)
from vlp_tpu_torch.data.loader import TrainLoader
from vlp_tpu_torch.decode import DecodeParams, Decoder
from vlp_tpu_torch.evals.cider import CiderScorer
from vlp_tpu_torch.models.model import VLPModel
from vlp_tpu_torch.ops.philox import step_seed
from vlp_tpu_torch.optim import BertAdam
from vlp_tpu_torch.scst import SCSTTrainer

WORDS = [f"w{i}" for i in range(40)]
N_TRAIN = 512          # training images
EVAL_BASE = 100000     # the eval images' keys start here
# MLE and SCST learning rates: the JAX tool's for the tiny model on the
# CPU; for bert-base in bf16 on cuda, PERF.md lists the runs that chose them
CPU_LR, CPU_SCST_LR = 2e-3, 1e-4
CARD_LR, CARD_SCST_LR = 5e-5, 2e-6


def make_vocab() -> Dict[str, int]:
    """The JAX tool's 56 tokens: [PAD], [unused1-11], the specials, and 40
    words."""
    return {w: i for i, w in enumerate(
        ["[PAD]"] + [f"[unused{i}]" for i in range(1, 12)]
        + ["[UNK]", "[CLS]", "[SEP]", "[MASK]"] + WORDS)}


def make_config(device: torch.device, vocab_size: int) -> VLPConfig:
    """The tiny fp32 model on the CPU (the JAX tool's), bert-base widths in
    bf16 on cuda; both with the JAX tool's task fields."""
    task = dict(vocab_size=vocab_size, type_vocab_size=6, relax_projection=4,
                max_pred=4, use_pallas_attention=False)
    if device.type == "cpu":
        return VLPConfig(hidden_size=64, num_hidden_layers=2,
                         num_attention_heads=4, intermediate_size=128,
                         len_vis_input=10, vis_feat_dim=32, vis_cls_dim=10,
                         vis_pe_dim=16, max_len_b=6, dtype="float32", **task)
    return VLPConfig(dtype="bfloat16", **task)


class ClusterStore:
    """The synthetic feature store: image ``img_i`` belongs to cluster
    ``i % C``; its region features are the cluster's centroid plus N(0,
    0.1²) noise and its class probabilities uniform, drawn from
    ``default_rng(1000 + i)`` (the JAX tool's store).  Each image is drawn
    once (:meth:`warm` draws many on threads) and kept, read-only, in
    ``dtype``."""

    def __init__(self, cfg: VLPConfig, clusters: int, dtype=np.float32):
        self.cfg, self.clusters, self.dtype = cfg, clusters, np.dtype(dtype)
        self.centroids = np.random.default_rng(0).normal(
            size=(clusters, cfg.len_vis_input, cfg.vis_feat_dim))
        self._kept: Dict[str, tuple] = {}

    def _draw(self, key: str):
        cfg = self.cfg
        i = int(key.split("_")[1])
        c = i % self.clusters
        r = np.random.default_rng(1000 + i)
        feat = (self.centroids[c]
                + 0.1 * r.normal(size=self.centroids[c].shape)).astype(
                    np.float32)
        bbox = np.zeros((cfg.len_vis_input, 6), np.float32)
        bbox[:, 2:4] = 10
        cls = r.uniform(size=(cfg.len_vis_input, cfg.vis_cls_dim)).astype(
            np.float32)
        out = []
        for a in (feat, featurize_regions(bbox, cls)):
            a = a.astype(self.dtype, copy=False)
            a.flags.writeable = False
            out.append(a)
        return tuple(out)

    def warm(self, keys, workers: int = 8) -> None:
        """Draw ``keys`` ahead, on ``workers`` threads."""
        keys = [k for k in keys if k not in self._kept]
        with ThreadPoolExecutor(workers) as pool:
            for k, v in zip(keys, pool.map(self._draw, keys)):
                self._kept[k] = v

    def get(self, key: str):
        if key not in self._kept:
            self._kept[key] = self._draw(key)
        return self._kept[key]


class ClusterTask:
    """The task: its vocabulary, each cluster's caption, the training
    examples, the store and the eval images' prompt batch and
    references."""

    def __init__(self, cfg: VLPConfig, clusters: int, eval_images: int,
                 feature_dtype=np.float32):
        self.cfg, self.clusters = cfg, clusters
        self.vocab = make_vocab()
        self.id2tok = {i: w for w, i in self.vocab.items()}
        self.caption = {c: [WORDS[(3 * c + j) % len(WORDS)] for j in range(4)]
                        for c in range(clusters)}
        self.examples = [CaptionExample(f"img_{i}", self.caption[i % clusters],
                                        image_id=i) for i in range(N_TRAIN)]
        self.store = ClusterStore(cfg, clusters, feature_dtype)
        eval_keys = [f"img_{EVAL_BASE + i}" for i in range(eval_images)]
        self.store.warm([ex.feature_key for ex in self.examples] + eval_keys)
        dec = DecodeExampleBuilder(cfg, self.vocab,
                                   max_tgt_length=cfg.max_len_b)
        self.eval_batch = collate([dec(*self.store.get(k))
                                   for k in eval_keys])
        self.gts = {i: [" ".join(self.caption[(EVAL_BASE + i) % clusters])]
                    for i in range(eval_images)}

    def loader(self, builder: TrainExampleBuilder, batch_size: int,
               seed: int) -> TrainLoader:
        return TrainLoader(self.examples, self.store, [builder], [1.0],
                           batch_size=batch_size, num_workers=2, seed=seed)

    def captions(self, ids: np.ndarray) -> Dict[int, List[str]]:
        """Each row's words up to its first [SEP] or [PAD]."""
        res = {}
        for i, row in enumerate(ids):
            toks = []
            for t in row:
                tok = self.id2tok[int(t)]
                if tok in ("[SEP]", "[PAD]"):
                    break
                toks.append(tok)
            res[i] = [" ".join(toks)]
        return res

    def score(self, model: VLPModel, beam_size: int = 1):
        """(CIDEr, captions) of the eval images, decoded greedily
        (``Decoder.greedy``) or with a beam (``Decoder.beam_search``)."""
        cfg = self.cfg
        dev = next(model.parameters()).device
        dp = DecodeParams(mask_id=self.vocab["[MASK]"],
                          eos_id=self.vocab["[SEP]"],
                          pad_id=self.vocab["[PAD]"], beam_size=beam_size,
                          max_tgt_length=cfg.max_len_b)
        decoder = Decoder(model, cfg, dp)
        batch = to_device(self.eval_batch, dev)
        if beam_size > 1:
            ids = decoder.beam_search(batch)["pred_seq"]
        else:
            ids = decoder.greedy(batch)[0].cpu().numpy()
        res = self.captions(ids)
        cider, _ = CiderScorer().compute_score(self.gts, res)
        return float(cider), res


def build_parser():
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--clusters", type=int, default=8)
    ap.add_argument("--batch", type=int, default=32)
    ap.add_argument("--device_loop", type=int, default=10)
    ap.add_argument("--eval_images", type=int, default=32)
    ap.add_argument("--scst_steps", type=int, default=0)
    ap.add_argument("--scst_lr", type=float, default=None,
                    help=f"SCST-phase lr (the reference restarts SCST with "
                         f"a much smaller lr than MLE, README.md:96); "
                         f"default {CPU_SCST_LR:g} on cpu (the tiny model), "
                         f"{CARD_SCST_LR:g} on cuda (bert-base)")
    ap.add_argument("--device", default="cuda", type=str,
                    help="'cuda' (bert-base, bf16, the kernels) or 'cpu' "
                         "(the tiny model, fp32, plain versions)")
    return ap


def train_mle(model: VLPModel, task: ClusterTask, args, lr: float,
              device: torch.device):
    """The MLE phase: groups of ``--device_loop`` steps through
    ``make_multi_step`` (on cuda one CUDA-graph replay a group), each
    group's batches stacked into a pinned slab and copied in one go.
    Returns (each group's K losses, numpy, and the steps done)."""
    cfg, K = task.cfg, args.device_loop
    builder = TrainExampleBuilder(cfg, task.vocab, mode="s2s", mask_prob=0.5)
    loader = task.loader(builder, args.batch, seed=1)
    optimizer = BertAdam(dict(model.named_parameters()), lr, warmup=0.05,
                         t_total=args.steps)
    multi = ts.make_multi_step(model, optimizer, K=K)
    staging = ts.GroupStaging(
        ts.staging_layout(builder, task.examples[0], task.store), K,
        args.batch, device, prefetch=loader.prefetch)
    done, epoch, pending, groups = 0, 0, [], []
    while done < args.steps:
        for batch in loader.epoch(epoch):
            pending.append(batch)
            if len(pending) < K:
                continue
            # the previous group's loss was read: its slab's copy is done
            slot = (done // K) % staging.n_slots
            ts.stack_batches(pending, staging.host[slot])
            pending = []
            group = step_seed(7, done)
            m = multi(staging.upload(slot),
                      [step_seed(group, i) for i in range(K)], 0.0)
            # the graph's outputs are overwritten by its next replay
            groups.append(m["loss"].float().cpu().numpy())
            done += K
            if done >= args.steps:
                break
        epoch += 1
    return groups, done


def train_scst(model: VLPModel, task: ClusterTask, args, lr: float,
               device: torch.device):
    """The SCST phase on a fresh BertAdam (the MLE schedule is spent at its
    t_total): no masking (``max_pred`` 0, ``mask_prob`` 0), the JAX tool's
    decode batch (the prompt, 0..L-1 positions) and ground truth (the
    caption after the prompt, its [SEP] included).  Returns the mean
    reward of each step and the steps done."""
    cfg = task.cfg
    vocab, prefix = task.vocab, cfg.prefix_len
    builder = TrainExampleBuilder(cfg, vocab, mode="s2s", mask_prob=0.0,
                                  max_pred=0)
    loader = task.loader(builder, args.batch, seed=2)
    optimizer = BertAdam(dict(model.named_parameters()), lr, warmup=0.1, t_total=args.scst_steps)
    trainer = SCSTTrainer(model, cfg, mask_id=vocab["[MASK]"],
                          eos_id=vocab["[SEP]"], pad_id=vocab["[PAD]"],
                          max_tgt_length=cfg.max_len_b, optimizer=optimizer)
    rewards, done, epoch = [], 0, 0
    while done < args.scst_steps:
        for batch in loader.epoch(epoch):
            gt = np.asarray(batch["input_ids"])[
                :, prefix:prefix + cfg.max_len_b + 1]
            _, m = trainer.step(scst_decode_batch(to_device(batch, device),
                                                  cfg), gt,
                                step_seed(11, done))
            rewards.append(m["mean_reward"])
            done += 1
            if done >= args.scst_steps:
                break
        epoch += 1
    return rewards, done


def main(argv=None) -> dict:
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    configure_precision()
    lr, scst_lr = (CPU_LR, CPU_SCST_LR) if device.type == "cpu" else (
        CARD_LR, CARD_SCST_LR)
    if args.scst_lr is not None:
        scst_lr = args.scst_lr
    vocab_size = len(make_vocab())
    cfg = make_config(device, vocab_size)
    t0 = time.time()
    task = ClusterTask(cfg, args.clusters, args.eval_images,
                       np.float32 if device.type == "cpu" else np.float16)
    setup_s = time.time() - t0
    model = VLPModel(cfg)
    model.init_weights(torch.Generator().manual_seed(0))
    model.to(device)
    print(f"{device.type}: hidden {cfg.hidden_size}, "
          f"{cfg.num_hidden_layers} layers, {cfg.dtype}, lr {lr:g}; the "
          f"task's features drawn in {setup_s:.1f}s", flush=True)

    base, _ = task.score(model)
    print(f"untrained CIDEr: {base:.3f}", flush=True)
    t0 = time.time()
    groups, done = train_mle(model, task, args, lr, device)
    losses = [float(g[-1]) for g in groups]   # a group's last, as JAX's
    mle_s = time.time() - t0
    print(f"trained {done} steps in {mle_s:.1f}s; loss {losses[0]:.3f} -> "
          f"{losses[-1]:.3f}", flush=True)
    cider, res = task.score(model)
    print(f"trained CIDEr: {cider:.3f}  (sample: {res[0][0]!r} vs "
          f"{' '.join(task.caption[EVAL_BASE % args.clusters])!r})",
          flush=True)
    ok = cider > max(1.0, base + 1.0) and losses[-1] < losses[0]
    out = dict(untrained_cider=base, cider=cider, loss_first=losses[0],
               loss_last=losses[-1], steps=done, mle_seconds=mle_s, lr=lr,
               setup_seconds=setup_s)

    if args.scst_steps:
        # train_mle's graph (which held the MLE optimizer's moments and the
        # gradient buffers it wrote) went with its return: SCST steps
        # eagerly on fresh gradients and a fresh BertAdam
        for p in model.parameters():
            p.grad = None
        gc.collect()
        if device.type == "cuda":
            torch.cuda.empty_cache()
        t0 = time.time()
        rewards, done_s = train_scst(model, task, args, scst_lr, device)
        scst_s = time.time() - t0
        post, _ = task.score(model)
        k = max(len(rewards) // 4, 1)
        early, late = sum(rewards[:k]) / k, sum(rewards[-k:]) / k
        print(f"SCST {done_s} steps in {scst_s:.1f}s: CIDEr {cider:.3f} -> "
              f"{post:.3f}; mean reward {early:+.3f} -> {late:+.3f}",
              flush=True)
        ok = ok and post > cider + 0.25
        out.update(scst_pre=cider, scst_post=post, reward_early=early,
                   reward_late=late, scst_steps=done_s, scst_seconds=scst_s,
                   scst_lr=scst_lr)
    print("PASS" if ok else "FAIL")
    return dict(out, ok=ok, model=model, task=task)


if __name__ == "__main__":
    sys.exit(0 if main()["ok"] else 1)
