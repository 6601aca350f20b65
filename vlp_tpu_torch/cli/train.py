"""Training CLI on PyTorch (counterpart of ``vlp_tpu/cli/train.py``): the
flag surface of the reference ``run_img2txt_dist.py`` on one card, for
caption fine-tuning and pretraining (``--s2s_prob/--bi_prob``), VQA 2.0
fine-tuning (``--tasks vqa2``) and self-critical training (``--scst``, the
fused replay, ``scst.py``).

    python -m vlp_tpu_torch.cli.train --do_train --bert_model vocab.txt \\
        --new_segment_ids --enable_butd --src_file coco.json \\
        --model_recover_path pretrained.bin --output_dir out ...
    # VQA 2.0 fine-tuning (bi mode; the answer vocab sets num_answers)
    python -m vlp_tpu_torch.cli.train --do_train --tasks vqa2 \
        --answer_vocab_file answers.txt --s2s_prob 0 --bi_prob 1 ...
    # SCST from a fine-tuned checkpoint (reference recipe: lr 1e-6)
    python -m vlp_tpu_torch.cli.train --do_train --scst --dataset coco \\
        --max_pred 0 --mask_prob 0 --learning_rate 1e-6 ...
    # fp16 activations with dynamic loss scaling (--loss_scale N: static)
    python -m vlp_tpu_torch.cli.train --do_train --true_fp16 ...

It runs on the card unless called with ``--device cpu``: bf16 activations
through the hand-written kernels on ``cuda``, fp32 through their plain
versions on ``cpu``; ``--device cuda`` without a GPU raises.
``--true_fp16`` (MLE and ``--tasks vqa2``, not ``--scst``) makes the
activations fp16 on either device, through the fp16 forms of K1 and K2 on
the card, with dynamic loss scaling (``--loss_scale N > 0``: a static
scale); the scale state is saved in ``optim.N.bin`` and restored on
resume.  Epoch
checkpoints are ``model.N.bin`` / ``optim.N.bin`` (``checkpoint.py``), and a
rerun with the same ``--output_dir`` resumes from the newest epoch or
``--save_steps`` checkpoint.

Data parallel, one process per GPU (``parallel/``): launch with torchrun,
or by hand with the JAX CLI's flags::

    torchrun --nproc_per_node=4 -m vlp_tpu_torch.cli.train ...
    python -m vlp_tpu_torch.cli.train --jax_distributed \
        --coordinator_address host:port --num_processes 4 --process_id i ...

``--train_batch_size`` stays global (each rank loads its share, and it must
divide by world x ``--gradient_accumulation_steps``); the gradients are
mean-all-reduced once per optimizer step, SCST scores its reward over the
global batch, rank 0 writes the checkpoints, ``metrics.jsonl`` and the log,
and the returned losses are global means.  ``--world_size``, when > 1, must
equal the group's size.

``--device_loop_steps K`` (K > 1; MLE and ``--tasks vqa2``, not
``--scst``, which steps one at a time as the JAX CLI does) runs the JAX
CLI's device loop: the loader writes K batches into a pinned ``[K, B,
...]`` slab (``train_step.GroupStaging``), one copy takes it to the
device, and the K optimizer steps run as one CUDA-graph replay
(``train_step.make_multi_step``; eagerly on ``cpu``).  A group's metrics
are read after the next group is launched; a trailing group of fewer than
K batches is dropped and logged; ``metrics.jsonl`` gets a record where
the JAX CLI writes one.  With a group on ``cuda`` it needs NCCL.

``--tensor_parallel N`` (N > 1; MLE and ``--tasks vqa2``, not ``--scst``
or ``--true_fp16``, as in the JAX CLI) runs the JAX CLI's manual
(shard_map, the default ``--tp_impl``) tensor parallelism: the world splits into groups of N
consecutive ranks (``parallel/mesh.py``), each rank holds 1/N of every
layer's heads and FFN columns and runs K1 and K2 on its own heads, the
Megatron f/g all-reduces go over its group (``ops/tp.py``), and the
gradients are averaged over the world / N data-parallel ranks::

    torchrun --nproc_per_node=2 -m vlp_tpu_torch.cli.train ... \
        --tensor_parallel 2

The world must divide by N, a group must lie within a node
(``LOCAL_WORLD_SIZE``), the heads and the FFN width must divide by N and
the batch by (world / N) x ``--gradient_accumulation_steps``.  The ranks
of a group take their group's first rank's batch.  Checkpoints are
gathered to the reference's full shapes before rank 0 writes them, so
``cli.decode`` and ``cli.eval_vqa2`` read them as they are, and a resume
shards the full files.  It composes with ``--device_loop_steps`` (on
``cuda`` over NCCL only, like data parallel).

``--tp_impl gspmd`` runs the JAX CLI's GSPMD layout instead
(``parallel/mesh.py``): the embedding tables' vocab, the tied MLM logits
and loss, the MLM transform and the region and answer heads are sharded
too (a table or head that does not divide by N stays whole), so a rank
holds less of the parameters and moments; the model inserts the
collectives GSPMD would, K1 and K2 still run on each rank's heads, and
the masked-LM loss is normalised over the data-parallel ranks' global
batch, as JAX's GSPMD step does.  As in the JAX CLI it has no device
loop: ``--device_loop_steps K > 1`` is coerced to 1 with a warning::

    torchrun --nproc_per_node=2 -m vlp_tpu_torch.cli.train ... \
        --tensor_parallel 2 --tp_impl gspmd

Flags the port leaves out raise: ``--scst_replay scan`` and
``--scst_remat`` (ROADMAP A, not to port).  The
TPU dispatch workaround ``--no_pallas`` is a no-op here and says so in the
log, as are ``--fp16/--amp/--fp32_embedding`` (the dtype follows
``--device``).  ``--profile_steps N`` writes a
``torch.profiler`` table of N steps (with K > 1: of the groups that cover
them) to ``output_dir/profile.txt`` and, with a group and K = 1, times
every step's gradient all-reduce (``allreduce_ms`` of the result).
"""

from __future__ import annotations

import argparse
import contextlib
import json
import logging
import os
import time

import numpy as np
import torch

from vlp_tpu_torch import checkpoint as ckpt
from vlp_tpu_torch import configure_precision
from vlp_tpu_torch import optim as optim_lib
from vlp_tpu_torch import parallel
from vlp_tpu_torch import train_step as ts
from vlp_tpu_torch.cli import common
from vlp_tpu_torch.cli.decode import resolve_device, to_device
from vlp_tpu_torch.config import VLPConfig
from vlp_tpu_torch.data.dataset import (CaptionExample, load_karpathy_index,
                                        load_vqa_index)
from vlp_tpu_torch.data.example_builder import TrainExampleBuilder
from vlp_tpu_torch.data.features import make_store
from vlp_tpu_torch.data.loader import TrainLoader
from vlp_tpu_torch.data.tokenization import WhitespaceTokenizer
from vlp_tpu_torch.evals.vqa import VQAAnswerProcessor
from vlp_tpu_torch.models.model import VLPModel
from vlp_tpu_torch.parallel import mesh
from vlp_tpu_torch.parallel.dp_step import (make_dp_multi_step,
                                            make_dp_train_step)
from vlp_tpu_torch.parallel.tp_step import (make_tp_multi_step,
                                            make_tp_train_step,
                                            sharded_names)
from vlp_tpu_torch.scst import SCSTTrainer

# parameters of the heads a BERT checkpoint lacks (reference
# optimization.py:196-201): --finetune_decay decays them toward zero
FRESH_HEADS = ("vis_embed", "vis_pe_embed", "ans_classifier")
# batches the train loader builds ahead; its feature slabs (and the device
# loop's staging slabs, train_step.GroupStaging) cover them
PREFETCH = 4


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser()
    # general (run_img2txt_dist.py:46-146)
    p.add_argument("--bert_model", default="bert-base-cased", type=str,
                   help="local vocab.txt path (or dir containing one)")
    p.add_argument("--config_path", default=None, type=str)
    p.add_argument("--output_dir", default="tmp", type=str)
    p.add_argument("--log_file", default="training.log", type=str)
    p.add_argument("--model_recover_path", default=None, type=str,
                   help="reference-format .bin to start from")
    p.add_argument("--do_train", action="store_true")
    p.add_argument("--do_lower_case", action="store_true")
    p.add_argument("--train_batch_size", default=64, type=int)
    p.add_argument("--learning_rate", default=3e-5, type=float)
    p.add_argument("--label_smoothing", default=0, type=float)
    p.add_argument("--weight_decay", default=0.01, type=float)
    p.add_argument("--num_train_epochs", default=30, type=int)
    p.add_argument("--warmup_proportion", default=0.1, type=float)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--gradient_accumulation_steps", type=int, default=1)
    p.add_argument("--fp16", action="store_true",
                   help="no-op: the activation dtype follows --device "
                        "(bf16 on cuda, fp32 on cpu)")
    p.add_argument("--amp", action="store_true", help="no-op, as --fp16")
    p.add_argument("--true_fp16", action="store_true",
                   help="fp16 activations + dynamic loss scaling (the "
                        "reference FP16_Optimizer_State path, "
                        "optimization_fp16.py:7-80), on either device; "
                        "not with --scst")
    p.add_argument("--loss_scale", type=float, default=0,
                   help="with --true_fp16: 0 = dynamic loss scaling, >0 = "
                        "static scale (run_img2txt_dist.py:119,415-420)")
    p.add_argument("--fp32_embedding", action="store_true",
                   help="no-op: parameters, embedding tables included, "
                        "stay fp32")
    p.add_argument("--from_scratch", action="store_true")
    p.add_argument("--new_segment_ids", action="store_true")
    p.add_argument("--tokenized_input", action="store_true")
    p.add_argument("--len_vis_input", type=int, default=100)
    p.add_argument("--max_len_b", type=int, default=20)
    p.add_argument("--trunc_seg", default="b",
                   help="no-op: only segment b (the caption) is truncated")
    p.add_argument("--always_truncate_tail", action="store_true")
    p.add_argument("--mask_prob", default=0.15, type=float)
    p.add_argument("--max_pred", type=int, default=3)
    p.add_argument("--num_workers", default=4, type=int)
    p.add_argument("--max_position_embeddings", type=int, default=None)
    # VLP (run_img2txt_dist.py:148-187)
    p.add_argument("--src_file", default=None, type=str, nargs="+")
    p.add_argument("--image_root", type=str, default="")
    p.add_argument("--dataset", default="coco", type=str)
    p.add_argument("--split", type=str, nargs="+",
                   default=["train", "restval"])
    p.add_argument("--world_size", default=1, type=int,
                   help="> 1: must equal the data-parallel group's size")
    p.add_argument("--file_valid_jpgs", default="", type=str)
    p.add_argument("--sche_mode", default="warmup_linear", type=str)
    p.add_argument("--drop_prob", default=0.1, type=float)
    p.add_argument("--use_num_imgs", default=-1, type=int)
    p.add_argument("--vis_mask_prob", default=0, type=float)
    p.add_argument("--max_drop_worst_ratio", default=0, type=float)
    p.add_argument("--drop_after", default=6, type=int)
    p.add_argument("--s2s_prob", default=1, type=float)
    p.add_argument("--bi_prob", default=0, type=float)
    p.add_argument("--enable_butd", action="store_true")
    p.add_argument("--region_bbox_file", default="", type=str)
    p.add_argument("--region_det_file_prefix", default="", type=str)
    p.add_argument("--packed_feature_file", default="", type=str,
                   help="native packed feature store (.vlps)")
    p.add_argument("--tasks", default="img2txt", choices=("img2txt", "vqa2"),
                   help="vqa2: VQA 2.0 fine-tuning (needs "
                        "--answer_vocab_file)")
    p.add_argument("--relax_projection", action="store_true")
    p.add_argument("--scst", action="store_true",
                   help="self-critical training (fused replay); needs "
                        "--dataset coco --max_pred 0 --mask_prob 0")
    p.add_argument("--scst_remat", action="store_true",
                   help="with --scst: not ported (the scan replay's remat, "
                        "ROADMAP A, not to port): raises")
    p.add_argument("--scst_replay", default="fused",
                   choices=("scan", "fused"),
                   help="with --scst: scan is not ported (ROADMAP A, not to "
                        "port) and raises")
    p.add_argument("--answer_vocab_file", default="", type=str,
                   help="only read with --tasks vqa2")
    # beyond the reference
    p.add_argument("--synthetic_data", action="store_true",
                   help="synthetic features + captions (smoke/bench)")
    p.add_argument("--steps_per_epoch", type=int, default=0,
                   help="cap steps per epoch (0 = full epoch)")
    p.add_argument("--index_cache_dir", default="", type=str,
                   help="cache the tokenized dataset index here")
    p.add_argument("--finetune_decay", action="store_true",
                   help="weight-decay toward the --model_recover_path "
                        "weights (reference BertAdamFineTune)")
    p.add_argument("--profile_steps", type=int, default=0,
                   help="torch.profiler over N steps of the first epoch "
                        "(from its second step) -> output_dir/profile.txt; "
                        "with a group, every step's all-reduce timed")
    p.add_argument("--save_steps", type=int, default=0,
                   help="also checkpoint every N optimizer steps "
                        "(model.sN.bin/optim.sN.bin, latest 2 kept) and "
                        "resume mid-epoch from the newest one")
    p.add_argument("--device", default="cuda", type=str,
                   help="torch device: 'cuda' (kernels, bf16) or 'cpu' "
                        "(plain versions, fp32)")
    p.add_argument("--device_loop_steps", type=int, default=1,
                   help="K > 1: K training steps per dispatch, one CUDA-"
                        "graph replay on cuda (metrics logged per group; a "
                        "tail of fewer than K batches is dropped); not with "
                        "--scst")
    # TPU dispatch workarounds of the JAX CLI: no-ops here
    p.add_argument("--no_pallas", action="store_true",
                   help="no-op: cuda always runs the kernels, cpu their "
                        "plain versions")
    p.add_argument("--tp_impl", choices=mesh.LAYOUTS,
                   default="shard_map",
                   help="with --tensor_parallel > 1: shard_map (heads and "
                        "FFN columns, Megatron f/g) or gspmd (also the "
                        "embedding tables' vocab, the tied MLM logits and "
                        "the region and answer heads; no device loop); the "
                        "kernels run on each rank's heads in both")
    p.add_argument("--jax_distributed", action="store_true",
                   help="data parallel: one process per GPU, in a group at "
                        "--coordinator_address (or use torchrun)")
    p.add_argument("--coordinator_address", default=None,
                   help="only read with --jax_distributed")
    p.add_argument("--num_processes", type=int, default=None,
                   help="only read with --jax_distributed")
    p.add_argument("--process_id", type=int, default=None,
                   help="only read with --jax_distributed")
    p.add_argument("--tensor_parallel", type=int, default=0,
                   help="shard every layer's heads and FFN columns over "
                        "groups of this many ranks (manual Megatron tensor "
                        "parallelism); composes with data parallelism "
                        "(world / N data-parallel ranks)")
    return p


def refuse_unported(args) -> None:
    """Raise on a flag whose slice the port does not have yet."""
    not_to_port = ("is under ROADMAP A 'Not to port' (A9 ported the fused "
                   "replay)")
    unported = [
        (args.scst and args.scst_replay == "scan",
         f"--scst_replay scan: the scan replay {not_to_port}"),
        (args.scst and args.scst_remat,
         f"--scst_remat: the scan replay's remat {not_to_port}"),
    ]
    for hit, what in unported:
        if hit:
            raise NotImplementedError(f"not ported to vlp_tpu_torch: {what}")


def make_config(args, vocab_size: int, dtype: str) -> VLPConfig:
    cfg = VLPConfig(
        vocab_size=vocab_size,
        type_vocab_size=6 if args.new_segment_ids else 2,
        relax_projection=4 if args.relax_projection else 0,
        label_smoothing=args.label_smoothing,
        hidden_dropout_prob=args.drop_prob,
        attention_probs_dropout_prob=args.drop_prob,
        len_vis_input=args.len_vis_input,
        max_len_b=args.max_len_b,
        max_pred=args.max_pred,
        dtype=dtype,
    )
    if args.max_position_embeddings:
        cfg = cfg.replace(max_position_embeddings=args.max_position_embeddings)
    if args.config_path:
        cfg = VLPConfig.from_reference_json(
            args.config_path, **{k: getattr(cfg, k) for k in (
                "type_vocab_size", "relax_projection", "label_smoothing",
                "len_vis_input", "max_len_b", "max_pred", "dtype")})
    return cfg


def synthetic_examples(n, tokenizer, rng):
    """Captions of 3-11 random vocabulary words (the JAX CLI's)."""
    words = [w for w in tokenizer.vocab_words if not w.startswith("[")]
    out = []
    for i in range(n):
        k = rng.integers(3, 12)
        toks = [words[rng.integers(0, len(words))] for _ in range(k)]
        out.append(CaptionExample(f"synthetic_{i}.npy", toks, image_id=i))
    return out


def task_idx(tasks: str) -> int:
    """The relax-projection head a reference .bin collapses to: 3 for
    captioning, 0 for VQA (JAX CLI :445)."""
    return 3 if tasks == "img2txt" else 0


def _anchors(model: VLPModel, path: str, cfg: VLPConfig, tasks: str):
    """--finetune_decay anchors: the model's parameters with those the
    reference .bin holds replaced by its values."""
    sd = ckpt.load_reference_bin(path, cfg, task_idx=task_idx(tasks))
    return {n: (sd[n] if n in sd else p.detach()).float().clone()
            for n, p in model.named_parameters()}


def scst_decode_batch(tbatch, cfg: VLPConfig) -> dict:
    """A training batch as the decoder's prompt batch: the prompt ids, the
    full segment ids and 0..L-1 position ids (run_img2txt_dist.py:488-496,
    JAX ``_scst_decode_batch``)."""
    B, L = tbatch["input_ids"].shape
    dev = tbatch["input_ids"].device
    return dict(input_ids=tbatch["input_ids"][:, :cfg.prefix_len],
                segment_ids=tbatch["segment_ids"],
                position_ids=torch.arange(L, device=dev).expand(B, L),
                task_idx=tbatch["task_idx"], vis_feats=tbatch["vis_feats"],
                vis_pe=tbatch["vis_pe"])


def main(argv=None, dist: parallel.Dist = None):
    """Returns ``{"losses", "step_seconds", "iter_seconds", "model",
    "optimizer", "allreduce_ms"}``: the loss of every step taken (the mean
    over the ranks), the seconds from a batch in hand to its loss on the
    host, the seconds between consecutive steps (loader included), the
    trained model and its optimizer, and the milliseconds of each step's gradient all-reduce (with
    ``--profile_steps``, a group and K = 1; empty otherwise).  With
    ``--device_loop_steps K > 1`` a step's two times are its group's
    divided by K, once per step: on ``cuda`` the group's span on the
    device (CUDA events from its batches' copy to the device to its
    metrics' copy back, so the host's work on the next group is not in
    it; on the CPU, from its batches in hand to its losses), and the host
    seconds between consecutive groups' losses; on ``cuda``
    ``"device_loop"`` then holds the graph's captures, replays and capture
    seconds (warm-up included).  A caller may pass
    its own group as ``dist``; otherwise the flags and torchrun's
    environment decide (``parallel.from_cli``)."""
    args = build_parser().parse_args(argv)
    refuse_unported(args)
    if args.scst:
        # the reference's asserts (run_img2txt_dist.py; JAX CLI :254-260)
        if args.dataset != "coco":
            raise ValueError("--scst supports --dataset coco only")
        if args.max_pred != 0 or args.mask_prob != 0:
            raise ValueError("--scst takes no masked-LM targets: pass "
                             "--max_pred 0 --mask_prob 0")
        if args.gradient_accumulation_steps > 1:
            raise ValueError("--scst does not compose with "
                             "--gradient_accumulation_steps")
        if args.true_fp16:
            # the JAX CLI's message (vlp_tpu/cli/train.py:385)
            raise ValueError("--true_fp16 is not supported with --scst "
                             "(use the default bf16 path)")
    if args.tensor_parallel > 1 and (args.scst or args.true_fp16):
        # the JAX CLI's assert (vlp_tpu/cli/train.py:263-266)
        raise ValueError("--tensor_parallel composes with the default bf16 "
                         "MLM/VQA paths only")
    if dist is not None:
        return train(args, dist)
    dist = parallel.from_cli(
        resolve_device(args.device), jax_distributed=args.jax_distributed,
        coordinator_address=args.coordinator_address,
        num_processes=args.num_processes, process_id=args.process_id)
    try:
        return train(args, dist)
    finally:
        dist.destroy()


def tensor_parallel_dist(dist: parallel.Dist, tp: int) -> parallel.Dist:
    """``dist`` split into tensor-parallel groups of ``tp``, after the JAX
    CLI's checks (vlp_tpu/cli/train.py:497-530): the world divides by tp
    and a group lies within a node (torchrun's ``LOCAL_WORLD_SIZE``)."""
    if dist.world % tp:
        raise ValueError(f"--tensor_parallel {tp} must divide the world "
                         f"({dist.world} processes)")
    local = os.environ.get("LOCAL_WORLD_SIZE")
    if local is not None and int(local) % tp:
        raise ValueError(f"--tensor_parallel {tp} must divide the per-node "
                         f"process count {local} (a tensor-parallel group "
                         "within a node)")
    return dist.with_tensor_parallel(tp)


def train(args, dist: parallel.Dist):
    """``main`` on this rank of ``dist``."""
    device = dist.device
    if args.world_size > 1 and args.world_size != dist.world:
        raise ValueError(f"--world_size {args.world_size} but the group has "
                         f"{dist.world} processes")
    tp = max(args.tensor_parallel, 1)
    dist = tensor_parallel_dist(dist, tp)
    configure_precision()
    gspmd = tp > 1 and args.tp_impl == "gspmd"
    loop_coerced = 0
    if gspmd and args.device_loop_steps > 1:
        # the JAX CLI's rule (vlp_tpu/cli/train.py:267-273): the GSPMD
        # step has no device-loop form
        loop_coerced, args.device_loop_steps = args.device_loop_steps, 1
    K = max(args.device_loop_steps, 1)
    loop = K > 1 and not args.scst
    if args.profile_steps and not loop:
        dist.time_reductions = True
    if abs(args.s2s_prob + args.bi_prob - 1.0) > 1e-6:
        raise ValueError("--s2s_prob + --bi_prob must be 1")
    args.max_seq_length = args.max_len_b + args.len_vis_input + 3
    args.mask_image_regions = args.vis_mask_prob > 0
    # --true_fp16: fp16 on either device (JAX CLI :216)
    dtype = ("float16" if args.true_fp16
             else "bfloat16" if device.type == "cuda" else "float32")

    if dist.is_main:
        logger = common.setup_logging(args.output_dir, args.log_file)
    else:  # only rank 0 writes the log; the others print warnings
        logger = logging.getLogger(f"vlp_tpu.rank{dist.rank}")
        logger.setLevel(logging.WARNING)
    if loop_coerced:
        logger.warning(
            "--tp_impl gspmd has no device-loop variant: "
            "--device_loop_steps %d coerced to 1 (use --tp_impl shard_map "
            "to keep the K-step device loop)", loop_coerced)
    noops = [(args.no_pallas, "--no_pallas"),
             (args.fp16 or args.amp or args.fp32_embedding,
              "--fp16/--amp/--fp32_embedding")]
    for hit, flag in noops:
        if hit:
            logger.warning("%s is a no-op in vlp_tpu_torch (activations are "
                           "%s on %s)", flag, dtype, device)
    if dist.is_main:
        common.dump_opts(args, args.output_dir)
    tokenizer = common.resolve_tokenizer(args.bert_model, args.do_lower_case,
                                         args.max_position_embeddings)
    data_tokenizer = (WhitespaceTokenizer() if args.tokenized_input
                      else tokenizer)
    cfg = make_config(args, len(tokenizer.vocab), dtype)
    rng_np = np.random.default_rng(args.seed)
    if tp > 1 and (cfg.num_attention_heads % tp
                   or cfg.intermediate_size % tp):
        raise ValueError(f"--tensor_parallel {tp} needs the heads "
                         f"({cfg.num_attention_heads}) and the FFN width "
                         f"({cfg.intermediate_size}) to divide by it")

    # ---- data ------------------------------------------------------------
    vqa = args.tasks == "vqa2"
    if vqa:
        if not args.answer_vocab_file:
            raise ValueError("--tasks vqa2 needs --answer_vocab_file")
        ans_proc = VQAAnswerProcessor(args.answer_vocab_file)
        cfg = cfg.replace(num_answers=len(ans_proc))
    if args.synthetic_data:
        examples = synthetic_examples(
            max(args.train_batch_size * max(args.steps_per_epoch, 4), 64),
            tokenizer, rng_np)
        store = make_store(synthetic=True, num_regions=cfg.len_vis_input,
                           feat_dim=cfg.vis_feat_dim, cls_dim=cfg.vis_cls_dim)
    else:
        store = make_store(args.region_det_file_prefix, args.region_bbox_file,
                           packed_file=args.packed_feature_file)
        if vqa:
            examples = load_vqa_index(args.src_file, data_tokenizer,
                                      args.image_root, args.use_num_imgs)
            for ex in examples:
                ex.ans_scores = ans_proc.answers_scores(ex.answers)
        else:
            if not args.src_file or len(args.src_file) != 1:
                raise ValueError("--src_file takes one Karpathy-split json")
            examples = load_karpathy_index(
                args.src_file[0], args.split, data_tokenizer,
                args.image_root, args.file_valid_jpgs, args.use_num_imgs,
                args.dataset, cache_dir=args.index_cache_dir or None)
    builder_kw = dict(mask_prob=args.mask_prob,
                      vis_mask_prob=args.vis_mask_prob,
                      new_segment_ids=args.new_segment_ids,
                      always_truncate_tail=args.always_truncate_tail,
                      load_vqa_ann=vqa)
    builders = [TrainExampleBuilder(cfg, tokenizer.vocab, mode=m, **builder_kw)
                for m in ("s2s", "bi")]
    accum = max(args.gradient_accumulation_steps, 1)
    if args.train_batch_size % (dist.dp_world * accum):
        raise ValueError(f"--train_batch_size (global) must divide into "
                         f"{dist.dp_world} data-parallel ranks x "
                         "--gradient_accumulation_steps micro-batches")
    # each data-parallel rank loads its share of the global batch (JAX CLI
    # :341-348); the ranks of a tensor-parallel group load the same one
    local_bs = args.train_batch_size // dist.dp_world
    if loop:
        # the loader writes each batch's features into the K-group slabs
        # that one copy takes to the device (JAX CLI :349-358)
        staging = ts.GroupStaging(
            ts.staging_layout(builders[0], examples[0], store), K,
            local_bs, device, prefetch=PREFETCH)
        slab_kw = dict(feature_slabs=staging.feature_slabs())
    else:
        slab_kw = dict(feature_slab_slots=PREFETCH + 2 + 1)
    loader = TrainLoader(examples, store, builders,
                         [args.s2s_prob, args.bi_prob],
                         batch_size=local_bs, num_workers=args.num_workers,
                         prefetch=PREFETCH, seed=args.seed,
                         process_index=dist.dp_index,
                         process_count=dist.dp_world,
                         **slab_kw)
    steps_per_epoch = len(loader)
    if args.steps_per_epoch:
        steps_per_epoch = min(steps_per_epoch, args.steps_per_epoch)
    t_total = steps_per_epoch * args.num_train_epochs

    # ---- model / optimizer / resume ----------------------------------------
    model = VLPModel(cfg, with_vqa=vqa)
    model.init_weights(torch.Generator().manual_seed(args.seed))
    model.to(device)
    # every rank resumes from what rank 0 finds (JAX CLI :397-410)
    recover_step, recover_gstep = (x or None for x in dist.broadcast_ints([
        ckpt.get_max_epoch_model(args.output_dir) or 0,
        ckpt.get_latest_step_checkpoint(args.output_dir) or 0]))
    start_epoch, skip_batches, tag = 1, 0, None
    if recover_gstep and recover_gstep > (recover_step or 0) * steps_per_epoch:
        # a step checkpoint newer than any epoch's: resume inside the epoch
        # by skipping the batches it consumed (the epoch order is fixed)
        logger.info("***** Recover model: step %d *****", recover_gstep)
        tag = f"s{recover_gstep}"
        start_epoch = recover_gstep // steps_per_epoch + 1
        skip_batches = recover_gstep % steps_per_epoch
    elif recover_step:
        logger.info("***** Recover model: %d *****", recover_step)
        tag = recover_step
        start_epoch = recover_step + 1
    if tag is not None:
        ckpt.restore_model(args.output_dir, tag, model)
    elif args.model_recover_path:
        logger.info("***** Recover model: %s *****", args.model_recover_path)
        missing = ckpt.load_into(model, {
            k: v.to(device) for k, v in ckpt.load_reference_bin(
                args.model_recover_path, cfg,
                task_idx=task_idx(args.tasks)).items()})
        if missing:
            logger.info("not in the checkpoint, kept at init: %s", missing)
    dist.broadcast_params(model)
    if args.finetune_decay and not args.model_recover_path:
        raise ValueError("--finetune_decay needs --model_recover_path (the "
                         "weights to decay toward)")
    anchors = (_anchors(model, args.model_recover_path, cfg, args.tasks)
               if args.finetune_decay else None)
    opt_kw = dict(warmup=args.warmup_proportion, t_total=t_total,
                  schedule=args.sche_mode, weight_decay=args.weight_decay)
    if tp > 1:
        # the whole model, the same on every rank, then this rank's shard
        # (JAX shard_state_shard_map_tp / shard_state)
        model.shard_(dist.tensor_parallel, layout=args.tp_impl)
        if anchors is not None:
            anchors = mesh.shard_state_dict(anchors, dist.tp_index, tp,
                                            args.tp_impl)
        opt_kw.update(clip_group=dist.tp_group,
                      clip_sharded=sharded_names(model))
        attention = "CUDA" if device.type == "cuda" else "plain"
        accum_note = f", grad_accum={accum}" if accum > 1 else ""
        if gspmd:
            # the JAX CLI's line (vlp_tpu/cli/train.py:539-541); K1/K2 on
            # each rank's heads where JAX rides XLA attention
            logger.info("GSPMD training: dp=%d x tp=%d (vocab-parallel "
                        "embeddings and MLM loss, %s attention on each "
                        "rank's heads%s)", dist.dp_world, tp, attention,
                        accum_note)
        else:
            logger.info("shard_map training: dp=%d x tp=%d (manual "
                        "Megatron collectives, %s attention%s)",
                        dist.dp_world, tp, attention, accum_note)

    params = dict(model.named_parameters())
    if args.finetune_decay:
        optimizer = optim_lib.bert_adam_finetune(
            params, args.learning_rate, init_params=anchors,
            missing_key_substrings=FRESH_HEADS, **opt_kw)
    else:
        optimizer = optim_lib.BertAdam(params, args.learning_rate, **opt_kw)
    loss_scale = None
    if args.true_fp16:
        loss_scale = (optim_lib.DynamicLossScale() if args.loss_scale == 0
                      else optim_lib.DynamicLossScale(
                          init_scale=args.loss_scale, static=True))
        logger.info("true-fp16: fp16 activations + %s loss scaling",
                    "dynamic" if args.loss_scale == 0
                    else f"static {args.loss_scale:g}")
    multi_step = None
    if args.scst:
        vocab = tokenizer.vocab
        scst_trainer = SCSTTrainer(
            model, cfg, mask_id=vocab["[MASK]"], eos_id=vocab["[SEP]"],
            pad_id=vocab["[PAD]"], max_tgt_length=cfg.max_len_b,
            optimizer=optimizer, dist=dist)
        p0 = cfg.prefix_len

        def run_step(batch, tbatch, seed, i_epoch):
            # ground truth: everything after the prompt, the final [SEP]
            # included (run_img2txt_dist.py:517)
            gt = np.asarray(batch["input_ids"])[:, p0:p0 + cfg.max_len_b + 1]
            loss, m = scst_trainer.step(scst_decode_batch(tbatch, cfg), gt,
                                        seed)
            return {"loss": loss, **m}
    elif loop:
        multi_step = (make_tp_multi_step if tp > 1 else make_dp_multi_step)(
            model, optimizer, dist, K=K,
            mask_image_regions=args.mask_image_regions, task=args.tasks,
            grad_accum=accum, loss_scale=loss_scale)
    else:
        train_step = (make_tp_train_step if tp > 1 else make_dp_train_step)(
            model, optimizer, dist, mask_image_regions=args.mask_image_regions,
            task=args.tasks, grad_accum=accum, loss_scale=loss_scale)

        def run_step(batch, tbatch, seed, i_epoch):
            return train_step(tbatch, seed, args.max_drop_worst_ratio
                              if i_epoch > args.drop_after else 0.0)
    def shard(sd):
        return mesh.shard_state_dict(sd, dist.tp_index, tp, args.tp_impl)

    def gather(sd):
        return mesh.gather_full(sd, dist.tp_index, tp, dist.tp_group,
                                model.tp_specs)

    if tag is not None:
        # after the step builder, which put the loss scale's state on the
        # optimizer: the saved one replaces it; the full moments sharded
        ckpt.restore_optimizer(args.output_dir, tag, optimizer,
                               shard=shard if tp > 1 else None)

    result = {"losses": [], "step_seconds": [], "iter_seconds": [],
              "model": model, "optimizer": optimizer, "allreduce_ms": []}
    if not args.do_train:
        return result
    logger.info("***** Running %straining on %s (%s), %d rank(s) *****",
                "SCST " if args.scst else "", device, dtype, dist.world)
    logger.info("  Batch size = %d  Num steps = %d", args.train_batch_size,
                t_total)
    last_save = (start_epoch - 1) * steps_per_epoch + skip_batches
    profiler = None

    def save(save_fn, tag):
        """Rank 0 writes a checkpoint, under tensor parallelism the full
        state that every rank of its group helps to gather."""
        full = None
        if tp > 1:
            opt = optimizer.state_dict()
            full = (gather(model.state_dict()),
                    dict(opt, m=gather(opt["m"]), v=gather(opt["v"])))
        if dist.is_main:
            save_fn(args.output_dir, tag, model, optimizer, full)

    def maybe_save_steps(i_epoch, step_i):
        """A step checkpoint every --save_steps optimizer steps, counted
        from loader batches (also after a K-step group)."""
        nonlocal last_save
        gdone = (i_epoch - 1) * steps_per_epoch + step_i + 1
        if args.save_steps and gdone - last_save >= args.save_steps:
            save(ckpt.save_step_checkpoint, gdone)
            last_save = gdone

    def record(mf, i_epoch, step_i, losses, metrics):
        logger.info("Epoch %d, Iter %d, Loss %.2f", i_epoch, step_i,
                    float(np.mean(losses)))
        rec = {"epoch": i_epoch, "step": step_i, "time": time.time()}
        rec.update({k: float(v) for k, v in metrics.items()})
        mf.write(json.dumps(rec) + "\n")
        mf.flush()

    with (open(os.path.join(args.output_dir, "metrics.jsonl"), "a")
          if dist.is_main else contextlib.nullcontext()) as mf:
        for i_epoch in range(start_epoch, args.num_train_epochs + 1):
            losses = []
            t_ep = t_prev = time.perf_counter()
            skip = skip_batches if i_epoch == start_epoch else 0
            pending, in_flight = [], None

            def drain(group):
                """The losses of a launched group, once its copy to the
                host is done (the JAX CLI's ``drain_ms``)."""
                nonlocal t_prev
                last, (host, done), t0, start = group
                if done is not None:
                    done.synchronize()
                group_losses = [float(x) for x in host["loss"]]
                t1 = time.perf_counter()
                group_s = (t1 - t0 if done is None
                           else start.elapsed_time(done) / 1e3)
                result["step_seconds"] += [group_s / K] * K
                result["iter_seconds"] += [(t1 - t_prev) / K] * K
                t_prev = t1
                losses.extend(group_losses)
                result["losses"].extend(group_losses)
                if (last // K) % max(100 // K, 1) == 0 and dist.is_main:
                    record(mf, i_epoch, last, losses,
                           {k: v[-1] for k, v in host.items()})

            for step_i, batch in enumerate(
                    loader.epoch(i_epoch - 1, start_batch=skip), start=skip):
                if args.steps_per_epoch and step_i >= args.steps_per_epoch:
                    break
                if loop:
                    # the device loop (JAX CLI :675-702): K batches, one
                    # copy, one launch
                    pending.append(batch)
                    if len(pending) < K:
                        continue
                    grp = (step_i - skip) // K
                    if (args.profile_steps and dist.is_main
                            and i_epoch == start_epoch and grp == 1):
                        profiler = start_profiler()
                    t0 = time.perf_counter()
                    slot = grp % staging.n_slots
                    staging.stack(slot, pending)
                    seeds = [ts.step_seed(args.seed + 1, i_epoch * 100000 + i)
                             for i in range(step_i - K + 1, step_i + 1)]
                    start = None
                    if device.type == "cuda":
                        start = torch.cuda.Event(enable_timing=True)
                        start.record()
                    staged = staging.upload(slot)
                    dist.broadcast_in_tp_group([staging.device_block])
                    metrics = multi_step(
                        staged, seeds,
                        args.max_drop_worst_ratio
                        if i_epoch > args.drop_after else 0.0)
                    pending = []
                    launched = (step_i, ts.fetch_metrics(metrics), t0, start)
                    if in_flight is not None:
                        drain(in_flight)
                    in_flight = launched
                    if (profiler is not None
                            and grp == -(-args.profile_steps // K)):
                        stop_profiler(profiler, args.output_dir)
                        profiler = None
                    maybe_save_steps(i_epoch, step_i)
                    continue
                if (args.profile_steps and dist.is_main
                        and i_epoch == start_epoch and step_i == skip + 1):
                    profiler = start_profiler()
                t0 = time.perf_counter()
                tbatch = to_device(batch, device)
                dist.broadcast_in_tp_group(
                    v for _, v in sorted(tbatch.items()))
                # the step's randomness follows from (seed, epoch, step), so
                # a resumed run draws what an uninterrupted one would
                seed = ts.step_seed(args.seed + 1, i_epoch * 100000 + step_i)
                metrics = run_step(batch, tbatch, seed, i_epoch)
                loss = float(metrics["loss"])
                t1 = time.perf_counter()
                result["step_seconds"].append(t1 - t0)
                result["iter_seconds"].append(t1 - t_prev)
                t_prev = t1
                losses.append(loss)
                result["losses"].append(loss)
                if (profiler is not None
                        and step_i == skip + args.profile_steps):
                    stop_profiler(profiler, args.output_dir)
                    profiler = None
                maybe_save_steps(i_epoch, step_i)
                if step_i % 100 == 0 and dist.is_main:
                    record(mf, i_epoch, step_i, losses, metrics)
            if in_flight is not None:
                drain(in_flight)
            if pending:
                # the JAX CLI's rule (:744-752): the next epoch's loader
                # restarts its slab rotation and would overwrite them
                logger.info("dropping %d tail batches (< device_loop_steps)",
                            len(pending))
            if profiler is not None:
                stop_profiler(profiler, args.output_dir)
                profiler = None
            logger.info("Epoch %d done in %.1fs, mean loss %.4f", i_epoch,
                        time.perf_counter() - t_ep,
                        float(np.mean(losses)) if losses else float("nan"))
            save(ckpt.save_checkpoint, i_epoch)
            # epoch barrier (run_img2txt_dist.py:604-605; JAX CLI :759-768)
            dist.barrier()
    if isinstance(multi_step, ts.CapturedSteps):
        result["device_loop"] = dict(
            captures=multi_step.captures, replays=multi_step.replays,
            capture_seconds=multi_step.capture_seconds)
    result["allreduce_ms"] = dist.reduction_ms()
    return result


def start_profiler():
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    prof = profile(activities=acts)
    prof.__enter__()
    return prof, time.perf_counter()


def stop_profiler(profiler, output_dir: str) -> None:
    """Write the profiled window's wall time, summed device time and
    busy share, then the per-op table sorted by device time (every row:
    the host-side ranges, such as ``dist.grad_agreement``, have none)."""
    prof, t0 = profiler
    cuda = torch.cuda.is_available()
    if cuda:
        torch.cuda.synchronize()
    wall_ms = (time.perf_counter() - t0) * 1e3
    prof.__exit__(None, None, None)
    from torch.autograd import DeviceType
    events = prof.key_averages()
    key = "self_device_time_total" if cuda else "self_cpu_time_total"
    # the device's own events (kernels, copies), as the table's total:
    # an op's self device time repeats its kernels' times
    device_ms = sum(getattr(e, key) for e in events
                    if (e.device_type != DeviceType.CPU) == cuda) / 1e3
    with open(os.path.join(output_dir, "profile.txt"), "w") as f:
        f.write(f"wall {wall_ms:.3f} ms, {key} summed {device_ms:.3f} ms, "
                f"busy share {device_ms / wall_ms:.3f}\n")
        f.write(events.table(sort_by=key, row_limit=-1))


if __name__ == "__main__":
    main()
