"""Training CLI on PyTorch (counterpart of ``vlp_tpu/cli/train.py``): the
masked-LM flag surface of the reference ``run_img2txt_dist.py`` on one
card, for caption fine-tuning and pretraining (``--s2s_prob/--bi_prob``).

    python -m vlp_tpu_torch.cli.train --do_train --bert_model vocab.txt \\
        --new_segment_ids --enable_butd --src_file coco.json \\
        --model_recover_path pretrained.bin --output_dir out ...

It runs on the card unless called with ``--device cpu``: bf16 activations
through the hand-written kernels on ``cuda``, fp32 through their plain
versions on ``cpu``; ``--device cuda`` without a GPU raises.  Epoch
checkpoints are ``model.N.bin`` / ``optim.N.bin`` (``checkpoint.py``), and a
rerun with the same ``--output_dir`` resumes from the newest epoch or
``--save_steps`` checkpoint.

Flags of slices not yet ported raise, naming the ROADMAP item: ``--scst``
(A9), ``--tasks vqa2`` (A8), ``--jax_distributed`` and ``--world_size > 1``
(A10), ``--tensor_parallel > 1`` and ``--true_fp16`` (ROADMAP A, not to
port).  The TPU dispatch workarounds ``--device_loop_steps``,
``--no_pallas`` and ``--tp_impl`` are no-ops here and say so in the log, as
are ``--fp16/--amp/--fp32_embedding`` (the dtype follows ``--device``).
``--profile_steps N`` writes a ``torch.profiler`` table of N steps to
``output_dir/profile.txt``.
"""

from __future__ import annotations

import argparse
import json
import os
import time

import numpy as np
import torch

from vlp_tpu_torch import checkpoint as ckpt
from vlp_tpu_torch import configure_precision
from vlp_tpu_torch import optim as optim_lib
from vlp_tpu_torch import train_step as ts
from vlp_tpu_torch.cli import common
from vlp_tpu_torch.cli.decode import resolve_device, to_device
from vlp_tpu_torch.config import VLPConfig
from vlp_tpu_torch.data.dataset import CaptionExample, load_karpathy_index
from vlp_tpu_torch.data.example_builder import TrainExampleBuilder
from vlp_tpu_torch.data.features import make_store
from vlp_tpu_torch.data.loader import TrainLoader
from vlp_tpu_torch.data.tokenization import WhitespaceTokenizer
from vlp_tpu_torch.models.model import VLPModel

# parameters of the heads a BERT checkpoint lacks (reference
# optimization.py:196-201): --finetune_decay decays them toward zero
FRESH_HEADS = ("vis_embed", "vis_pe_embed", "ans_classifier")


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
                   help="not ported (fp16 + loss scaling, ROADMAP A): "
                        "raises")
    p.add_argument("--loss_scale", type=float, default=0,
                   help="only read with --true_fp16")
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
                   help="> 1 is data-parallel training, ROADMAP A10: "
                        "raises")
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
                   help="vqa2 is ROADMAP A8: raises")
    p.add_argument("--relax_projection", action="store_true")
    p.add_argument("--scst", action="store_true",
                   help="SCST is ROADMAP A9: raises")
    p.add_argument("--scst_remat", action="store_true",
                   help="only read with --scst")
    p.add_argument("--scst_replay", default="fused",
                   choices=("scan", "fused"), help="only read with --scst")
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
                        "(from its second step) -> output_dir/profile.txt")
    p.add_argument("--save_steps", type=int, default=0,
                   help="also checkpoint every N optimizer steps "
                        "(model.sN.bin/optim.sN.bin, latest 2 kept) and "
                        "resume mid-epoch from the newest one")
    p.add_argument("--device", default="cuda", type=str,
                   help="torch device: 'cuda' (kernels, bf16) or 'cpu' "
                        "(plain versions, fp32)")
    # TPU dispatch workarounds of the JAX CLI: no-ops here
    p.add_argument("--device_loop_steps", type=int, default=1,
                   help="no-op (a TPU dispatch workaround)")
    p.add_argument("--no_pallas", action="store_true",
                   help="no-op: cuda always runs the kernels, cpu their "
                        "plain versions")
    p.add_argument("--tp_impl", choices=("shard_map", "gspmd"),
                   default="shard_map", help="no-op (see --tensor_parallel)")
    p.add_argument("--jax_distributed", action="store_true",
                   help="multi-host training is ROADMAP A10: raises")
    p.add_argument("--coordinator_address", default=None,
                   help="only read with --jax_distributed")
    p.add_argument("--num_processes", type=int, default=None,
                   help="only read with --jax_distributed")
    p.add_argument("--process_id", type=int, default=None,
                   help="only read with --jax_distributed")
    p.add_argument("--tensor_parallel", type=int, default=0,
                   help="> 1 is not ported (ROADMAP A, not to port): "
                        "raises")
    return p


def refuse_unported(args) -> None:
    """Raise on a flag whose slice the port does not have yet."""
    unported = [
        (args.scst, "--scst: SCST is ROADMAP item A9"),
        (args.tasks == "vqa2", "--tasks vqa2: VQA is ROADMAP item A8"),
        (args.jax_distributed,
         "--jax_distributed: multi-process training is ROADMAP item A10"),
        (args.world_size > 1,
         "--world_size > 1: data-parallel training is ROADMAP item A10"),
        (args.tensor_parallel > 1,
         "--tensor_parallel: manual tensor parallelism is under ROADMAP A "
         "'Not to port'"),
        (args.true_fp16,
         "--true_fp16: fp16 with loss scaling is under ROADMAP A "
         "'Not to port'"),
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


def _anchors(model: VLPModel, path: str, cfg: VLPConfig):
    """--finetune_decay anchors: the model's parameters with those the
    reference .bin holds replaced by its values."""
    sd = ckpt.load_reference_bin(path, cfg, task_idx=3)
    return {n: (sd[n] if n in sd else p.detach()).float().clone()
            for n, p in model.named_parameters()}


def main(argv=None):
    """Returns ``{"losses", "step_seconds", "iter_seconds", "model"}``:
    the loss of every step taken, the seconds from a batch in hand to its
    loss on the host, the seconds between consecutive steps (loader
    included), and the trained model."""
    args = build_parser().parse_args(argv)
    refuse_unported(args)
    device = resolve_device(args.device)
    configure_precision()
    if abs(args.s2s_prob + args.bi_prob - 1.0) > 1e-6:
        raise ValueError("--s2s_prob + --bi_prob must be 1")
    args.max_seq_length = args.max_len_b + args.len_vis_input + 3
    args.mask_image_regions = args.vis_mask_prob > 0
    dtype = "bfloat16" if device.type == "cuda" else "float32"

    logger = common.setup_logging(args.output_dir, args.log_file)
    noops = [(args.device_loop_steps > 1, "--device_loop_steps"),
             (args.no_pallas, "--no_pallas"),
             (args.tp_impl != "shard_map", "--tp_impl"),
             (args.fp16 or args.amp or args.fp32_embedding,
              "--fp16/--amp/--fp32_embedding")]
    for hit, flag in noops:
        if hit:
            logger.warning("%s is a no-op in vlp_tpu_torch (activations are "
                           "%s on %s)", flag, dtype, device)
    common.dump_opts(args, args.output_dir)
    tokenizer = common.resolve_tokenizer(args.bert_model, args.do_lower_case,
                                         args.max_position_embeddings)
    data_tokenizer = (WhitespaceTokenizer() if args.tokenized_input
                      else tokenizer)
    cfg = make_config(args, len(tokenizer.vocab), dtype)
    rng_np = np.random.default_rng(args.seed)

    # ---- data ------------------------------------------------------------
    if args.synthetic_data:
        examples = synthetic_examples(
            max(args.train_batch_size * max(args.steps_per_epoch, 4), 64),
            tokenizer, rng_np)
        store = make_store(synthetic=True, num_regions=cfg.len_vis_input,
                           feat_dim=cfg.vis_feat_dim, cls_dim=cfg.vis_cls_dim)
    else:
        store = make_store(args.region_det_file_prefix, args.region_bbox_file,
                           packed_file=args.packed_feature_file)
        if not args.src_file or len(args.src_file) != 1:
            raise ValueError("--src_file takes one Karpathy-split json")
        examples = load_karpathy_index(
            args.src_file[0], args.split, data_tokenizer, args.image_root,
            args.file_valid_jpgs, args.use_num_imgs, args.dataset,
            cache_dir=args.index_cache_dir or None)
    builder_kw = dict(mask_prob=args.mask_prob,
                      vis_mask_prob=args.vis_mask_prob,
                      new_segment_ids=args.new_segment_ids,
                      always_truncate_tail=args.always_truncate_tail)
    builders = [TrainExampleBuilder(cfg, tokenizer.vocab, mode=m, **builder_kw)
                for m in ("s2s", "bi")]
    accum = max(args.gradient_accumulation_steps, 1)
    if args.train_batch_size % accum:
        raise ValueError("--train_batch_size must divide into "
                         "--gradient_accumulation_steps micro-batches")
    loader = TrainLoader(examples, store, builders,
                         [args.s2s_prob, args.bi_prob],
                         batch_size=args.train_batch_size,
                         num_workers=args.num_workers, seed=args.seed,
                         feature_slab_slots=4 + 2 + 1)
    steps_per_epoch = len(loader)
    if args.steps_per_epoch:
        steps_per_epoch = min(steps_per_epoch, args.steps_per_epoch)
    t_total = steps_per_epoch * args.num_train_epochs

    # ---- model / optimizer / resume ----------------------------------------
    model = VLPModel(cfg)
    model.init_weights(torch.Generator().manual_seed(args.seed))
    model.to(device)
    recover_step = ckpt.get_max_epoch_model(args.output_dir)
    recover_gstep = ckpt.get_latest_step_checkpoint(args.output_dir)
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
                args.model_recover_path, cfg, task_idx=3).items()})
        if missing:
            logger.info("not in the checkpoint, kept at init: %s", missing)

    params = dict(model.named_parameters())
    opt_kw = dict(warmup=args.warmup_proportion, t_total=t_total,
                  schedule=args.sche_mode, weight_decay=args.weight_decay)
    if args.finetune_decay:
        if not args.model_recover_path:
            raise ValueError("--finetune_decay needs --model_recover_path "
                             "(the weights to decay toward)")
        optimizer = optim_lib.bert_adam_finetune(
            params, args.learning_rate,
            init_params=_anchors(model, args.model_recover_path, cfg),
            missing_key_substrings=FRESH_HEADS, **opt_kw)
    else:
        optimizer = optim_lib.BertAdam(params, args.learning_rate, **opt_kw)
    if tag is not None:
        ckpt.restore_optimizer(args.output_dir, tag, optimizer)
    train_step = ts.make_train_step(
        model, optimizer, mask_image_regions=args.mask_image_regions,
        grad_accum=accum)

    result = {"losses": [], "step_seconds": [], "iter_seconds": [],
              "model": model}
    if not args.do_train:
        return result
    logger.info("***** Running training on %s (%s) *****", device, dtype)
    logger.info("  Batch size = %d  Num steps = %d", args.train_batch_size,
                t_total)
    last_save = (start_epoch - 1) * steps_per_epoch + skip_batches
    profiler = None
    with open(os.path.join(args.output_dir, "metrics.jsonl"), "a") as mf:
        for i_epoch in range(start_epoch, args.num_train_epochs + 1):
            losses = []
            t_ep = t_prev = time.perf_counter()
            skip = skip_batches if i_epoch == start_epoch else 0
            for step_i, batch in enumerate(
                    loader.epoch(i_epoch - 1, start_batch=skip), start=skip):
                if args.steps_per_epoch and step_i >= args.steps_per_epoch:
                    break
                if (args.profile_steps and i_epoch == start_epoch
                        and step_i == skip + 1):
                    profiler = _start_profiler()
                t0 = time.perf_counter()
                tbatch = to_device(batch, device)
                ratio = (args.max_drop_worst_ratio
                         if i_epoch > args.drop_after else 0.0)
                # the step's dropout follows from (seed, epoch, step), so a
                # resumed run draws what an uninterrupted one would
                metrics = train_step(
                    tbatch, ts.step_seed(args.seed + 1,
                                         i_epoch * 100000 + step_i), ratio)
                loss = float(metrics["loss"])
                t1 = time.perf_counter()
                result["step_seconds"].append(t1 - t0)
                result["iter_seconds"].append(t1 - t_prev)
                t_prev = t1
                losses.append(loss)
                result["losses"].append(loss)
                if (profiler is not None
                        and step_i == skip + args.profile_steps):
                    _stop_profiler(profiler, args.output_dir)
                    profiler = None
                gdone = (i_epoch - 1) * steps_per_epoch + step_i + 1
                if args.save_steps and gdone - last_save >= args.save_steps:
                    ckpt.save_step_checkpoint(args.output_dir, gdone, model,
                                              optimizer)
                    last_save = gdone
                if step_i % 100 == 0:
                    logger.info("Epoch %d, Iter %d, Loss %.2f", i_epoch,
                                step_i, float(np.mean(losses)))
                    rec = {"epoch": i_epoch, "step": step_i,
                           "time": time.time()}
                    rec.update({k: float(v) for k, v in metrics.items()})
                    mf.write(json.dumps(rec) + "\n")
                    mf.flush()
            if profiler is not None:
                _stop_profiler(profiler, args.output_dir)
                profiler = None
            logger.info("Epoch %d done in %.1fs, mean loss %.4f", i_epoch,
                        time.perf_counter() - t_ep,
                        float(np.mean(losses)) if losses else float("nan"))
            ckpt.save_checkpoint(args.output_dir, i_epoch, model, optimizer)
    return result


def _start_profiler():
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(ProfilerActivity.CUDA)
    prof = profile(activities=acts)
    prof.__enter__()
    return prof, time.perf_counter()


def _stop_profiler(profiler, output_dir: str) -> None:
    """Write the profiled window's wall time, summed device time and
    busy share, then the per-op table sorted by device time."""
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
        f.write(events.table(sort_by=key, row_limit=40))


if __name__ == "__main__":
    main()
