"""VQA 2.0 evaluation CLI on PyTorch (counterpart of
``vlp_tpu/cli/eval_vqa2.py``, the reference ``eval_vqa2.py``): the bi-mode
pipeline with no masked-LM targets, one ``VLPModel.vqa_inference`` argmax
per batch, and the native VQA accuracy (``evals/vqa.py``).

    python -m vlp_tpu_torch.cli.eval_vqa2 --bert_model vocab.txt \\
        --answer_vocab_file answers.txt --model_recover_path 'model.*.bin' \\
        --new_segment_ids --enable_butd --src_file imdb_val.npy \\
        --ref_file v2_mscoco_val2014_annotations.json --batch_size 256 ...

It runs on the card unless called with ``--device cpu``: bf16 activations
through the hand-written attention kernel on ``cuda``, fp32 through its
plain version on ``cpu``; ``--device cuda`` without a GPU raises.  It reads
reference ``.bin`` checkpoints (the relax projection collapses to head 0);
a JAX orbax directory raises with the remedy, ``python -m
vlp_tpu.cli.convert --direction jax2torch`` (``checkpoint.require_bin``).  Under torchrun
(``torchrun --nproc_per_node=N -m vlp_tpu_torch.cli.eval_vqa2 ...``) it
evaluates data parallel, one process per GPU (the JAX CLI's
``shard_map``): rank r answers the r-th contiguous slice of the questions
(ceil-split), and rank 0 gathers the answers, writes them in the
single-process order and scores them.
``--no_pallas``, ``--fp16`` and ``--amp`` are no-ops and say so.  The
decode-only flags of the reference CLI are accepted and unused.
``--profile_batches N`` writes a ``torch.profiler`` table of N batches to
``output_dir/profile.txt``, as the train CLI's ``--profile_steps``.
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import time

import numpy as np
import torch

from vlp_tpu_torch import checkpoint as ckpt
from vlp_tpu_torch import configure_precision
from vlp_tpu_torch import parallel
from vlp_tpu_torch.cli import common
from vlp_tpu_torch.cli.decode import resolve_device, to_device
from vlp_tpu_torch.cli.train import make_config, start_profiler, stop_profiler
from vlp_tpu_torch.data.dataset import CaptionExample, load_vqa_index
from vlp_tpu_torch.data.example_builder import TrainExampleBuilder
from vlp_tpu_torch.data.features import make_store
from vlp_tpu_torch.evals.vqa import (VQAAnswerProcessor,
                                     load_vqa_annotations, vqa_accuracy)
from vlp_tpu_torch.models.model import VLPModel

# the batch entries the encode reads
MODEL_KEYS = ("input_ids", "segment_ids", "mode", "text_end")


def build_parser():
    p = argparse.ArgumentParser()
    p.add_argument("--bert_model", default="bert-base-cased", type=str)
    p.add_argument("--model_recover_path", default=None, type=str,
                   help="reference-format .bin checkpoint(s), glob allowed")
    p.add_argument("--fp16", action="store_true",
                   help="no-op: the activation dtype follows --device "
                        "(bf16 on cuda, fp32 on cpu)")
    p.add_argument("--amp", action="store_true", help="no-op, as --fp16")
    p.add_argument("--seed", type=int, default=123)
    p.add_argument("--do_lower_case", action="store_true")
    p.add_argument("--new_segment_ids", action="store_true")
    p.add_argument("--batch_size", type=int, default=4)
    p.add_argument("--max_tgt_length", type=int, default=20)
    # decode-only flags of the reference CLI (eval_vqa2.py:76-86), unused
    p.add_argument("--beam_size", type=int, default=1)
    p.add_argument("--length_penalty", type=float, default=0)
    p.add_argument("--forbid_duplicate_ngrams", action="store_true")
    p.add_argument("--forbid_ignore_word", type=str, default=None)
    p.add_argument("--min_len", default=None, type=int)
    p.add_argument("--ngram_size", type=int, default=3)
    p.add_argument("--file_valid_jpgs", default="", type=str)
    p.add_argument("--src_file", default=None, type=str)
    p.add_argument("--ref_file", default="", type=str,
                   help="v2_mscoco_*_annotations.json for local scoring")
    p.add_argument("--dataset", default="coco", type=str)
    p.add_argument("--len_vis_input", type=int, default=100)
    p.add_argument("--image_root", type=str, default="")
    p.add_argument("--split", type=str, default="val")
    p.add_argument("--drop_prob", default=0.1, type=float)
    p.add_argument("--enable_butd", action="store_true")
    p.add_argument("--region_bbox_file", default="", type=str)
    p.add_argument("--region_det_file_prefix", default="", type=str)
    p.add_argument("--packed_feature_file", default="", type=str,
                   help="native packed feature store (.vlps)")
    p.add_argument("--output_dir", default="tmp", type=str)
    p.add_argument("--answer_vocab_file", required=True, type=str)
    p.add_argument("--synthetic_data", action="store_true")
    p.add_argument("--num_synthetic", type=int, default=16)
    p.add_argument("--no_pallas", action="store_true",
                   help="no-op: cuda always runs the kernel, cpu its plain "
                        "version")
    p.add_argument("--config_path", default=None, type=str)
    p.add_argument("--device", default="cuda", type=str,
                   help="torch device: 'cuda' (kernels, bf16) or 'cpu' "
                        "(plain versions, fp32)")
    p.add_argument("--profile_batches", type=int, default=0,
                   help="torch.profiler over N batches of the first "
                        "checkpoint (from its second batch) -> "
                        "output_dir/profile.txt")
    return p


def main(argv=None, dist: parallel.Dist = None):
    """Writes ``vqa2-results-{tag}-{split}.json`` per checkpoint and returns
    ``{tag: {"n_questions", "eval_seconds", **accuracy}}`` (the accuracy
    with ``--ref_file``; on ranks other than 0: their own share, no
    accuracy).  A caller may pass its own group as ``dist``; otherwise
    torchrun's environment decides (``parallel.from_cli``)."""
    args = build_parser().parse_args(argv)
    if dist is not None:
        return evaluate(args, dist)
    dist = parallel.from_cli(resolve_device(args.device))
    try:
        return evaluate(args, dist)
    finally:
        dist.destroy()


def evaluate(args, dist: parallel.Dist):
    """``main`` on this rank of ``dist``."""
    device = dist.device
    configure_precision()
    dtype = "bfloat16" if device.type == "cuda" else "float32"
    for hit, flag in ((args.no_pallas, "--no_pallas"),
                      (args.fp16 or args.amp, "--fp16/--amp")):
        if hit:
            print(f"{flag} is a no-op in vlp_tpu_torch (activations are "
                  f"{dtype} on {device})")
    args.max_seq_length = args.max_tgt_length + args.len_vis_input + 3
    args.label_smoothing = 0
    args.max_len_b = args.max_tgt_length
    args.max_pred = 0
    args.relax_projection = False
    args.vis_mask_prob = 0
    args.max_position_embeddings = 512

    tokenizer = common.resolve_tokenizer(args.bert_model, args.do_lower_case,
                                         args.max_seq_length)
    cfg = make_config(args, len(tokenizer.vocab), dtype)
    ans_proc = VQAAnswerProcessor(args.answer_vocab_file)
    cfg = cfg.replace(num_answers=len(ans_proc))

    if args.synthetic_data:
        rng_np = np.random.default_rng(args.seed)
        words = [w for w in tokenizer.vocab_words if not w.startswith("[")]
        eval_list = []
        for i in range(args.num_synthetic):
            q = [words[rng_np.integers(0, len(words))] for _ in range(6)]
            ex = CaptionExample(f"synthetic_{i}.npy", q, image_id=i)
            ex.question_id = i
            eval_list.append(ex)
        store = make_store(synthetic=True, num_regions=cfg.len_vis_input,
                           feat_dim=cfg.vis_feat_dim, cls_dim=cfg.vis_cls_dim)
    else:
        eval_list = load_vqa_index([args.src_file], tokenizer,
                                   args.image_root)
        for i, ex in enumerate(eval_list):
            ex.question_id = getattr(ex, "question_id", i)
        store = make_store(args.region_det_file_prefix, args.region_bbox_file,
                           packed_file=args.packed_feature_file)

    # bi mode, no masked positions, always_truncate_tail (reference
    # eval_vqa2.py:138-144); the arrays keep width 1, the cap disables
    # masking
    builder = TrainExampleBuilder(
        cfg.replace(max_pred=1), tokenizer.vocab, mode="bi", mask_prob=0.0,
        max_pred=0, new_segment_ids=args.new_segment_ids,
        always_truncate_tail=True, load_vqa_ann=True)

    paths = (sorted(glob.glob(args.model_recover_path.strip()))
             if args.model_recover_path else [None])
    if args.model_recover_path and not paths:
        raise FileNotFoundError(args.model_recover_path)
    all_stats = {}
    for model_recover_path in paths:
        model = VLPModel(cfg, with_vqa=True)
        model.init_weights(torch.Generator().manual_seed(args.seed))
        if model_recover_path:
            print(f"***** Recover model: {model_recover_path} *****")
            ckpt.load_into(model, ckpt.load_reference_bin(
                model_recover_path, cfg, task_idx=0))
        model = model.to(device).cast_for_inference().eval()

        predictions = []
        rng_np = np.random.default_rng(args.seed)
        B = args.batch_size
        share = dist.shard(len(eval_list))
        mine = eval_list[share.start:share.stop]
        # two recycled feature slabs: fresh ~1.4 MB allocations per example
        # cost first-touch page faults, and each batch is copied to the
        # device before the next one is built
        slabs = None
        if mine:
            f0, p0 = store.get(mine[0].feature_key)
            slabs = [(np.empty((B,) + f0.shape, f0.dtype),
                      np.empty((B,) + p0.shape, p0.dtype)) for _ in range(2)]

        def flush(pending):
            ans_idx = pending[0].cpu().numpy()  # waits for the batch
            for i, ex in enumerate(pending[1]):
                predictions.append({
                    "question_id": getattr(ex, "question_id",
                                           pending[2] + i),
                    "answer": ans_proc.idx2word(ans_idx[i])})

        # the result fetch trails the dispatch by one batch, so the host
        # builds batch i+1 while the card runs batch i
        pending = profiler = None
        os.makedirs(args.output_dir, exist_ok=True)
        t0 = time.time()
        with torch.no_grad():
            for bi, lo in enumerate(range(0, len(mine), B)):
                if (args.profile_batches and bi == 1 and not all_stats
                        and dist.is_main):
                    profiler = start_profiler()
                chunk = mine[lo:lo + B]
                fs, ps = slabs[bi % 2]
                exs = []
                for j, ex in enumerate(chunk):
                    if hasattr(store, "get_into"):
                        store.get_into(ex.feature_key, fs[j], ps[j])
                    else:
                        fs[j], ps[j] = store.get(ex.feature_key)
                    exs.append(builder(ex.tokens, fs[j], ps[j], rng_np))
                for j in range(len(chunk), B):  # the tail pads in place
                    fs[j] = fs[len(chunk) - 1]
                    ps[j] = ps[len(chunk) - 1]
                exs += [exs[-1]] * (B - len(exs))
                batch = {k: np.stack([e[k] for e in exs]) for k in MODEL_KEYS}
                batch["vis_feats"], batch["vis_pe"] = fs, ps
                out = model.vqa_inference(to_device(batch, device))
                if pending is not None:
                    flush(pending)
                pending = (out, chunk, share.start + lo)
                if profiler is not None and bi == args.profile_batches:
                    stop_profiler(profiler, args.output_dir)
                    profiler = None
            if pending is not None:
                flush(pending)
            if profiler is not None:
                stop_profiler(profiler, args.output_dir)
        parts = dist.gather_objects(predictions)
        dt = time.time() - t0
        tag = os.path.basename(model_recover_path or "random")
        if not dist.is_main:
            all_stats[tag] = {"n_questions": len(predictions),
                              "eval_seconds": dt}
            continue
        predictions = [p for part in parts for p in part]
        print(f"answered {len(predictions)} questions in {dt:.1f}s "
              f"({len(predictions) / max(dt, 1e-9):.1f} q/s) on {device}")

        results_file = os.path.join(
            args.output_dir, f"vqa2-results-{tag}-{args.split}.json")
        with open(results_file, "w") as f:
            json.dump(predictions, f)
        print("predictions ->", results_file)

        stats = {"n_questions": len(predictions), "eval_seconds": dt}
        if args.split == "test2015":
            print("[WARNING] test split: submit", results_file,
                  "to the EvalAI VQA 2.0 server")
        elif args.ref_file:
            acc = vqa_accuracy(predictions,
                               load_vqa_annotations(args.ref_file))
            print(json.dumps(acc, indent=2))
            stats.update(acc)
        all_stats[tag] = stats
    return all_stats


if __name__ == "__main__":
    main()
