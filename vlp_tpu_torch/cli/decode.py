"""Caption decoding CLI on PyTorch (counterpart of ``vlp_tpu/cli/decode.py``).

Same flag surface as the reference ``decode_img2txt.py`` and the JAX CLI,
minus the TPU-only ``--approx_topk/--topk_impl/--topk_block/--reorder_impl/
--no_pallas``, plus ``--device`` (default ``cuda``).  On CUDA the model runs
bf16 activations through the hand-written kernels; on CPU it runs fp32
through their plain versions.  ``--device cuda`` without a GPU raises.

    python -m vlp_tpu_torch.cli.decode --bert_model vocab.txt \\
        --model_recover_path 'model.*.bin' --new_segment_ids --enable_butd \\
        --beam_size 5 --max_tgt_length 20 --forbid_duplicate_ngrams ...
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
from vlp_tpu_torch.cli import common
from vlp_tpu_torch.config import VLPConfig
from vlp_tpu_torch.data.dataset import CaptionExample, load_eval_index
from vlp_tpu_torch.data.example_builder import DecodeExampleBuilder
from vlp_tpu_torch.data.features import make_store
from vlp_tpu_torch.data.loader import EvalLoader
from vlp_tpu_torch.data.tokenization import detokenize
from vlp_tpu_torch.decode import DecodeParams, Decoder
from vlp_tpu_torch.models.model import VLPModel


def build_parser():
    p = argparse.ArgumentParser()
    p.add_argument("--config_path", default=None, type=str)
    p.add_argument("--bert_model", default="bert-base-cased", type=str)
    p.add_argument("--model_recover_path", default=None, type=str,
                   help="reference-format .bin checkpoint(s), glob allowed")
    p.add_argument("--max_position_embeddings", type=int, default=512)
    p.add_argument("--fp16", action="store_true",
                   help="no-op: the activation dtype follows --device "
                        "(bf16 on cuda, fp32 on cpu)")
    p.add_argument("--amp", action="store_true", help="no-op, as --fp16")
    p.add_argument("--seed", type=int, default=123)
    p.add_argument("--do_lower_case", action="store_true")
    p.add_argument("--new_segment_ids", action="store_true")
    p.add_argument("--batch_size", type=int, default=4)
    p.add_argument("--beam_size", type=int, default=1)
    p.add_argument("--length_penalty", type=float, default=0)
    p.add_argument("--forbid_duplicate_ngrams", action="store_true")
    p.add_argument("--forbid_ignore_word", type=str, default=None)
    p.add_argument("--min_len", default=None, type=int)
    p.add_argument("--ngram_size", type=int, default=3)
    p.add_argument("--max_tgt_length", type=int, default=20)
    p.add_argument("--src_file", default=None, type=str)
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
    p.add_argument("--file_valid_jpgs", default="", type=str)
    p.add_argument("--ann_file", default="", type=str,
                   help="caption annotations for metric eval (COCO or "
                        "Karpathy json); empty = skip metrics")
    p.add_argument("--output_dir", default="eval_results", type=str)
    p.add_argument("--synthetic_data", action="store_true")
    p.add_argument("--num_synthetic", type=int, default=16)
    p.add_argument("--device", default="cuda", type=str,
                   help="torch device: 'cuda' (kernels, bf16) or 'cpu' "
                        "(plain versions, fp32)")
    return p


def make_config(args, vocab_size: int, dtype: str) -> VLPConfig:
    """The decode part of the JAX train CLI's ``make_config``, JAX-free.
    The relax projection is collapsed to the task head at load time (the
    reference decoder's from_pretrained surgery), so the head here has one
    projection."""
    cfg = VLPConfig(
        vocab_size=vocab_size,
        type_vocab_size=6 if args.new_segment_ids else 2,
        relax_projection=0,
        label_smoothing=0.0,
        hidden_dropout_prob=args.drop_prob,
        attention_probs_dropout_prob=args.drop_prob,
        len_vis_input=args.len_vis_input,
        max_len_b=args.max_tgt_length,
        max_pred=3,
        dtype=dtype,
        use_pallas_attention=False,
    )
    if args.max_position_embeddings:
        cfg = cfg.replace(max_position_embeddings=args.max_position_embeddings)
    if args.config_path:
        cfg = VLPConfig.from_reference_json(
            args.config_path, **{k: getattr(cfg, k) for k in (
                "type_vocab_size", "relax_projection", "label_smoothing",
                "len_vis_input", "max_len_b", "max_pred", "dtype",
                "use_pallas_attention")})
    return cfg


def resolve_device(name: str) -> torch.device:
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda but torch.cuda.is_available() is "
                           "False; pass --device cpu to decode on the CPU")
    if device.type not in ("cuda", "cpu"):
        raise ValueError(f"unsupported --device {name!r}")
    return device


def to_device(batch, device) -> dict:
    """Copy a loader batch to ``device``.  Always a copy: the loader reuses
    its feature slabs, and on the CPU ``torch.from_numpy`` would alias
    them."""
    return {k: torch.from_numpy(np.asarray(v)).to(device, copy=True)
            for k, v in batch.items()}


def main(argv=None):
    args = build_parser().parse_args(argv)
    device = resolve_device(args.device)
    configure_precision()
    dtype = "bfloat16" if device.type == "cuda" else "float32"
    args.max_seq_length = args.max_tgt_length + args.len_vis_input + 3

    tokenizer = common.resolve_tokenizer(args.bert_model, args.do_lower_case,
                                         args.max_seq_length)
    cfg = make_config(args, vocab_size=len(tokenizer.vocab), dtype=dtype)
    sp = tokenizer.vocab

    forbid_ignore_ids = ()
    if args.forbid_ignore_word:
        w_list = [w.upper() if w.startswith("[") and w.endswith("]") else w
                  for w in args.forbid_ignore_word.split("|")]
        forbid_ignore_ids = tuple(tokenizer.convert_tokens_to_ids(w_list))

    if args.synthetic_data:
        eval_list = [CaptionExample(f"synthetic_{i}.npy", [], image_id=i)
                     for i in range(args.num_synthetic)]
        store = make_store(synthetic=True, num_regions=cfg.len_vis_input,
                           feat_dim=cfg.vis_feat_dim, cls_dim=cfg.vis_cls_dim)
    else:
        eval_list = load_eval_index(args.src_file, args.split,
                                    args.image_root, args.dataset,
                                    args.file_valid_jpgs)
        store = make_store(args.region_det_file_prefix, args.region_bbox_file,
                           packed_file=args.packed_feature_file)

    builder = DecodeExampleBuilder(cfg, tokenizer.vocab,
                                   new_segment_ids=args.new_segment_ids,
                                   max_tgt_length=args.max_tgt_length)
    dp = DecodeParams(
        mask_id=sp["[MASK]"], eos_id=sp["[SEP]"], pad_id=sp["[PAD]"],
        beam_size=args.beam_size, length_penalty=args.length_penalty,
        forbid_duplicate_ngrams=args.forbid_duplicate_ngrams,
        ngram_size=args.ngram_size, min_len=args.min_len or 0,
        max_tgt_length=args.max_tgt_length,
        forbid_ignore_ids=forbid_ignore_ids)

    all_stats = {}
    paths = (sorted(glob.glob(args.model_recover_path.strip()))
             if args.model_recover_path else [None])
    if args.model_recover_path and not paths:
        raise FileNotFoundError(args.model_recover_path)
    for model_recover_path in paths:
        model = VLPModel(cfg)
        model.init_weights(torch.Generator().manual_seed(args.seed))
        if model_recover_path:
            print(f"***** Recover model: {model_recover_path} *****")
            if os.path.isdir(model_recover_path):
                raise NotImplementedError(
                    "the torch port loads reference .bin checkpoints; "
                    f"{model_recover_path} is a JAX orbax directory")
            ckpt.load_into(model, ckpt.load_reference_bin(
                model_recover_path, cfg, task_idx=3))
        model = model.to(device).cast_for_inference().eval()
        decoder = Decoder(model, cfg, dp)

        loader = EvalLoader(eval_list, store, builder, args.batch_size,
                            feature_slab_slots=3, prefetch=True)
        output = {}
        t0 = time.time()
        for batch, chunk, _pad in loader:
            tbatch = to_device(batch, device)
            if args.beam_size > 1:
                out_ids = decoder.beam_search(tbatch)["pred_seq"]
            else:
                out_ids = decoder.greedy(tbatch)[0].cpu().numpy()
            for i, ex in enumerate(chunk):
                toks = tokenizer.convert_ids_to_tokens(
                    [int(x) for x in out_ids[i]])
                words = []
                for t in toks:
                    if t in ("[SEP]", "[PAD]"):
                        break
                    words.append(t)
                output[ex.image_id] = " ".join(detokenize(words))
        dt = time.time() - t0
        n_done = len(output)
        print(f"decoded {n_done} images in {dt:.1f}s "
              f"({n_done / max(dt, 1e-9):.1f} img/s) on {device}")

        predictions = [{"image_id": iid, "caption": cap}
                       for iid, cap in output.items()]
        os.makedirs(args.output_dir, exist_ok=True)
        tag = os.path.basename(model_recover_path or "random")
        pred_file = os.path.join(args.output_dir,
                                 f"preds-{tag}-{args.split}.json")
        with open(pred_file, "w") as f:
            json.dump(predictions, f)
        print("predictions ->", pred_file)

        stats = {"n_images": n_done, "decode_seconds": dt}
        if args.ann_file:
            from vlp_tpu_torch.evals.coco import language_eval
            metrics = language_eval(args.ann_file, predictions, tag,
                                    args.split, args.output_dir)
            print(json.dumps(metrics, indent=2))
            stats.update(metrics)
        all_stats[tag] = stats
    return all_stats


if __name__ == "__main__":
    main()
