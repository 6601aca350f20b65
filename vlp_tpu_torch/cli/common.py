"""Shared CLI plumbing: tokenizer/vocab resolution, stores, logging."""

from __future__ import annotations

import json
import logging
import os
from typing import Optional

from vlp_tpu_torch.data.tokenization import BertTokenizer


def setup_logging(output_dir: str, log_file: str) -> logging.Logger:
    os.makedirs(output_dir, exist_ok=True)
    logger = logging.getLogger("vlp_tpu")
    logger.setLevel(logging.INFO)
    # reconfigure per call (basicConfig would be a once-per-process no-op)
    for h in list(logger.handlers):
        logger.removeHandler(h)
    fmt = logging.Formatter(
        "%(asctime)s - %(levelname)s - %(name)s -   %(message)s",
        datefmt="%m/%d/%Y %H:%M:%S")
    fh = logging.FileHandler(os.path.join(output_dir, log_file), mode="w")
    fh.setFormatter(fmt)
    logger.addHandler(fh)
    logger.addHandler(logging.StreamHandler())
    return logger


def resolve_tokenizer(bert_model: str, do_lower_case: bool,
                      max_len: Optional[int] = None) -> BertTokenizer:
    """``bert_model`` must be a local vocab.txt path or a directory holding
    one (model-hub downloads are not available in air-gapped TPU pods)."""
    path = bert_model
    if os.path.isdir(path):
        path = os.path.join(path, "vocab.txt")
    if not os.path.isfile(path):
        raise FileNotFoundError(
            f"vocab file not found: {bert_model!r}. Pass --bert_model as a "
            "local vocab.txt (or a directory containing one).")
    return BertTokenizer(path, do_lower_case=do_lower_case, max_len=max_len)


def write_synthetic_vocab(path: str, extra_words=(), size: int = 200):
    """Small BERT-style vocab for smoke tests / synthetic runs."""
    words = ["[PAD]"] + [f"[unused{i}]" for i in range(1, 12)]
    words += ["[UNK]", "[CLS]", "[SEP]", "[MASK]"]
    words += list(extra_words)
    i = 0
    while len(words) < size:
        words.append(f"tok{i}")
        i += 1
    with open(path, "w") as f:
        f.write("\n".join(words) + "\n")
    return path


def dump_opts(args, output_dir: str):
    os.makedirs(output_dir, exist_ok=True)
    with open(os.path.join(output_dir, "opt.json"), "w") as f:
        json.dump(vars(args), f, sort_keys=True, indent=2, default=str)
