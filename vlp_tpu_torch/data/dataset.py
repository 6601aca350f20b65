"""Dataset indexes: Karpathy-format captions and pythia VQA imdb.

Parity with ``Img2txtDataset`` (reference vlp/seq2seq_loader.py:62-176):
builds an in-memory example list of (feature_key, caption_tokens, answers)
from the Karpathy JSON (``images[].sentences[].raw``, ``split``, ``filename``)
or the VQA imdb ``.npy``.  Image-validity checking by decoding JPEGs is
dropped (the TPU build consumes pre-extracted region features only — the
reference asserts ``enable_butd`` upstream, run_img2txt_dist.py:199); the
``file_valid_jpgs`` cache file is still honored as a filter when provided.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass
from typing import List, Optional, Sequence

import numpy as np


@dataclass
class CaptionExample:
    feature_key: str          # image id / feature path stem
    tokens: List[str]         # tokenized caption
    image_id: int = -1
    answers: Optional[list] = None


def _index_cache_path(cache_dir: str, src_file: str, split: Sequence[str],
                      tokenizer, image_root: str,
                      file_valid_jpgs: Optional[str], use_num_imgs: int,
                      dataset: str) -> str:
    """Cache key: source file identity (path+mtime+size), tokenizer identity
    (vocab content + lowercasing), and every argument that shapes the list."""
    import hashlib
    st = os.stat(src_file)
    h = hashlib.sha1()
    vocab_h = hashlib.sha1(
        "\n".join(tokenizer.vocab.keys()).encode()).hexdigest()
    lower = getattr(getattr(tokenizer, "basic_tokenizer", None),
                    "do_lower_case", None)
    for part in (os.path.abspath(src_file), st.st_mtime_ns, st.st_size,
                 tuple(sorted(split)), image_root, file_valid_jpgs or "",
                 use_num_imgs, dataset, vocab_h, lower):
        h.update(repr(part).encode())
    return os.path.join(cache_dir, f"karpathy-{h.hexdigest()[:20]}.pkl")


def load_karpathy_index(src_file: str, split: Sequence[str],
                        tokenizer, image_root: str = "",
                        file_valid_jpgs: Optional[str] = None,
                        use_num_imgs: int = -1,
                        dataset: str = "coco",
                        cache_dir: Optional[str] = None
                        ) -> List[CaptionExample]:
    """One example per (image, sentence) pair, like seq2seq_loader.py:123-140.

    ``cache_dir`` (opt-in) caches the TOKENIZED index: tokenizing ~3M
    Conceptual Captions sentences costs ~5 min of single-core Python at
    every restart otherwise.  The key includes the source file's
    mtime+size and the tokenizer's vocab hash, so edits invalidate it.
    """
    cache_path = None
    if cache_dir:
        os.makedirs(cache_dir, exist_ok=True)
        cache_path = _index_cache_path(cache_dir, src_file, split, tokenizer,
                                       image_root, file_valid_jpgs,
                                       use_num_imgs, dataset)
        if os.path.exists(cache_path):
            import pickle
            try:
                with open(cache_path, "rb") as f:
                    return pickle.load(f)
            except Exception:
                pass  # corrupt/partial cache: rebuild
    with open(src_file, "r", encoding="utf-8") as f:
        img_dat = json.load(f)["images"]
    valid = None
    if file_valid_jpgs and os.path.isfile(file_valid_jpgs):
        valid = set(json.load(open(file_valid_jpgs)))
    out: List[CaptionExample] = []
    counter = 0
    for src in img_dat:
        if src["split"] not in split:
            continue
        if use_num_imgs != -1 and counter >= use_num_imgs:
            break
        if valid is not None and src["filename"] not in valid:
            continue
        key = os.path.join(image_root, src.get("filepath", "trainval"),
                           src["filename"][:-4] + ".npy")
        image_id = _image_id(src, dataset)
        for sent in src["sentences"]:
            toks = tokenizer.tokenize(sent["raw"])
            assert len(toks) > 0
            out.append(CaptionExample(key, toks, image_id=image_id))
        counter += 1
    if cache_path:
        import pickle
        tmp = cache_path + f".tmp{os.getpid()}"
        with open(tmp, "wb") as f:
            pickle.dump(out, f, protocol=pickle.HIGHEST_PROTOCOL)
        os.replace(tmp, cache_path)  # atomic: concurrent hosts race safely
    return out


def _image_id(src: dict, dataset: str) -> int:
    """decode_img2txt.py:199-204 id extraction."""
    try:
        if dataset == "coco":
            return int(src["filename"].split("_")[2][:-4])
        if dataset == "cc":
            return int(src["imgid"])
        if dataset == "flickr30k":
            return int(src["filename"].split(".")[0])
    except (KeyError, ValueError, IndexError):
        pass
    return int(src.get("imgid", -1))


def load_eval_index(src_file: str, split: str, image_root: str = "",
                    dataset: str = "coco",
                    file_valid_jpgs: Optional[str] = None
                    ) -> List[CaptionExample]:
    """Decode-time list: one entry per image (decode_img2txt.py:187-207)."""
    with open(src_file, "r", encoding="utf-8") as f:
        img_dat = json.load(f)["images"]
    valid = None
    if file_valid_jpgs and dataset not in ("coco", "flickr30k") \
            and os.path.isfile(file_valid_jpgs):
        valid = set(json.load(open(file_valid_jpgs)))
    out = []
    for src in img_dat:
        if src["split"] != split:
            continue
        if valid is not None and src["filename"] not in valid:
            continue
        key = os.path.join(image_root, src.get("filepath", "trainval"),
                           src["filename"][:-4] + ".npy")
        out.append(CaptionExample(key, [], image_id=_image_id(src, dataset)))
    return out


def load_vqa_index(src_files: Sequence[str], tokenizer,
                   image_root: str = "", use_num_imgs: int = -1
                   ) -> List[CaptionExample]:
    """VQA imdb .npy index (seq2seq_loader.py:141-156)."""
    out: List[CaptionExample] = []
    counter = 0
    for file_s in src_files:
        img_dat = np.load(file_s, allow_pickle=True)
        assert img_dat[0]["has_answer"] is True
        for i in range(1, img_dat.shape[0]):
            if use_num_imgs != -1 and counter >= use_num_imgs:
                break
            rec = img_dat[i]
            key = os.path.join(image_root, rec["image_name"].split("_")[1],
                               rec["feature_path"])
            out.append(CaptionExample(
                key, tokenizer.tokenize(rec["question_str"]),
                image_id=int(rec.get("image_id", -1)),
                answers=list(rec["answers"])))
            counter += 1
    return out
