"""The raw inputs of a run, made from its seed: a BERT-style vocabulary,
region features, class probabilities and boxes for each image, captions
or questions of wordpieces, and VQA soft answer scores.  All synthetic;
the same seed gives the same inputs.

The region arrays are drawn on the device with one ``torch.Generator`` in
a few large calls and kept on the host in float16, the precision of the
packed store the runs read.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

SPECIALS = {0: "[PAD]", 100: "[UNK]", 101: "[CLS]", 102: "[SEP]",
            103: "[MASK]"}
FIRST_WORD = 104        # ids below are specials and [unused] slots
IMAGE_CHUNK = 64        # images drawn per generator call


@dataclasses.dataclass
class Inputs:
    vocab: List[str]                 # id -> wordpiece
    feat: Optional[np.ndarray]       # fp16 [N, regions, feat_dim]
    cls: Optional[np.ndarray]        # fp16 [N, regions, cls_dim]
    bbox: Optional[np.ndarray]       # fp16 [N, regions, 6]
    example_image: np.ndarray        # int [E]: each example's image
    example_tokens: List[List[str]]  # [E] caption / question wordpieces
    ans_scores: Optional[list]       # [E] fp32 [num_answers] or None
    loader_seed: int

    @property
    def vocab_index(self):
        return {w: i for i, w in enumerate(self.vocab)}

    @property
    def n_images(self) -> int:
        return self.feat.shape[0]

    def keys(self) -> List[str]:
        return [image_key(i) for i in range(self.n_images)]


def image_key(i: int) -> str:
    return f"{i:012d}"


def make_vocab(size: int) -> List[str]:
    return [SPECIALS.get(i, f"[unused{i}]" if i < FIRST_WORD else f"w{i}")
            for i in range(size)]


def make_images(n: int, cfg: dict, seed: int, device):
    """fp16 host arrays (feat, cls, bbox) of ``n`` images: ReLU'd normal
    features, softmax class probabilities, boxes inside 640 x 480 with a
    detection confidence in column 5."""
    nr, fd, cd = cfg["len_vis_input"], cfg["vis_feat_dim"], cfg["vis_cls_dim"]
    g = torch.Generator(device=device).manual_seed(seed)
    feat = np.empty((n, nr, fd), np.float16)
    cls = np.empty((n, nr, cd), np.float16)
    bbox = np.empty((n, nr, 6), np.float16)
    for lo in range(0, n, IMAGE_CHUNK):
        k = min(IMAGE_CHUNK, n - lo)
        f = torch.randn((k, nr, fd), generator=g, device=device).relu_()
        c = torch.softmax(2.0 * torch.randn((k, nr, cd), generator=g,
                                            device=device), dim=-1)
        u = torch.rand((k, nr, 5), generator=g, device=device)
        x1, y1 = u[..., 0] * 500, u[..., 1] * 380
        w, h = 10 + u[..., 2] * 130, 10 + u[..., 3] * 100
        b = torch.stack([x1, y1, x1 + w, y1 + h, w * h,
                         0.2 + 0.8 * u[..., 4]], dim=-1)
        feat[lo:lo + k] = f.half().cpu().numpy()
        cls[lo:lo + k] = c.half().cpu().numpy()
        bbox[lo:lo + k] = b.half().cpu().numpy()
    return feat, cls, bbox


def vqa_soft_scores(answers: List[int], n_answers: int) -> np.ndarray:
    """VQA 2.0's soft target of ten human answers: for each distinct
    answer, the mean over leave-one-out subsets of min(1, matches / 3)."""
    out = np.zeros(n_answers, np.float32)
    for a in set(answers):
        accs = [min(1.0, (answers[:i] + answers[i + 1:]).count(a) / 3.0)
                for i in range(len(answers))]
        out[a] = float(np.mean(accs))
    return out


def make_inputs(cfg: dict, traffic: dict, seed: int, device,
                images: bool = True) -> Inputs:
    """Everything a cell's traffic reads, from ``seed``.  ``images``
    False leaves the region arrays out (None): a rank that reads them from
    the store another rank wrote; the rest is the same."""
    rng = np.random.default_rng(np.random.SeedSequence((seed, 1)))
    vocab = make_vocab(cfg["vocab_size"])
    image_seed = int(rng.integers(2 ** 62))
    feat, cls, bbox = (make_images(traffic["images"], cfg, image_seed,
                                   device) if images else (None, None, None))
    n_ex = traffic.get("examples", 0)
    lo, hi = traffic.get("tokens", [1, 1])
    lens = rng.integers(lo, hi + 1, n_ex)
    ids = rng.integers(FIRST_WORD, len(vocab), int(lens.sum()))
    cuts = np.cumsum(lens)[:-1]
    tokens = [[vocab[i] for i in part] for part in np.split(ids, cuts)] \
        if n_ex else []
    image = rng.integers(0, traffic["images"], n_ex)
    scores = None
    if traffic.get("answers_per_question"):
        # a pool of distinct soft targets; each question takes one
        pool = []
        for _ in range(traffic["score_pool"]):
            distinct = rng.integers(1, cfg["num_answers"],
                                    rng.integers(1, 5))
            ans = list(rng.choice(distinct,
                                  traffic["answers_per_question"]))
            pool.append(vqa_soft_scores([int(a) for a in ans],
                                        cfg["num_answers"]))
        scores = [pool[i] for i in rng.integers(0, len(pool), n_ex)]
    return Inputs(vocab, feat, cls, bbox, image, tokens, scores,
                  int(rng.integers(2 ** 31)))
