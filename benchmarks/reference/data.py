"""The batches of a run worked out again from the benchmark's raw inputs
(``benchmarks/inputs.py``): the loader's epoch order and per-example
random streams, the caption's masking, the sequence layout and the region
geometry featurization, as the reference VLP preprocessing states them
(``seq2seq_loader.py``: ``Preprocess4Seq2seq``, ``Preprocess4Seq2seqDecoder``
and the BUTD featurization), in numpy.

Only the raw inputs are read: the region features, class probabilities
and boxes as the benchmark made them, the caption tokens and the vocabulary.
"""

from __future__ import annotations

from typing import Dict, List

import numpy as np

MODE_BI, MODE_S2S = 0, 1
TASK_IDX_BI, TASK_IDX_S2S = 0, 3


def featurize(bbox: np.ndarray, cls_probs: np.ndarray) -> np.ndarray:
    """float32 [N, 6 + C]: coordinates over the largest extent, the clamped
    relative area in place of column 4, the confidence, each of the two
    parts layer-normalised without parameters (eps 1e-5)."""
    bbox = np.asarray(bbox, np.float32).copy()
    cls_probs = np.asarray(cls_probs, np.float32)
    w = bbox[:, [0, 2]].max() + 1e-5
    h = bbox[:, [1, 3]].max() + 1e-5
    bbox[:, [0, 2]] /= w
    bbox[:, [1, 3]] /= h
    area = np.clip((bbox[:, 3] - bbox[:, 1]) * (bbox[:, 2] - bbox[:, 0]),
                   0, None)
    geom = np.concatenate([bbox[:, :4], area[:, None], bbox[:, 5:6]], -1)

    def ln(x):
        return (x - x.mean(-1, keepdims=True)) / np.sqrt(
            x.var(-1, keepdims=True) + 1e-5)

    return np.concatenate([ln(geom), ln(cls_probs)], -1).astype(np.float32)


def epoch_order(loader_seed: int, epoch: int, n: int) -> np.ndarray:
    return np.random.default_rng(loader_seed + epoch).permutation(n)


def build_train_example(cfg: dict, vocab: Dict[str, int], words: List[str],
                        tokens: List[str], rng: np.random.Generator,
                        builder_probs, mask_prob: float,
                        ans_scores=None) -> dict:
    """One training example: the builder drawn by ``builder_probs``
    ([s2s, bi]), then ``[CLS] regions [SEP] caption [SEP] [PAD]...`` with
    masked-LM corruption of the caption and its final [SEP]."""
    nv = cfg["len_vis_input"]
    prefix = nv + 2
    L = seq_len(cfg)
    mode = ("s2s", "bi")[rng.choice(2, p=builder_probs)]
    tokens = list(tokens)
    while len(tokens) > cfg["max_len_b"]:
        if rng.random() >= 0.5:
            tokens.pop()
        else:
            del tokens[0]
    nb = len(tokens)
    ids = np.full(L, vocab["[PAD]"], np.int64)
    ids[0] = vocab["[CLS]"]
    ids[1:nv + 1] = vocab["[UNK]"]
    ids[nv + 1] = vocab["[SEP]"]
    ids[prefix:prefix + nb] = [vocab[t] for t in tokens]
    ids[prefix + nb] = vocab["[SEP]"]
    text_end = prefix + nb + 1
    seg = np.zeros(L, np.int64)
    a_seg, b_seg = (4, 5) if mode == "s2s" else (0, 1)
    seg[:prefix] = a_seg
    seg[prefix:text_end] = b_seg
    n_pred = min(cfg["max_pred"], max(1, int(round(nb * mask_prob))))
    cand = np.arange(prefix, text_end)
    rng.shuffle(cand)
    masked_pos = np.zeros(cfg["max_pred"], np.int64)
    masked_ids = np.zeros(cfg["max_pred"], np.int64)
    masked_w = np.zeros(cfg["max_pred"], np.float32)
    for j, pos in enumerate(cand[:n_pred]):
        masked_pos[j] = pos
        masked_ids[j] = ids[pos]
        masked_w[j] = 1.0
        if rng.random() < 0.8:
            ids[pos] = vocab["[MASK]"]
        elif rng.random() < 0.5:
            ids[pos] = vocab[words[rng.integers(0, len(words))]]
    out = dict(input_ids=ids, segment_ids=seg,
               mode=MODE_S2S if mode == "s2s" else MODE_BI,
               text_end=text_end, masked_pos=masked_pos,
               masked_ids=masked_ids, masked_weights=masked_w,
               task_idx=TASK_IDX_S2S if mode == "s2s" else TASK_IDX_BI)
    if ans_scores is not None:
        out["ans_scores"] = np.asarray(ans_scores, np.float32)
    return out


def seq_len(cfg: dict) -> int:
    """The sequence as the model runs it: [CLS] regions [SEP] caption
    [SEP], padded up to a multiple of 128."""
    return -(-(cfg["max_len_b"] + cfg["len_vis_input"] + 3) // 128) * 128


def rank_order(loader_seed: int, epoch: int, n: int, rank: int,
               world: int) -> np.ndarray:
    """A rank's share of the epoch's permutation, as a distributed
    sampler deals it: the permutation padded with its own head to a
    multiple of ``world``, every ``world``-th entry from ``rank``."""
    order = epoch_order(loader_seed, epoch, n)
    total = -(-n // world) * world
    order = np.concatenate([order, order[:total - n]])
    return order[rank::world]


def train_batch(inputs, cfg: dict, traffic: dict, epoch: int,
                batch_index: int, rank: int = 0,
                world: int = 1) -> Dict[str, np.ndarray]:
    """Batch ``batch_index`` of epoch ``epoch`` of one of ``world`` ranks,
    as its loader orders and builds it: examples in the rank's share of
    the epoch's permutation, example ``pos`` of that share drawing from
    ``SeedSequence((loader_seed, epoch, rank, pos))``."""
    B = traffic["batch_size"]
    order = rank_order(inputs.loader_seed, epoch, len(inputs.example_tokens),
                       rank, world)
    vocab = inputs.vocab_index
    words = inputs.vocab
    probs = [traffic["s2s_prob"], traffic["bi_prob"]]
    rows, feats, pes = [], [], []
    for j in range(B):
        pos = batch_index * B + j
        ex = int(order[pos])
        rng = np.random.default_rng(np.random.SeedSequence(
            (inputs.loader_seed, epoch, rank, pos)))
        img = inputs.example_image[ex]
        scores = (inputs.ans_scores[ex] if inputs.ans_scores is not None
                  else None)
        rows.append(build_train_example(
            cfg, vocab, words, inputs.example_tokens[ex], rng, probs,
            traffic["mask_prob"], scores))
        feats.append(inputs.feat[img].astype(np.float32))
        pes.append(featurize(inputs.bbox[img], inputs.cls[img]))
    batch = {k: np.stack([r[k] for r in rows]) for k in rows[0]}
    batch["vis_feats"] = np.stack(feats)
    batch["vis_pe"] = np.stack(pes)
    return batch


def decode_prompt(inputs, cfg: dict, image: int) -> Dict[str, np.ndarray]:
    """The decoding prompt of one image: ``[CLS] regions [SEP]``, segment
    ids 4 for the prompt and 5 after it, positions 0..L-1, and the
    image's features."""
    nv = cfg["len_vis_input"]
    prefix = nv + 2
    L = seq_len(cfg)
    vocab = inputs.vocab_index
    ids = np.full(prefix, vocab["[PAD]"], np.int64)
    ids[0] = vocab["[CLS]"]
    ids[1:nv + 1] = vocab["[UNK]"]
    ids[nv + 1] = vocab["[SEP]"]
    seg = np.full(L, 5, np.int64)
    seg[:prefix] = 4
    return dict(input_ids=ids, segment_ids=seg,
                vis_feats=inputs.feat[image].astype(np.float32),
                vis_pe=featurize(inputs.bbox[image], inputs.cls[image]))
