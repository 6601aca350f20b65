"""Corpus BLEU-1..4, pure Python (coco-caption BLEU semantics: clipped
n-gram precision, closest-reference-length brevity penalty, corpus-level
aggregation with the small-ratio epsilon)."""

from __future__ import annotations

import math
from collections import Counter
from typing import Dict, List, Tuple

TINY = 1e-15
SMALL = 1e-9


def _ngrams(tokens, n):
    return Counter(tuple(tokens[i:i + n]) for i in range(len(tokens) - n + 1))


def compute_bleu(gts: Dict, res: Dict, n_max: int = 4
                 ) -> Tuple[List[float], List[List[float]]]:
    """gts: {key: [ref strings]}, res: {key: [hyp string]}.
    Returns ([bleu1..bleu4 corpus], per-image scores)."""
    keys = list(res.keys())
    totals = [0.0] * n_max      # clipped matches per n
    counts = [0.0] * n_max      # candidate ngram counts per n
    hyp_len_sum = 0
    ref_len_sum = 0
    per_image: List[List[float]] = []

    stats = []
    for k in keys:
        hyp = res[k][0].split()
        refs = [r.split() for r in gts[k]]
        hl = len(hyp)
        # closest reference length (ties -> shorter)
        rl = min((abs(len(r) - hl), len(r)) for r in refs)[1]
        hyp_len_sum += hl
        ref_len_sum += rl
        img_match, img_count = [], []
        for n in range(1, n_max + 1):
            hng = _ngrams(hyp, n)
            max_ref: Counter = Counter()
            for r in refs:
                for ng, c in _ngrams(r, n).items():
                    max_ref[ng] = max(max_ref[ng], c)
            match = sum(min(c, max_ref[ng]) for ng, c in hng.items())
            cand = max(len(hyp) - n + 1, 0)
            totals[n - 1] += match
            counts[n - 1] += cand
            img_match.append(match)
            img_count.append(cand)
        stats.append((hl, rl, img_match, img_count))

    def _bleu(match, count, hl, rl):
        out = []
        logp = 0.0
        # brevity penalty exactly as bleu_scorer.py: ratio guarded by
        # tiny/small so an empty hypothesis scores ~0, not bp=1
        ratio = (hl + TINY) / (rl + SMALL)
        bp = 1.0 if ratio >= 1.0 else math.exp(1 - 1 / ratio)
        for n in range(n_max):
            p = (match[n] + TINY) / (count[n] + SMALL)
            logp += math.log(p)
            out.append(math.exp(logp / (n + 1)) * bp)
        return out

    corpus = _bleu(totals, counts, hyp_len_sum, ref_len_sum)
    for hl, rl, m, c in stats:
        per_image.append(_bleu(m, c, hl, rl))
    return corpus, per_image
