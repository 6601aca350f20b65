"""ROUGE-L (coco-caption semantics: LCS F-beta with beta=1.2, max over
references)."""

from __future__ import annotations

from typing import Dict, List, Tuple

BETA = 1.2


def _lcs_len(a: List[str], b: List[str]) -> int:
    if not a or not b:
        return 0
    prev = [0] * (len(b) + 1)
    for x in a:
        cur = [0] * (len(b) + 1)
        for j, y in enumerate(b, 1):
            cur[j] = prev[j - 1] + 1 if x == y else max(prev[j], cur[j - 1])
        prev = cur
    return prev[-1]


def _score_pair(hyp: List[str], refs: List[List[str]]) -> float:
    # pycocoevalcap quirk (rouge.py calc_score): max precision and max
    # recall are taken INDEPENDENTLY across references, then combined —
    # NOT max-F over references.  When the best-precision and best-recall
    # references differ, the two formulations disagree; match the scorer
    # the reference's published numbers came from.
    if not hyp:
        return 0.0
    prec_max = 0.0
    rec_max = 0.0
    for ref in refs:
        if not ref:
            continue
        lcs = _lcs_len(hyp, ref)
        prec_max = max(prec_max, lcs / len(hyp))
        rec_max = max(rec_max, lcs / len(ref))
    if prec_max == 0.0 or rec_max == 0.0:
        return 0.0
    return ((1 + BETA ** 2) * prec_max * rec_max) / (
        rec_max + BETA ** 2 * prec_max)


def compute_rouge(gts: Dict, res: Dict) -> Tuple[float, List[float]]:
    keys = list(res.keys())
    scores = [_score_pair(res[k][0].split(), [r.split() for r in gts[k]])
              for k in keys]
    return sum(scores) / max(len(scores), 1), scores
