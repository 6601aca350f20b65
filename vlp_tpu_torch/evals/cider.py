"""CIDEr(-D) metric, pure Python — no Java / coco-caption dependency.

Same algorithm the reference consumes through the coco-caption submodule
(reference vlp/scst_utils.py:10-12, lang_utils.py:17-18): tf-idf
n-gram (1..4) cosine similarity with count clipping and a gaussian length
penalty (sigma=6), idf from the reference corpus ('corpus' df mode), score
scaled by 10 and averaged over references.
"""

from __future__ import annotations

import math
from collections import Counter, defaultdict
from typing import Dict, List, Sequence, Tuple


def _ngram_counts(tokens: Sequence[str], n_max: int = 4) -> Counter:
    counts: Counter = Counter()
    for n in range(1, n_max + 1):
        for i in range(len(tokens) - n + 1):
            counts[tuple(tokens[i:i + n])] += 1
    return counts


class CiderScorer:
    """Corpus-df CIDEr scorer.

    gts: {key: [ref strings]}, res: {key: [hyp string]} — strings are
    space-tokenized (ids or words).
    """

    def __init__(self, n: int = 4, sigma: float = 6.0):
        self.n = n
        self.sigma = sigma

    def compute_score(self, gts: Dict, res: Dict) -> Tuple[float, List[float]]:
        keys = list(res.keys())

        # memoize per unique text: the SCST reward duplicates every gt
        # across the sample/greedy halves (scst.get_self_critical_reward,
        # reference scst_utils semantics), so half the reference-side
        # n-gram/tf-idf work repeats verbatim.  Pure caching — scores are
        # bit-identical (oracle cross-validation unchanged).
        cnt_cache: Dict[str, Counter] = {}

        def counts_of(text: str) -> Counter:
            c = cnt_cache.get(text)
            if c is None:
                c = _ngram_counts(text.split(), self.n)
                cnt_cache[text] = c
            return c

        crefs = [[counts_of(r) for r in gts[k]] for k in keys]
        ctest = [counts_of(res[k][0]) for k in keys]

        # document frequency over reference sets
        doc_freq: Counter = Counter()
        for refs in crefs:
            for ng in set(ng for ref in refs for ng in ref):
                doc_freq[ng] += 1
        ref_len = math.log(float(max(len(crefs), 1)))

        def counts2vec(cnts: Counter):
            vec = [defaultdict(float) for _ in range(self.n)]
            norm = [0.0] * self.n
            length = 0
            for ng, tf in cnts.items():
                df = math.log(max(1.0, float(doc_freq[ng])))
                ni = len(ng) - 1
                vec[ni][ng] = float(tf) * (ref_len - df)
                norm[ni] += vec[ni][ng] ** 2
                if ni == 0:
                    length += tf
            return vec, [math.sqrt(x) for x in norm], length

        def sim(vh, nh, lh, vr, nr, lr):
            delta = float(lh - lr)
            val = [0.0] * self.n
            for ni in range(self.n):
                for ng, w in vh[ni].items():
                    # count clipping: min(hyp tf-idf, ref tf-idf) * ref tf-idf
                    val[ni] += min(w, vr[ni][ng]) * vr[ni][ng]
                if nh[ni] != 0 and nr[ni] != 0:
                    val[ni] /= (nh[ni] * nr[ni])
                val[ni] *= math.exp(-(delta ** 2) / (2 * self.sigma ** 2))
            return val

        # counts2vec memo keyed by the (cached, long-lived) Counter object
        vec_cache: Dict[int, tuple] = {}

        def counts2vec_cached(cnts: Counter):
            r = vec_cache.get(id(cnts))
            if r is None:
                r = counts2vec(cnts)
                vec_cache[id(cnts)] = r
            return r

        scores = []
        for refs, test in zip(crefs, ctest):
            vh, nh, lh = counts2vec_cached(test)
            score = [0.0] * self.n
            for ref in refs:
                vr, nr, lr = counts2vec_cached(ref)
                s = sim(vh, nh, lh, vr, nr, lr)
                for ni in range(self.n):
                    score[ni] += s[ni]
            score_avg = sum(score) / self.n / max(len(refs), 1) * 10.0
            scores.append(score_avg)
        mean = sum(scores) / max(len(scores), 1)
        return mean, scores
