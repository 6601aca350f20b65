"""METEOR (Java-free), anchored to the Meteor **1.5** jar.

coco-caption's METEOR wrapper invokes the Meteor-1.5 jar
(``java -jar meteor-1.5.jar - - -stdio -l en -norm``; reference
reference vlp/lang_utils.py:17-18 via pycocoevalcap's Meteor class).
This module implements the Meteor 1.5 SCORING FUNCTION (Denkowski & Lavie
2014, "Meteor Universal: Language Specific Translation Evaluation for Any
Target Language") with the jar's shipped English parameters::

    alpha = 0.85   beta = 0.2   gamma = 0.6   delta = 0.75
    matcher weights: exact 1.0, stem 0.6, synonym 0.8, paraphrase 0.6

Per aligned segment pair, with content words (h_c/r_c) and function words
(h_f/r_f) split by a function-word list and m_i(.) the words covered by
matcher i::

    P     = sum_i w_i (d*m_i(h_c) + (1-d)*m_i(h_f)) / (d|h_c| + (1-d)|h_f|)
    R     = likewise over the reference
    Fmean = P*R / (alpha*P + (1-alpha)*R)
    Pen   = gamma * (chunks / matches)^beta
    score = (1 - Pen) * Fmean

The system-level score aggregates the per-segment sufficient statistics of
the best-scoring reference and evaluates the same formula on the totals
(Meteor's MeteorStats aggregation — NOT a mean of segment scores).

The ALIGNER is the jar's own algorithm (Denkowski & Lavie 2011 §3.1):
candidate matches from every matcher are resolved by a beam search that
selects, lexicographically, (1) maximum covered words, (2) minimum
chunks, (3) minimum summed |i - j| position distance — see ``_align``.
With the algorithm identical, the only divergence from the jar is DATA:

  * implemented matchers: exact, Porter-stem, WordNet-synonym (when the
    corpus is installed; the jar's synonym module has the same
    share-a-synset semantics);
  * the paraphrase-table matcher is NOT implemented (its data file ships
    only inside the jar), and the synonym matcher is skipped air-gapped —
    ``meteor_bounds`` brackets every alignment the jar's comparator could
    choose given those extra edges (derivation in ``_bound_stats``; no
    assumption that the jar keeps this module's matched pairs);
  * the jar's ``function.words`` list (corpus tokens with relative
    frequency above 1e-3) is approximated by the closed-class list below;
    ``meteor_bounds`` BOUNDS this approximation (round 5) by evaluating
    the per-segment interval under BOTH the closed-class list and a
    corpus-frequency-derived list built with the jar's own rule
    (``corpus_function_words``) and taking the envelope — the reported
    [METEOR_lb, METEOR_ub] therefore brackets the matcher data AND the
    function-word sensitivity.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Tuple

# Meteor 1.5 English parameters (meteor-1.5.jar -l en defaults)
ALPHA, BETA, GAMMA, DELTA = 0.85, 0.2, 0.6, 0.75
# matcher weights by stage index: exact, stem, synonym; PARA applies only
# inside the bounds (the paraphrase matcher itself is jar-only)
STAGE_WEIGHTS = (1.0, 0.6, 0.8)
W_SYN, W_PARA = 0.8, 0.6

try:
    from nltk.stem.porter import PorterStemmer
    _STEM = PorterStemmer().stem
except Exception:  # pragma: no cover
    _STEM = lambda w: w

SynonymFn = Callable[[str], frozenset]

# Approximation of the jar's English function.words (corpus tokens with
# relative frequency > 1e-3 — overwhelmingly the closed classes below plus
# punctuation).  Deviations shift a token between the delta=0.75 content
# weight and the 0.25 function weight; they do not add or remove matches.
FUNCTION_WORDS = frozenset("""
a an the this that these those some any each every no neither either
and or but nor so yet for because although though while if unless until
when whenever where wherever why how than as whether once since
i you he she it we they me him her us them my your his its our their
mine yours hers ours theirs myself yourself himself herself itself
ourselves themselves who whom whose which what
is am are was were be been being do does did done have has had having
will would shall should may might must can could ought
not n't never ever only just also too very quite rather
of in on at by with from to into onto upon about against between among
through during before after above below under over out off down up
again further then there here all both few more most other such own same
s t d ll m re ve y
. , ; : ! ? ' " ` `` '' ( ) [ ] { } - -- ... &
""".split())


def classify(tok: str, fwords: frozenset = FUNCTION_WORDS) -> bool:
    """True when ``tok`` is a function word (jar semantics: list lookup on
    the normalised lowercase token)."""
    return tok.lower() in fwords


def corpus_function_words(texts, threshold: float = 1e-3) -> frozenset:
    """Derive a function-word list with the JAR'S OWN RULE: tokens whose
    relative frequency in a corpus exceeds ``threshold`` (Meteor 1.5 builds
    function.words this way from a large English corpus).  Applied to the
    evaluation corpus itself this yields the in-domain frequency list;
    ``meteor_bounds`` evaluates under both this and the closed-class
    approximation and reports the envelope."""
    freq: Dict[str, int] = {}
    n = 0
    for t in texts:
        for w in t.lower().split():
            freq[w] = freq.get(w, 0) + 1
            n += 1
    if n == 0:
        return FUNCTION_WORDS
    return frozenset(w for w, c in freq.items() if c / n > threshold)


def wordnet_synonyms() -> Optional[SynonymFn]:
    """WordNet synset-id lookup (the jar's synonym module semantics: two
    words match when they share a synset).  Returns None when the WordNet
    corpus is not installed."""
    try:
        from nltk.corpus import wordnet
        wordnet.synsets("dog")  # probe: raises LookupError without data
    except Exception:
        return None
    cache: Dict[str, frozenset] = {}

    def syn(word: str) -> frozenset:
        got = cache.get(word)
        if got is None:
            got = frozenset(s.name() for s in wordnet.synsets(word))
            cache[word] = got
        return got

    return syn


ALIGN_BEAM = 256  # jar default is 40; wider = exhaustive at caption scale


def _match_stages(hyp: List[str], ref: List[str],
                  synonyms: Optional[SynonymFn]
                  ) -> Dict[Tuple[int, int], int]:
    """All candidate matches: (i, j) -> stage, stage labelled by matcher
    PRECEDENCE (exact before stem before synonym), the jar's module
    order — a pair that both stems and synonym-matches is a stem match."""
    hstem = [_STEM(w) for w in hyp]
    rstem = [_STEM(w) for w in ref]
    hsyn = [synonyms(w) for w in hyp] if synonyms is not None else None
    rsyn = [synonyms(w) for w in ref] if synonyms is not None else None
    mat: Dict[Tuple[int, int], int] = {}
    for i, hw in enumerate(hyp):
        for j, rw in enumerate(ref):
            if hw == rw:
                mat[(i, j)] = 0
            elif hstem[i] == rstem[j]:
                mat[(i, j)] = 1
            elif hsyn is not None and hsyn[i] and (hsyn[i] & rsyn[j]):
                mat[(i, j)] = 2
    return mat


def _align(hyp: List[str], ref: List[str],
           synonyms: Optional[SynonymFn] = None
           ) -> List[Tuple[int, int, int]]:
    """The Meteor alignment-resolution beam search (Denkowski & Lavie 2011
    §3.1; the jar's ``meteor.aligner`` — invoked by the reference via the
    coco-caption wrapper, reference vlp/lang_utils.py:17-18).  Among
    one-to-one alignments over the candidate matches, select by the
    published criteria, lexicographically:

      1. maximise covered words (all implemented matchers are single-word,
         so this is the match count);
      2. minimise the number of chunks;
      3. minimise the sum of absolute distances |i - j| between matched
         positions (prefer aligning phrases at similar positions).

    Beam search over hypothesis positions, partial alignments ranked by the
    same criteria; ``ALIGN_BEAM`` = 256 is exhaustive for caption-length
    segments (the jar searches the identical state space at beam 40).
    Returns (hyp_i, ref_j, stage) triples."""
    mat = _match_stages(hyp, ref, synonyms)
    if not mat:
        return []
    cands: Dict[int, List[int]] = {}
    for (i, j) in mat:
        cands.setdefault(i, []).append(j)
    for v in cands.values():
        v.sort()
    # state: (used-ref bitmask, pairs, m, chunks, dist, last_i, last_j)
    states = [(0, (), 0, 0, 0, -2, -2)]
    for i in range(len(hyp)):
        js = cands.get(i)
        if not js:
            continue
        new = list(states)  # skipping hyp word i is always a branch
        for mask, pairs, m, ch, dist, li, lj in states:
            for j in js:
                if mask >> j & 1:
                    continue
                nch = ch + (0 if (li == i - 1 and lj == j - 1) else 1)
                new.append((mask | 1 << j, pairs + ((i, j),), m + 1,
                            nch, dist + abs(i - j), i, j))
        new.sort(key=lambda s: (-s[2], s[3], s[4], s[1]))
        states = new[:ALIGN_BEAM]
    best = states[0]
    return [(i, j, mat[(i, j)]) for (i, j) in best[1]]


def _chunks(pairs: List[Tuple[int, int]]) -> int:
    if not pairs:
        return 0
    pairs = sorted(pairs)
    n = 1
    for (i0, j0), (i1, j1) in zip(pairs, pairs[1:]):
        if not (i1 == i0 + 1 and j1 == j0 + 1):
            n += 1
    return n


@dataclasses.dataclass
class PairStats:
    """Sufficient statistics of one (hyp, best-ref) alignment — Meteor's
    MeteorStats equivalent; the corpus score evaluates the formula on
    componentwise sums."""
    mass_h: float = 0.0   # sum_i w_i (d*content + (1-d)*function), hyp side
    mass_r: float = 0.0
    den_h: float = 0.0    # d*|h_c| + (1-d)*|h_f|
    den_r: float = 0.0
    m: float = 0.0        # matches (unigram stages: same on both sides)
    ch: float = 0.0       # chunks

    def add(self, o: "PairStats") -> "PairStats":
        return PairStats(self.mass_h + o.mass_h, self.mass_r + o.mass_r,
                         self.den_h + o.den_h, self.den_r + o.den_r,
                         self.m + o.m, self.ch + o.ch)


def score_from_stats(s: PairStats) -> float:
    if s.m <= 0 or s.den_h <= 0 or s.den_r <= 0:
        return 0.0
    p = s.mass_h / s.den_h
    r = s.mass_r / s.den_r
    if p <= 0 or r <= 0:
        return 0.0
    f = p * r / (ALPHA * p + (1 - ALPHA) * r)
    pen = GAMMA * (s.ch / s.m) ** BETA
    return (1 - pen) * f


def _weighted_den(toks: List[str],
                  fwords: frozenset = FUNCTION_WORDS) -> float:
    nf = sum(1 for t in toks if classify(t, fwords))
    return DELTA * (len(toks) - nf) + (1 - DELTA) * nf


def pair_stats(hyp: List[str], ref: List[str],
               synonyms: Optional[SynonymFn] = None,
               fwords: frozenset = FUNCTION_WORDS) -> PairStats:
    triples = _align(hyp, ref, synonyms)
    mass_h = mass_r = 0.0
    for i, j, sidx in triples:
        w = STAGE_WEIGHTS[sidx]
        mass_h += w * ((1 - DELTA) if classify(hyp[i], fwords) else DELTA)
        mass_r += w * ((1 - DELTA) if classify(ref[j], fwords) else DELTA)
    return PairStats(mass_h=mass_h, mass_r=mass_r,
                     den_h=_weighted_den(hyp, fwords),
                     den_r=_weighted_den(ref, fwords),
                     m=float(len(triples)),
                     ch=float(_chunks([(i, j) for i, j, _ in triples])))


def meteor_pair(hyp: List[str], ref: List[str],
                synonyms: Optional[SynonymFn] = None) -> float:
    """Meteor 1.5 segment score for one (hyp, ref) pair."""
    if not hyp or not ref:
        return 0.0
    return score_from_stats(pair_stats(hyp, ref, synonyms))


def _bound_stats(hyp: List[str], ref: List[str],
                 synonyms: Optional[SynonymFn] = None,
                 fwords: frozenset = FUNCTION_WORDS
                 ) -> Tuple[PairStats, PairStats, PairStats]:
    """(ours, upper-stats, lower-stats) for one pair.

    The jar runs the SAME alignment-resolution algorithm as ``_align`` over
    a superset of the candidate matches (extra edges from the paraphrase
    table, and from WordNet when the synonym stage could not run here).
    Adding edges can only move the comparator's winner to an alignment
    whose (coverage, chunks, distance) key is lexicographically no worse,
    so every jar-choosable alignment A satisfies:

      * m <= |A| <= m + k   (k = min(unmatched hyp, unmatched ref); the
        comparator maximises coverage and our m is its optimum over the
        implemented matchers — a subset of the jar's edges);
      * if |A| = m then chunks(A) <= our chunk count;
      * each matched token contributes at most
        max(best implemented stage weight incident to it, w_extra)
        and at least W_PARA = 0.6 (the minimum of all matcher weights)
        times its content/function weight.

    upper: mass = the top-(m+k) per-token caps on each side; chunks = 1
      (an adversarial table can always complete one contiguous run);
      provable — no assumption about which pairs the jar keeps.
    lower: min over extra-match counts e in [0, k] of the score with
      per-side mass = 0.6 * (sum of the m+e smallest token weights) and
      chunks = our chunk count when e = 0 (the comparator can only reduce
      chunks at equal coverage) else m+e (maximal fragmentation).
      When the pair is an exact identity alignment (all tokens matched
      exactly, one chunk, zero distance) the comparator key (max, 1, 0) is
      attained only by the identity alignment itself, so lb = ours.

    Both bounds are assumption-free given the beam widths (ours: 256, the
    jar's: 40) exhaust the caption-scale state space; only the missing
    matcher DATA (paraphrase table; WordNet when absent) is bracketed."""
    triples = _align(hyp, ref, synonyms)
    ours = pair_stats(hyp, ref, synonyms, fwords)
    mat = _match_stages(hyp, ref, synonyms)
    matched_h = {i for i, _, _ in triples}
    matched_r = {j for _, j, _ in triples}
    k = min(len(hyp) - len(matched_h), len(ref) - len(matched_r))
    m = int(ours.m)
    w_extra = W_PARA if synonyms is not None else W_SYN

    # ---- upper -----------------------------------------------------------
    def cap_masses(toks, side):
        best_impl = [0.0] * len(toks)
        for (i, j), s in mat.items():
            t = i if side == 0 else j
            best_impl[t] = max(best_impl[t], STAGE_WEIGHTS[s])
        caps = [max(w, w_extra)
                * ((1 - DELTA) if classify(t, fwords) else DELTA)
                for w, t in zip(best_impl, toks)]
        return sum(sorted(caps, reverse=True)[:m + k])

    ub = PairStats(mass_h=cap_masses(hyp, 0), mass_r=cap_masses(ref, 1),
                   den_h=ours.den_h, den_r=ours.den_r, m=m + k,
                   ch=1.0 if m + k else 0.0)

    # ---- lower -----------------------------------------------------------
    dist = sum(abs(i - j) for i, j, _ in triples)
    identity = (k == 0 and dist == 0 and ours.ch <= 1
                and m == len(hyp) == len(ref)
                and all(s == 0 for _, _, s in triples))
    if identity:
        return ours, ub, ours

    def min_mass(toks, mm):
        w = sorted(((1 - DELTA) if classify(t, fwords) else DELTA)
                   for t in toks)
        return W_PARA * sum(w[:mm])

    lb_best, lb_score = ours, float("inf")
    for e in range(int(k) + 1):
        cand = PairStats(mass_h=min_mass(hyp, m + e),
                         mass_r=min_mass(ref, m + e),
                         den_h=ours.den_h, den_r=ours.den_r, m=m + e,
                         ch=float(ours.ch if e == 0 else m + e))
        s = score_from_stats(cand)
        if s < lb_score:
            lb_score, lb_best = s, cand
    return ours, ub, lb_best


def compute_meteor(gts: Dict, res: Dict,
                   synonyms: Optional[SynonymFn] = None
                   ) -> Tuple[float, List[float]]:
    """Corpus Meteor 1.5: per-segment best-reference stats aggregated, the
    formula evaluated on the totals (the jar's system-level score).  Also
    returns the per-segment scores (the jar's per-segment output).
    gts: {key: [ref strings]}, res: {key: [hyp string]}."""
    keys = list(res.keys())
    seg_scores = []
    total = PairStats()
    for key in keys:
        hyp = res[key][0].lower().split()
        # ties (and all-zero segments) keep the FIRST reference's stats,
        # matching the jar's best-reference selection
        best, best_s = None, -1.0
        for r in gts[key]:
            st = pair_stats(hyp, r.lower().split(), synonyms)
            s = score_from_stats(st)
            if best is None or s > best_s:
                best, best_s = st, s
        seg_scores.append(max(best_s, 0.0))
        total = total.add(best if best is not None else PairStats())
    return score_from_stats(total), seg_scores


def _meteor_bounds_one_list(gts: Dict, res: Dict,
                            synonyms: Optional[SynonymFn],
                            fwords: frozenset) -> Tuple[float, float]:
    tot_lb, tot_ub = PairStats(), PairStats()
    for key in res:
        hyp = res[key][0].lower().split()
        best_ub = best_lb = None
        best_ub_s = best_lb_s = -1.0
        for r in gts[key]:
            _, ub, lb = _bound_stats(hyp, r.lower().split(), synonyms,
                                     fwords)
            su, sl = score_from_stats(ub), score_from_stats(lb)
            if best_ub is None or su > best_ub_s:
                best_ub, best_ub_s = ub, su
            if best_lb is None or sl > best_lb_s:
                best_lb, best_lb_s = lb, sl
        tot_ub = tot_ub.add(best_ub if best_ub is not None else PairStats())
        tot_lb = tot_lb.add(best_lb if best_lb is not None else PairStats())
    lower = score_from_stats(tot_lb)
    upper = score_from_stats(tot_ub)
    return min(lower, upper), max(lower, upper)


def meteor_bounds(gts: Dict, res: Dict,
                  synonyms: Optional[SynonymFn] = None,
                  fword_lists=None) -> Tuple[float, float]:
    """(lower, upper) corpus interval for the Meteor-1.5 jar's system
    score, bracketing the two data files that cannot ship air-gapped:

      * matcher DATA (paraphrase table always; WordNet synonyms when the
        corpus is absent) — per segment the bounds are assumption-free over
        every alignment the jar's comparator could choose (_bound_stats);
      * the ``function.words`` list — the interval is the ENVELOPE over
        candidate lists: the closed-class approximation AND a list derived
        from the evaluation corpus itself with the jar's own frequency
        rule (``corpus_function_words``; pass ``fword_lists`` to add
        others, e.g. one derived from a larger external text).  Shifting a
        token between lists moves delta-weight mass only; evaluating both
        lists brackets that sensitivity instead of assuming one list.

    Across segments each bound aggregates the reference selected by its
    own score (the jar's best-reference rule applied to the bound stats —
    the formula on summed stats is not monotone in the per-segment choice,
    so the corpus interval inherits that standard aggregation rather than
    a proof; ``coco.language_eval`` additionally clamps the interval
    around the native score)."""
    if fword_lists is None:
        corpus_texts = [t for refs in gts.values() for t in refs]
        corpus_texts += [t for hyps in res.values() for t in hyps]
        fword_lists = (FUNCTION_WORDS, corpus_function_words(corpus_texts))
    los, his = [], []
    for fw in fword_lists:
        lo, hi = _meteor_bounds_one_list(gts, res, synonyms, fw)
        los.append(lo)
        his.append(hi)
    return min(los), max(his)


# ---------------------------------------------------------------------------
# METEOR v1 (Banerjee & Lavie 2005) — kept for comparison/experiments; the
# reported METEOR numbers use the 1.5 scoring above (the jar coco-caption
# actually runs).  alpha=0.9, beta=3, gamma=0.5, unweighted stages.
# ---------------------------------------------------------------------------

def meteor_v1_pair(hyp: List[str], ref: List[str],
                   synonyms: Optional[SynonymFn] = None) -> float:
    triples = _align(hyp, ref, synonyms)
    m = len(triples)
    if m == 0 or not hyp or not ref:
        return 0.0
    p, r = m / len(hyp), m / len(ref)
    f = p * r / (0.9 * p + (1 - 0.9) * r)
    frag = _chunks([(i, j) for i, j, _ in triples]) / m
    return (1 - 0.5 * frag ** 3) * f


def compute_meteor_v1(gts: Dict, res: Dict,
                      synonyms: Optional[SynonymFn] = None
                      ) -> Tuple[float, List[float]]:
    keys = list(res.keys())
    scores = [max((meteor_v1_pair(res[k][0].split(), r.split(), synonyms)
                   for r in gts[k]), default=0.0) for k in keys]
    return sum(scores) / max(len(scores), 1), scores
