"""SPICE — Semantic Propositional Image Caption Evaluation (Java-free).

The reference publishes SPICE columns scored through the coco-caption
submodule's Java pipeline (reference vlp/lang_utils.py:17-18;
README.md:189-193), which runs a Stanford dependency parser to build scene
graphs and then computes an F1 over semantic propositions.

This module is a two-part native replacement:
  * the SCORING half is the published SPICE definition implemented exactly:
    a caption's scene graph is flattened into proposition tuples —
    ``(object,)``, ``(object, attribute)``, ``(subject, relation, object)``
    — and the score is the F1 between the candidate's tuple (multi)set and
    the union of the references' tuples, with tuples matched after
    lemmatisation (and through the same WordNet-synonym hook METEOR uses,
    when available);
  * the PARSING half is a rule-based scene-graph extractor for
    caption-shaped English (determiner/adjective/noun chunking, copulas,
    prepositional and verbal relations).  A full dependency parser cannot
    run air-gapped; ``compute_spice(..., parser=...)`` accepts an external
    ``str -> SceneGraph`` callable so deployments with the Stanford/Java
    stack can plug the original parser and keep this scoring
    implementation.

Because candidate and reference captions go through the SAME parser, the
approximation is consistent across compared models; absolute values can
differ from the Java pipeline's and are labelled as approximate in
``language_eval``.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Callable, Dict, FrozenSet, List, Optional, Set, Tuple

# ---------------------------------------------------------------- lexicon --

DETERMINERS = frozenset("""
a an the this that these those his her its their our my your some any each
every no several many few both all half one couple group lot lots bunch
number
""".split())

# counting numerals become attributes, as in the Java pipeline's scene
# graphs ("two dogs" -> (dog, two)); "one" stays a determiner (article-like
# in captions)
NUMERALS = frozenset("""
two three four five six seven eight nine ten eleven twelve
""".split())

# multiword-preposition members: consumed into the relation when adjacent
# to of/to ("on top of", "next to", "in front of")
_MWE_PREP = {"top": ("of",), "front": ("of",), "next": ("to",),
             "side": ("of",)}


def _is_mwe_prep(toks) -> bool:
    """True when ``toks`` is exactly a multiword preposition chain the
    Stanford pipeline case-marks as a unit: [prep, mwe, of/to] ("on top
    of", "in front of") or [mwe, of/to] ("next to")."""
    if len(toks) == 3:
        return (toks[0] in PREPOSITIONS and toks[1] in _MWE_PREP
                and toks[2] in _MWE_PREP[toks[1]])
    if len(toks) == 2:
        return toks[0] in _MWE_PREP and toks[1] in _MWE_PREP[toks[0]]
    return False

PREPOSITIONS = frozenset("""
on in at with near under over above behind beside by of for from down up
along across through around between against inside outside onto off atop
into towards toward beneath below past upon within without amid among
""".split())

COPULAS = frozenset("is are was were be being been am".split())
AUXILIARIES = frozenset("has have had do does did will would can could".split())
CONJUNCTIONS = frozenset("and or but while as".split())
PRONOUNS = frozenset("it he she they there who which that".split())
PARTICLES = frozenset("to not n't".split())
# PTB-split possessive clitic: a connector, mapped to the 'have' relation
# ("the man 's hat" -> (man, have, hat) — the same convention as the
# auxiliary-have possession rule below)
POSSESSIVES = frozenset(("'s",))

ADJECTIVES = frozenset("""
white black red blue green yellow brown gray grey orange pink purple golden
silver dark light bright colorful striped spotted checkered plaid large
small big little huge tiny giant tall short long wide narrow thin thick
young old new vintage modern wooden metal metallic plastic glass stone
brick concrete empty full open closed busy crowded quiet sunny cloudy
rainy snowy foggy wet dry dirty clean shiny rusty broken cracked fresh
ripe raw cooked delicious tasty hot cold warm frozen furry fluffy hairy
fuzzy cute pretty beautiful handsome happy sad angry smiling laughing
sleepy tired hungry curious playful friendly wild domestic stuffed toy
leather denim wool cotton silk floral decorative ornate fancy plain
simple double single upper lower left right front back top bottom middle
nearby distant remote urban rural outdoor indoor professional amateur
electric electronic digital manual
""".split())

# -ing words that are (almost always) nouns in captions, not verbs
ING_NOUNS = frozenset("""
building ceiling clothing painting drawing railing awning icing frosting
lightning morning evening everything nothing something anything spring
string wedding landing siding
""".split())

VERBS = frozenset("""
sit sits stand stands ride rides hold holds play plays run runs walk walks
eat eats look looks watch watches wear wears fly flies jump jumps carry
carries drive drives hang hangs lay lays lie lies graze grazes swim swims
rest rests lean leans perch perches float floats park parks stop stops
wait waits pose poses smile smiles talk talks drink drinks feed feeds
pull pulls push pushes throw throws catch catches hit hits kick kicks
serve serves cut cuts cook cooks bake bakes read reads write writes chase chases use
uses work works travel travels cross crosses climb climbs land lands take
takes make makes give gives show shows contain contains include includes
surround surrounds fill fills cover covers top tops
""".split())

_ADJ_SUFFIX = re.compile(r".{3,}(?:ful|ous|ish|less|able|ible|ive|al|ic)$")


# s-final words that are NOT plurals (the external SPICE-paper golden
# caught "tennis" -> "tenni")
NON_PLURAL_S = frozenset({"tennis", "lens", "chaos", "circus", "cactus"})


def _lemma(word: str) -> str:
    """Light lemmatiser for tuple matching (dogs->dog, riding->ride,
    carries->carry).  Both sides of the comparison go through it, so
    consistency matters more than linguistic perfection."""
    w = word
    if w in NON_PLURAL_S:
        return w
    if w.endswith("ies") and len(w) > 4:
        return w[:-3] + "y"
    if w.endswith("sses") or w.endswith("shes") or w.endswith("ches") or \
            w.endswith("xes") or w.endswith("zes"):
        return w[:-2]
    if w.endswith("s") and not w.endswith("ss") and len(w) > 3:
        return w[:-1]
    if w.endswith("ing") and len(w) > 5 and w not in ING_NOUNS:
        stem = w[:-3]
        if len(stem) > 2 and stem[-1] == stem[-2]:  # sitting -> sit
            stem = stem[:-1]
        elif stem in VERBS:                          # standing -> stand
            pass
        elif stem + "e" in VERBS:                    # riding -> ride
            stem = stem + "e"
        return stem
    return w


def _ed_stem(tok: str) -> Optional[str]:
    """topped -> top, parked -> park, filled -> fill (None if not -ed).
    The doubled-consonant undouble applies only when the doubled form is
    not itself a verb (filled -> fill, not fil)."""
    if not tok.endswith("ed") or len(tok) < 4:
        return None
    stem = tok[:-2]
    if len(stem) > 2 and stem[-1] == stem[-2] and stem not in VERBS:
        return stem[:-1]
    return stem


def _is_verb(tok: str) -> bool:
    if tok in VERBS or _lemma(tok) in VERBS:
        return True
    ed = _ed_stem(tok)
    if ed is not None and tok not in ADJECTIVES and (
            ed in VERBS or ed + "e" in VERBS):
        return True
    return tok.endswith("ing") and tok not in ING_NOUNS and len(tok) > 4


def _is_adjective(tok: str) -> bool:
    return tok in ADJECTIVES or bool(_ADJ_SUFFIX.match(tok))


def _rel_lemma(t: str) -> str:
    """Relation-token lemma: verb lemmatisation incl. past participles
    (perched -> perch, topped -> top, served -> serve).  In relation
    position an -ed participle reads as a verb even when it doubles as an
    adjective ("pot filled with" -> fill, though "filled" is adjectival
    prenominally)."""
    if _is_verb(t) or (t.endswith("ed") and _ed_stem(t) is not None
                       and (_ed_stem(t) in VERBS
                            or _ed_stem(t) + "e" in VERBS)):
        lem = _lemma(t)
        if lem == t:
            ed = _ed_stem(t)
            if ed is not None:
                return ed + "e" if (ed not in VERBS
                                    and ed + "e" in VERBS) else ed
        return lem
    return t


# ------------------------------------------------------------ scene graph --

Tuple1 = Tuple[str]
TupleN = Tuple[str, ...]


@dataclasses.dataclass
class SceneGraph:
    objects: Set[str]
    attributes: Set[Tuple[str, str]]          # (object, attribute)
    relations: Set[Tuple[str, str, str]]      # (subject, relation, object)

    def tuples(self) -> Set[TupleN]:
        out: Set[TupleN] = {(o,) for o in self.objects}
        out |= {t for t in self.attributes}
        out |= {t for t in self.relations}
        return out


@dataclasses.dataclass
class _NP:
    head: str
    attrs: List[str]


def _chunk(tokens: List[str]):
    """Greedy caption chunker: noun phrases and the connectors between
    them.  Yields ('np', _NP) and ('rel', [tokens]) segments."""
    i, n = 0, len(tokens)
    segs = []
    rel_buf: List[str] = []
    while i < n:
        tok = tokens[i]
        if tok in _MWE_PREP and i + 1 < n \
                and tokens[i + 1] in _MWE_PREP[tok]:
            # "on top of" / "next to" / "in front of": the noun-shaped
            # member joins the relation instead of opening a phrase
            rel_buf.append(tok)
            i += 1
            continue
        if tok in DETERMINERS or tok in NUMERALS or _is_adjective(tok) \
                or not (
                tok in PREPOSITIONS or tok in COPULAS or tok in AUXILIARIES
                or tok in CONJUNCTIONS or tok in PRONOUNS
                or tok in PARTICLES or tok in POSSESSIVES
                or _is_verb(tok)):
            # start of a noun phrase: [det] (adj|noun-mod)* head-noun
            j = i
            words: List[str] = []
            seen_det = False
            while j < n:
                t = tokens[j]
                if t in DETERMINERS and not words:
                    seen_det = True
                    j += 1
                    continue
                if (t in PREPOSITIONS or t in COPULAS or t in AUXILIARIES
                        or t in CONJUNCTIONS or t in PRONOUNS
                        or t in PARTICLES or t in POSSESSIVES):
                    break
                if _is_verb(t) and not (seen_det and not words):
                    # "the park"/"a drink": a determiner forces the next
                    # word to be read as a noun even if verb-shaped
                    break
                if (words and t.endswith("ed") and _ed_stem(t) is not None
                        and (_ed_stem(t) in VERBS
                             or _ed_stem(t) + "e" in VERBS)
                        and j + 1 < n and tokens[j + 1] in PREPOSITIONS):
                    # postnominal participle ("pot filled with ...", caught
                    # by the external SPICE-paper golden): a relation token,
                    # not an adjective extending the phrase
                    break
                words.append(t)
                j += 1
                if seen_det and len(words) == 1 and _is_verb(t) \
                        and t not in ADJECTIVES:
                    # det + verb-shaped word: a following noun keeps the
                    # phrase going as a participle modifier ("a parked
                    # car"); anything else ends it ("a drink sits")
                    nxt = tokens[j] if j < n else None
                    if nxt is None or nxt in PREPOSITIONS \
                            or nxt in COPULAS or nxt in AUXILIARIES \
                            or nxt in CONJUNCTIONS or nxt in PRONOUNS \
                            or nxt in PARTICLES or nxt in DETERMINERS \
                            or _is_verb(nxt):
                        break
            if words:
                if rel_buf:
                    segs.append(("rel", rel_buf))
                    rel_buf = []
                head = _lemma(words[-1])
                attrs = [_lemma(w) if not _is_adjective(w) else w
                         for w in words[:-1]]
                segs.append(("np", _NP(head, attrs)))
                i = j
                continue
            if seen_det and j < n and tokens[j] == "of":
                # determiner-only pseudo-partitive ("lots of", "a couple
                # of", "a bunch of"): transparent quantity — skip the
                # "of" so it doesn't contaminate the relation chain
                # ("kitchen filled with lots of cabinets" must read
                # 'fill with', not 'fill with of')
                i = j + 1
                continue
            i = j + 1 if j == i else j
            continue
        if tok in CONJUNCTIONS:
            segs.append(("conj", tok))
            i += 1
            continue
        rel_buf.append(tok)
        i += 1
    if rel_buf:
        segs.append(("rel", rel_buf))
    return segs


def parse_scene_graph(caption_tokens: List[str]) -> SceneGraph:
    """Rule-based scene-graph extraction from PTB-style lowercase tokens."""
    g = SceneGraph(set(), set(), set())
    segs = _chunk(caption_tokens)

    # coordinated prenominal adjectives ("a black and white photo"): an
    # all-adjective NP conjoined with a noun-headed NP contributes its
    # adjectives to that NP instead of standing as a phantom object
    drop = set()
    for k in range(len(segs) - 2):
        if segs[k][0] == "np" and segs[k + 1][0] == "conj" \
                and segs[k + 2][0] == "np":
            a, b = segs[k][1], segs[k + 2][1]
            if _is_adjective(a.head) \
                    and all(_is_adjective(x) for x in a.attrs) \
                    and not _is_adjective(b.head):
                b.attrs.extend([a.head] + a.attrs)
                drop.add(k)
                drop.add(k + 1)
    if drop:
        segs = [sg for idx, sg in enumerate(segs) if idx not in drop]

    # copula + adjective phrase -> attribute of the subject ("the door is
    # open"): the adjective chunks after a pure-copula segment are
    # predicates, not objects — reassign and drop them
    predicative = set()
    for k in range(len(segs) - 2):
        if segs[k][0] == "np" and segs[k + 1][0] == "rel" \
                and segs[k + 2][0] == "np":
            rel_toks = segs[k + 1][1]
            np2 = segs[k + 2][1]
            if rel_toks and all(t in COPULAS or t in AUXILIARIES
                                or t in PARTICLES for t in rel_toks) \
                    and _is_adjective(np2.head) \
                    and all(_is_adjective(a) for a in np2.attrs):
                for a in [np2.head] + np2.attrs:
                    g.attributes.add((segs[k][1].head, a))
                predicative.add(k + 2)
                # "is clean and bright": predicate adjectives chain
                # through conjunctions
                fwd = k + 2
                while fwd + 2 < len(segs) and segs[fwd + 1][0] == "conj" \
                        and segs[fwd + 2][0] == "np" \
                        and _is_adjective(segs[fwd + 2][1].head) \
                        and all(_is_adjective(a)
                                for a in segs[fwd + 2][1].attrs):
                    for a in ([segs[fwd + 2][1].head]
                              + segs[fwd + 2][1].attrs):
                        g.attributes.add((segs[k][1].head, a))
                    predicative.add(fwd + 2)
                    fwd += 2
    # adjectives left inside a copula rel segment ("is open and shiny"
    # can chunk either way depending on the lexicon)
    for k in range(len(segs) - 1):
        if segs[k][0] == "np" and segs[k + 1][0] == "rel":
            rel_toks = segs[k + 1][1]
            if rel_toks and rel_toks[0] in COPULAS:
                for t in rel_toks[1:]:
                    if _is_adjective(t):
                        g.attributes.add((segs[k][1].head, t))

    nps = [(k, s[1]) for k, s in enumerate(segs)
           if s[0] == "np" and k not in predicative]
    for _, np_ in nps:
        g.objects.add(np_.head)
        for a in np_.attrs:
            g.attributes.add((np_.head, a))

    # NP (rel tokens) NP -> relation; conjunction joins subjects
    subjects: List[str] = []
    # attachment lifting (round 5): obj_info[np_index] = (subjects, kind)
    # records how an NP became an object — kind "of" (complement), "verb"
    # (clause object) or "prep".  A following relation then attaches per
    # the Stanford pipeline's conventions instead of always to the nearest
    # NP:  participle chains attach to the CLAUSE subject ("a man wearing
    # a jacket riding a skateboard" -> man rides), bare prepositions lift
    # past verb objects and of-complements ("a woman holding an umbrella
    # in the rain" -> woman in rain; "a plate of food on the table" ->
    # plate on table), while "of" itself and verbs after of-complements
    # stay on the nearest NP ("a slice of pizza"; "a herd of sheep
    # grazing..." -> sheep graze).
    obj_info: Dict[int, Tuple[List[str], str]] = {}
    k = 0
    while k < len(segs):
        kind = segs[k][0]
        if kind == "np":
            subjects = [segs[k][1].head]
            # "a and b <rel> c" — extend subject set through conjunctions
            back = k - 2
            while back >= 0 and segs[back + 1][0] == "conj" \
                    and segs[back][0] == "np":
                subjects.append(segs[back][1].head)
                back -= 2
            info = obj_info.get(k)
            if info is not None and k + 1 < len(segs) \
                    and segs[k + 1][0] == "rel":
                toks = [t for t in segs[k + 1][1]
                        if not (t in COPULAS or t in AUXILIARIES
                                or t in PARTICLES)]
                has_verb = any(t not in PREPOSITIONS and _is_verb(t)
                               for t in toks)
                # "of" complements and possessives attach to the nearest
                # NP, never the clause subject ("the boy 's ball" ->
                # (boy, have, ball) even mid-clause)
                of_initial = bool(toks) and (toks[0] == "of"
                                             or toks[0] in POSSESSIVES)
                src, via = info
                if not of_initial and (
                        (has_verb and via == "verb")
                        or (not has_verb and via in ("verb", "of"))):
                    subjects = list(src)
            if k + 2 < len(segs) and segs[k + 1][0] == "rel" \
                    and segs[k + 2][0] == "np":
                raw = segs[k + 1][1]
                rel_toks = [t for j, t in enumerate(raw)
                            if not (t in COPULAS or t in AUXILIARIES
                                    or t in PARTICLES)
                            or (t == "to" and j > 0
                                and raw[j - 1] in _MWE_PREP)]
                if not rel_toks and any(t in ("has", "have", "had")
                                        for t in raw):
                    # "the room has a sink": possession is a relation, not
                    # an auxiliary (the Java graphs emit 'have')
                    rel_toks = ["have"]
                if (len(rel_toks) >= 3 and rel_toks[0] not in PREPOSITIONS
                        and _is_verb(rel_toks[0])
                        and _is_mwe_prep(rel_toks[1:])):
                    # SPICE convention (the paper's Fig.-1 reference graph:
                    # "girl standing on top of a tennis court" -> (girl,
                    # standing) + (girl, on-top-of, court)): a participle
                    # before a MULTIWORD preposition is an attribute of the
                    # subject and the MWE preposition alone is the
                    # relation.  Single-word prepositions stay merged into
                    # the verb ("filled with" -> fill-with), also per the
                    # paper's candidate graph.
                    for s in subjects:
                        g.attributes.add((s, _rel_lemma(rel_toks[0])))
                    rel_toks = rel_toks[1:]
                was_poss = rel_toks == ["'s"]
                if was_poss:
                    # possessive clitic -> the possession relation
                    rel_toks = ["have"]
                if rel_toks:
                    rel = " ".join(_rel_lemma(t) for t in rel_toks)
                    # a non-possessive relation whose object NP is a
                    # possessor attaches to the POSSESSED head ("a dog
                    # chasing the boy 's ball" -> (dog, chase, ball);
                    # (boy, have, ball) is emitted when k reaches 'boy')
                    base = k + 2
                    while not was_poss and base + 2 < len(segs) \
                            and segs[base + 1][0] == "rel" \
                            and segs[base + 1][1] == ["'s"] \
                            and segs[base + 2][0] == "np":
                        base += 2
                    objs = [segs[base][1].head]
                    # "<s> rel c and d" — extend through conjunctions,
                    # unless the conj NP starts its own clause (is itself
                    # followed by a rel segment)
                    fwd = base
                    while fwd + 2 < len(segs) and segs[fwd + 1][0] == "conj" \
                            and segs[fwd + 2][0] == "np" \
                            and not (fwd + 3 < len(segs)
                                     and segs[fwd + 3][0] == "rel"):
                        objs.append(segs[fwd + 2][1].head)
                        fwd += 2
                    for s in subjects:
                        for o in objs:
                            g.relations.add((s, rel, o))
                    via = ("of" if rel == "of" else
                           "verb" if any(t not in PREPOSITIONS
                                         and _is_verb(t)
                                         for t in rel_toks) else "prep")
                    for idx in range(base, fwd + 1, 2):
                        obj_info[idx] = (list(subjects), via)
        k += 1
    return g


# ---------------------------------------------------------------- scoring --

SynonymFn = Callable[[str], FrozenSet[str]]


def _tuple_match(t1: TupleN, t2: TupleN,
                 synonyms: Optional[SynonymFn]) -> bool:
    if len(t1) != len(t2):
        return False
    for a, b in zip(t1, t2):
        if a == b:
            continue
        if synonyms is not None and (synonyms(a) & synonyms(b)):
            continue
        return False
    return True


def spice_pair(cand: Set[TupleN], refs: Set[TupleN],
               synonyms: Optional[SynonymFn] = None) -> float:
    """F1 over proposition tuples (the published SPICE combination:
    P = |matched cand| / |cand|, R = |matched ref| / |refs-union|)."""
    if not cand or not refs:
        return 0.0
    if synonyms is None:
        matched_c = len(cand & refs)
        matched_r = matched_c
    else:
        matched_c = sum(1 for t in cand
                        if any(_tuple_match(t, r, synonyms) for r in refs))
        matched_r = sum(1 for r in refs
                        if any(_tuple_match(r, t, synonyms) for t in cand))
    p = matched_c / len(cand)
    r = matched_r / len(refs)
    if p + r == 0:
        return 0.0
    return 2 * p * r / (p + r)


_CONNECTORS = (DETERMINERS | PREPOSITIONS | COPULAS | AUXILIARIES
               | CONJUNCTIONS | PRONOUNS | PARTICLES)


def parse_coverage(tokens: List[str], g: SceneGraph) -> float:
    """Fraction of a caption's content tokens (connectors excluded) that the
    rule-based parse consumed into some proposition tuple — the per-run
    caveat metric reported next to SPICE in ``language_eval``.  A low value
    flags captions whose constructions the chunker does not understand
    (their propositions are missing from the F1 on BOTH sides)."""
    content = [t for t in tokens if t not in _CONNECTORS]
    if not content:
        return 1.0
    vocab: Set[str] = set()
    for t in g.tuples():
        for el in t:
            vocab.update(el.split())
    hit = sum(1 for t in content if t in vocab or _lemma(t) in vocab)
    return hit / len(content)


def corpus_parse_coverage(gts: Dict, res: Dict) -> float:
    """Mean ``parse_coverage`` over all candidate AND reference captions
    (both sides go through the same parser, so both sides' blind spots
    matter)."""
    vals = []
    for k in res:
        for s in list(res[k][:1]) + list(gts.get(k, [])):
            toks = s.split()
            vals.append(parse_coverage(toks, parse_scene_graph(toks)))
    return sum(vals) / max(len(vals), 1)


def compute_spice(gts: Dict, res: Dict,
                  synonyms: Optional[SynonymFn] = None,
                  parser: Optional[Callable[[str], SceneGraph]] = None
                  ) -> Tuple[float, List[float]]:
    """gts: {key: [ref strings]}, res: {key: [hyp string]} — strings are
    space-tokenized captions (ptb_tokenize output).  ``parser`` overrides
    the rule-based scene-graph extractor (e.g. a Stanford-parser bridge)."""
    parse = (lambda s: parser(s)) if parser else (
        lambda s: parse_scene_graph(s.split()))
    keys = list(res.keys())
    scores = []
    for k in keys:
        cand = parse(res[k][0]).tuples()
        ref_union: Set[TupleN] = set()
        for rstr in gts[k]:
            ref_union |= parse(rstr).tuples()
        scores.append(spice_pair(cand, ref_union, synonyms))
    return sum(scores) / max(len(scores), 1), scores
