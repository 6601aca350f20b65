"""Faithful PTB tokenizer + coco-caption normalisation, pure Python.

The reference tokenizes captions with Stanford CoreNLP's PTBTokenizer via
the coco-caption submodule's Java jar before every metric
(reference vlp/lang_utils.py:20-24; coco-caption ptbtokenizer.py runs
``edu.stanford.nlp.process.PTBTokenizer -preserveLines -lowerCase`` and then
drops a fixed punctuation-token list).  Tokenization differences shift
BLEU/CIDEr by real tenths, so this module ports the published Penn Treebank
``tokenizer.sed`` rules (the same rule set behind nltk's
TreebankWordTokenizer) instead of approximating with a punctuation-strip
regex: contractions split ("don't" -> "do n't", "dog's" -> "dog 's"),
intra-word hyphens and abbreviations are preserved ("well-known", "u.s."),
and only the exact coco-caption punctuation TOKENS are removed.

``tests/test_evals.py`` cross-validates the tokenizer against nltk's
TreebankWordTokenizer (an independent implementation of the same rules) on
a corpus of caption-shaped sentences.
"""

from __future__ import annotations

import re
from typing import List

# Rule tables below follow the public PTB sed script order:
# starting quotes, punctuation, brackets, dashes, ending quotes,
# contraction splits.

_STARTING_QUOTES = [
    (re.compile(r"^\""), r"``"),
    (re.compile(r"(``)"), r" \1 "),
    (re.compile(r"([ \(\[{<])(\"|\'{2})"), r"\1 `` "),
]

_PUNCTUATION = [
    (re.compile(r"([:,])([^\d])"), r" \1 \2"),
    (re.compile(r"([:,])$"), r" \1 "),
    (re.compile(r"\.\.\."), r" ... "),
    (re.compile(r"[;@#$%&]"), r" \g<0> "),
    # final-sentence period (keeps interior abbreviation dots intact)
    (re.compile(r"([^\.])(\.)([\]\)}>\"\']*)\s*$"), r"\1 \2\3 "),
    (re.compile(r"[?!]"), r" \g<0> "),
    (re.compile(r"([^'])' "), r"\1 ' "),
]

_PARENS_BRACKETS = [
    (re.compile(r"[\]\[\(\)\{\}<>]"), r" \g<0> "),
]

_DOUBLE_DASHES = [
    (re.compile(r"--"), r" -- "),
]

_ENDING_QUOTES = [
    (re.compile(r"\""), r" '' "),
    (re.compile(r"(\S)(\'\')"), r"\1 \2 "),
    (re.compile(r"([^' ])('[sS]|'[mM]|'[dD]|') "), r"\1 \2 "),
    (re.compile(r"([^' ])('ll|'LL|'re|'RE|'ve|'VE|n't|N'T) "), r"\1 \2 "),
]

_CONTRACTIONS = [
    re.compile(r"(?i)\b(can)(not)\b"),
    re.compile(r"(?i)\b(d)('ye)\b"),
    re.compile(r"(?i)\b(gim)(me)\b"),
    re.compile(r"(?i)\b(gon)(na)\b"),
    re.compile(r"(?i)\b(got)(ta)\b"),
    re.compile(r"(?i)\b(lem)(me)\b"),
    re.compile(r"(?i)\b(mor)('n)\b"),
    re.compile(r"(?i)\b(wan)(na)\s"),
]
_CONTRACTIONS3 = [
    re.compile(r"(?i) ('t)(is)\b"),
    re.compile(r"(?i) ('t)(was)\b"),
]

# coco-caption ptbtokenizer.py PUNCTUATIONS — removed as exact TOKENS after
# tokenization (so "u.s." keeps its dots but a sentence-final "." drops).
# CoreNLP's DEFAULT ptb3Escaping (which the jar runs with) renders brackets
# as -LRB-/-RRB-/-LCB-/-RCB- before that filter drops them; this port emits
# literal bracket characters, so the literals are filtered too — same
# observable normalisation.
PUNCTUATIONS = frozenset([
    "''", "'", "``", "`", "-LRB-", "-RRB-", "-LCB-", "-RCB-",
    ".", "?", "!", ",", ":", "-", "--", "...", ";",
    "(", ")", "[", "]", "{", "}",
])


def ptb_tokens(text: str) -> List[str]:
    """Penn-Treebank word tokens of ``text`` (no punctuation removal)."""
    for rx, sub in _STARTING_QUOTES:
        text = rx.sub(sub, text)
    for rx, sub in _PUNCTUATION:
        text = rx.sub(sub, text)
    for rx, sub in _PARENS_BRACKETS:
        text = rx.sub(sub, text)
    for rx, sub in _DOUBLE_DASHES:
        text = rx.sub(sub, text)
    text = " " + text + " "
    for rx, sub in _ENDING_QUOTES:
        text = rx.sub(sub, text)
    for rx in _CONTRACTIONS:
        text = rx.sub(r" \1 \2 ", text)
    for rx in _CONTRACTIONS3:
        text = rx.sub(r" \1 \2 ", text)
    return text.split()


def ptb_tokenize(caption: str) -> str:
    """coco-caption normalisation: PTB tokens, lowercased, punctuation
    tokens removed, space-joined (ptbtokenizer.py semantics)."""
    return " ".join(w.lower() for w in ptb_tokens(caption)
                    if w not in PUNCTUATIONS)
