"""WordPiece tokenizer (pure Python, host-side).

Behavioral parity with the reference tokenizer
(reference pytorch_pretrained_bert/tokenization.py:55-353): vocab loading
remaps ``[unused1]`` -> ``[X_SEP]`` and ``[unused2..11]`` -> ``[SEP_0..9]``;
basic tokenization cleans control chars, isolates CJK codepoints, optionally
lower-cases + strips accents, splits punctuation; WordPiece is greedy
longest-match-first with a 100-char word cap.

Tokenization is host work feeding the device input pipeline — there is no
device-side component.
"""

from __future__ import annotations

import unicodedata
from typing import Dict, Iterable, List, Optional, Sequence

NEVER_SPLIT = ("[UNK]", "[SEP]", "[X_SEP]", "[PAD]", "[CLS]", "[MASK]")

_UNUSED_REMAP = {"[unused1]": "[X_SEP]"}
for _i in range(10):
    _UNUSED_REMAP[f"[unused{_i + 2}]"] = f"[SEP_{_i}]"


def load_vocab(vocab_file: str) -> Dict[str, int]:
    """Load a BERT vocab.txt, applying the VLP unused-token remap."""
    vocab: Dict[str, int] = {}
    with open(vocab_file, "r", encoding="utf-8") as f:
        for index, line in enumerate(f):
            token = line.rstrip("\n")
            if not token and line == "":
                break
            token = token.strip()
            vocab[_UNUSED_REMAP.get(token, token)] = index
    return vocab


def _is_whitespace(ch: str) -> bool:
    if ch in (" ", "\t", "\n", "\r"):
        return True
    return unicodedata.category(ch) == "Zs"


def _is_control(ch: str) -> bool:
    if ch in ("\t", "\n", "\r"):
        return False
    return unicodedata.category(ch).startswith("C")


def _is_punctuation(ch: str) -> bool:
    cp = ord(ch)
    if (33 <= cp <= 47) or (58 <= cp <= 64) or (91 <= cp <= 96) or (123 <= cp <= 126):
        return True
    return unicodedata.category(ch).startswith("P")


def _is_cjk(cp: int) -> bool:
    return (
        0x4E00 <= cp <= 0x9FFF or 0x3400 <= cp <= 0x4DBF
        or 0x20000 <= cp <= 0x2A6DF or 0x2A700 <= cp <= 0x2B73F
        or 0x2B740 <= cp <= 0x2B81F or 0x2B820 <= cp <= 0x2CEAF
        or 0xF900 <= cp <= 0xFAFF or 0x2F800 <= cp <= 0x2FA1F
    )


class BasicTokenizer:
    """Whitespace/punctuation/CJK splitting with optional lowercasing."""

    def __init__(self, do_lower_case: bool = True,
                 never_split: Sequence[str] = NEVER_SPLIT):
        self.do_lower_case = do_lower_case
        self.never_split = set(never_split)

    def tokenize(self, text: str) -> List[str]:
        cleaned = []
        for ch in text:
            cp = ord(ch)
            if cp == 0 or cp == 0xFFFD or _is_control(ch):
                continue
            cleaned.append(" " if _is_whitespace(ch) else ch)
        spaced = []
        for ch in "".join(cleaned):
            if _is_cjk(ord(ch)):
                spaced.extend((" ", ch, " "))
            else:
                spaced.append(ch)
        out: List[str] = []
        for token in "".join(spaced).split():
            if self.do_lower_case and token not in self.never_split:
                token = token.lower()
                token = "".join(
                    ch for ch in unicodedata.normalize("NFD", token)
                    if unicodedata.category(ch) != "Mn")
            out.extend(self._split_punct(token))
        return " ".join(out).split()

    def _split_punct(self, token: str) -> List[str]:
        if token in self.never_split:
            return [token]
        pieces: List[List[str]] = []
        new_word = True
        for ch in token:
            if _is_punctuation(ch):
                pieces.append([ch])
                new_word = True
            else:
                if new_word:
                    pieces.append([])
                new_word = False
                pieces[-1].append(ch)
        return ["".join(p) for p in pieces]


class WordpieceTokenizer:
    """Greedy longest-match-first subword segmentation."""

    def __init__(self, vocab: Dict[str, int], unk_token: str = "[UNK]",
                 max_chars_per_word: int = 100):
        self.vocab = vocab
        self.unk_token = unk_token
        self.max_chars_per_word = max_chars_per_word

    def tokenize(self, text: str) -> List[str]:
        out: List[str] = []
        for token in text.strip().split():
            if len(token) > self.max_chars_per_word:
                out.append(self.unk_token)
                continue
            subs: List[str] = []
            start, n = 0, len(token)
            ok = True
            while start < n:
                end = n
                match: Optional[str] = None
                while start < end:
                    piece = token[start:end]
                    if start > 0:
                        piece = "##" + piece
                    if piece in self.vocab:
                        match = piece
                        break
                    end -= 1
                if match is None:
                    ok = False
                    break
                subs.append(match)
                start = end
            out.extend(subs if ok else [self.unk_token])
        return out


class BertTokenizer:
    """End-to-end tokenizer: basic split + WordPiece + id mapping."""

    def __init__(self, vocab_file: str, do_lower_case: bool = True,
                 max_len: Optional[int] = None,
                 never_split: Sequence[str] = NEVER_SPLIT):
        self.vocab = load_vocab(vocab_file)
        self.ids_to_tokens = {i: t for t, i in self.vocab.items()}
        self.basic_tokenizer = BasicTokenizer(do_lower_case, never_split)
        self.wordpiece_tokenizer = WordpieceTokenizer(self.vocab)
        self.max_len = max_len if max_len is not None else int(1e12)

    def tokenize(self, text: str) -> List[str]:
        out: List[str] = []
        for token in self.basic_tokenizer.tokenize(text):
            out.extend(self.wordpiece_tokenizer.tokenize(token))
        return out

    def convert_tokens_to_ids(self, tokens: Iterable[str]) -> List[int]:
        ids = [self.vocab[t] for t in tokens]
        if len(ids) > self.max_len:
            raise ValueError(
                f"sequence length {len(ids)} exceeds tokenizer max_len {self.max_len}")
        return ids

    def convert_ids_to_tokens(self, ids: Iterable[int]) -> List[str]:
        return [self.ids_to_tokens[i] for i in ids]

    @property
    def vocab_words(self) -> List[str]:
        return list(self.vocab.keys())


class WhitespaceTokenizer:
    """Pass-through tokenizer for pre-tokenized input."""

    def tokenize(self, text: str) -> List[str]:
        return text.strip().split()


def detokenize(tokens: List[str]) -> List[str]:
    """Merge ``##`` word pieces back into words (decode_img2txt.py:36-43)."""
    out: List[str] = []
    for tk in tokens:
        if tk.startswith("##") and out:
            out[-1] = out[-1] + tk[2:]
        else:
            out.append(tk)
    return out
