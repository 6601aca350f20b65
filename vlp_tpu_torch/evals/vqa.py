"""VQA 2.0 answer processing + accuracy scoring, native.

Replaces the pythia pieces the reference shells out to:
  * ``VQAAnswerProcessor`` (seq2seq_loader.py:218-226) — answer vocab lookup
    and soft target scores from the 10 human answers;
  * ``pythia/legacy/eval_model/eval_demo.py`` (eval_vqa2.py:260-262) — the
    official VQA accuracy: for each answer, average over the 10
    leave-one-out subsets of min(1, matches/3).
"""

from __future__ import annotations

import json
import re
from collections import defaultdict
from typing import Dict, List, Sequence

import numpy as np

_ARTICLES = {"a", "an", "the"}
_PUNCT = re.compile(r"[;/\[\]\"{}()=+\\_\-><@`,?!.]")
_COMMA_NUM = re.compile(r"(\d),(\d)")

_CONTRACTIONS = {
    "aint": "ain't", "arent": "aren't", "cant": "can't", "couldve":
    "could've", "couldnt": "couldn't", "didnt": "didn't", "doesnt":
    "doesn't", "dont": "don't", "hadnt": "hadn't", "hasnt": "hasn't",
    "havent": "haven't", "hes": "he's", "im": "i'm", "isnt": "isn't",
    "itll": "it'll", "its": "it's", "lets": "let's", "shes": "she's",
    "shouldve": "should've", "shouldnt": "shouldn't", "thats": "that's",
    "theres": "there's", "theyd": "they'd", "theyll": "they'll",
    "theyre": "they're", "theyve": "they've", "wasnt": "wasn't",
    "werent": "weren't", "whats": "what's", "wheres": "where's",
    "wont": "won't", "wouldve": "would've", "wouldnt": "wouldn't",
    "youd": "you'd", "youll": "you'll", "youre": "you're", "youve": "you've",
}

_NUMBER_MAP = {
    "none": "0", "zero": "0", "one": "1", "two": "2", "three": "3",
    "four": "4", "five": "5", "six": "6", "seven": "7", "eight": "8",
    "nine": "9", "ten": "10",
}


def process_answer(answer: str) -> str:
    """VQA answer normalisation (punctuation, number words, articles,
    contractions) — the standard processPunctuation/processDigitArticle."""
    answer = answer.replace("\n", " ").replace("\t", " ").strip().lower()
    answer = _COMMA_NUM.sub(r"\1\2", answer)
    answer = _PUNCT.sub("", answer)
    answer = answer.replace(":", "")
    words = []
    for w in answer.split():
        w = _NUMBER_MAP.get(w, w)
        if w in _ARTICLES:
            continue
        words.append(_CONTRACTIONS.get(w, w))
    return " ".join(words)


class VQAAnswerProcessor:
    """Answer vocab + 3129-dim soft score targets."""

    def __init__(self, vocab_file: str, num_answers: int = 10):
        with open(vocab_file, "r", encoding="utf-8") as f:
            self.answers = [line.strip() for line in f if line.strip() != ""]
        self.word2idx_map = {w: i for i, w in enumerate(self.answers)}
        self.num_answers = num_answers

    def __len__(self):
        return len(self.answers)

    def word2idx(self, word: str) -> int:
        return self.word2idx_map.get(word, 0)  # 0 = <unk>

    def idx2word(self, idx: int) -> str:
        return self.answers[int(idx)]

    def answers_scores(self, answers: Sequence[str]) -> np.ndarray:
        """Soft targets: avg over leave-one-out subsets of min(1, matches/3)
        (the official VQA accuracy applied as a target)."""
        scores = np.zeros(len(self.answers), np.float32)
        answers = [process_answer(a) for a in answers]
        unique = set(answers)
        n = len(answers)
        for ans in unique:
            idx = self.word2idx_map.get(ans)
            if idx is None or idx == 0:
                continue
            accs = []
            for i in range(n):
                others = answers[:i] + answers[i + 1:]
                accs.append(min(1.0, others.count(ans) / 3.0))
            scores[idx] = float(np.mean(accs))
        return scores

    def __call__(self, item: dict) -> dict:
        return {"answers_scores": self.answers_scores(item["answers"])}


def vqa_accuracy(predictions: List[dict], annotations: Dict[int, dict]
                 ) -> Dict[str, float]:
    """Official VQA accuracy given {'question_id': ..., 'answer': str}
    predictions and {question_id: {'answers': [...], 'answer_type': t}}
    annotations."""
    per_type: Dict[str, List[float]] = defaultdict(list)
    accs: List[float] = []
    for p in predictions:
        qid = p["question_id"]
        if qid not in annotations:
            continue
        ann = annotations[qid]
        gt = [process_answer(a) for a in ann["answers"]]
        pred = process_answer(p["answer"])
        n = len(gt)
        loo = [min(1.0, (gt[:i] + gt[i + 1:]).count(pred) / 3.0)
               for i in range(n)]
        acc = float(np.mean(loo))
        accs.append(acc)
        per_type[ann.get("answer_type", "other")].append(acc)
    out = {"overall": 100.0 * float(np.mean(accs)) if accs else 0.0}
    for t, v in per_type.items():
        out[t] = 100.0 * float(np.mean(v))
    return out


def load_vqa_annotations(ann_file: str) -> Dict[int, dict]:
    """Parse v2_mscoco_*_annotations.json into {qid: {'answers', 'answer_type'}}."""
    with open(ann_file, "r", encoding="utf-8") as f:
        ann = json.load(f)
    out = {}
    for a in ann["annotations"]:
        out[a["question_id"]] = {
            "answers": [x["answer"] for x in a["answers"]],
            "answer_type": a.get("answer_type", "other"),
        }
    return out
