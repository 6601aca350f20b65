"""Caption evaluation glue — ``language_eval`` equivalent
(reference vlp/lang_utils.py:7-53) without the coco-caption/Java
dependency: BLEU-1..4, ROUGE-L and CIDEr run natively; METEOR/SPICE (Java
jars in the reference submodule) are reported only when a scorer command is
available.

Annotations: either a COCO captions_val2014-style JSON
({'annotations': [{'image_id', 'caption'}], 'images': [...]}) or a
Karpathy-format JSON ({'images': [{'sentences': [{'raw'}], 'filename', ...}]}).
"""

from __future__ import annotations

import json
import os
from collections import defaultdict
from typing import Dict, List

from vlp_tpu_torch.evals.bleu import compute_bleu
from vlp_tpu_torch.evals.cider import CiderScorer
from vlp_tpu_torch.evals.ptbtok import ptb_tokenize  # noqa: F401 (re-exported)
from vlp_tpu_torch.evals.rouge import compute_rouge


def load_references(ann_file: str) -> Dict[int, List[str]]:
    with open(ann_file, "r", encoding="utf-8") as f:
        ann = json.load(f)
    refs: Dict[int, List[str]] = defaultdict(list)
    if "annotations" in ann:
        for a in ann["annotations"]:
            refs[int(a["image_id"])].append(ptb_tokenize(a["caption"]))
    else:
        from vlp_tpu_torch.data.dataset import _image_id
        for img in ann["images"]:
            iid = _image_id(img, "coco")
            for s in img.get("sentences", []):
                refs[iid].append(ptb_tokenize(s["raw"]))
    return dict(refs)


def language_eval(ann_file: str, preds: List[dict], model_id: str,
                  split: str, out_dir: str = "eval_results") -> Dict[str, float]:
    """preds: [{'image_id': int, 'caption': str}]; returns metric dict and
    caches per-image results like lang_utils.py:20-51."""
    os.makedirs(out_dir, exist_ok=True)
    cache_path = os.path.join(out_dir, f"{model_id}_{split}.json")

    refs = load_references(ann_file)
    preds_filt = [p for p in preds if int(p["image_id"]) in refs]
    print(f"using {len(preds_filt)}/{len(preds)} predictions")
    with open(cache_path, "w") as f:
        json.dump(preds_filt, f)

    gts = {int(p["image_id"]): refs[int(p["image_id"])] for p in preds_filt}
    res = {int(p["image_id"]): [ptb_tokenize(p["caption"])]
           for p in preds_filt}

    out: Dict[str, float] = {}
    img_scores: Dict[int, Dict[str, float]] = {k: {} for k in res}
    if res:
        bleu, bleu_img = compute_bleu(gts, res)
        for i, b in enumerate(bleu, 1):
            out[f"Bleu_{i}"] = b
        cider, cider_img = CiderScorer().compute_score(gts, res)
        out["CIDEr"] = cider
        rouge, rouge_img = compute_rouge(gts, res)
        out["ROUGE_L"] = rouge
        from vlp_tpu_torch.evals.meteor import (compute_meteor, meteor_bounds,
                                          wordnet_synonyms)
        syn = wordnet_synonyms()  # synonym stage when WordNet is installed
        # Meteor-1.5 scoring (the jar coco-caption actually runs,
        # lang_utils.py:17-18): METEOR is the native 1.5 system score;
        # the [lb, ub] interval brackets the matchers that cannot run
        # air-gapped (see evals/meteor.py docstring)
        out["METEOR"], _ = compute_meteor(gts, res, syn)
        lb, ub = meteor_bounds(gts, res, syn)
        # the native score and each bound select best references
        # independently and the system formula on summed stats is not
        # monotone in that choice — clamp so the reported interval always
        # contains the reported score
        out["METEOR_lb"] = min(lb, out["METEOR"])
        out["METEOR_ub"] = max(ub, out["METEOR"])
        # SPICE: exact published scoring over an approximate (rule-based)
        # scene-graph parse — consistent across compared models; plug an
        # external parser via evals/spice.compute_spice for Java parity.
        # SPICE_parse_coverage is the per-run caveat: the fraction of
        # content tokens the parser consumed into propositions (golden
        # scene-graph fidelity is pinned in tests/test_evals.py)
        from vlp_tpu_torch.evals.spice import compute_spice, corpus_parse_coverage
        out["SPICE"], _ = compute_spice(gts, res, syn)
        out["SPICE_parse_coverage"] = corpus_parse_coverage(gts, res)
        for j, k in enumerate(res):
            img_scores[k] = {"CIDEr": cider_img[j], "ROUGE_L": rouge_img[j],
                             "Bleu_4": bleu_img[j][3]}

    with open(cache_path, "w") as f:
        json.dump({"overall": out, "imgToEval": {
            str(k): dict(v, caption=res[k][0]) for k, v in img_scores.items()
        }}, f)
    return out
