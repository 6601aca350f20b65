"""The port keeps its own copies of the JAX package's JAX-free modules
(config, data/, cli/common, evals/ and the numpy half of checkpoint) so that
it imports nothing of ``vlp_tpu``.  Each copy gives the same outputs as its
original on the same inputs."""

import json
import os
import re

import numpy as np
import pytest

import vlp_tpu
import vlp_tpu_torch
from vlp_tpu import checkpoint as jckpt
from vlp_tpu.cli import common as jcommon
from vlp_tpu.config import VLPConfig as JConfig
from vlp_tpu.data import dataset as jds
from vlp_tpu.data import example_builder as jeb
from vlp_tpu.data import features as jfeat
from vlp_tpu.data import loader as jloader
from vlp_tpu.evals import coco as jcoco
from vlp_tpu_torch import checkpoint as tckpt
from vlp_tpu_torch.cli import common as tcommon
from vlp_tpu_torch.config import VLPConfig as TConfig
from vlp_tpu_torch.data import dataset as tds
from vlp_tpu_torch.data import example_builder as teb
from vlp_tpu_torch.data import features as tfeat
from vlp_tpu_torch.data import loader as tloader
from vlp_tpu_torch.evals import coco as tcoco

COPIED = ["config.py", "cli/common.py"] + [
    f"data/{m}.py" for m in ("tokenization", "example_builder", "dataset",
                             "features", "loader", "native_store")] + [
    f"evals/{m}.py" for m in ("coco", "bleu", "cider", "rouge", "ptbtok",
                              "meteor", "spice")]
TINY = dict(len_vis_input=8, max_len_b=6, max_pred=3, vis_feat_dim=12,
            vis_cls_dim=4, vis_pe_dim=10)


def _same_batches(a, b):
    assert sorted(a) == sorted(b)
    for k in a:
        np.testing.assert_array_equal(np.asarray(a[k]), np.asarray(b[k]),
                                      err_msg=k)


@pytest.mark.parametrize("path", COPIED)
def test_copy_differs_only_in_its_imports(path):
    """Line for line the original, with ``vlp_tpu.`` read as
    ``vlp_tpu_torch.`` on import lines; the docstrings cite the reference
    tree's files without the directory it was mounted at."""
    def read(pkg):
        with open(os.path.join(os.path.dirname(pkg.__file__), path)) as f:
            return f.read().splitlines()
    orig, copy = read(vlp_tpu), read(vlp_tpu_torch)
    assert len(orig) == len(copy)
    for a, b in zip(orig, copy):
        a = re.sub(r"/[a-z]+/reference/", "reference ", a)
        if a != b:
            assert a.lstrip().startswith(("from vlp_tpu.", "import vlp_tpu."))
            assert b == a.replace("vlp_tpu.", "vlp_tpu_torch.", 1)


def test_config_copy():
    assert TConfig().to_dict() == JConfig().to_dict()
    assert TConfig.tiny(**TINY).to_dict() == JConfig.tiny(**TINY).to_dict()
    assert TConfig.tiny(**TINY).seq_len == 128


def test_example_builders_and_collate(tmp_path):
    vocab_file = str(tmp_path / "vocab.txt")
    jcommon.write_synthetic_vocab(vocab_file, size=60)
    vocab = tcommon.resolve_tokenizer(vocab_file, False).vocab
    assert vocab == jcommon.resolve_tokenizer(vocab_file, False).vocab
    words = [w for w in vocab if not w.startswith("[")]
    out = {}
    for tag, eb, cfg in (("jax", jeb, JConfig.tiny(**TINY)),
                         ("port", teb, TConfig.tiny(**TINY))):
        rng = np.random.default_rng(3)
        exs = []
        for i in range(6):
            b = eb.TrainExampleBuilder(cfg, vocab,
                                       mode="s2s" if i % 2 else "bi",
                                       vis_mask_prob=0.3)
            toks = [words[j] for j in rng.integers(0, len(words),
                                                   rng.integers(2, 9))]
            exs.append(b(toks, rng.normal(size=(8, 12)),
                         rng.normal(size=(8, 10)), rng))
        dec = eb.DecodeExampleBuilder(cfg, vocab, max_tgt_length=6)
        out[tag] = (eb.collate(exs), eb.collate(
            [dec(rng.normal(size=(8, 12)), rng.normal(size=(8, 10)))
             for _ in range(3)]))
    for a, b in zip(out["jax"], out["port"]):
        _same_batches(a, b)


def test_train_loader_epoch(tmp_path):
    vocab_file = str(tmp_path / "vocab.txt")
    jcommon.write_synthetic_vocab(vocab_file, size=60)
    vocab = jcommon.resolve_tokenizer(vocab_file, False).vocab
    words = [w for w in vocab if not w.startswith("[")]
    batches = {}
    for tag, eb, ds, feat, ld, cfg in (
            ("jax", jeb, jds, jfeat, jloader, JConfig.tiny(**TINY)),
            ("port", teb, tds, tfeat, tloader, TConfig.tiny(**TINY))):
        rng = np.random.default_rng(0)
        exs = [ds.CaptionExample(
            f"img_{i}.npy", [words[j] for j in rng.integers(0, 40, 5)],
            image_id=i) for i in range(10)]
        store = feat.make_store(synthetic=True, num_regions=8, feat_dim=12,
                                cls_dim=4)
        builders = [eb.TrainExampleBuilder(cfg, vocab, mode=m,
                                           vis_mask_prob=0.25)
                    for m in ("s2s", "bi")]
        loader = ld.TrainLoader(exs, store, builders, [0.6, 0.4],
                                batch_size=3, num_workers=2, seed=9,
                                feature_slab_slots=7)
        batches[tag] = [{k: np.array(v) for k, v in b.items()}
                        for b in loader.epoch(1)]
        batches[tag + "_order"] = loader.epoch_indices(1)
    np.testing.assert_array_equal(batches["jax_order"], batches["port_order"])
    assert len(batches["jax"]) == len(batches["port"]) == 3
    for a, b in zip(batches["jax"], batches["port"]):
        _same_batches(a, b)


def test_apply_surgery_and_name_map():
    rng = np.random.default_rng(1)
    H = 8
    sd = {"bert.embeddings.token_type_embeddings.weight":
          rng.normal(size=(2, H)),
          "bert.embeddings.position_embeddings.weight":
          rng.normal(size=(40, H)),
          "bert.embeddings.LayerNorm.gamma": rng.normal(size=H),
          "bert.embeddings.LayerNorm.beta": rng.normal(size=H),
          "cls.predictions.transform.dense.weight":
          rng.normal(size=(4 * H, H)),
          "cls.predictions.transform.dense.bias": rng.normal(size=4 * H),
          "cls.predictions.transform.LayerNorm.weight":
          rng.normal(size=4 * H),
          "cls.predictions.transform.LayerNorm.bias":
          rng.normal(size=4 * H)}
    for relax, task in ((0, 2), (4, None)):
        kw = dict(hidden_size=H, num_attention_heads=2,
                  max_position_embeddings=100, relax_projection=relax)
        want = jckpt.apply_surgery(dict(sd), JConfig.tiny(**kw), task)
        got = tckpt.apply_surgery(dict(sd), TConfig.tiny(**kw), task)
        _same_batches(want, got)
        assert jckpt._torch_to_flax_map(JConfig.tiny(**kw)) == \
            tckpt._torch_to_flax_map(TConfig.tiny(**kw))


def test_language_eval(tmp_path):
    coco = {"annotations": [
        {"image_id": 1, "caption": "A man rides a horse."},
        {"image_id": 1, "caption": "a person on a brown horse"},
        {"image_id": 2, "caption": "a dog runs on the grass"},
        {"image_id": 3, "caption": "two cats sleep on a red sofa"}],
        "images": [{"id": 1}, {"id": 2}, {"id": 3}]}
    karpathy = {"images": [
        {"filename": "COCO_val2014_000000000001.jpg",
         "sentences": [{"raw": "A man rides a horse."}]},
        {"filename": "COCO_val2014_000000000002.jpg",
         "sentences": [{"raw": "a dog runs on the grass"}]}]}
    preds = [{"image_id": 1, "caption": "a man riding a horse"},
             {"image_id": 2, "caption": "a dog on grass"},
             {"image_id": 3, "caption": "a cat on a sofa"}]
    ann_file = tmp_path / "coco.json"
    ann_file.write_text(json.dumps(coco))
    want = jcoco.language_eval(str(ann_file), preds, "m", "val",
                               out_dir=str(tmp_path / "jax"))
    got = tcoco.language_eval(str(ann_file), preds, "m", "val",
                              out_dir=str(tmp_path / "port"))
    assert got == want and want["CIDEr"] > 0 and "SPICE" in got
    # the Karpathy-split references go through the port's data.dataset
    ann_file = tmp_path / "karpathy.json"
    ann_file.write_text(json.dumps(karpathy))
    refs = tcoco.load_references(str(ann_file))
    assert refs == jcoco.load_references(str(ann_file)) and len(refs) == 2
