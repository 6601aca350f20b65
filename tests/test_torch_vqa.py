"""The port's VQA 2.0 model path (``VLPModel(cfg, with_vqa=True)``:
``vqa_logits``/``vqa_inference`` and ``pretrain_losses(task="vqa2")``)
against the JAX VLPModel on the same weights, carried across with
``state_dict_from_flax``: fp32, dropout off, ``VLPConfig.tiny`` with the
Pallas attention (interpret mode) on the JAX side.  Logits within 1e-5 and
identical answer ids; the VQA loss within 1e-5 and every gradient within
rtol 1e-4 / atol 1e-6 on soft answer scores.  The port's copy of
``evals/vqa.py`` scores answers as the JAX package's does."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import linen as nn

from vlp_tpu.checkpoint import params_to_torch
from vlp_tpu.config import VLPConfig
from vlp_tpu.data.example_builder import TrainExampleBuilder, collate
from vlp_tpu.evals import vqa as jvqa
from vlp_tpu.models.model import VLPModel as JaxVLPModel
from vlp_tpu.parallel import train_step as jts
from vlp_tpu_torch import train_step as tts
from vlp_tpu_torch.checkpoint import state_dict_from_flax
from vlp_tpu_torch.evals import vqa as tvqa
from vlp_tpu_torch.models.model import VLPModel

LOGIT_TOL = dict(rtol=1e-5, atol=1e-5)
LOSS_TOL = dict(rtol=1e-5, atol=1e-6)
GRAD_TOL = dict(rtol=1e-4, atol=1e-6)
WORDS = [f"w{i}" for i in range(34)]
VOCAB = {w: i for i, w in enumerate(
    ["[PAD]", "[UNK]", "[X_SEP]", "[CLS]", "[SEP]", "[MASK]"] + WORDS)}
N_ANSWERS = 40


def tiny_cfg(**kw):
    base = dict(vocab_size=len(VOCAB), len_vis_input=10, max_len_b=6,
                max_pred=3, vis_feat_dim=12, vis_cls_dim=4, vis_pe_dim=10,
                num_answers=N_ANSWERS, hidden_dropout_prob=0.0,
                attention_probs_dropout_prob=0.0, use_pallas_attention=True)
    base.update(kw)
    return VLPConfig.tiny(**base)


@pytest.fixture(scope="module")
def pair():
    """JAX VQA model + params (initialised under one jit through the XLA
    attention path: the same tree), and the port model on those weights."""
    cfg = tiny_cfg()
    xla = cfg.replace(use_pallas_attention=False)
    params = jax.jit(lambda key: jts.init_params(
        jts.create_model(xla, "vqa2"), xla, key, "vqa2"))(
            jax.random.PRNGKey(3))
    model = VLPModel(cfg, with_vqa=True)
    model.load_state_dict(state_dict_from_flax(
        jax.tree_util.tree_map(np.asarray, params), cfg), strict=True)
    return cfg, jts.create_model(cfg, "vqa2"), params, model


def vqa_batch(cfg, B, rng):
    """Bi-mode questions with soft answer scores (a few answers per
    question at the VQA score levels)."""
    b = TrainExampleBuilder(cfg, VOCAB, mode="bi", mask_prob=0.0,
                            load_vqa_ann=True)
    exs = []
    for _ in range(B):
        scores = np.zeros(N_ANSWERS, np.float32)
        scores[rng.choice(np.arange(1, N_ANSWERS), 3, replace=False)] = \
            rng.choice([0.3, 0.6, 0.9, 1.0], 3)
        toks = [WORDS[j] for j in rng.integers(0, len(WORDS),
                                               rng.integers(2, 7))]
        exs.append(b(toks, rng.normal(size=(10, 12)).astype(np.float32),
                     rng.normal(size=(10, 10)).astype(np.float32), rng,
                     ans_scores=scores))
    return collate(exs)


def _jax_logits(m, b):
    """The JAX answer logits of ``vqa_inference``, before the argmax."""
    seq, _ = m.encode(b["input_ids"], b["segment_ids"], b["mode"],
                      b["text_end"], b["vis_feats"], b["vis_pe"],
                      deterministic=True)
    e = seq[:, 0] * seq[:, m.cfg.len_vis_input + 1]
    return m.ans_fc2(nn.relu(m.ans_fc1(e)))


def test_vqa_inference_matches_jax(pair, rng):
    cfg, jmodel, params, model = pair
    nb = vqa_batch(cfg, 4, rng)
    jb = {k: jnp.asarray(v) for k, v in nb.items()}
    logits_j = np.asarray(jmodel.apply({"params": params}, jb,
                                       method=_jax_logits))
    ids_j = np.asarray(jmodel.apply({"params": params}, jb,
                                    method=JaxVLPModel.vqa_inference))
    tb = {k: torch.from_numpy(v) for k, v in nb.items()}
    with torch.no_grad():
        logits = model.vqa_logits(tb)
        ids = model.vqa_inference(tb)
    assert logits.dtype == torch.float32
    assert logits.shape == (4, N_ANSWERS)
    np.testing.assert_allclose(logits.numpy(), logits_j, **LOGIT_TOL)
    # the ids are compared where the top two answers are apart
    top2 = np.sort(logits_j[:, 1:], axis=-1)[:, -2:]
    assert (top2[:, 1] - top2[:, 0] > 1e-4).all()
    np.testing.assert_array_equal(ids.numpy(), ids_j)
    assert (ids.numpy() >= 1).all()


def test_vqa_loss_and_grads_match_jax(pair, rng):
    cfg, jmodel, params, model = pair
    nb = vqa_batch(cfg, 4, rng)
    jb = {k: jnp.asarray(v) for k, v in nb.items()}
    grads_j, metrics_j = jax.jit(lambda p, b: jts.grads_with_accum(
        jmodel, p, b, jax.random.PRNGKey(1), drop_worst_ratio=0.0,
        mask_image_regions=False, task="vqa2"))(params, jb)
    metrics = tts.grads_with_accum(
        model, {k: torch.from_numpy(v) for k, v in nb.items()}, 7,
        drop_worst_ratio=0.0, mask_image_regions=False, task="vqa2")
    for key in ("loss", "vqa2_loss", "masked_lm_loss"):
        np.testing.assert_allclose(float(metrics[key]),
                                   float(metrics_j[key]), **LOSS_TOL,
                                   err_msg=key)
    assert float(metrics["masked_lm_loss"]) == 0.0
    assert float(metrics["vqa2_loss"]) > 1.0
    want = params_to_torch(grads_j, cfg)
    for name, p in model.named_parameters():
        got = torch.zeros_like(p) if p.grad is None else p.grad
        np.testing.assert_allclose(got.numpy(), np.asarray(want[name]),
                                   **GRAD_TOL, err_msg=name)
    assert model.ans_classifier[2].weight.grad.abs().max() > 0


def test_answer_scores_and_accuracy_match_jax(tmp_path):
    vocab = tmp_path / "answers.txt"
    vocab.write_text("<unk>\nyes\nno\n2\nred\ndog\n")
    jp = jvqa.VQAAnswerProcessor(str(vocab))
    tp = tvqa.VQAAnswerProcessor(str(vocab))
    cases = [["yes"] * 10, ["no"] * 4 + ["yes"] * 6,
             ["two", "2", "Red.", "a dog", "cat", "dog", "no", "2", "2", "x"],
             ["maybe"] * 10]
    for answers in cases:
        got, want = tp.answers_scores(answers), jp.answers_scores(answers)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    assert tp.answers_scores(cases[0])[1] == 1.0
    preds = [{"question_id": i, "answer": a}
             for i, a in enumerate(["yes", "no", "2", "red"])]
    anns = {i: {"answers": a, "answer_type": "other" if i % 2 else "yes/no"}
            for i, a in enumerate(cases)}
    assert tvqa.vqa_accuracy(preds, anns) == jvqa.vqa_accuracy(preds, anns)
