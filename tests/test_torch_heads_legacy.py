"""The legacy BERT task heads (vlp_tpu_torch/models/heads_legacy.py)
against the JAX package's (vlp_tpu/models/heads_legacy.py) on carried
weights, fp32, deterministic: each head's outputs and loss.  The weights
go through ``checkpoint.state_dict_from_flax(..., legacy=True)`` and load
with ``strict=True``, so every parameter of the port's head, its own
layer included, is set from the JAX tree (perturbed from its
initialisation, so that zero biases cannot hide a wrong map).  A
reference-named state dict (JAX ``legacy_head_params_to_torch``) loads
through ``apply_surgery`` into the same values."""

import jax
import numpy as np
import pytest
import torch

from vlp_tpu import checkpoint as jckpt
from vlp_tpu.config import VLPConfig
from vlp_tpu.models import heads_legacy as jheads
from vlp_tpu_torch import checkpoint as tckpt
from vlp_tpu_torch.models import heads_legacy as theads

TOL = dict(rtol=1e-5, atol=1e-5)
B, C = 3, 2


def tiny_cfg():
    return VLPConfig.tiny(vocab_size=40, len_vis_input=5, max_len_b=6,
                          vis_feat_dim=12, vis_cls_dim=4, vis_pe_dim=10,
                          use_pallas_attention=False)


def _inputs(name, cfg, rng):
    """(constructor kwargs, call kwargs as numpy) of head ``name``."""
    L, V, H = cfg.seq_len, cfg.vocab_size, cfg.hidden_size
    ids = rng.integers(1, V, size=(B, L)).astype(np.int32)
    tt = rng.integers(0, 2, size=(B, L)).astype(np.int32)
    alen = rng.integers(cfg.len_vis_input + 2, L + 1, size=(B,)).astype(
        np.int32)
    text = dict(input_ids=ids, token_type_ids=tt, attention_len=alen)
    if name == "BertForMaskedLM":
        labels = rng.integers(1, V, size=(B, L)).astype(np.int32)
        labels[:, ::3] = -1
        labels[:, 1::5] = 0
        return {}, dict(text, masked_lm_labels=labels)
    if name in ("BertForPreTraining", "BertForNextSentencePrediction"):
        return {}, text
    if name == "BertForSequenceClassification":
        return dict(num_labels=3), dict(text, labels=rng.integers(
            0, 3, size=(B,)).astype(np.int32))
    if name == "BertForMultipleChoice":
        return dict(num_choices=C), dict(
            input_ids=rng.integers(1, V, size=(B, C, L)).astype(np.int32),
            token_type_ids=rng.integers(0, 2, size=(B, C, L)).astype(
                np.int32),
            attention_len=rng.integers(cfg.len_vis_input + 2, L + 1,
                                       size=(B, C)).astype(np.int32),
            labels=rng.integers(0, C, size=(B,)).astype(np.int32))
    if name == "BertForTokenClassification":
        return dict(num_labels=3), dict(text, labels=rng.integers(
            0, 3, size=(B, L)).astype(np.int32))
    if name == "BertForQuestionAnswering":
        return {}, dict(text, start_positions=rng.integers(
            0, L, size=(B,)).astype(np.int32), end_positions=rng.integers(
            0, L, size=(B,)).astype(np.int32))
    if name == "BertForExtractiveSummarization":
        return {}, dict(text, sentence_positions=rng.integers(
            0, L, size=(B, 3)).astype(np.int32))
    mask = np.where(rng.random((B, 4)) > 0.5, 1.0, -1.0).astype(np.float32)
    return dict(num_rel=3), dict(                      # PairRelHead
        pair_x=rng.normal(size=(B, 4, H)).astype(np.float32),
        pair_y=rng.normal(size=(B, 4, H)).astype(np.float32),
        pair_r=rng.integers(0, 3, size=(B, 4)).astype(np.int32),
        pair_pos_neg_mask=mask)


def _flat(out):
    return [np.asarray(x, np.float32) for x in
            (out if isinstance(out, (tuple, list)) else (out,))]


@pytest.mark.parametrize("name", [h.__name__ for h in theads.HEADS])
def test_head_matches_jax(name, rng):
    cfg = tiny_cfg()
    ctor, call = _inputs(name, cfg, rng)
    jhead = getattr(jheads, name)(cfg, **ctor)
    jcall = {k: jax.numpy.asarray(v) for k, v in call.items()}
    params = jhead.init(jax.random.PRNGKey(2), **jcall)["params"]
    params = jax.tree_util.tree_map(
        lambda x: np.asarray(x) + rng.normal(scale=0.02, size=x.shape).astype(
            np.float32), params)
    head = getattr(theads, name)(cfg, **ctor)
    head.load_state_dict(tckpt.state_dict_from_flax(params, cfg, legacy=True),
                         strict=True)
    head.eval()
    tcall = {k: torch.from_numpy(v) for k, v in call.items()}
    with torch.no_grad():
        got = _flat(head(**tcall))
    want = _flat(jhead.apply({"params": params}, **jcall))
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert np.isfinite(g).all()
        np.testing.assert_allclose(g, w, **TOL)
    if name not in ("BertForPreTraining", "BertForNextSentencePrediction",
                    "BertForExtractiveSummarization", "PairRelHead"):
        # the logits too, for the heads whose call above returned a loss
        loss_keys = {"masked_lm_labels", "labels", "start_positions",
                     "end_positions"}
        with torch.no_grad():
            got = _flat(head(**{k: v for k, v in tcall.items()
                                if k not in loss_keys}))
        want = _flat(jhead.apply({"params": params}, **{
            k: v for k, v in jcall.items() if k not in loss_keys}))
        for g, w in zip(got, want):
            np.testing.assert_allclose(g, w, **TOL)

    # the reference-named state dict of the same weights loads as the VLP
    # one does (apply_surgery, then load_into); extract is the one head
    # parameter the JAX package's map leaves out
    sd = jckpt.legacy_head_params_to_torch(params, cfg)
    fresh = getattr(theads, name)(cfg, **ctor)
    missing = tckpt.load_into(fresh, {
        k: torch.from_numpy(np.ascontiguousarray(v))
        for k, v in tckpt.apply_surgery(sd, cfg).items()})
    assert sorted(m for m in missing if m != tckpt.TIED_DECODER) == (
        ["extract.bias", "extract.weight"]
        if name == "BertForExtractiveSummarization" else [])
    want_sd = head.state_dict()
    for k, v in fresh.state_dict().items():
        if not k.startswith("extract."):
            assert torch.equal(v, want_sd[k]), k
