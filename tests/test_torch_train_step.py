"""The port's training step (vlp_tpu_torch/train_step.py, optim.py,
losses.py and the model's training forward) against the JAX package's
``make_train_step`` on identical weights and batches: fp32, dropout off,
``VLPConfig.tiny`` with the Pallas attention (interpret mode) on the JAX
side.  The loss, every gradient, and the parameters after two BertAdam steps
(warmup schedule, so the first step runs at lr 0 and the second does not)
agree to fp32 reassociation: loss rtol 1e-5, gradients and parameters
atol 1e-5 / rtol 1e-4."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vlp_tpu.checkpoint import params_to_torch
from vlp_tpu.config import VLPConfig
from vlp_tpu.data.example_builder import TrainExampleBuilder, collate
from vlp_tpu.parallel import train_step as jts
from vlp_tpu_torch import optim as topt
from vlp_tpu_torch import train_step as tts
from vlp_tpu_torch.models.model import VLPModel

LOSS_TOL = dict(rtol=1e-5, atol=1e-6)
TOL = dict(rtol=1e-4, atol=1e-5)
WORDS = [f"w{i}" for i in range(34)]
VOCAB = {w: i for i, w in enumerate(
    ["[PAD]", "[UNK]", "[X_SEP]", "[CLS]", "[SEP]", "[MASK]"] + WORDS)}


def tiny_cfg(**kw):
    base = dict(vocab_size=len(VOCAB), len_vis_input=10, max_len_b=6,
                max_pred=3, vis_feat_dim=12, vis_cls_dim=4, vis_pe_dim=10,
                hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0,
                use_pallas_attention=True)
    base.update(kw)
    return VLPConfig.tiny(**base)


def init_params(cfg, seed):
    """JAX params of ``cfg``, initialised under one jit (op by op, the init
    costs ~10 s of per-op compiles on the CPU) through the XLA attention
    path (the same tree; no Pallas kernel to interpret)."""
    xla = cfg.replace(use_pallas_attention=False)
    model = jts.create_model(xla)
    return jax.jit(lambda key: jts.init_params(model, xla, key))(
        jax.random.PRNGKey(seed))


@pytest.fixture(scope="module")
def params0():
    return init_params(tiny_cfg(), 0)


def make_batch(cfg, B, rng, vis_mask_prob):
    exs = []
    for i in range(B):
        b = TrainExampleBuilder(cfg, VOCAB, mode="s2s" if i % 2 else "bi",
                                mask_prob=0.4, vis_mask_prob=vis_mask_prob)
        toks = [WORDS[j] for j in rng.integers(0, len(WORDS),
                                               rng.integers(2, 7))]
        exs.append(b(toks, rng.normal(size=(10, 12)).astype(np.float32),
                     rng.normal(size=(10, 10)).astype(np.float32), rng))
    return collate(exs)


def _by_name(tree, cfg):
    return {k: torch.from_numpy(np.array(v))
            for k, v in params_to_torch(tree, cfg).items()}


CASES = {
    "plain": dict(ls=0.0, ratio=0.0, pretext=False, accum=1),
    # label smoothing, drop-worst (of each 2-example micro-batch, one is
    # kept) and the pretext loss, under gradient accumulation
    "smoothing_drop_worst_pretext_accum2": dict(ls=0.1, ratio=0.5,
                                                pretext=True, accum=2),
}


def _grad(p):
    return torch.zeros_like(p) if p.grad is None else p.grad


@pytest.mark.parametrize("case", sorted(CASES))
def test_train_step_matches_jax(case, rng, params0):
    c = CASES[case]
    cfg = tiny_cfg(label_smoothing=c["ls"])
    jmodel = jts.create_model(cfg)
    params = params0
    tx = jts.make_optimizer(cfg, params, lr=1e-3, warmup=0.1, t_total=4)
    state = jts.TrainState(params=params, opt_state=tx.init(params),
                           step=jnp.zeros((), jnp.int32))
    model = VLPModel(cfg)
    model.load_state_dict(_by_name(state.params, cfg), strict=True)
    optimizer = topt.BertAdam(dict(model.named_parameters()), 1e-3,
                               warmup=0.1, t_total=4)
    kw = dict(mask_image_regions=c["pretext"], grad_accum=c["accum"])
    step = jax.jit(jts.make_train_step(jmodel, tx, **kw))
    tstep = tts.make_train_step(model, optimizer, **kw)
    batches = [make_batch(cfg, 4, rng, 0.3 if c["pretext"] else 0.0)
               for _ in range(2)]
    if c["accum"] == 1:
        # the gradients themselves (under accumulation the first moments
        # below check them: m = 0.1 * clip(g) after one step)
        jb = {k: jnp.asarray(v) for k, v in batches[0].items()}
        grads_j, metrics_j = jax.jit(lambda p, b: jts.grads_with_accum(
            jmodel, p, b, jax.random.PRNGKey(1),
            drop_worst_ratio=c["ratio"], mask_image_regions=c["pretext"],
            task="img2txt"))(state.params, jb)
        metrics = tts.grads_with_accum(
            model, {k: torch.from_numpy(v) for k, v in batches[0].items()},
            7, drop_worst_ratio=c["ratio"], mask_image_regions=c["pretext"])
        for key in ("loss", "masked_lm_loss", "pretext_loss"):
            np.testing.assert_allclose(float(metrics[key]),
                                       float(metrics_j[key]), **LOSS_TOL,
                                       err_msg=key)
        want = _by_name(grads_j, cfg)
        for name, p in model.named_parameters():
            np.testing.assert_allclose(_grad(p).numpy(), want[name].numpy(),
                                       **TOL, err_msg=name)

    for i, nb in enumerate(batches):
        state, m_j = step(state, {k: jnp.asarray(v) for k, v in nb.items()},
                          jax.random.PRNGKey(1), c["ratio"])
        m = tstep({k: torch.from_numpy(v) for k, v in nb.items()}, 7,
                  c["ratio"])
        for key in ("loss", "masked_lm_loss", "pretext_loss"):
            np.testing.assert_allclose(float(m[key]), float(m_j[key]),
                                       **LOSS_TOL, err_msg=key)
        if c["pretext"]:
            assert float(m["pretext_loss"]) > 0.1
        if i == 0:
            for tree, got in ((state.opt_state.m, optimizer.m),
                              (state.opt_state.v, optimizer.v)):
                want = _by_name(tree, cfg)
                for name, t in got.items():
                    np.testing.assert_allclose(t.numpy(), want[name].numpy(),
                                               **TOL, err_msg=name)
    assert optimizer.step_count == int(state.opt_state.step) == 2
    want = _by_name(state.params, cfg)
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                                   **TOL, err_msg=name)


def test_schedules_and_decay_mask_match_jax(params0):
    from vlp_tpu import optim as jopt
    x = np.linspace(0.0, 1.2, 13).astype(np.float32)
    for name, fn in topt.SCHEDULES.items():
        got = fn(torch.from_numpy(x), 0.1).numpy()
        # one fp32 ulp: torch's and XLA's cos round differently
        np.testing.assert_allclose(
            got, np.asarray(jopt.SCHEDULES[name](jnp.asarray(x), 0.1)),
            rtol=2e-6, atol=1e-7, err_msg=name)
    cfg = tiny_cfg()
    params = params0
    want = params_to_torch(jopt.default_weight_decay_mask(params), cfg)
    got = topt.default_weight_decay_mask(
        n for n, _ in VLPModel(cfg).named_parameters())
    assert got == {k: bool(want[k]) for k in got}
    assert not got["bert.embeddings.LayerNorm.weight"]
    assert got["bert.embeddings.word_embeddings.weight"]


def test_finetune_decay_matches_jax(rng, params0):
    """bert_adam_finetune decays toward the anchors (fresh heads toward
    zero) exactly as the JAX optimizer."""
    from vlp_tpu import optim as jopt
    cfg = tiny_cfg()
    params = params0
    grads = jax.tree_util.tree_map(
        lambda p: jnp.asarray(rng.normal(size=p.shape).astype(np.float32)),
        params)
    anchor = jax.tree_util.tree_map(lambda p: p * 0.5, params)
    tx = jopt.bert_adam_finetune(
        1e-2, init_params=anchor, missing_key_substrings=("vis_fc",),
        weight_decay=0.1, weight_decay_mask=jopt.default_weight_decay_mask(
            params))
    updates, _ = jax.jit(tx.update)(grads, tx.init(params), params)
    want = _by_name(jax.tree_util.tree_map(jnp.add, params, updates), cfg)

    model = VLPModel(cfg)
    model.load_state_dict(_by_name(params, cfg), strict=True)
    for name, p in model.named_parameters():
        p.grad = _by_name(grads, cfg)[name].clone()
    opt = topt.bert_adam_finetune(
        dict(model.named_parameters()), 1e-2,
        init_params=_by_name(anchor, cfg),
        missing_key_substrings=("vis_embed",), weight_decay=0.1)
    opt.step()
    for name, p in model.named_parameters():
        np.testing.assert_allclose(p.detach().numpy(), want[name].numpy(),
                                   **TOL, err_msg=name)
