"""``--true_fp16`` on the CPU: the port's loss scaling
(vlp_tpu_torch/optim.py ``DynamicLossScale``, train_step.py ``apply_grads``)
and its fp16 model and attention against the JAX package.

* ``DynamicLossScale`` against JAX's class: the four cases of
  tests/test_extras.py::TestLossScale, on both.
* A power-of-two scale is exact in fp32: the scaled step lands on the
  unscaled step's parameters bit for bit (as TestTrueFp16TrainStep).
* On identical weights and batches (fp32, dropout off), the port's
  loss-scaled step equals JAX's ``make_train_step(loss_scale=...)`` over a
  good step, an overflow (an inf feature: params, both moments and the
  schedule's step kept, the scale halved, good_steps zeroed) and a good
  step again: scale, good_steps, skipped_step exactly; parameters and
  moments at the fp32 tolerance of tests/test_torch_train_step.py.
* A tiny fp16 model: loss and scaled gradients against JAX in fp16 (XLA
  attention, as the JAX CLI runs ``--true_fp16``).
* The plain fp16 attention, forward and backward, against JAX's XLA
  attention in fp16."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_train_step import (_by_name, init_params, make_batch,
                                         tiny_cfg)
from vlp_tpu import optim as jopt
from vlp_tpu.ops import attention as jattn
from vlp_tpu.ops.masks import attention_bias
from vlp_tpu.parallel import train_step as jts
from vlp_tpu_torch import optim as topt
from vlp_tpu_torch import train_step as tts
from vlp_tpu_torch.models.model import VLPModel
from vlp_tpu_torch.ops import attention as tattn

TOL = dict(rtol=1e-4, atol=1e-5)        # fp32, test_torch_train_step.py's


def _ls_case(mod, case, t):
    """Run one TestLossScale case with module ``mod``'s class; ``t``
    makes a tensor of that framework.  Returns what the case observes."""
    if case == "skip_on_overflow_and_halve":
        ls = mod.DynamicLossScale(init_scale=16.0, growth_interval=2)
        st = ls.init()
        grads, finite = ls.unscale_and_check(
            {"w": t([math.inf, 1.0])}, st)
        st = ls.update(st, finite)
        # the skipped update itself: test_loss_scaled_steps_and_overflow_
        # match_jax (BertAdam.step(finite=...) against apply_or_skip)
        return [bool(finite), float(st["scale"]), int(st["good_steps"])]
    if case == "growth":
        ls = mod.DynamicLossScale(init_scale=4.0, growth_interval=2)
        st = ls.init()
        fin = t(True)
        seen = []
        for _ in range(3):
            st = ls.update(st, fin)
            seen.append((float(st["scale"]), int(st["good_steps"])))
        return seen
    if case == "static_never_adjusts":
        ls = mod.DynamicLossScale(init_scale=128.0, growth_interval=1,
                                  static=True)
        st = ls.init()
        seen = []
        for fin in (False, True, True):
            st = ls.update(st, t(fin))
            seen.append(float(st["scale"]))
        return seen
    ls = mod.DynamicLossScale(init_scale=32.0)          # scale_unscale
    st = ls.init()
    g, finite = ls.unscale_and_check({"w": t([64.0])}, st)
    return [float(ls.scale_loss(t(2.0), st)), bool(finite),
            np.asarray(g["w"]).tolist()]


@pytest.mark.parametrize("case", ["skip_on_overflow_and_halve", "growth",
                                  "static_never_adjusts",
                                  "scale_unscale_roundtrip"])
def test_dynamic_loss_scale_matches_jax(case):
    want = _ls_case(jopt, case, jnp.asarray)
    got = _ls_case(topt, case, torch.tensor)
    assert got == want


def _port(cfg, params, **opt_kw):
    model = VLPModel(cfg)
    model.load_state_dict(_by_name(params, cfg), strict=True)
    return model, topt.BertAdam(dict(model.named_parameters()), 1e-3,
                                **opt_kw)


def _tbatch(b):
    return {k: torch.from_numpy(np.array(v)) for k, v in b.items()}


def test_power_of_two_scale_is_the_unscaled_step(rng):
    cfg = tiny_cfg()
    params = init_params(cfg, 0)
    batches = [make_batch(cfg, 4, rng, 0.0) for _ in range(2)]
    runs = {}
    for scaled in (False, True):
        model, opt = _port(cfg, params, warmup=0.1, t_total=4)
        ls = topt.DynamicLossScale(init_scale=8.0, growth_interval=3)
        step = tts.make_train_step(model, opt,
                                   loss_scale=ls if scaled else None)
        metrics = [step(_tbatch(b), 7) for b in batches]
        runs[scaled] = (model, opt, metrics)
    model_s, opt_s, m_s = runs[True]
    model_p, _, m_p = runs[False]
    assert [float(m["skipped_step"]) for m in m_s] == [0.0, 0.0]
    assert [float(m["loss_scale"]) for m in m_s] == [8.0, 8.0]
    assert int(opt_s.loss_scale["good_steps"]) == 2
    assert int(opt_s.step_count) == 2
    for a, b in zip(m_s, m_p):
        assert float(a["loss"]) == float(b["loss"])
    want = dict(model_p.named_parameters())
    for n, p in model_s.named_parameters():
        assert torch.equal(p, want[n]), n


def test_loss_scaled_steps_and_overflow_match_jax(rng):
    """good, overflow (an inf feature), good: the second step changes
    nothing but the scale (halved) and good_steps (zeroed), on both; the
    third runs at the schedule's step 1, on both."""
    cfg = tiny_cfg()
    params = init_params(cfg, 0)
    jmodel = jts.create_model(cfg)
    tx = jts.make_optimizer(cfg, params, lr=1e-3, warmup=0.1, t_total=4)
    ls_j = jopt.DynamicLossScale(init_scale=8.0, growth_interval=2)
    state = jts.TrainState(params=params, opt_state=tx.init(params),
                           step=jnp.zeros((), jnp.int32),
                           loss_scale=ls_j.init())
    jstep = jax.jit(jts.make_train_step(jmodel, tx, loss_scale=ls_j))
    model, opt = _port(cfg, params, warmup=0.1, t_total=4)
    tstep = tts.make_train_step(
        model, opt, loss_scale=topt.DynamicLossScale(init_scale=8.0,
                                                     growth_interval=2))
    batches = [make_batch(cfg, 4, rng, 0.0) for _ in range(3)]
    batches[1]["vis_feats"][0, 0, 0] = np.inf
    seen = []
    for i, b in enumerate(batches):
        before = {n: p.detach().clone() for n, p in model.named_parameters()}
        m_before = {n: t.clone() for n, t in opt.m.items()}
        state, m_j = jstep(state, {k: jnp.asarray(v) for k, v in b.items()},
                           jax.random.PRNGKey(1), 0.0)
        m = tstep(_tbatch(b), 7)
        got = (float(m["skipped_step"]), float(m["loss_scale"]),
               float(opt.loss_scale["scale"]),
               int(opt.loss_scale["good_steps"]), int(opt.step_count))
        want = (float(m_j["skipped_step"]), float(m_j["loss_scale"]),
                float(state.loss_scale["scale"]),
                int(state.loss_scale["good_steps"]),
                int(state.opt_state.step))
        assert got == want, i
        seen.append(got)
        if i == 1:
            for n, p in model.named_parameters():
                assert torch.equal(p, before[n]), n
                assert torch.equal(opt.m[n], m_before[n]), n
        for tree, mine in ((state.params, dict(model.named_parameters())),
                           (state.opt_state.m, opt.m),
                           (state.opt_state.v, opt.v)):
            want_t = _by_name(tree, cfg)
            for n, t in mine.items():
                np.testing.assert_allclose(t.detach().numpy(),
                                           want_t[n].numpy(), **TOL,
                                           err_msg=f"step {i}: {n}")
    assert seen == [(0.0, 8.0, 8.0, 1, 1), (1.0, 4.0, 4.0, 0, 1),
                    (0.0, 4.0, 4.0, 1, 2)]


# fp16 against JAX's fp16: both round every activation to fp16 (2^-11
# relative), at points that differ between XLA's fused CPU kernels and
# PyTorch's per-op ones, over two layers; a few fp16 ulps of each value,
# relative to the largest of its tensor.
FP16_LOSS_RTOL = 2e-3
FP16_GRAD_TOL = 2e-2     # of max |g| of each tensor


def test_fp16_model_loss_and_grads_match_jax_fp16(rng):
    cfg = tiny_cfg(dtype="float16", use_pallas_attention=False)
    params = init_params(cfg, 0)
    batch = make_batch(cfg, 4, rng, 0.0)
    scale = 1024.0
    grads_j, metrics_j = jax.jit(lambda p, b: jts.grads_with_accum(
        jts.create_model(cfg), p, b, jax.random.PRNGKey(1),
        drop_worst_ratio=0.0, mask_image_regions=False, task="img2txt",
        scale=jnp.float32(scale)))(
            params, {k: jnp.asarray(v) for k, v in batch.items()})
    model, _ = _port(cfg, params)
    metrics = tts.grads_with_accum(model, _tbatch(batch), 7,
                                   drop_worst_ratio=0.0,
                                   mask_image_regions=False,
                                   scale=torch.tensor(scale))
    np.testing.assert_allclose(float(metrics["loss"]),
                               float(metrics_j["loss"]),
                               rtol=FP16_LOSS_RTOL)
    want = _by_name(grads_j, cfg)
    for n, p in model.named_parameters():
        g = torch.zeros_like(p) if p.grad is None else p.grad
        w = want[n].float()
        assert torch.isfinite(g).all(), n
        atol = FP16_GRAD_TOL * max(float(w.abs().max()), 1e-3)
        np.testing.assert_allclose(g.numpy(), w.numpy(), atol=atol, rtol=0,
                                   err_msg=n)


# one fp16 ulp at [1, 2) is 9.8e-4: the outputs within two ulps of their
# size; the gradients (fp32 sums of fp16-rounded products on the JAX
# side, fp32 throughout in the plain backward) within 1% of max |g|
FP16_ATTN_TOL = dict(atol=2e-3, rtol=2e-3)
FP16_ATTN_GRAD_TOL = 1e-2


@pytest.mark.parametrize("mode", ["s2s", "bi", "mixed"])
def test_plain_fp16_attention_matches_jax_xla_fp16(rng, mode):
    B, L, H, D, P = 3, 24, 2, 8, 7
    modes = {"s2s": [1, 1, 1], "bi": [0, 0, 0], "mixed": [1, 0, 1]}[mode]
    q, k, v, do = (rng.normal(size=(B, L, H, D)).astype(np.float16)
                   for _ in range(4))
    md = np.asarray(modes, np.int32)
    te = np.asarray([L, P + 3, P + 9], np.int32)
    vis_keep = (rng.random((B, P - 2)) > 0.4).astype(np.float32)
    ck = np.ones((B, L), np.float32)
    ck[:, 1:P - 1] = vis_keep
    bias = attention_bias(jnp.asarray(md), jnp.asarray(te),
                          jnp.asarray(vis_keep), P, L)

    def jf(q, k, v):
        out = jattn.attention_xla(*(x.transpose(0, 2, 1, 3)
                                    for x in (q, k, v)), bias)
        return out.transpose(0, 2, 1, 3)

    out_j, vjp = jax.vjp(jf, *(jnp.asarray(x) for x in (q, k, v)))
    grads_j = vjp(jnp.asarray(do))
    tq, tk, tv, tdo = (torch.from_numpy(x) for x in (q, k, v, do))
    meta = (torch.from_numpy(md), torch.from_numpy(te),
            torch.from_numpy(ck))
    out = tattn.attention_plain(tq, tk, tv, *meta, prefix=P)
    grads = tattn.attention_bwd_plain(tq, tk, tv, *meta, tdo, prefix=P)
    assert out.dtype == torch.float16
    np.testing.assert_allclose(out.float().numpy(),
                               np.asarray(out_j, np.float32),
                               **FP16_ATTN_TOL)
    for name, g, w in zip(("dq", "dk", "dv"), grads, grads_j):
        assert g.dtype == torch.float16
        w = np.asarray(w, np.float32)
        np.testing.assert_allclose(
            g.float().numpy(), w,
            atol=FP16_ATTN_GRAD_TOL * float(np.abs(w).max()), rtol=0,
            err_msg=name)
