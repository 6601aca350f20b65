"""The dropout branch of the port's decode step (K5's plain version) and its
regenerator (K6's plain version, ``decode_dropout_scales``) on the CPU.

* Rate 0 is the deterministic step (K3) exactly; rate > 0 is K3's
  probabilities times ``philox.decode_keep_scale`` before the cast.
* Against the JAX package: JAX cannot draw the port's bits off a TPU (its
  CPU rollout takes ``jax.random`` in ``_incremental_cols``), so its decode
  layer is fed the port's own multipliers through ``explicit_dropout`` (the
  pattern of tests/test_torch_attention_bwd.py).  fp32, 1e-5.
* ``decode_dropout_scales`` lays out step t's draws for example b at row
  t*B + b, bit for bit those of ``decode_keep_scale`` and of Philox on
  Python ints, and keeps 1 - rate of them.

The CUDA kernels are held against these plain versions in
tests/test_torch_kernels.py."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import vlp_tpu.models.model as jax_model
from vlp_tpu_torch.ops import decode_attention as dec
from vlp_tpu_torch.ops import philox

from tests.test_torch_attention_bwd import _philox_int
from tests.test_torch_model import make_pair, tiny_cfg

NEG = -10000.0
TOL = dict(rtol=1e-5, atol=1e-5)


def _inputs(rng, B, S, P, G, HD):
    def f(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32))
    return (f(B, S, HD), f(B, S, HD), f(B, S, HD), f(B, P, HD), f(B, P, HD),
            f(B, G, HD), f(B, G, HD))


def _reference(q, k, v, pk, pv, gk, gv, gen_len, H, mult):
    """The decode step written out over the concatenated (prompt |
    generated) scores, K == 1: softmax, times ``mult``, P.V."""
    B, S, HD = q.shape
    P, G, D = pk.shape[1], gk.shape[1], HD // H
    gk, gv = gk.clone(), gv.clone()
    gk[:, gen_len:gen_len + S] = k[:, :G - gen_len]
    gv[:, gen_len:gen_len + S] = v[:, :G - gen_len]
    keys = torch.cat([pk, gk], 1).view(B, P + G, H, D)
    vals = torch.cat([pv, gv], 1).view(B, P + G, H, D)
    s = torch.einsum("bshd,bjhd->bhsj", q.view(B, S, H, D), keys) / \
        math.sqrt(D)
    vis = torch.ones(S, P + G, dtype=torch.bool)
    vis[:, P:] = (torch.arange(G)[None, :]
                  <= gen_len + torch.arange(S)[:, None])
    p = torch.softmax(s.masked_fill(~vis, NEG), dim=-1) * mult
    return torch.einsum("bhsj,bjhd->bshd", p, vals).reshape(B, S, HD)


@pytest.mark.parametrize("gen_len", [0, 3, 6, 7])
def test_plain_dropout_is_k3_times_the_multipliers(gen_len, rng):
    B, S, P, G, H, D = 3, 2, 7, 8, 2, 16
    seed, rate = 0x0DDBA11CAFEF00D5, 0.3
    ops = _inputs(rng, B, S, P, G, H * D)
    k3 = dec.decode_attention(*(t.clone() for t in ops), gen_len, n_heads=H)
    off = dec.decode_attention(*(t.clone() for t in ops), gen_len, n_heads=H,
                               drop_seed=seed, drop_rate=0.0)
    assert torch.equal(off, k3)
    mult = philox.decode_keep_scale(seed, B, H, S, P, G, rate)
    assert 0.0 < float((mult == 0).float().mean()) < 0.5
    q, k, v, pk, pv, gk, gv = (t.clone() for t in ops)
    got = dec.decode_attention(q, k, v, pk, pv, gk, gv, gen_len, n_heads=H,
                               drop_seed=seed, drop_rate=rate)
    torch.testing.assert_close(
        got, _reference(*ops, gen_len, H, mult), rtol=1e-6, atol=1e-6)
    torch.testing.assert_close(
        k3, _reference(*ops, gen_len, H, torch.ones_like(mult)),
        rtol=1e-6, atol=1e-6)
    assert np.abs((got - k3).numpy()).max() > 1e-3
    # the in-place cache writes do not depend on dropout
    gk3, gv3 = ops[5].clone(), ops[6].clone()
    dec.decode_attention(*ops[:5], gk3, gv3, gen_len, n_heads=H)
    assert torch.equal(gk, gk3) and torch.equal(gv, gv3)


def test_dropout_refuses_beam_search(rng):
    B, K, S, P, G, HD = 2, 2, 2, 3, 8, 8
    x = torch.randn(B * K, S, HD)
    with pytest.raises(ValueError, match="K == 1"):
        dec.decode_attention(x, x, x, torch.randn(B, P, HD),
                             torch.randn(B, P, HD), torch.zeros(B * K, G, HD),
                             torch.zeros(B * K, G, HD), 0, n_heads=2,
                             drop_seed=1, drop_rate=0.1)


@pytest.mark.parametrize("gen_len", [0, 2])
def test_decode_layer_matches_jax_fed_the_port_multipliers(gen_len, rng,
                                                           monkeypatch):
    """One layer's SCST rollout step, port K5 (plain) against the JAX
    layer's column-layout dropout path (``_incremental_cols``, the JAX
    rollout off a TPU) with the port's multipliers for its draw."""
    cfg = tiny_cfg(hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.3)
    jmodel, params, model = make_pair(cfg, seed=4)
    B, S, P, G, HD = 3, 2, cfg.prefix_len, 8, cfg.hidden_size
    H = cfg.num_attention_heads
    seed = 0xFEEDFACE12345678
    mult = philox.decode_keep_scale(seed, B, H, S, P, G,
                                    cfg.attention_probs_dropout_prob)

    def port_draw(x, key, rate):
        if rate == 0.0:
            return x
        assert x.shape == (B, 1, H, S, P + G)
        return x * jnp.asarray(mult.numpy())[:, None]

    monkeypatch.setattr(jax_model, "explicit_dropout", port_draw)
    x = rng.normal(size=(B, S, HD)).astype(np.float32)
    pk, pv, gk, gv = (rng.normal(size=shape).astype(np.float32)
                      for shape in ((B, P, HD), (B, P, HD), (B, G, HD),
                                    (B, G, HD)))
    out_j, gk_j, gv_j = jmodel.apply(
        {"params": params}, *(jnp.asarray(a) for a in (x, pk, pv, gk, gv)),
        gen_len, dropout_key=jax.random.PRNGKey(0),
        method=lambda m, *a, **kw: m.layers[0].incremental_split(*a, **kw))
    tgk, tgv = torch.from_numpy(gk.copy()), torch.from_numpy(gv.copy())
    with torch.no_grad():
        out = model.layers[0].incremental_split(
            torch.from_numpy(x), torch.from_numpy(pk), torch.from_numpy(pv),
            tgk, tgv, gen_len, drop_seed=seed)
    np.testing.assert_allclose(out.numpy(), np.asarray(out_j), **TOL)
    np.testing.assert_array_equal(tgk.numpy(), np.asarray(gk_j))
    np.testing.assert_array_equal(tgv.numpy(), np.asarray(gv_j))


def test_dropout_scales_layout_and_bits():
    """Row t*B + b holds decode step t's draws (seed t) for example b, bit
    for bit decode_keep_scale's and Philox's on Python ints."""
    W, B, H, S, P, G, rate = 3, 4, 2, 2, 102, 24, 0.1
    seeds = [philox.step_seed(5, 1, t, 0) for t in range(W)]
    got = dec.decode_dropout_scales(seeds, B, n_heads=H, S=S, P=P, G=G,
                                    rate=rate, device="cpu")
    assert got.shape == (W * B, H, S, P + G) and got.dtype == torch.float32
    for t, sd in enumerate(seeds):
        assert torch.equal(got[t * B:(t + 1) * B],
                           philox.decode_keep_scale(sd, B, H, S, P, G, rate))
    thr = philox.keep_threshold(rate)
    # c = 101 and 102 share counter 25 across the prompt/generated boundary
    for t, b, h, s, c in ((0, 0, 0, 0, 0), (2, 3, 1, 1, 101),
                          (1, 2, 1, 0, 102), (2, 1, 0, 1, P + G - 1)):
        word = _philox_int((c // 4, s, h, b), (seeds[t] & 0xFFFFFFFF,
                                               seeds[t] >> 32))[c % 4]
        assert float(got[t * B + b, h, s, c]) == \
            (np.float32(1 / (1 - rate)) if word >= thr else 0.0)
    with pytest.raises(ValueError, match="rate"):
        dec.decode_dropout_scales(seeds, B, n_heads=H, S=S, P=P, G=G,
                                  rate=0.0, device="cpu")


def test_dropout_scales_keep_fraction():
    # the SCST shape of one layer at B=16: 19 steps, 0.9 M draws
    seeds = [philox.step_seed(9, 1, t, 3) for t in range(19)]
    got = dec.decode_dropout_scales(seeds, 16, n_heads=12, S=2, P=102, G=24,
                                    rate=0.1, device="cpu")
    assert abs(float((got > 0).float().mean()) - 0.9) < 0.005
    assert set(np.unique(got.numpy())) == {0.0, np.float32(1 / 0.9)}
