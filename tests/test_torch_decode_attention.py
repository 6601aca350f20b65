"""Port decode-step attention (vlp_tpu_torch/ops/decode_attention.py)
against the JAX package's fused decode kernel (interpret mode on the CPU),
with and without the ancestry bias of the fused beam reorder; and
chip_smoke.py's library bar for the decode kernels (one SDPA call over the
joint keys) against the plain step.  The CUDA kernel is held against the
plain version in tests/test_torch_kernels.py."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from vlp_tpu.ops import decode_attention as jax_dec
from vlp_tpu_torch.ops import decode_attention as dec

NEG = -10000.0


def ancestry_bias(rng, B, K, G, gen_len):
    """A real ancestry map as the beam loop builds it: random lineages for
    committed slots, each beam's own row at gen_len and gen_len+1."""
    anc = rng.integers(0, K, size=(B * K, G))
    own = np.arange(B * K) % K
    for s in (gen_len, gen_len + 1):
        if s < G:
            anc[:, s] = own
    bias = np.where(anc[:, None, :] == np.arange(K)[None, :, None], 0.0, NEG)
    return bias.reshape(B * K, K * G).astype(np.float32)


def make_inputs(rng, B, K, S, P, G, HD):
    def f(*shape):
        return rng.normal(size=shape).astype(np.float32)
    return (f(B * K, S, HD), f(B * K, S, HD), f(B * K, S, HD),
            f(B, P, HD), f(B, P, HD), f(B * K, G, HD), f(B * K, G, HD))


@pytest.mark.parametrize("anc", [False, True], ids=["K3", "K4_anc"])
@pytest.mark.parametrize("gen_len", [0, 3, 6, 7])
def test_plain_matches_pallas(anc, gen_len, rng):
    B, K, S, P, G, H, D = 2, 3, 2, 7, 8, 2, 16
    ops = make_inputs(rng, B, K, S, P, G, H * D)
    bias = ancestry_bias(rng, B, K, G, gen_len) if anc else None
    ctx_j, gk_j, gv_j = jax_dec.decode_attention(
        *(jnp.asarray(x) for x in ops), gen_len, n_heads=H,
        beam_bias=None if bias is None else jnp.asarray(bias))
    q, k, v, pk, pv, gk, gv = (torch.from_numpy(x.copy()) for x in ops)
    ctx = dec.decode_attention(
        q, k, v, pk, pv, gk, gv, gen_len, n_heads=H,
        beam_bias=None if bias is None else torch.from_numpy(bias))
    np.testing.assert_allclose(ctx.numpy(), np.asarray(ctx_j),
                               atol=1e-5, rtol=1e-5)
    # the in-place cache writes are bit-exact (slot gen_len+1 == G dropped)
    np.testing.assert_array_equal(gk.numpy(), np.asarray(gk_j))
    np.testing.assert_array_equal(gv.numpy(), np.asarray(gv_j))


def test_strided_prompt_cache_is_not_copied(rng):
    """The prefill hands over k[:, :P] of a [B, P+1, H*D] projection; the
    plain version reads it through the view."""
    B, K, S, P, G, H, D = 2, 2, 2, 5, 8, 2, 8
    q, k, v, pk, pv, gk, gv = (torch.from_numpy(x) for x in
                               make_inputs(rng, B, K, S, P + 1, G, H * D))
    ctx_view = dec.decode_attention(q, k, v, pk[:, :P], pv[:, :P],
                                    gk.clone(), gv.clone(), 2, n_heads=H)
    ctx_copy = dec.decode_attention(q, k, v, pk[:, :P].contiguous(),
                                    pv[:, :P].contiguous(), gk, gv, 2,
                                    n_heads=H)
    torch.testing.assert_close(ctx_view, ctx_copy, atol=0, rtol=0)


@pytest.mark.parametrize("kind", ["K3", "K4", "K5_rate0"])
@pytest.mark.parametrize("gen_len", [0, 3, 7])
def test_sdpa_bar_computes_the_plain_step(kind, gen_len, rng):
    """chip_smoke.decode_sdpa (K4: q [B, H, K*S, D] against the example's
    joint keys under the visibility + ancestry mask; K3 and K5: per beam,
    the prompt repeated over the beams) equals decode_attention_plain in
    fp32 once the step's new tokens are in the caches (SDPA writes no
    slots; gen_len 7 drops the second one past G = 8).  K5 at rate 0, as
    SDPA's dropout bits are its own."""
    B, S, P, G, H, D = 2, 2, 7, 8, 2, 16
    K = 1 if kind == "K5_rate0" else 3
    q, k, v, pk, pv, gk, gv = (torch.from_numpy(x) for x in
                               make_inputs(rng, B, K, S, P + 1, G, H * D))
    pk, pv = pk[:, :P], pv[:, :P]   # the prefill's strided views
    bias = (torch.from_numpy(ancestry_bias(rng, B, K, G, gen_len))
            if kind == "K4" else None)
    want = dec.decode_attention_plain(
        q, k, v, pk, pv, gk, gv, gen_len, n_heads=H, beam_bias=bias,
        drop_seed=5 if kind == "K5_rate0" else None, drop_rate=0.0)
    got = chip_smoke.decode_sdpa(q, pk, pv, gk, gv, gen_len, H, bias)
    torch.testing.assert_close(got, want, atol=1e-5, rtol=1e-5)
    parts = chip_smoke.decode_sdpa_parts(q, pk, pv, gk, gv, gen_len, H, bias)
    torch.testing.assert_close(
        chip_smoke.decode_sdpa(q, pk, pv, gk, gv, gen_len, H, bias,
                               parts=parts), got, atol=0, rtol=0)
