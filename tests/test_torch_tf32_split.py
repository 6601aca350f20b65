"""The arithmetic of the port's fp32 attention kernels on the card, emulated
on the CPU: every product in split TF32 ("3xTF32", ``csrc/mma.cuh``).

Each fp32 operand x is split into hi = tf32(x) and lo = tf32(x - hi), with
``cvt.rna``'s rounding (to nearest, ties away from zero, to TF32's 10
mantissa bits), and a product is lo*hi + hi*lo + hi*hi in fp32.  Here the
plain fp32 attention forward and backward (``ops/attention.py``) run with
every product so replaced, and are held against the JAX package's fp32
attention (its Pallas kernels in interpret mode; with dropout, its
attention math fed the port's Philox mask) within the card tests' fp32
tolerance.  On inputs that are multiples of 1/8 in [-1, 1] (the all-masked
example of tests/test_torch_kernels.py) the split is exact: lo = 0."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vlp_tpu.ops import attention as jattn
from vlp_tpu.ops.masks import attention_bias
from vlp_tpu_torch.config import MODE_BI, MODE_S2S
from vlp_tpu_torch.ops import attention as tattn
from vlp_tpu_torch.ops import philox

FP32_TOL = dict(atol=1e-4, rtol=1e-4)   # the card tests' fp32 tolerance
B, H, D, PREFIX = 2, 2, 64, 7


def tf32_rna(x: torch.Tensor) -> torch.Tensor:
    """fp32 rounded to TF32 as ``cvt.rna.tf32.f32`` does: add half of the
    dropped 13 bits' range to the magnitude, then clear them (ties away
    from zero; finite inputs)."""
    bits = x.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def split(x: torch.Tensor):
    hi = tf32_rna(x)
    return hi, tf32_rna(x - hi)


def einsum3(eq: str, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """torch.einsum in split TF32: the two small terms first, then hi*hi."""
    ah, al = split(a.float())
    bh, bl = split(b.float())
    return (torch.einsum(eq, al, bh) + torch.einsum(eq, ah, bl)
            + torch.einsum(eq, ah, bh))


def _probs3(q, k, mode, text_end, colkeep):
    bias = tattn._mask_bias(mode, text_end, colkeep, PREFIX, q.shape[1])
    s = einsum3("blhd,bmhd->bhlm", q, k) * (1.0 / math.sqrt(D))
    s = s + bias[:, None]
    e = torch.exp(s - s.amax(dim=-1, keepdim=True))
    return e / e.sum(dim=-1, keepdim=True)


def forward3(q, k, v, mode, text_end, colkeep, keep=None):
    """attention_plain in fp32 with every product in split TF32."""
    p = _probs3(q, k, mode, text_end, colkeep)
    if keep is not None:
        p = p * keep
    return einsum3("bhlm,bmhd->blhd", p, v)


def backward3(q, k, v, mode, text_end, colkeep, dout, keep=None):
    """attention_bwd_plain in fp32 with every product in split TF32."""
    scale = 1.0 / math.sqrt(D)
    p = _probs3(q, k, mode, text_end, colkeep)
    pd = p if keep is None else p * keep
    dv = einsum3("bhlm,blhd->bmhd", pd, dout)
    dp = einsum3("blhd,bmhd->bhlm", dout, v)
    if keep is not None:
        dp = dp * keep
    ds = p * (dp - (dp * p).sum(dim=-1, keepdim=True))
    return (einsum3("bhlm,bmhd->blhd", ds, k) * scale,
            einsum3("bhlm,blhd->bmhd", ds, q) * scale, dv)


def _inputs(rng, L, eighths):
    """q, k, v, dout [B, L, H, D], mixed modes, zeros in colkeep; example 1
    all-masked (bi, every column dropped) when ``eighths``, whose inputs
    are then multiples of 1/8 in [-1, 1]."""
    if eighths:
        q, k, v, do = (rng.integers(-8, 9, size=(B, L, H, D)) / 8.0
                       for _ in range(4))
    else:
        q, k, v, do = (rng.normal(size=(B, L, H, D)) for _ in range(4))
    mode = np.asarray([MODE_S2S, MODE_BI], np.int32)
    te = rng.integers(PREFIX + 1, L + 1, size=B).astype(np.int32)
    ck = np.ones((B, L), np.float32)
    ck[:, 1:PREFIX - 1] = rng.random((B, PREFIX - 2)) > 0.3
    if eighths:
        te[1] = L
        ck[1] = 0.0
    return [np.asarray(x, np.float32) for x in (q, k, v, do)] + [mode, te, ck]


@jax.jit
def _pallas_vjp(q, k, v, do, md, te, ck):
    def f(q, k, v):
        return jattn.attention_pallas(q, k, v, md, te, ck, prefix=PREFIX,
                                      layout="blhd")

    out, vjp = jax.vjp(f, q, k, v)
    return out, vjp(do)


@jax.jit
def _masked_vjp(q, k, v, do, bias, keep):
    """JAX attention math fed an explicit dropout mask."""
    def f(q, k, v):
        s = jnp.einsum("blhd,bmhd->bhlm", q, k) / math.sqrt(D) + bias
        return jnp.einsum("bhlm,bmhd->blhd",
                          jax.nn.softmax(s, axis=-1) * keep, v)

    out, vjp = jax.vjp(f, q, k, v)
    return out, vjp(do)


def test_rounding_is_cvt_rna():
    """Ties round away from zero, other values to nearest, and TF32 keeps
    10 mantissa bits."""
    x = torch.tensor([1 + 2 ** -11, -(1 + 2 ** -11), 1 + 2 ** -12,
                      1 + 3 * 2 ** -11, 1 + 2 ** -10, 0.0, -2.5],
                     dtype=torch.float32)
    want = torch.tensor([1 + 2 ** -10, -(1 + 2 ** -10), 1.0,
                         1 + 2 * 2 ** -10, 1 + 2 ** -10, 0.0, -2.5],
                        dtype=torch.float32)
    assert torch.equal(tf32_rna(x), want)
    r = torch.from_numpy(np.random.default_rng(0).normal(
        size=4096).astype(np.float32))
    assert (tf32_rna(r).view(torch.int32) & 0x1FFF).eq(0).all()
    assert ((tf32_rna(r) - r).abs() <= r.abs() * 2.0 ** -11).all()


def test_split_products_keep_fp32_accuracy():
    """Per element, the split product is within ~2^-21 of the exact one
    (relative to the sum of |terms|), where TF32 alone is ~2^-11 off."""
    rng = np.random.default_rng(1)
    a, b = (torch.from_numpy(rng.normal(size=(64, 64)).astype(np.float32))
            for _ in range(2))
    exact = a.double() @ b.double()
    mag = a.double().abs() @ b.double().abs()
    err3 = ((einsum3("ik,kj->ij", a, b).double() - exact).abs() / mag).max()
    err1 = ((tf32_rna(a) @ tf32_rna(b)).double() - exact).abs().div(mag).max()
    assert err3 < 2.0 ** -20 < err1 / 100


def test_eighths_split_exactly():
    """Multiples of 1/8 in [-1, 1] are TF32 values: lo = 0, so S = Q K^T is
    the plain fp32 product bit for bit."""
    q, k = (torch.from_numpy(x) for x in _inputs(np.random.default_rng(2),
                                                 16, True)[:2])
    hi, lo = split(q)
    assert torch.equal(hi, q) and not lo.any()
    assert torch.equal(einsum3("blhd,bmhd->bhlm", q, k),
                       torch.einsum("blhd,bmhd->bhlm", q, k))


@pytest.mark.parametrize("eighths", [False, True], ids=["randn", "eighths"])
@pytest.mark.parametrize("L", [16, 128])
def test_split_attention_matches_jax_fp32(L, eighths):
    """Rate 0: the split forward and backward against jax.vjp of the
    Pallas blhd kernels (interpret mode) within the fp32 tolerance."""
    arrays = _inputs(np.random.default_rng(L + eighths), L, eighths)
    out_j, grads_j = _pallas_vjp(*(jnp.asarray(a) for a in arrays))
    q, k, v, do, md, te, ck = (torch.from_numpy(a) for a in arrays)
    np.testing.assert_allclose(forward3(q, k, v, md, te, ck).numpy(),
                               np.asarray(out_j), **FP32_TOL)
    for g, gj in zip(backward3(q, k, v, md, te, ck, do), grads_j):
        np.testing.assert_allclose(g.numpy(), np.asarray(gj), **FP32_TOL)


@pytest.mark.parametrize("L", [16, 128])
def test_split_attention_with_dropout_matches_jax_fp32(L):
    """Rate 0.1: the split forward and backward against JAX's attention
    math fed the port's Philox mask."""
    rate, seed = 0.1, 0x6A09E667F3BCC909
    arrays = _inputs(np.random.default_rng(7 * L), L, False)
    keep = philox.keep_scale(seed, B, H, L, rate)
    q, k, v, do, md, te, ck = (torch.from_numpy(a) for a in arrays)
    bias = attention_bias(jnp.asarray(arrays[4]), jnp.asarray(arrays[5]),
                          jnp.asarray(arrays[6][:, 1:PREFIX - 1]), PREFIX, L)
    out_j, grads_j = _masked_vjp(*(jnp.asarray(a) for a in arrays[:4]), bias,
                                 jnp.asarray(keep.numpy()))
    np.testing.assert_allclose(forward3(q, k, v, md, te, ck, keep).numpy(),
                               np.asarray(out_j), **FP32_TOL)
    for g, gj in zip(backward3(q, k, v, md, te, ck, do, keep), grads_j):
        np.testing.assert_allclose(g.numpy(), np.asarray(gj), **FP32_TOL)
