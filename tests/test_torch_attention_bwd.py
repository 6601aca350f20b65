"""The training attention of the port (vlp_tpu_torch/ops/attention.py,
ops/philox.py) against the JAX package on the CPU.

* Dropout off: the plain backward (K2's plain version), torch autograd of
  ``attention_plain`` and ``FusedAttention`` match ``jax.vjp`` of
  ``attention_pallas(layout="blhd")``, whose forward and backward Pallas
  kernels run in interpret mode.  fp32, tolerance 1e-5.
* Dropout on: the JAX package cannot reproduce the port's bits off a TPU,
  so the port is held against JAX attention math fed the port's own Philox
  mask (the pattern of tests/test_tpu_dropout.py:72-93).
* Philox matches Random123's known-answer vectors and a pure-Python-int
  implementation, and keeps 1 - rate of its draws."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vlp_tpu.ops import attention as jattn
from vlp_tpu.ops.masks import attention_bias
from vlp_tpu_torch.ops import attention as tattn
from vlp_tpu_torch.ops import philox

TOL = dict(rtol=1e-5, atol=1e-5)
B, L, H, D, PREFIX = 3, 24, 2, 8, 7
MODES = {"s2s": [1, 1, 1], "bi": [0, 0, 0], "mixed": [1, 0, 1]}


def _inputs(rng, mode, colkeep_zeros):
    q, k, v, do = (rng.normal(size=(B, L, H, D)).astype(np.float32)
                   for _ in range(4))
    te = np.asarray([L, PREFIX + 3, PREFIX + 9], np.int32)
    ck = np.ones((B, L), np.float32)
    if colkeep_zeros:
        ck[:, 1:PREFIX - 1] = (rng.random((B, PREFIX - 2)) > 0.4)
    return q, k, v, do, np.asarray(MODES[mode], np.int32), te, ck


def _torch(*arrays):
    return [torch.from_numpy(np.array(a)) for a in arrays]


def _port_grads(q, k, v, do, mode, te, ck, rate=0.0, seed=None):
    """(forward, plain-bwd grads, autograd grads of attention_plain,
    autograd grads of FusedAttention)."""
    tq, tk, tv, tdo, tm, tte, tck = _torch(q, k, v, do, mode, te, ck)
    kw = dict(prefix=PREFIX, dropout_rate=rate, seed=seed)
    plain = tattn.attention_bwd_plain(tq, tk, tv, tm, tte, tck, tdo, **kw)
    leaves = [t.clone().requires_grad_() for t in (tq, tk, tv)]
    out = tattn.attention_plain(*leaves, tm, tte, tck, **kw)
    auto = torch.autograd.grad(out, leaves, tdo)
    leaves = [t.clone().requires_grad_() for t in (tq, tk, tv)]
    fused_out = tattn.FusedAttention.apply(*leaves, tm, tte, tck, PREFIX,
                                           rate, seed)
    fused = torch.autograd.grad(fused_out, leaves, tdo)
    np.testing.assert_array_equal(fused_out.detach().numpy(),
                                  out.detach().numpy())
    return out.detach().numpy(), plain, auto, fused


@jax.jit
def _pallas_vjp(q, k, v, do, md, te, ck):
    """Forward and (dq, dk, dv) of the Pallas blhd kernels, one compile
    for every mask (the metadata are traced arguments)."""
    def f(q, k, v):
        return jattn.attention_pallas(q, k, v, md, te, ck, prefix=PREFIX,
                                      layout="blhd")

    out, vjp = jax.vjp(f, q, k, v)
    return out, vjp(do)


@jax.jit
def _masked_vjp(q, k, v, do, bias, keep):
    """The same attention in jnp, fed an explicit dropout mask."""
    def f(q, k, v):
        s = jnp.einsum("blhd,bmhd->bhlm", q, k) / math.sqrt(D) + bias
        p = jax.nn.softmax(s, axis=-1) * keep
        return jnp.einsum("bhlm,bmhd->blhd", p, v)

    out, vjp = jax.vjp(f, q, k, v)
    return out, vjp(do)


@pytest.mark.parametrize("mode", sorted(MODES))
@pytest.mark.parametrize("colkeep_zeros", [False, True],
                         ids=["colkeep1", "colkeep0"])
def test_backward_matches_jax_pallas_vjp(mode, colkeep_zeros, rng):
    q, k, v, do, md, te, ck = _inputs(rng, mode, colkeep_zeros)
    out_j, grads_j = _pallas_vjp(*(jnp.asarray(a)
                                   for a in (q, k, v, do, md, te, ck)))
    out, plain, auto, fused = _port_grads(q, k, v, do, md, te, ck)
    np.testing.assert_allclose(out, np.asarray(out_j), **TOL)
    for name, grads in (("plain", plain), ("autograd", auto),
                        ("fused", fused)):
        for g, gj, which in zip(grads, grads_j, "qkv"):
            np.testing.assert_allclose(g.numpy(), np.asarray(gj), **TOL,
                                       err_msg=f"{name} d{which}")


@pytest.mark.parametrize("mode", ["s2s", "mixed"])
def test_dropout_matches_jax_fed_the_port_mask(mode, rng):
    rate, seed = 0.3, 0xDEADBEEF12345678
    q, k, v, do, md, te, ck = _inputs(rng, mode, colkeep_zeros=True)
    keep = philox.keep_scale(seed, B, H, L, rate).numpy()
    assert 0.0 < (keep == 0).mean() < 0.5
    bias = attention_bias(jnp.asarray(md), jnp.asarray(te),
                          jnp.asarray(ck[:, 1:PREFIX - 1]), PREFIX, L)
    out_j, grads_j = _masked_vjp(*(jnp.asarray(a) for a in (q, k, v, do)),
                                 bias, jnp.asarray(keep))
    out, plain, auto, fused = _port_grads(q, k, v, do, md, te, ck, rate,
                                          seed)
    np.testing.assert_allclose(out, np.asarray(out_j), **TOL)
    for grads in (plain, auto, fused):
        for g, gj in zip(grads, grads_j):
            np.testing.assert_allclose(g.numpy(), np.asarray(gj), **TOL)
    # a different seed gives another mask, so the output moves
    other = _port_grads(q, k, v, do, md, te, ck, rate, seed + 1)[0]
    assert np.abs(other - out).max() > 1e-3


BF16_TOL = dict(atol=3e-2, rtol=1e-2)  # chip_smoke.py's bf16 tolerance


def _bf16_mma_backward(q, k, v, do, md, te, ck, keep, prefix):
    """The CUDA tensor-core backward's arithmetic (csrc/attention_bwd.cu,
    bf16 body): fp32 scores and softmax from bf16 inputs, P o keep and dS
    rounded to bf16 before the products that take them, fp32 sums."""
    qf, kf, vf, dof = (t.float() for t in (q, k, v, do))
    p = tattn._probs(q, k, md, te, ck, prefix)
    keep = torch.ones_like(p) if keep is None else keep
    pk = (p * keep).bfloat16().float()
    dp = torch.einsum("blhd,bmhd->bhlm", dof, vf) * keep
    ds = (p * (dp - (dp * p).sum(-1, keepdim=True))).bfloat16().float()
    scale = 1.0 / math.sqrt(q.shape[-1])
    dq = torch.einsum("bhlm,bmhd->blhd", ds, kf) * scale
    dk = torch.einsum("bhlm,blhd->bmhd", ds, qf) * scale
    dv = torch.einsum("bhlm,blhd->bmhd", pk, dof)
    return [g.bfloat16() for g in (dq, dk, dv)]


@jax.jit
def _jax_bf16_bwd_fed_mask(q, k, v, do, bias, keep):
    """The JAX backward kernel's math (vlp_tpu/ops/attention.py:214-242):
    fp32 throughout from bf16 inputs, fed an explicit dropout mask."""
    q, k, v, do = (x.astype(jnp.float32) for x in (q, k, v, do))
    scale = 1.0 / math.sqrt(q.shape[-1])
    p = jax.nn.softmax(jnp.einsum("blhd,bmhd->bhlm", q, k) * scale + bias,
                       axis=-1)
    dv = jnp.einsum("bhlm,blhd->bmhd", p * keep, do)
    dp = jnp.einsum("blhd,bmhd->bhlm", do, v) * keep
    ds = p * (dp - jnp.sum(dp * p, axis=-1, keepdims=True))
    dq = jnp.einsum("bhlm,bmhd->blhd", ds, k) * scale
    dk = jnp.einsum("bhlm,blhd->bmhd", ds, q) * scale
    return [g.astype(jnp.bfloat16) for g in (dq, dk, dv)]


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("l", [128, 256])
def test_bf16_rounded_backward_fits_the_jax_bf16_backward(l, rate, rng):
    """Go/no-go for the tensor-core backward's rounding at the training
    width (D=64, mixed modes, zeros in colkeep), at L=128 (the one-block
    body) and L=256 (the tiled body, whose softmax sums over more
    columns): rounding P o keep and dS to bf16 before their products stays
    within the bf16 tolerance of JAX's bf16 backward (the Pallas kernel in
    interpret mode at rate 0; its math fed the port's Philox mask at rate
    0.1)."""
    b, h, d, prefix, seed = 2, 2, 64, 102, 0x5DEECE66D0123457
    q, k, v, do = (torch.from_numpy(rng.normal(size=(b, l, h, d)).astype(
        np.float32)).bfloat16() for _ in range(4))
    md = np.asarray([1, 0], np.int32)
    te = np.asarray([l, prefix + 9], np.int32)
    ck = np.ones((b, l), np.float32)
    ck[:, 1:prefix - 1] = rng.random((b, prefix - 2)) > 0.3
    keep = philox.keep_scale(seed, b, h, l, rate) if rate else None
    got = _bf16_mma_backward(q, k, v, do, *_torch(md, te, ck), keep, prefix)
    jx = [jnp.asarray(t.float().numpy(), jnp.bfloat16) for t in (q, k, v, do)]
    if rate:
        bias = attention_bias(jnp.asarray(md), jnp.asarray(te),
                              jnp.asarray(ck[:, 1:prefix - 1]), prefix, l)
        want = _jax_bf16_bwd_fed_mask(*jx, bias, jnp.asarray(keep.numpy()))
    else:
        def f(q_, k_, v_):
            return jattn.attention_pallas(q_, k_, v_, jnp.asarray(md),
                                          jnp.asarray(te), jnp.asarray(ck),
                                          prefix=prefix, layout="blhd")
        want = jax.vjp(f, *jx[:3])[1](jx[3])
    for g, w, which in zip(got, want, "qkv"):
        np.testing.assert_allclose(
            g.float().numpy(), np.asarray(w, np.float32), **BF16_TOL,
            err_msg=f"d{which}")


M0, M1, W0, W1 = 0xD2511F53, 0xCD9E8D57, 0x9E3779B9, 0xBB67AE85


def _philox_int(c, key):
    """Philox4x32-10 on Python ints (Salmon et al., SC'11)."""
    c, k = list(c), list(key)
    for r in range(10):
        if r:
            k = [(k[0] + W0) & 0xFFFFFFFF, (k[1] + W1) & 0xFFFFFFFF]
        p0, p1 = M0 * c[0], M1 * c[2]
        c = [(p1 >> 32) ^ c[1] ^ k[0], p1 & 0xFFFFFFFF,
             (p0 >> 32) ^ c[3] ^ k[1], p0 & 0xFFFFFFFF]
    return c


def _philox_torch(c, seed):
    words = philox.philox4x32(*(torch.tensor([x], dtype=torch.int64)
                                for x in c), seed)
    return [int(w) for w in words]


@pytest.mark.parametrize("counter,seed,want", [
    # Random123's kat_vectors for philox4x32_10
    ((0, 0, 0, 0), 0, (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((0xFFFFFFFF,) * 4, 2 ** 64 - 1,
     (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344),
     0x299F31D0A4093822, (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
])
def test_philox_known_answers(counter, seed, want):
    assert _philox_torch(counter, seed) == list(want)
    assert _philox_int(counter, (seed & 0xFFFFFFFF, seed >> 32)) == \
        list(want)


def test_philox_matches_python_ints_and_the_mask_layout(rng):
    seeds = [int(s) for s in rng.integers(0, 2 ** 63, 3, dtype=np.int64)]
    seeds.append(2 ** 64 - 3)
    for seed in seeds:
        for c in rng.integers(0, 2 ** 32, (6, 4), dtype=np.int64).tolist():
            assert _philox_torch(c, seed) == _philox_int(
                c, (seed & 0xFFFFFFFF, seed >> 32))
    # element (b, h, i, j) takes word j % 4 of counter (j // 4, i, h, b)
    seed, rate = seeds[0], 0.5
    ks = philox.keep_scale(seed, 2, 3, 7, rate)
    thr = philox.keep_threshold(rate)
    for b, h, i, j in ((0, 0, 0, 0), (1, 2, 4, 6), (1, 0, 6, 5)):
        word = _philox_int((j // 4, i, h, b),
                           (seed & 0xFFFFFFFF, seed >> 32))[j % 4]
        assert float(ks[b, h, i, j]) == (2.0 if word >= thr else 0.0)


def test_keep_fraction():
    ks = philox.keep_scale(12345, 8, 12, 128, 0.1)      # 1.6e6 draws
    assert abs(float((ks > 0).float().mean()) - 0.9) < 0.005
    assert float(ks.max()) == np.float32(1 / 0.9)
    assert float(philox.keep_scale(7, 2, 2, 8, 0.0).min()) == 1.0
