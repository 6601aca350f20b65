"""The arithmetic of K1's 16-bit body past L = 128 (csrc/attention_fwd.cu,
``attention_fwd_rows``) on the CPU, against the JAX package.

The body cannot run here, so a torch model of its arithmetic stands in for
it: blocks of 128 query rows, warps of 16, 64-key tiles streamed twice --
pass 1 keeps each row's running max and sum in fp32 (scores in log2
units, the sum rescaled when the max moves), pass 2 forms P = exp(S - m)
/ l in fp32, multiplies it by the Philox keep multipliers, casts it to
bf16 and accumulates P V in fp32 -- and skips what the kernel skips
(``vlp::masked_region``, common.cuh).

* The model against JAX's bf16 forward: the Pallas kernel in interpret
  mode at rate 0, and JAX's attention math fed the port's Philox mask at
  rate 0.1, at the training width (D = 64, mixed modes, zeros in colkeep),
  within the bf16 tolerance that chip_smoke.py holds the kernel to.
* A Python mirror of the skip (the block's visible key tiles, a warp's
  tiles and a warp's 8-key Philox slices) never skips an entry that
  ``attention_plain``'s mask leaves visible, and only skips rows that see
  a visible entry (so that exp(S - m) is an exact 0 there)."""

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

BF16_TOL = dict(atol=3e-2, rtol=1e-2)  # chip_smoke.py's bf16 tolerance
PREFIX = 102
ROWS, WARP_ROWS, TILE, SLICE = 128, 16, 64, 8   # the body's tiling
LOG2E = 1.4426950408889634
NEG_INF = -10000.0


def masked_region(md, te, prefix, first, i0, i1, j0):
    """``vlp::masked_region``: whether query rows [i0, i1) see none of the
    keys from j0 on through the structural mask while each sees a kept
    column."""
    if md == MODE_S2S:
        hi = max(prefix - 1, min(i1, te) - 1) if i0 < te else prefix - 1
        return j0 > hi and prefix - 1 >= first
    return j0 > te - 1 and te - 1 >= first


def first_kept(ck_row):
    """``vlp::first_kept``: the first column colkeep keeps (L if none)."""
    kept = np.flatnonzero(np.asarray(ck_row) > 0.5)
    return int(kept[0]) if kept.size else len(ck_row)


def visible_tiles(md, te, prefix, first, q0, L):
    """The key tiles a block of rows q0 .. q0 + 127 stages: the prefix of
    tiles that masked_region leaves visible (tile 0 always)."""
    nk, nvis = -(-L // TILE), 1
    while nvis < nk and not masked_region(md, te, prefix, first, q0,
                                          q0 + ROWS, nvis * TILE):
        nvis += 1
    return nvis


def warp_sees(md, te, prefix, first, r0, j0, L):
    """The kernel's ``sees``: whether the warp of rows r0 .. r0 + 15 sees
    key j0 or a later one."""
    return r0 < L and j0 < L and not masked_region(md, te, prefix, first,
                                                   r0, r0 + WARP_ROWS, j0)


def skip_masks(mode, te, ck, prefix, L):
    """bool [B, L, L] of the (row, key) entries whose scores the body
    computes (``computed``: the block stages the tile and the warp does
    not skip it) and of those whose keep multiplier it draws
    (``drawn``)."""
    B = len(mode)
    computed = np.zeros((B, L, L), bool)
    drawn = np.zeros((B, L, L), bool)
    for b in range(B):
        md, t = int(mode[b]), int(te[b])
        first = first_kept(ck[b])
        for q0 in range(0, L, ROWS):
            nvis = visible_tiles(md, t, prefix, first, q0, L)
            for r0 in range(q0, min(q0 + ROWS, L), WARP_ROWS):
                rows = slice(r0, min(r0 + WARP_ROWS, L))
                for kt in range(nvis):
                    j0 = kt * TILE
                    if not warp_sees(md, t, prefix, first, r0, j0, L):
                        continue
                    computed[b, rows, j0:j0 + TILE] = True
                    for c in range(j0, min(j0 + TILE, L), SLICE):
                        if warp_sees(md, t, prefix, first, r0, c, L):
                            drawn[b, rows, c:c + SLICE] = True
    return computed, drawn


def tiled_forward(q, k, v, mode, te, ck, prefix, keep):
    """The row-block body's arithmetic on bf16 q/k/v [B, L, H, D]: fp32
    scores in log2 units, pass 1 over the computed tiles (running max and
    sum, rescaled when the max moves), pass 2 P = exp2(x - m) * (1/l),
    times keep where the kernel draws it, cast to bf16, P V in fp32 over
    the tiles; the output cast to bf16."""
    B, L, H, D = q.shape
    scale2 = LOG2E / math.sqrt(D)
    bias2 = tattn._mask_bias(mode, te, ck, prefix, L)[:, None] * LOG2E
    x = torch.einsum("blhd,bmhd->bhlm", q.float(), k.float()) * scale2 + bias2
    computed, drawn = (torch.from_numpy(m)[:, None]
                       for m in skip_masks(mode.numpy(), te.numpy(),
                                           ck.numpy(), prefix, L))
    m = torch.full((B, H, L, 1), -math.inf)
    l = torch.zeros((B, H, L, 1))
    for j0 in range(0, L, TILE):
        cols = slice(j0, j0 + TILE)
        use = computed[..., cols].any(-1, keepdim=True)
        xt = x[..., cols]
        mn = torch.maximum(m, xt.amax(-1, keepdim=True))
        upd = l * torch.exp2(m - mn) + torch.exp2(xt - mn).sum(-1,
                                                              keepdim=True)
        l = torch.where(use, upd, l)
        m = torch.where(use, mn, m)
    inv = 1.0 / l
    out = torch.zeros((B, H, L, D))
    for j0 in range(0, L, TILE):
        cols = slice(j0, j0 + TILE)
        use = computed[..., cols].any(-1, keepdim=True)
        p = torch.exp2(x[..., cols] - m) * inv
        if keep is not None:
            # the kernel draws no bits where its rows see nothing: P is an
            # exact 0 there
            hidden = use & ~drawn[..., cols]
            assert (p[hidden.expand_as(p)] == 0).all()
            p = torch.where(drawn[..., cols], p * keep[..., cols], p)
        pv = torch.einsum("bhlm,bmhd->bhld", p.bfloat16().float(),
                          v[:, cols].float())
        out = out + torch.where(use, pv, 0.0)
    return out.transpose(1, 2).bfloat16()


@jax.jit
def _jax_bf16_fwd_fed_mask(q, k, v, bias, keep):
    """The JAX forward kernel's math (vlp_tpu/ops/attention.py:140-150) on
    bf16 inputs, fed an explicit dropout mask: fp32 scores and softmax,
    P o keep cast to bf16, P V accumulated in fp32, cast to bf16."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = jnp.einsum("blhd,bmhd->bhlm", q, k,
                   preferred_element_type=jnp.float32) * scale + bias
    p = jax.nn.softmax(s, axis=-1) * keep
    return jnp.einsum("bhlm,bmhd->blhd", p.astype(jnp.bfloat16), v,
                      preferred_element_type=jnp.float32).astype(
                          jnp.bfloat16)


def _inputs(rng, L, b=2, h=2, d=64):
    """bf16 q/k/v [b, L, h, d] and mixed-mode mask metadata: example 0
    s2s with its caption ending before L, example 1 bi; zeros among the
    regions' colkeep."""
    q, k, v = (torch.from_numpy(rng.normal(size=(b, L, h, d)).astype(
        np.float32)).bfloat16() for _ in range(3))
    mode = torch.tensor([MODE_S2S, MODE_BI], dtype=torch.int32)
    te = torch.tensor([L - 7, PREFIX + 9], dtype=torch.int32)
    ck = np.ones((b, L), np.float32)
    ck[:, 1:PREFIX - 1] = rng.random((b, PREFIX - 2)) > 0.3
    return q, k, v, mode, te, torch.from_numpy(ck)


@pytest.mark.parametrize("rate", [0.0, 0.1])
@pytest.mark.parametrize("L", [160, 256, 528])
def test_tiled_forward_fits_the_jax_bf16_forward(L, rate, rng):
    """The row-block body's arithmetic against JAX's bf16 forward (the
    Pallas kernel in interpret mode at rate 0; its math fed the port's
    Philox mask at rate 0.1), and against the port's plain version."""
    q, k, v, mode, te, ck = _inputs(rng, L)
    seed = 0x5DEECE66D0123457
    keep = philox.keep_scale(seed, 2, 2, L, rate) if rate else None
    got = tiled_forward(q, k, v, mode, te, ck, PREFIX, keep)
    jx = [jnp.asarray(t.float().numpy(), jnp.bfloat16) for t in (q, k, v)]
    if rate:
        bias = attention_bias(jnp.asarray(mode.numpy()),
                              jnp.asarray(te.numpy()),
                              jnp.asarray(ck.numpy()[:, 1:PREFIX - 1]),
                              PREFIX, L)
        want = _jax_bf16_fwd_fed_mask(*jx, bias, jnp.asarray(keep.numpy()))
    else:
        want = jattn.attention_pallas(*jx, jnp.asarray(mode.numpy()),
                                      jnp.asarray(te.numpy()),
                                      jnp.asarray(ck.numpy()), prefix=PREFIX,
                                      layout="blhd")
    assert got.shape == q.shape and torch.isfinite(got.float()).all()
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **BF16_TOL)
    plain = tattn.attention_plain(q, k, v, mode, te, ck, prefix=PREFIX,
                                  dropout_rate=rate, seed=seed)
    torch.testing.assert_close(got.float(), plain.float(), **BF16_TOL)


def _mask_cases(L):
    """(mode, text_end, colkeep) of one example each: s2s and bi at short,
    middle and full text ends, colkeep all kept, zeros among the regions,
    every region dropped, everything dropped (an all-masked example), and
    the prefix dropped with the caption kept."""
    rng = np.random.default_rng(L)
    kept = np.ones(L, np.float32)
    holes = kept.copy()
    holes[1:PREFIX - 1] = rng.random(PREFIX - 2) > 0.3
    no_regions = kept.copy()
    no_regions[1:PREFIX - 1] = 0.0
    nothing = np.zeros(L, np.float32)
    no_prefix = kept.copy()
    no_prefix[:PREFIX] = 0.0
    cases = []
    for md in (MODE_S2S, MODE_BI):
        for te in sorted({PREFIX + 1, (PREFIX + L) // 2, L - 7, L}):
            for ck in (kept, holes, no_regions, nothing, no_prefix):
                cases.append((md, te, ck))
    return cases


@pytest.mark.parametrize("L", [145, 160, 256, 417, 528])
def test_skip_mirror_never_skips_a_visible_entry(L):
    """Over modes, text ends and colkeep patterns: every entry the body
    skips (a tile not staged or skipped by its warp, a Philox slice not
    drawn) is masked in attention_plain's bias, in a row that sees a
    visible entry, so its P is an exact 0; an example that sees nothing
    skips nothing."""
    cases = _mask_cases(L)
    mode = np.asarray([c[0] for c in cases], np.int32)
    te = np.asarray([c[1] for c in cases], np.int32)
    ck = np.stack([c[2] for c in cases])
    computed, drawn = skip_masks(mode, te, ck, PREFIX, L)
    assert (computed | ~drawn).all()        # a drawn entry is computed
    visible = tattn._mask_bias(torch.from_numpy(mode), torch.from_numpy(te),
                               torch.from_numpy(ck), PREFIX, L).numpy() == 0
    assert not (visible & ~drawn).any()
    sees = visible.any(-1)                   # [case, row]
    skipped_rows = (~drawn).any(-1)
    assert (sees | ~skipped_rows).all()
    nothing = ~sees.any(-1)
    assert nothing.any() and drawn[nothing].all()
    # the skip does skip: s2s rows past the prefix miss the later keys
    assert (~computed).any()
