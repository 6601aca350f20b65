"""One KV-cached decode step of attention (counterpart of
``vlp_tpu/ops/decode_attention.py``).

Caches live in the projections' column layout: the prompt cache
``pk/pv [B, P, H*D]`` once per example (shared by its K beams, never
beam-expanded) and the generated-token cache ``gk/gv [B*K, G, H*D]``.  One
step writes the S new tokens' K/V into slots ``gen_len .. gen_len+S-1`` **in
place** (slots >= G are dropped), scores every query row against the prompt
and the generated cache, and takes one softmax over (prompt | generated):

* without ``beam_bias`` (K3) a row sees its own beam's slots j <= gen_len+s;
* with ``beam_bias`` (K4, the fused beam reorder) it sees all K beams of its
  example plus an additive ancestry bias ``[B*K, K*G]`` (0 where column beam
  k2 holds the row's lineage at slot j, else -10000), so the caches are never
  gathered when beams reorder;
* with ``drop_seed`` and ``drop_rate > 0`` (K5, the SCST sampled rollout,
  K == 1) the probabilities are multiplied by the Philox keep/scale
  multipliers of ``philox.decode_keep_scale`` before their cast to the
  activation dtype.

``decode_dropout_scales`` (K6) writes K5's multipliers for every (decode
step, example) of one layer, for the SCST teacher-forced replay.

``decode_attention_plain`` is the plain PyTorch version; ``decode_attention``
launches ``csrc/decode_attention.cu`` for CUDA tensors and
``decode_dropout_scales`` ``csrc/decode_dropout.cu``; both take the plain
version only for CPU tensors.  The JAX package's ``decode_dropout_impl="xla"``
switch (its CPU route for the rollout) has no counterpart: on the card K5
always runs.
"""

from __future__ import annotations

import ctypes
import math

import torch

from vlp_tpu_torch.ops import _build, philox
from vlp_tpu_torch.ops.attention import HEAD_DIM
from vlp_tpu_torch.ops.masks import NEG_INF

MAX_DROPOUT_STEPS = 128   # kMaxSteps of csrc/decode_dropout.cu


def _write_slots(gk, gv, k, v, gen_len: int) -> None:
    n = max(0, min(k.shape[1], gk.shape[1] - gen_len))
    gk[:, gen_len:gen_len + n] = k[:, :n]
    gv[:, gen_len:gen_len + n] = v[:, :n]


def decode_attention_plain(q, k, v, pk, pv, gk, gv, gen_len: int, *,
                           n_heads: int, beam_bias=None, drop_seed=None,
                           drop_rate: float = 0.0,
                           drop_mult=None) -> torch.Tensor:
    """q/k/v: [B*K, S, H*D]; pk/pv: [B, P, H*D]; gk/gv: [B*K, G, H*D]
    (written in place); gen_len: committed tokens so far; beam_bias: fp32
    [B*K, K*G] or None; drop_seed: 64-bit seed of the step's attention
    dropout at ``drop_rate`` (K == 1, no beam bias).  ``drop_mult`` (fp32
    [B, H, S, P+G]) hands in the multipliers instead of drawing them from
    the seed, so that a check can apply K6's.  Returns the context
    [B*K, S, H*D]."""
    BK, S, HD = q.shape
    B, P, _ = pk.shape
    G = gk.shape[1]
    K = BK // B
    H = n_heads
    D = HD // H
    dt = q.dtype
    _write_slots(gk, gv, k, v, gen_len)
    scale = 1.0 / math.sqrt(D)
    qb = q.float().view(B, K, S, H, D)
    pk4 = pk.float().reshape(B, P, H, D)
    pv4 = pv.float().reshape(B, P, H, D)
    sp = torch.einsum("bkshd,bjhd->bkhsj", qb, pk4) * scale
    slot = torch.arange(G, device=q.device)
    spos = gen_len + torch.arange(S, device=q.device)
    gmask = torch.full((S, G), NEG_INF, dtype=torch.float32, device=q.device)
    gmask = gmask.masked_fill(slot[None, :] <= spos[:, None], 0.0)
    if beam_bias is None:
        gk5 = gk.float().view(B, K, G, H, D)
        sg = torch.einsum("bkshd,bkjhd->bkhsj", qb, gk5) * scale + gmask
    else:
        gk4 = gk.float().view(B, K * G, H, D)
        sg = torch.einsum("bkshd,bchd->bkhsc", qb, gk4) * scale
        bias = gmask.repeat(1, K) + beam_bias.view(B, K, 1, 1, K * G)
        sg = sg + bias
    m = torch.maximum(sp.amax(dim=-1, keepdim=True),
                      sg.amax(dim=-1, keepdim=True))
    ep = torch.exp(sp - m)
    eg = torch.exp(sg - m)
    denom = ep.sum(dim=-1, keepdim=True) + eg.sum(dim=-1, keepdim=True)
    pp, pg = ep / denom, eg / denom
    if drop_mult is None and _drops(drop_seed, drop_rate, K, beam_bias):
        drop_mult = philox.decode_keep_scale(drop_seed, B, H, S, P, G,
                                             drop_rate, device=q.device)
    if drop_mult is not None:
        mult = drop_mult[:, None]
        pp, pg = pp * mult[..., :P], pg * mult[..., P:]
    pp, pg = pp.to(dt).float(), pg.to(dt).float()
    ctx = torch.einsum("bkhsj,bjhd->bkshd", pp, pv4)
    if beam_bias is None:
        ctx = ctx + torch.einsum("bkhsj,bkjhd->bkshd", pg,
                                 gv.float().view(B, K, G, H, D))
    else:
        ctx = ctx + torch.einsum("bkhsc,bchd->bkshd", pg,
                                 gv.float().view(B, K * G, H, D))
    return ctx.to(dt).reshape(BK, S, HD)


def _drops(drop_seed, drop_rate: float, K: int, beam_bias) -> bool:
    """Whether a step applies dropout (K5); raises where K5 does not
    apply (beam search, as the TPU kernel's asserts)."""
    if drop_seed is None or drop_rate <= 0.0:
        return False
    if beam_bias is not None or K != 1:
        raise ValueError("decode attention dropout is for sampled rollouts: "
                         "K == 1 and no beam bias")
    return True


def decode_attention(q, k, v, pk, pv, gk, gv, gen_len: int, *,
                     n_heads: int, beam_bias=None, drop_seed=None,
                     drop_rate: float = 0.0) -> torch.Tensor:
    """Fused decode step; same contract as ``decode_attention_plain``.

    CUDA inputs: bf16 or fp32; q/k/v and gk/gv contiguous; pk/pv with
    contiguous rows and any batch stride (the prefill hands over a
    ``[:, :P]`` view of its [B, P+1, H*D] projections); head width 64."""
    if q.device.type == "cpu":
        return decode_attention_plain(q, k, v, pk, pv, gk, gv, gen_len,
                                      n_heads=n_heads, beam_bias=beam_bias,
                                      drop_seed=drop_seed,
                                      drop_rate=drop_rate)
    return _decode_attention_cuda(q, k, v, pk, pv, gk, gv, gen_len, n_heads,
                                  beam_bias, drop_seed, drop_rate)


def _decode_attention_cuda(q, k, v, pk, pv, gk, gv, gen_len, n_heads,
                           beam_bias, drop_seed=None, drop_rate=0.0):
    if q.device.type != "cuda":
        raise ValueError(f"decode_attention: unsupported device {q.device}")
    BK, S, HD = q.shape
    B, P, _ = pk.shape
    G = gk.shape[1]
    H = n_heads
    if HD != H * HEAD_DIM:
        raise ValueError(f"decode_attention kernel takes head width "
                         f"{HEAD_DIM}, got {HD}/{H}")
    if BK % B:
        raise ValueError("decode_attention: rows are not a multiple of B")
    K = BK // B
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"decode_attention takes bf16 or fp32, got {q.dtype}")
    tensors = (q, k, v, pk, pv, gk, gv)
    if any(t.dtype != q.dtype or t.device != q.device for t in tensors):
        raise ValueError("decode_attention: operands differ in dtype/device")
    if k.shape != q.shape or v.shape != q.shape:
        raise ValueError("decode_attention: q, k, v differ in shape")
    if pv.shape != pk.shape or pk.shape[2] != HD:
        raise ValueError("decode_attention: bad prompt cache shape")
    if gk.shape != (BK, G, HD) or gv.shape != gk.shape:
        raise ValueError("decode_attention: bad generated cache shape")
    for t in (q, k, v, gk, gv):
        if not t.is_contiguous():
            raise ValueError("decode_attention: q/k/v/gk/gv must be "
                             "contiguous (gk/gv are written in place)")
    if pk.stride(2) != 1 or pk.stride(1) != HD or pv.stride() != pk.stride():
        raise ValueError("decode_attention: prompt cache rows must be "
                         "contiguous and pk/pv must share strides")
    if not 0 <= gen_len:
        raise ValueError(f"decode_attention: gen_len {gen_len} < 0")
    # the kernel moves 16-byte chunks; it refuses (P, K, G) whose staged
    # caches exceed a block's shared memory
    if any(t.data_ptr() % 16 for t in tensors) or \
            (pk.stride(0) * pk.element_size()) % 16:
        raise ValueError("decode_attention: operands and the prompt cache's "
                         "batch stride must be 16-byte aligned")
    ab = 0
    if beam_bias is not None:
        if (beam_bias.shape != (BK, K * G) or beam_bias.dtype != torch.float32
                or beam_bias.device != q.device
                or not beam_bias.is_contiguous()):
            raise ValueError("decode_attention: beam_bias must be contiguous "
                             "fp32 [B*K, K*G] on q's device")
        ab = beam_bias.data_ptr()
    out = torch.empty_like(q)
    ptrs = (q.data_ptr(), k.data_ptr(), v.data_ptr(), pk.data_ptr(),
            pv.data_ptr(), gk.data_ptr(), gv.data_ptr())
    tail = (int(gen_len), 1.0 / math.sqrt(HEAD_DIM))
    flags = (int(q.dtype == torch.bfloat16), _build.stream_ptr(q.device))
    lib = _build.library()
    if _drops(drop_seed, drop_rate, K, beam_bias):
        name = "decode_attention_drop"
        err = lib.vlp_decode_attention_drop(
            *ptrs, out.data_ptr(), B, S, P, G, H, pk.stride(0), *tail,
            *_dropout_args(drop_rate, drop_seed), *flags)
    else:
        name = ("decode_attention" if beam_bias is None
                else "decode_attention_anc")
        err = lib.vlp_decode_attention(
            *ptrs, ab, out.data_ptr(), B, K, S, P, G, H, pk.stride(0),
            *tail, *flags)
    _build.check(err, name)
    _build.count_launch(name)
    return out


def _dropout_args(dropout_rate: float, seed: int):
    """(seed, threshold, keep_scale) of K5's and K6's C interface, which
    take the 64-bit seed by value (an SCST step is not captured in a CUDA
    graph; K1/K2 read theirs from device memory, ``ops.attention``)."""
    if not 0.0 <= dropout_rate < 1.0:
        raise ValueError(f"dropout rate {dropout_rate} outside [0, 1)")
    if dropout_rate == 0.0:
        return 0, 0, 1.0
    if seed is None or not 0 <= seed < 2 ** 64:
        raise ValueError("attention dropout needs a 64-bit seed")
    return (seed, philox.keep_threshold(dropout_rate),
            1.0 / (1.0 - dropout_rate))


def decode_dropout_scales(seeds, B: int, *, n_heads: int, S: int, P: int,
                          G: int, rate: float, device) -> torch.Tensor:
    """K5's multipliers of one layer over a rollout: fp32
    ``[N, H, S, P+G]``, N = len(seeds) * B, row ``t*B + b`` holding step
    t's draws for example b (``seeds[t]`` keyed K5 in step t).  The
    ``decode_dropout_scales`` kernel (K6, at most ``MAX_DROPOUT_STEPS``
    seeds) on a CUDA device, ``philox.decode_keep_scale`` on the CPU."""
    device = torch.device(device)
    H = n_heads
    if not 0.0 < rate < 1.0:
        raise ValueError(f"decode_dropout_scales: rate {rate} outside (0, 1)")
    if device.type == "cpu":
        return torch.cat([philox.decode_keep_scale(s, B, H, S, P, G, rate)
                          for s in seeds])
    if device.type != "cuda":
        raise ValueError(f"decode_dropout_scales: unsupported device {device}")
    for s in seeds:
        _dropout_args(rate, s)   # each a 64-bit seed
    W = len(seeds)
    if not 0 < W <= MAX_DROPOUT_STEPS:
        raise ValueError(f"decode_dropout_scales kernel takes 1 to "
                         f"{MAX_DROPOUT_STEPS} decode steps, got {W}")
    out = torch.empty((W * B, H, S, P + G), dtype=torch.float32,
                      device=device)
    _, threshold, keep = _dropout_args(rate, seeds[0])
    # the seeds go to the kernel by value, from host memory
    err = _build.library().vlp_decode_dropout_scales(
        out.data_ptr(), (ctypes.c_ulonglong * W)(*seeds), W, B, H, S, P + G,
        threshold, keep, _build.stream_ptr(device))
    _build.check(err, "decode_dropout_scales")
    _build.count_launch("decode_dropout_scales")
    return out
