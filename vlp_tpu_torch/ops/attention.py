"""Structurally-masked multi-head attention, ``[B, L, H, D]`` layout
(counterpart of ``vlp_tpu/ops/attention.py``, ``layout="blhd"``).

* ``attention_plain`` — plain PyTorch with the reference math: fp32 scores
  ``Q K^T / sqrt(D)`` plus the additive -10000 mask built from
  (``mode``, ``text_end``, ``colkeep``, ``prefix``), fp32 softmax, optional
  attention-prob dropout (Philox keep/scale multipliers, ``ops/philox.py``),
  P cast to the activation dtype, P V accumulated in fp32.
* ``attention_bwd_plain`` — its backward, written out as the TPU backward
  kernel computes it (P recomputed, the dropout mask regenerated).
* ``attention`` — the inference wrapper (decode prefill, encode).  For CPU
  tensors it takes ``attention_plain``; for CUDA tensors it launches
  ``csrc/attention_fwd.cu`` (counterpart of ``_fwd_kernel_blhd``) or raises.
* ``FusedAttention`` — the training ``torch.autograd.Function``
  (counterpart of ``_fused_attention``): forward K1 with dropout
  (``attention_fwd_drop``), backward K2 (``csrc/attention_bwd.cu``,
  counterpart of ``_bwd_kernel_blhd``), or their plain versions for CPU
  tensors.  There is no fallback between a kernel and its plain version.
* ``dropout_mask`` — the multipliers themselves (``csrc/dropout_mask.cu``),
  to hold the kernels' bits against ``philox.keep_scale`` on the card.

A dropout ``seed`` is a 64-bit int, one per call (per layer and step); the
example, head, row and column of a draw are Philox's counter.
"""

from __future__ import annotations

import math

import torch

from vlp_tpu_torch.ops import _build, masks, philox
from vlp_tpu_torch.ops.masks import NEG_INF

HEAD_DIM = 64  # the only head width the kernels are built for


def _mask_bias(mode, text_end, colkeep, prefix: int, L: int) -> torch.Tensor:
    """Additive fp32 mask [B, L, L] (``_mask_bias`` of the JAX package)."""
    vis = masks.structural_visibility(mode, text_end, prefix, L)
    vis = vis & (colkeep[:, None, :] > 0.5)
    bias = torch.full(vis.shape, NEG_INF, dtype=torch.float32,
                      device=vis.device)
    return bias.masked_fill(vis, 0.0)


def _probs(q, k, mode, text_end, colkeep, prefix):
    """fp32 softmax probabilities [B, H, L, L]."""
    L, D = q.shape[1], q.shape[-1]
    bias = _mask_bias(mode, text_end, colkeep, prefix, L)
    s = torch.einsum("blhd,bmhd->bhlm", q.float(), k.float())
    s = s * (1.0 / math.sqrt(D)) + bias[:, None]
    e = torch.exp(s - s.amax(dim=-1, keepdim=True))
    return e / e.sum(dim=-1, keepdim=True)


def _keep(q, dropout_rate: float, seed):
    """Philox keep/scale multipliers [B, H, L, L] for q's shape, or None."""
    if dropout_rate <= 0.0:
        return None
    if seed is None:
        raise ValueError("attention dropout needs a seed")
    B, L, H, _ = q.shape
    return philox.keep_scale(seed, B, H, L, dropout_rate, device=q.device)


def attention_plain(q, k, v, mode, text_end, colkeep, *, prefix: int,
                    dropout_rate: float = 0.0, seed=None) -> torch.Tensor:
    """q/k/v: [B, L, H, D]; mode/text_end: int[B]; colkeep: float[B, L];
    seed: 64-bit int when ``dropout_rate > 0``.  Returns [B, L, H, D] in
    q's dtype."""
    p = _probs(q, k, mode, text_end, colkeep, prefix)
    keep = _keep(q, dropout_rate, seed)
    if keep is not None:
        p = p * keep
    out = torch.einsum("bhlm,bmhd->blhd", p.to(q.dtype).float(), v.float())
    return out.to(q.dtype)


def attention_bwd_plain(q, k, v, mode, text_end, colkeep, dout, *,
                        prefix: int, dropout_rate: float = 0.0, seed=None):
    """(dq, dk, dv) of ``attention_plain`` for the output gradient ``dout``,
    each [B, L, H, D] in q's dtype.  fp32 throughout, as the TPU backward
    kernel: ``rowsum(dP o P)`` takes P without the keep mask and dP with
    it."""
    D = q.shape[-1]
    scale = 1.0 / math.sqrt(D)
    qf, kf, vf, dof = (t.float() for t in (q, k, v, dout))
    p = _probs(q, k, mode, text_end, colkeep, prefix)
    keep = _keep(q, dropout_rate, seed)
    pd = p if keep is None else p * keep
    dv = torch.einsum("bhlm,blhd->bmhd", pd, dof)
    dp = torch.einsum("blhd,bmhd->bhlm", dof, vf)
    if keep is not None:
        dp = dp * keep
    ds = p * (dp - (dp * p).sum(dim=-1, keepdim=True))
    dq = torch.einsum("bhlm,bmhd->blhd", ds, kf) * scale
    dk = torch.einsum("bhlm,blhd->bmhd", ds, qf) * scale
    return dq.to(q.dtype), dk.to(q.dtype), dv.to(q.dtype)


def attention(q, k, v, mode, text_end, colkeep, *,
              prefix: int) -> torch.Tensor:
    """Fused attention forward without dropout; same contract as
    ``attention_plain``.  No backward on CUDA: training goes through
    ``FusedAttention``.

    CUDA inputs: q/k/v bf16 or fp32 with identical strides, the (H, D)
    dims packed (``x.view(B, L, H, D)`` of a projection output, any batch
    and row stride); D == 64."""
    if q.device.type == "cpu":
        return attention_plain(q, k, v, mode, text_end, colkeep,
                               prefix=prefix)
    return _forward_cuda(q, k, v, mode, text_end, colkeep, prefix)


def _check_qkv(q, k, v, mode, text_end, colkeep, what):
    if q.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {q.device}")
    B, L, H, D = q.shape
    if D != HEAD_DIM:
        raise ValueError(f"{what} kernel takes D == {HEAD_DIM}, got {D}")
    if q.dtype not in (torch.bfloat16, torch.float32):
        raise TypeError(f"{what} kernel takes bf16 or fp32, got {q.dtype}")
    for t in (k, v):
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"{what}: q, k, v differ in shape/dtype/device")
        if t.stride() != q.stride():
            raise ValueError(f"{what}: q, k, v must share strides")
    if q.stride(3) != 1 or q.stride(2) != D:
        raise ValueError(f"{what}: the (H, D) dims must be packed")
    if any(m.device != q.device for m in (mode, text_end, colkeep)):
        raise ValueError(f"{what}: mask metadata must be on q's device")
    if mode.shape != (B,) or text_end.shape != (B,) or colkeep.shape != (B, L):
        raise ValueError(f"{what}: mask metadata has the wrong shape")
    return (mode.to(torch.int32).contiguous(),
            text_end.to(torch.int32).contiguous(),
            colkeep.to(torch.float32).contiguous())


def _dropout_args(dropout_rate: float, seed):
    """(seed, threshold, keep_scale) of the kernels' C interface."""
    if not 0.0 <= dropout_rate < 1.0:
        raise ValueError(f"dropout rate {dropout_rate} outside [0, 1)")
    if dropout_rate == 0.0:
        return 0, 0, 1.0
    if seed is None or not 0 <= seed < 2 ** 64:
        raise ValueError("attention dropout needs a 64-bit seed")
    return (seed, philox.keep_threshold(dropout_rate),
            1.0 / (1.0 - dropout_rate))


def _forward_cuda(q, k, v, mode, text_end, colkeep, prefix,
                  dropout=None):
    """K1; ``dropout`` = (rate, seed) selects the training entry point."""
    what = "attention_fwd" if dropout is None else "attention_fwd_drop"
    mode, text_end, colkeep = _check_qkv(q, k, v, mode, text_end, colkeep,
                                         what)
    B, L, H, D = q.shape
    out = torch.empty((B, L, H, D), dtype=q.dtype, device=q.device)
    common = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
              mode.data_ptr(), text_end.data_ptr(), colkeep.data_ptr(),
              B, L, H, q.stride(0), q.stride(1), prefix, 1.0 / math.sqrt(D))
    lib = _build.library()
    if dropout is None:
        err = lib.vlp_attention_fwd(*common, int(q.dtype == torch.bfloat16),
                                    _build.stream_ptr(q.device))
    else:
        err = lib.vlp_attention_fwd_drop(
            *common, *_dropout_args(*dropout),
            int(q.dtype == torch.bfloat16), _build.stream_ptr(q.device))
    _build.check(err, what)
    _build.KERNELS[what].launches += 1
    return out


def _backward_cuda(q, k, v, mode, text_end, colkeep, dout, prefix, rate,
                   seed):
    """K2: (dq, dk, dv), each contiguous [B, L, H, D] in q's dtype."""
    mode, text_end, colkeep = _check_qkv(q, k, v, mode, text_end, colkeep,
                                         "attention_bwd")
    B, L, H, D = q.shape
    lib = _build.library()
    max_len = lib.vlp_attention_bwd_max_len()
    if L > max_len:
        raise ValueError(f"attention_bwd kernel takes L <= {max_len} "
                         f"(its tiles must fit a block's shared memory), "
                         f"got {L}")
    if dout.shape != q.shape or dout.dtype != q.dtype:
        raise ValueError("attention_bwd: dout differs from q in shape/dtype")
    if dout.stride(3) != 1 or dout.stride(2) != D:
        dout = dout.contiguous()
    grads = [torch.empty((B, L, H, D), dtype=q.dtype, device=q.device)
             for _ in range(3)]
    err = lib.vlp_attention_bwd(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
        *(g.data_ptr() for g in grads), mode.data_ptr(),
        text_end.data_ptr(), colkeep.data_ptr(), B, L, H, q.stride(0),
        q.stride(1), dout.stride(0), dout.stride(1), prefix,
        1.0 / math.sqrt(D), *_dropout_args(rate, seed),
        int(q.dtype == torch.bfloat16), _build.stream_ptr(q.device))
    _build.check(err, "attention_bwd")
    _build.KERNELS["attention_bwd"].launches += 1
    return tuple(grads)


class FusedAttention(torch.autograd.Function):
    """Training attention: K1 with dropout forward, K2 backward, no L x L
    residual saved (the backward recomputes P and regenerates the dropout
    multipliers from ``seed``).

    ``FusedAttention.apply(q, k, v, mode, text_end, colkeep, prefix,
    dropout_rate, seed)``; gradients flow to q, k and v only."""

    @staticmethod
    def forward(ctx, q, k, v, mode, text_end, colkeep, prefix, dropout_rate,
                seed):
        ctx.save_for_backward(q, k, v, mode, text_end, colkeep)
        ctx.args = (prefix, dropout_rate, seed)
        if q.device.type == "cpu":
            return attention_plain(q, k, v, mode, text_end, colkeep,
                                   prefix=prefix, dropout_rate=dropout_rate,
                                   seed=seed)
        return _forward_cuda(q, k, v, mode, text_end, colkeep, prefix,
                             dropout=(dropout_rate, seed))

    @staticmethod
    def backward(ctx, dout):
        q, k, v, mode, text_end, colkeep = ctx.saved_tensors
        prefix, rate, seed = ctx.args
        if q.device.type == "cpu":
            dq, dk, dv = attention_bwd_plain(
                q, k, v, mode, text_end, colkeep, dout, prefix=prefix,
                dropout_rate=rate, seed=seed)
        else:
            dq, dk, dv = _backward_cuda(q, k, v, mode, text_end, colkeep,
                                        dout, prefix, rate, seed)
        return dq, dk, dv, None, None, None, None, None, None


def dropout_mask(B: int, H: int, L: int, dropout_rate: float, seed,
                 device) -> torch.Tensor:
    """fp32 [B, H, L, L] attention-dropout multipliers: ``philox.keep_scale``
    on the CPU, the ``dropout_mask`` kernel on a CUDA device."""
    device = torch.device(device)
    if device.type == "cpu":
        return philox.keep_scale(seed, B, H, L, dropout_rate)
    if device.type != "cuda":
        raise ValueError(f"dropout_mask: unsupported device {device}")
    out = torch.empty((B, H, L, L), dtype=torch.float32, device=device)
    err = _build.library().vlp_dropout_mask(
        out.data_ptr(), B, H, L, *_dropout_args(dropout_rate, seed),
        _build.stream_ptr(device))
    _build.check(err, "dropout_mask")
    _build.KERNELS["dropout_mask"].launches += 1
    return out


def colkeep_from_vis_keep(vis_keep: torch.Tensor,
                          seq_len: int) -> torch.Tensor:
    """Expand float[B, nv] region-keep into float[B, L] column-keep."""
    B, nv = vis_keep.shape
    colkeep = torch.ones((B, seq_len), dtype=torch.float32,
                         device=vis_keep.device)
    colkeep[:, 1:nv + 1] = vis_keep
    return colkeep
