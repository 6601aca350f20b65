"""Structurally-masked multi-head attention (counterpart of
``vlp_tpu/ops/attention.py``, ``attention_pallas`` :422) in both of its
layouts: ``layout="blhd"`` (q/k/v ``[B, L, H, D]``, the projections' own
layout, which every model call uses) and ``layout="bhld"``
(``[B, H, L, D]``).  The output layout is the input's.

* ``attention_plain`` — plain PyTorch with the reference math: fp32 scores
  ``Q K^T / sqrt(D)`` plus the additive -10000 mask built from
  (``mode``, ``text_end``, ``colkeep``, ``prefix``), fp32 softmax, optional
  attention-prob dropout (Philox keep/scale multipliers, ``ops/philox.py``),
  P cast to the activation dtype, P V accumulated in fp32.
* ``attention_bwd_plain`` — its backward, written out as the TPU backward
  kernel computes it (P recomputed, the dropout mask regenerated).
* ``attention`` — the inference wrapper (decode prefill, encode).  For CPU
  tensors it takes ``attention_plain``; for CUDA tensors it launches
  ``csrc/attention_fwd.cu`` (counterpart of ``_fwd_kernel_blhd``, or of
  ``_fwd_kernel`` in bhld) or raises.
* ``FusedAttention`` — the training ``torch.autograd.Function``
  (counterpart of ``_fused_attention``): forward K1 with dropout
  (``attention_fwd_drop``; ``attention_fwd_bhld_drop`` in bhld), backward
  K2 (``csrc/attention_bwd.cu``, counterpart of ``_bwd_kernel_blhd``, or
  ``_bwd_kernel`` in bhld), or their plain versions for CPU tensors.
  There is no fallback between a kernel and its plain version, and no
  layout becomes the other's kernel plus transposes: the bhld kernels
  read and write ``[B, H, L, D]`` themselves.  The plain versions of bhld
  are those of blhd on transposed views.
* The dtype picks the kernel body, in both layouts and both directions:
  bf16 (every main path) runs the tensor-core bodies (``mma.sync`` on
  tiles staged with ``cp.async``; the backward rounds P o keep and dS to
  bf16 before their products), fp16 (``--true_fp16`` training) the same
  bodies instantiated for fp16 (rounding to fp16 where bf16 rounds to
  bf16; an overflow becomes inf and a NaN stays NaN, so the loss scaler
  sees it), fp32 the split-TF32 bodies (every product
  as three TF32 tensor-core products of the operands' two parts, accurate
  to fp32's summation-order differences, which the card-vs-CPU fp32
  checks rest on).  Every dtype takes every L up to the 16-bit forward's
  limit (528).  Nothing falls back from one body to another.  fp16 has
  launch counts of its own (``attention_fwd_fp16``, ...: the name of the
  bf16 and fp32 form plus ``_fp16``).
* ``dropout_mask`` — the multipliers themselves (``csrc/dropout_mask.cu``),
  to hold the kernels' bits against ``philox.keep_scale`` on the card.
* MLA (``models/kimi_vl.py``): q and k of D = 192 a head beside v of 128.
  The plain versions take any v width; on the card the L <= 128 bodies
  are instantiated at (192, 128), bf16 at rate 0 in blhd, with launch
  counts of their own (``attention_fwd_mla``, ``attention_bwd_mla``).
  Every other shape of the kernels keeps D == 64.

A dropout ``seed`` is 64 bits, one per call (per layer and step); the
example, head, row and column of a draw are Philox's counter.  Every
function here takes it in one of two forms: a 0-d ``int64`` or ``uint64``
tensor (its 64 bits as they are) or a Python int in [0, 2^64).  The
kernels read it from device memory, as the TPU kernels take theirs as a
scalar-prefetch operand (``vlp_tpu/ops/attention.py:295``), so a captured
CUDA graph draws whatever its slot holds when it is replayed
(``models.model.DropoutRNG``'s seed table); a Python int is first written
into a slot of its own (:func:`seed_slot`).  The plain versions take
either form and draw the same bits from both.
"""

from __future__ import annotations

import math

import torch

from vlp_tpu_torch.ops import _build, masks, philox
from vlp_tpu_torch.ops.masks import NEG_INF

HEAD_DIM = 64  # VLP's head width: every kernel body and layout
MLA_QK_DIM, MLA_V_DIM = 192, 128  # MLA's q.k and v widths (bf16, blhd)
MLA_MAX_LEN = 128  # the L <= 128 bodies are the ones instantiated for MLA
LAYOUTS = ("blhd", "bhld")
# the kernels' dtype code (csrc/common.cuh vlp::DType)
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def _check_layout(layout: str) -> None:
    if layout not in LAYOUTS:
        raise ValueError(f"attention layout must be one of {LAYOUTS}, got "
                         f"{layout!r}")


def _swap(layout: str, *ts):
    """bhld tensors as blhd views (and back): dims 1 and 2 swapped."""
    _check_layout(layout)
    return ts if layout == "blhd" else tuple(t.transpose(1, 2) for t in ts)


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
                    dropout_rate: float = 0.0, seed=None,
                    layout: str = "blhd") -> torch.Tensor:
    """q/k/v: [B, L, H, D] (``[B, H, L, D]`` in bhld); mode/text_end:
    int[B]; colkeep: float[B, L]; seed (module docstring) when
    ``dropout_rate > 0``.  Returns q's layout and dtype."""
    if layout != "blhd":
        q, k, v = _swap(layout, q, k, v)
        return attention_plain(q, k, v, mode, text_end, colkeep,
                               prefix=prefix, dropout_rate=dropout_rate,
                               seed=seed).transpose(1, 2)
    p = _probs(q, k, mode, text_end, colkeep, prefix)
    keep = _keep(q, dropout_rate, seed)
    if keep is not None:
        p = p * keep
    out = torch.einsum("bhlm,bmhd->blhd", p.to(q.dtype).float(), v.float())
    return out.to(q.dtype)


def attention_bwd_plain(q, k, v, mode, text_end, colkeep, dout, *,
                        prefix: int, dropout_rate: float = 0.0, seed=None,
                        layout: str = "blhd"):
    """(dq, dk, dv) of ``attention_plain`` for the output gradient ``dout``,
    each in q's layout and dtype.  fp32 throughout, as the TPU backward
    kernel: ``rowsum(dP o P)`` takes P without the keep mask and dP with
    it."""
    if layout != "blhd":
        grads = attention_bwd_plain(*_swap(layout, q, k, v), mode, text_end,
                                    colkeep, dout.transpose(1, 2),
                                    prefix=prefix, dropout_rate=dropout_rate,
                                    seed=seed)
        return tuple(g.transpose(1, 2) for g in grads)
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


def attention(q, k, v, mode, text_end, colkeep, *, prefix: int,
              layout: str = "blhd") -> torch.Tensor:
    """Fused attention forward without dropout; same contract as
    ``attention_plain``.  No backward on CUDA: training goes through
    ``FusedAttention``.

    CUDA inputs: q/k/v bf16 or fp16 (the 16-bit tensor-core body) or fp32
    (the split-TF32 body) with identical strides and D == 64.  In blhd the (H, D) dims are
    packed (``x.view(B, L, H, D)`` of a projection output, any batch and
    row stride); in bhld any batch, head and row strides with the last dim
    contiguous.  Base pointers or strides that are not 16-byte aligned
    are taken too: the kernel then stages with narrower copies.  The
    output is contiguous."""
    if q.device.type == "cpu":
        return attention_plain(q, k, v, mode, text_end, colkeep,
                               prefix=prefix, layout=layout)
    return _forward_cuda(q, k, v, mode, text_end, colkeep, prefix,
                         layout=layout)


def _dims(q, layout):
    """(B, L, H, D) of a q in ``layout``."""
    if layout == "blhd":
        B, L, H, D = q.shape
    else:
        B, H, L, D = q.shape
    return B, L, H, D


def is_mla(q, v, layout: str = "blhd") -> bool:
    """Whether (q, v) take the MLA kernels: blhd, q.k of 192 and v of 128
    a head."""
    return (layout == "blhd" and q.shape[-1] == MLA_QK_DIM
            and v.shape[-1] == MLA_V_DIM)


def _check_mla(q, k, v, mode, text_end, colkeep, what, dropout_rate):
    B, L, H, _ = q.shape
    if q.dtype != torch.bfloat16:
        raise TypeError(f"{what} kernel takes bf16, got {q.dtype}")
    if dropout_rate != 0.0:
        raise ValueError(f"{what} kernel takes no dropout, got rate "
                         f"{dropout_rate}")
    if L > MLA_MAX_LEN:
        raise ValueError(f"{what} kernel takes L <= {MLA_MAX_LEN}, got {L}")
    if (k.shape != q.shape or v.shape != (B, L, H, MLA_V_DIM)
            or {k.dtype, v.dtype} != {q.dtype}
            or {k.device, v.device} != {q.device}):
        raise ValueError(f"{what}: q, k [B, L, H, {MLA_QK_DIM}] and v "
                         f"[B, L, H, {MLA_V_DIM}] differ in shape/dtype/"
                         "device")
    if k.stride() != q.stride():
        raise ValueError(f"{what}: q and k must share strides")
    for t, d in ((q, MLA_QK_DIM), (v, MLA_V_DIM)):
        if t.stride(3) != 1 or t.stride(2) != d:
            raise ValueError(f"{what}: the (H, D) dims must be packed")
    if any(m.device != q.device for m in (mode, text_end, colkeep)):
        raise ValueError(f"{what}: mask metadata must be on q's device")
    if mode.shape != (B,) or text_end.shape != (B,) or colkeep.shape != (B, L):
        raise ValueError(f"{what}: mask metadata has the wrong shape")
    return (mode.to(torch.int32).contiguous(),
            text_end.to(torch.int32).contiguous(),
            colkeep.to(torch.float32).contiguous())


def _check_qkv(q, k, v, mode, text_end, colkeep, what, layout="blhd"):
    _check_layout(layout)
    if q.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {q.device}")
    B, L, H, D = _dims(q, layout)
    if D != HEAD_DIM:
        raise ValueError(f"{what} kernel takes D == {HEAD_DIM}, got {D}")
    if q.dtype not in DTYPE_CODES:
        raise TypeError(f"{what} kernel takes bf16, fp16 or fp32, got "
                        f"{q.dtype}")
    for t in (k, v):
        if t.shape != q.shape or t.dtype != q.dtype or t.device != q.device:
            raise ValueError(f"{what}: q, k, v differ in shape/dtype/device")
        if t.stride() != q.stride():
            raise ValueError(f"{what}: q, k, v must share strides")
    if q.stride(3) != 1:
        raise ValueError(f"{what}: the last dim must be contiguous")
    if layout == "blhd" and q.stride(2) != D:
        raise ValueError(f"{what}: the (H, D) dims must be packed")
    if any(m.device != q.device for m in (mode, text_end, colkeep)):
        raise ValueError(f"{what}: mask metadata must be on q's device")
    if mode.shape != (B,) or text_end.shape != (B,) or colkeep.shape != (B, L):
        raise ValueError(f"{what}: mask metadata has the wrong shape")
    return (mode.to(torch.int32).contiguous(),
            text_end.to(torch.int32).contiguous(),
            colkeep.to(torch.float32).contiguous())


def seed_slot(seed, device) -> torch.Tensor:
    """The 0-d int64 tensor on ``device`` that the kernels read a dropout
    seed from: ``seed`` itself when it is a 0-d int64 tensor there (a
    uint64 one viewed as int64, the same bits), or a Python int in
    [0, 2^64) written into a new slot by a fill on the device (no host
    copy, no sync)."""
    device = torch.device(device)
    if torch.is_tensor(seed):
        if seed.shape != () or seed.dtype not in (torch.int64, torch.uint64):
            raise ValueError("a dropout seed tensor is 0-d int64 or uint64, "
                             f"got {tuple(seed.shape)} {seed.dtype}")
        if seed.device != device:
            raise ValueError(f"dropout seed on {seed.device}, not {device}")
        return seed.view(torch.int64)
    if seed is None or not 0 <= seed < 2 ** 64:
        raise ValueError("attention dropout needs a 64-bit seed")
    return torch.full((), philox.as_int64(seed), dtype=torch.int64,
                      device=device)


def _dropout_args(dropout_rate: float, seed, device):
    """(slot, seed pointer, threshold, keep_scale) of the kernels' C
    interface: ``slot`` (:func:`seed_slot`, None at rate 0) holds the seed
    the pointer points to and must outlive the launch."""
    if not 0.0 <= dropout_rate < 1.0:
        raise ValueError(f"dropout rate {dropout_rate} outside [0, 1)")
    if dropout_rate == 0.0:
        return None, None, 0, 1.0
    slot = seed_slot(seed, device)
    return (slot, slot.data_ptr(), philox.keep_threshold(dropout_rate),
            1.0 / (1.0 - dropout_rate))


def _count_name(name: str, dtype: torch.dtype) -> str:
    """The launch count a call of kernel ``name`` in ``dtype`` adds to:
    fp16 forms count apart from the bf16 and fp32 ones."""
    return name + ("_fp16" if dtype == torch.float16 else "")


def _forward_cuda(q, k, v, mode, text_end, colkeep, prefix,
                  dropout=None, layout="blhd"):
    """K1 (``_fwd_kernel``'s counterpart in bhld); ``dropout`` = (rate,
    seed) selects the training branch.  Each layout has one entry point
    for both branches (rate 0 is the deterministic kernel); each branch
    keeps its own launch count."""
    if is_mla(q, v, layout):
        return _forward_mla(q, k, v, mode, text_end, colkeep, prefix,
                            0.0 if dropout is None else dropout[0])
    entry = "attention_fwd" + ("_bhld" if layout == "bhld" else "")
    what = _count_name(entry + ("" if dropout is None else "_drop"), q.dtype)
    mode, text_end, colkeep = _check_qkv(q, k, v, mode, text_end, colkeep,
                                         what, layout)
    B, L, H, D = _dims(q, layout)
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    strides = q.stride()[:3] if layout == "bhld" else q.stride()[:2]
    common = (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
              mode.data_ptr(), text_end.data_ptr(), colkeep.data_ptr(),
              B, L, H, *strides, prefix, 1.0 / math.sqrt(D))
    slot, *drop_args = _dropout_args(*(dropout or (0.0, None)), q.device)
    err = getattr(_build.library(), "vlp_" + entry)(
        *common, *drop_args, DTYPE_CODES[q.dtype],
        _build.stream_ptr(q.device))
    _build.check(err, what)
    _build.count_launch(what)
    return out


def _forward_mla(q, k, v, mode, text_end, colkeep, prefix, rate):
    """K1 at MLA's (192, 128): out [B, L, H, 128], contiguous."""
    what = "attention_fwd_mla"
    mode, text_end, colkeep = _check_mla(q, k, v, mode, text_end, colkeep,
                                         what, rate)
    B, L, H, D = q.shape
    out = torch.empty(v.shape, dtype=q.dtype, device=q.device)
    err = _build.library().vlp_attention_fwd_mla(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
        mode.data_ptr(), text_end.data_ptr(), colkeep.data_ptr(), B, L, H,
        q.stride(0), q.stride(1), v.stride(0), v.stride(1), prefix,
        1.0 / math.sqrt(D), _build.stream_ptr(q.device))
    _build.check(err, what)
    _build.count_launch(what)
    return out


def _backward_mla(q, k, v, mode, text_end, colkeep, dout, prefix, rate):
    """K2 at MLA's (192, 128): (dq, dk, dv), contiguous."""
    what = "attention_bwd_mla"
    mode, text_end, colkeep = _check_mla(q, k, v, mode, text_end, colkeep,
                                         what, rate)
    B, L, H, D = q.shape
    if dout.shape != v.shape or dout.dtype != q.dtype:
        raise ValueError(f"{what}: dout differs from v in shape/dtype")
    if dout.stride(3) != 1 or dout.stride(2) != MLA_V_DIM:
        dout = dout.contiguous()
    dq, dk = (torch.empty(q.shape, dtype=q.dtype, device=q.device)
              for _ in range(2))
    dv = torch.empty(v.shape, dtype=q.dtype, device=q.device)
    err = _build.library().vlp_attention_bwd_mla(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
        dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), mode.data_ptr(),
        text_end.data_ptr(), colkeep.data_ptr(), B, L, H, q.stride(0),
        q.stride(1), v.stride(0), v.stride(1), dout.stride(0),
        dout.stride(1), prefix, 1.0 / math.sqrt(D),
        _build.stream_ptr(q.device))
    _build.check(err, what)
    _build.count_launch(what)
    return dq, dk, dv


def _backward_cuda(q, k, v, mode, text_end, colkeep, dout, prefix, rate,
                   seed, layout="blhd"):
    """K2 (``_bwd_kernel``'s counterpart in bhld): (dq, dk, dv), each
    contiguous in q's layout and dtype."""
    if is_mla(q, v, layout):
        return _backward_mla(q, k, v, mode, text_end, colkeep, dout, prefix,
                             rate)
    entry = "attention_bwd" + ("_bhld" if layout == "bhld" else "")
    what = _count_name(entry, q.dtype)
    mode, text_end, colkeep = _check_qkv(q, k, v, mode, text_end, colkeep,
                                         what, layout)
    B, L, H, D = _dims(q, layout)
    lib = _build.library()
    dtype = DTYPE_CODES[q.dtype]
    max_len = lib.vlp_attention_bwd_max_len()
    if L > max_len:
        raise ValueError(f"attention_bwd kernel takes L <= {max_len} (the "
                         f"forward's limit), got {L}")
    if dout.shape != q.shape or dout.dtype != q.dtype:
        raise ValueError(f"{what}: dout differs from q in shape/dtype")
    n = 3 if layout == "bhld" else 2   # the strides the entry point takes
    if dout.stride(3) != 1 or (layout == "blhd" and dout.stride(2) != D):
        dout = dout.contiguous()
    grads = [torch.empty(q.shape, dtype=q.dtype, device=q.device)
             for _ in range(3)]
    # the tiled bodies (bf16 and fp16 past L = 144, fp32 at every L) keep
    # each row's softmax statistics and keep bits between their kernels in
    # an fp32 scratch, O(L) floats per (example, head)
    n_scratch = lib.vlp_attention_bwd_scratch_floats(L, dtype)
    scratch = (torch.empty(B * H * n_scratch, dtype=torch.float32,
                           device=q.device) if n_scratch else None)
    slot, *drop_args = _dropout_args(rate, seed, q.device)
    err = getattr(lib, "vlp_" + entry)(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), dout.data_ptr(),
        *(g.data_ptr() for g in grads),
        None if scratch is None else scratch.data_ptr(), mode.data_ptr(),
        text_end.data_ptr(), colkeep.data_ptr(), B, L, H,
        *q.stride()[:n], *dout.stride()[:n], prefix, 1.0 / math.sqrt(D),
        *drop_args, dtype, _build.stream_ptr(q.device))
    _build.check(err, what)
    _build.count_launch(what)
    return tuple(grads)


class FusedAttention(torch.autograd.Function):
    """Training attention: K1 with dropout forward, K2 backward, no L x L
    residual saved (the backward recomputes P and regenerates the dropout
    multipliers from ``seed``).  On the card the seed is held as its device
    slot (:func:`seed_slot`), and K2 reads the slot K1 read.

    ``FusedAttention.apply(q, k, v, mode, text_end, colkeep, prefix,
    dropout_rate, seed[, layout])``, ``layout`` "blhd" (the default, every
    model call) or "bhld" (the bhld kernels); gradients flow to q, k and v
    only.  The same seed draws the same multipliers in both layouts."""

    @staticmethod
    def forward(ctx, q, k, v, mode, text_end, colkeep, prefix, dropout_rate,
                seed, layout="blhd"):
        ctx.save_for_backward(q, k, v, mode, text_end, colkeep)
        if q.device.type != "cpu" and dropout_rate > 0.0:
            seed = seed_slot(seed, q.device)
        ctx.args = (prefix, dropout_rate, seed, layout)
        if q.device.type == "cpu":
            return attention_plain(q, k, v, mode, text_end, colkeep,
                                   prefix=prefix, dropout_rate=dropout_rate,
                                   seed=seed, layout=layout)
        return _forward_cuda(q, k, v, mode, text_end, colkeep, prefix,
                             dropout=(dropout_rate, seed), layout=layout)

    @staticmethod
    def backward(ctx, dout):
        q, k, v, mode, text_end, colkeep = ctx.saved_tensors
        prefix, rate, seed, layout = ctx.args
        if q.device.type == "cpu":
            dq, dk, dv = attention_bwd_plain(
                q, k, v, mode, text_end, colkeep, dout, prefix=prefix,
                dropout_rate=rate, seed=seed, layout=layout)
        else:
            dq, dk, dv = _backward_cuda(q, k, v, mode, text_end, colkeep,
                                        dout, prefix, rate, seed, layout)
        return dq, dk, dv, None, None, None, None, None, None, None


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
    slot, *drop_args = _dropout_args(dropout_rate, seed, device)
    err = _build.library().vlp_dropout_mask(
        out.data_ptr(), B, H, L, *drop_args, _build.stream_ptr(device))
    _build.check(err, "dropout_mask")
    _build.count_launch("dropout_mask")
    return out


def colkeep_from_vis_keep(vis_keep: torch.Tensor,
                          seq_len: int) -> torch.Tensor:
    """Expand float[B, nv] region-keep into float[B, L] column-keep."""
    B, nv = vis_keep.shape
    colkeep = torch.ones((B, seq_len), dtype=torch.float32,
                         device=vis_keep.device)
    colkeep[:, 1:nv + 1] = vis_keep
    return colkeep
