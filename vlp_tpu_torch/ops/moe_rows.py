"""The row passes of Kimi-VL's expert layer (``models/kimi_vl.py``) around
its two grouped products, over the sorted row buffer of (token, held
expert) pairs: ``csrc/moe_rows.cu`` for CUDA tensors, the ``*_plain``
functions for CPU tensors (no fallback from one to the other).

The buffer has R rows, the most pairs a layer can hold (tokens x min(k,
held)); rows [0, count) belong to the held experts, sorted by expert, where
the count is ``offs[-1]`` (``offs`` int32, the end of each held expert's
rows).  Every function here touches only those rows: the kernels read the
count from device memory (no host sync, so a CUDA graph captures them),
and rows past it are neither read nor written.  Their contents are
undefined; the plain versions fill them with NaN, so that a pass that did
read them would show in the CPU tests.

* ``gather``: row r of the buffer is token ``order[r] // k``'s row of x;
  ``gather_bwd``: each token sums its held picks' rows (``row_of``, the
  inverse of the sort: pair p's row).
* ``swiglu``: ``silu(g) * u`` of the gate-up product's rows ``[g | u]``;
  ``swiglu_bwd``: d[g | u].
* ``combine``: each token's held picks' rows, weighted by the router's fp32
  weights ``w`` [T, k], summed, plus ``base`` (the shared experts' output);
  ``combine_bwd``: (d rows, dw), dw 0 for a pick that is not held.

Sums are fp32 over a token's picks j = 0..k-1 in order, rounded once; no
atomics.  :class:`GatherRows` and :class:`SwiGLURows` are the two passes
as autograd functions (the combine's backward is called by the layer's
``HeldRows`` directly).
"""

from __future__ import annotations

import functools

import torch
import torch.nn.functional as F

from vlp_tpu_torch.ops import _build

MAX_TOPK = 8         # csrc/moe_rows.cu kMaxTopK
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
BLOCKS_PER_SM = 8    # 256-thread blocks: a full SM


# --- plain versions (CPU) -----------------------------------------------

def _count(offs: torch.Tensor) -> int:
    return int(offs[-1]) if offs.numel() else 0


def _picks(row_of: torch.Tensor, k: int, count: int):
    """(each pick's row [T, k] with 0 where not held, held [T, k])."""
    r = row_of.view(-1, k)
    held = r < count
    return torch.where(held, r, 0), held


def _nan_rows(R: int, width: int, like: torch.Tensor) -> torch.Tensor:
    return torch.full((R, width), float("nan"), dtype=like.dtype,
                      device=like.device)


def gather_plain(x, order, offs, k: int) -> torch.Tensor:
    count = _count(offs)
    out = _nan_rows(order.shape[0], x.shape[1], x)
    out[:count] = x[order[:count] // k]
    return out


def gather_bwd_plain(dxg, row_of, offs, k: int) -> torch.Tensor:
    r, held = _picks(row_of, k, _count(offs))
    parts = torch.where(held[..., None], dxg[r].float(), 0.0)
    return parts.sum(1).to(dxg.dtype)


def swiglu_plain(gu, offs) -> torch.Tensor:
    count, inter = _count(offs), gu.shape[1] // 2
    out = _nan_rows(gu.shape[0], inter, gu)
    g, u = gu[:count].float().split(inter, dim=-1)
    out[:count] = (F.silu(g) * u).to(gu.dtype)
    return out


def swiglu_bwd_plain(dh, gu, offs) -> torch.Tensor:
    count, inter = _count(offs), gu.shape[1] // 2
    out = _nan_rows(gu.shape[0], 2 * inter, gu)
    g, u = gu[:count].float().split(inter, dim=-1)
    d = dh[:count].float()
    s = torch.sigmoid(g)
    out[:count] = torch.cat([d * u * (s * (1 + g * (1 - s))), d * g * s],
                            dim=-1).to(gu.dtype)
    return out


def combine_plain(y_rows, w, row_of, offs, k: int, base) -> torch.Tensor:
    r, held = _picks(row_of, k, _count(offs))
    parts = torch.where(held[..., None], w[..., None] * y_rows[r].float(),
                        0.0)
    return (parts.sum(1) + base.float()).to(y_rows.dtype)


def combine_bwd_plain(g, y_rows, w, row_of, offs, k: int):
    count = _count(offs)
    r, held = _picks(row_of, k, count)
    g32 = g.float()
    dw = torch.where(held, (g32[:, None] * y_rows[r].float()).sum(-1), 0.0)
    dy_rows = _nan_rows(y_rows.shape[0], y_rows.shape[1], y_rows)
    dy_rows[r[held]] = (w[held][:, None]
                        * g32[:, None].expand(-1, k, -1)[held]
                        ).to(y_rows.dtype)
    return dy_rows, dw


# --- the kernels (CUDA) -------------------------------------------------

@functools.lru_cache(maxsize=None)
def _max_blocks(index: int) -> int:
    return (torch.cuda.get_device_properties(index).multi_processor_count
            * BLOCKS_PER_SM)


def _vectors(what: str, t: torch.Tensor, width: int) -> int:
    """16-byte vectors in a row of ``width`` elements of t's dtype."""
    nbytes = width * t.element_size()
    if nbytes % 16:
        raise ValueError(f"{what}: a row of {width} {t.dtype} is not a "
                         "whole number of 16-byte vectors")
    return nbytes // 16


def _check(what: str, floats, offs, index=None, k: int = 1):
    """The kernels' terms: float tensors of one CUDA device, one dtype
    (bf16 or fp32), 2-D, contiguous, 16-byte aligned; int64 indices and
    int32 offsets on that device."""
    dev = floats[0].device
    dtype = floats[0].dtype
    if dtype not in DTYPE_CODES:
        raise TypeError(f"{what} kernel takes bf16 or fp32, got {dtype}")
    for t in floats:
        if t.device != dev or t.dtype != dtype or t.dim() != 2:
            raise ValueError(f"{what}: rows differ in device/dtype, or are "
                             "not 2-D")
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError(f"{what}: rows must be contiguous and 16-byte "
                             "aligned")
    if offs.device != dev or offs.dtype != torch.int32 or offs.dim() != 1 \
            or offs.numel() == 0:
        raise ValueError(f"{what}: offs must be int32 [held] on {dev}")
    if index is not None and (index.device != dev
                              or index.dtype != torch.int64
                              or not index.is_contiguous()):
        raise ValueError(f"{what}: indices must be contiguous int64 on {dev}")
    if not 1 <= k <= MAX_TOPK:
        raise ValueError(f"{what}: k = {k} outside 1..{MAX_TOPK}")


def _launch(what: str, err: int) -> None:
    _build.check(err, what)
    _build.count_launch(what)


def _ptr(t) -> int:
    return 0 if t is None else t.data_ptr()


def gather(x, order, offs, k: int) -> torch.Tensor:
    """[R, H]: row r < count is x[order[r] // k] (R = len(order))."""
    if not x.is_cuda:
        return gather_plain(x, order, offs, k)
    what = "moe_gather"
    _check(what, [x], offs, order, k)
    R, H = order.shape[0], x.shape[1]
    out = torch.empty((R, H), dtype=x.dtype, device=x.device)
    _launch(what, _build.library().vlp_moe_gather(
        x.data_ptr(), order.data_ptr(), offs.data_ptr(), offs.numel(),
        out.data_ptr(), R, _vectors(what, x, H), k,
        _max_blocks(x.device.index), _build.stream_ptr(x.device)))
    return out


def _sum_picks(what, rows, w, base, row_of, offs, k: int) -> torch.Tensor:
    T, H = row_of.shape[0] // k, rows.shape[1]
    _check(what, [rows] + ([] if base is None else [base]), offs, row_of, k)
    if w is not None and (w.device != rows.device or w.dtype != torch.float32
                          or w.shape != (T, k) or not w.is_contiguous()):
        raise ValueError(f"{what}: w must be contiguous fp32 [{T}, {k}]")
    if base is not None and base.shape != (T, H):
        raise ValueError(f"{what}: base must be [{T}, {H}]")
    out = torch.empty((T, H), dtype=rows.dtype, device=rows.device)
    _launch(what, _build.library().vlp_moe_sum_picks(
        rows.data_ptr(), _ptr(w), _ptr(base), row_of.data_ptr(),
        offs.data_ptr(), offs.numel(), out.data_ptr(), T,
        _vectors(what, rows, H), k, DTYPE_CODES[rows.dtype],
        _max_blocks(rows.device.index), _build.stream_ptr(rows.device)))
    return out


def gather_bwd(dxg, row_of, offs, k: int) -> torch.Tensor:
    """[T, H]: token t's sum of its held picks' rows of dxg."""
    if not dxg.is_cuda:
        return gather_bwd_plain(dxg, row_of, offs, k)
    return _sum_picks("moe_gather_bwd", dxg, None, None, row_of, offs, k)


def combine(y_rows, w, row_of, offs, k: int, base) -> torch.Tensor:
    """[T, H]: sum_j w[t, j] y_rows[row_of[t k + j]] over token t's held
    picks, plus ``base`` [T, H]."""
    if not y_rows.is_cuda:
        return combine_plain(y_rows, w, row_of, offs, k, base)
    return _sum_picks("moe_combine", y_rows, w, base, row_of, offs, k)


def combine_bwd(g, y_rows, w, row_of, offs, k: int):
    """(dy_rows [R, H], dw fp32 [T, k]) of :func:`combine` from g =
    dL/dy [T, H]."""
    if not g.is_cuda:
        return combine_bwd_plain(g, y_rows, w, row_of, offs, k)
    what = "moe_combine_bwd"
    T, H = row_of.shape[0] // k, g.shape[1]
    _check(what, [g, y_rows], offs, row_of, k)
    if w.dtype != torch.float32 or w.shape != (T, k) \
            or not w.is_contiguous() or g.shape[0] != T:
        raise ValueError(f"{what}: w must be contiguous fp32 [{T}, {k}] "
                         f"and g [{T}, H]")
    dy_rows = torch.empty_like(y_rows)
    dw = torch.empty((T, k), dtype=torch.float32, device=g.device)
    _launch(what, _build.library().vlp_moe_combine_bwd(
        g.data_ptr(), y_rows.data_ptr(), w.data_ptr(), row_of.data_ptr(),
        offs.data_ptr(), offs.numel(), dy_rows.data_ptr(), dw.data_ptr(), T,
        _vectors(what, g, H), k, DTYPE_CODES[g.dtype],
        _max_blocks(g.device.index), _build.stream_ptr(g.device)))
    return dy_rows, dw


def swiglu(gu, offs) -> torch.Tensor:
    """[R, I]: silu(g) * u of rows [g | u] of gu [R, 2 I]."""
    if not gu.is_cuda:
        return swiglu_plain(gu, offs)
    what = "moe_swiglu"
    _check(what, [gu], offs)
    R, inter = gu.shape[0], gu.shape[1] // 2
    vpr = _vectors(what, gu, inter)
    h = torch.empty((R, inter), dtype=gu.dtype, device=gu.device)
    _launch(what, _build.library().vlp_moe_swiglu(
        gu.data_ptr(), offs.data_ptr(), offs.numel(), h.data_ptr(), R, vpr,
        DTYPE_CODES[gu.dtype], _max_blocks(gu.device.index),
        _build.stream_ptr(gu.device)))
    return h


def swiglu_bwd(dh, gu, offs) -> torch.Tensor:
    """[R, 2 I]: d[g | u] of :func:`swiglu` from dh [R, I]."""
    if not gu.is_cuda:
        return swiglu_bwd_plain(dh, gu, offs)
    what = "moe_swiglu_bwd"
    _check(what, [dh, gu], offs)
    R, inter = gu.shape[0], gu.shape[1] // 2
    if dh.shape != (R, inter):
        raise ValueError(f"{what}: dh must be [{R}, {inter}]")
    vpr = _vectors(what, gu, inter)
    dgu = torch.empty_like(gu)
    _launch(what, _build.library().vlp_moe_swiglu_bwd(
        dh.data_ptr(), gu.data_ptr(), offs.data_ptr(), offs.numel(),
        dgu.data_ptr(), R, vpr, DTYPE_CODES[gu.dtype],
        _max_blocks(gu.device.index), _build.stream_ptr(gu.device)))
    return dgu


# --- autograd -----------------------------------------------------------

class GatherRows(torch.autograd.Function):
    """:func:`gather`, its backward :func:`gather_bwd`."""

    @staticmethod
    def forward(ctx, x, order, row_of, offs, k):
        ctx.save_for_backward(row_of, offs)
        ctx.k = k
        return gather(x, order, offs, k)

    @staticmethod
    def backward(ctx, dxg):
        row_of, offs = ctx.saved_tensors
        return (gather_bwd(dxg.contiguous(), row_of, offs, ctx.k), None,
                None, None, None)


class SwiGLURows(torch.autograd.Function):
    """:func:`swiglu`, its backward :func:`swiglu_bwd`."""

    @staticmethod
    def forward(ctx, gu, offs):
        ctx.save_for_backward(gu, offs)
        return swiglu(gu, offs)

    @staticmethod
    def backward(ctx, dh):
        gu, offs = ctx.saved_tensors
        return swiglu_bwd(dh.contiguous(), gu, offs), None
