"""Manual tensor-parallel collectives: the Megatron "f" and "g" operators
(arXiv:1909.08053 §3) over a tensor-parallel process group (counterpart of
``vlp_tpu/ops/tp.py``, whose ``custom_vjp`` pair runs under shard_map).

* :func:`replicate_for_branch` (f): identity forward, sum all-reduce of
  the gradient backward.  It wraps a replicated activation where it enters
  column-parallel branches (q/k/v projections, the FFN's first dense): each
  rank's backward sees only the gradient through its own columns, and the
  sum restores the full gradient, so every parameter upstream gets the
  same full gradient on every rank.
* :func:`sum_partial` (g): sum all-reduce forward, identity backward.  It
  wraps the partial product of a row-parallel matmul (attention output,
  the FFN's second dense) before its bias is added once.

With f and g placed so, no gradient needs a collective over the
tensor-parallel group afterwards: a sharded parameter's gradient is exactly
its shard of the full gradient, a replicated one's is full.  BertAdam's
per-parameter clip still needs the full parameter's norm
(``optim.BertAdam(clip_group=...)``).

The GSPMD layout (``parallel/mesh.py``, ``--tp_impl gspmd``) shards the
embedding tables' vocab and the heads too, and needs three more
collectives, each the identity without a group of two or more:

* :func:`vocab_parallel_rows` looks up the ids in this rank's rows and
  writes zero for the others; the model sums such partial lookups under
  one g (a vocab-parallel embedding lookup is :func:`sum_partial` of it);
* :func:`gather_last` (an all-gather of the last dim, in rank order)
  joins column-parallel outputs that a replicated op (the MLM head's
  LayerNorm over r·H) needs whole; its backward takes this rank's slice,
  since every rank computes the same thing downstream;
* the reductions of a sharded log-sum-exp (``losses.
  mlm_position_loss_vocab_parallel``): :func:`max_over_group` (a max,
  detached) and :func:`sum_in_rank_order` (g whose sum runs in rank order
  on every rank, so that every rank gets the same bits whatever order
  the backend's all-reduce adds in; identity backward).

Every collective of the model's forward and backward goes through
:func:`_all_reduce_`, one in-place all-reduce.

A :class:`TP` names this rank's place in its tensor-parallel group.  With
no group, or a group of one, both operators are the identity both ways, so
a model without tensor parallelism runs exactly what it ran before.

The premise of f and g is that every rank of a group computes its
replicated values alike.  PyTorch's CUDA embedding backward does not: it
sums the rows of repeated ids in an order that can change from run to run
(the token-type table's gradient, 8,192 rows onto 6, differed between the
two ranks of one card in one step of three), so the replicated tables
would drift apart.  :func:`broadcast_from_first` puts the group's first
rank's gradients on every rank (the train step does so for the embedding
tables, ``VLPModel.align_replicated_grads``).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch
import torch.distributed as tdist
import torch.nn.functional as F


@dataclasses.dataclass(frozen=True)
class TP:
    """This rank's index in its tensor-parallel group of ``size`` ranks;
    ``group`` is the ``torch.distributed`` group (None: no collective)."""
    index: int = 0
    size: int = 1
    group: Any = None

    @property
    def active(self) -> bool:
        return self.size > 1


def _all_reduce_(t: torch.Tensor, group, op=tdist.ReduceOp.SUM
                 ) -> torch.Tensor:
    """All-reduce ``t`` in place over ``group``; returns it."""
    tdist.all_reduce(t, op=op, group=group)
    return t


def _all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    return _all_reduce_(x.contiguous().clone(), group)


def gather_dim(x: torch.Tensor, dim: int, tp: TP) -> torch.Tensor:
    """Every rank's ``x`` joined along ``dim`` in rank order: this rank's
    placed at its offset in a zero tensor and sum-all-reduced (an
    all-gather that every backend takes for CUDA tensors, exact: each
    entry has one addend that is not zero).  No autograd."""
    shape = list(x.shape)
    n = shape[dim]
    shape[dim] = n * tp.size
    full = torch.zeros(shape, dtype=x.dtype, device=x.device)
    full.narrow(dim, tp.index * n, n).copy_(x)
    return _all_reduce_(full, tp.group)


class _F(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _all_reduce(g, ctx.group), None


class _G(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, g):
        return g, None


def replicate_for_branch(x: torch.Tensor, tp: Optional[TP]) -> torch.Tensor:
    """Megatron "f": identity forward, sum all-reduce of the gradient over
    ``tp``'s group backward (the identity without a group of two or
    more)."""
    if tp is None or not tp.active:
        return x
    return _F.apply(x, tp.group)


def broadcast_from_first(tensors, tp: Optional[TP]) -> None:
    """The group's first rank's ``tensors`` on every rank of ``tp``'s
    group, in place (nothing without a group of two or more)."""
    if tp is None or not tp.active:
        return
    src = 0 if tp.group is None else tdist.get_global_rank(tp.group, 0)
    for t in tensors:
        tdist.broadcast(t, src=src, group=tp.group)


def sum_partial(x: torch.Tensor, tp: Optional[TP]) -> torch.Tensor:
    """Megatron "g": sum all-reduce over ``tp``'s group forward, identity
    backward (the identity without a group of two or more)."""
    if tp is None or not tp.active:
        return x
    return _G.apply(x, tp.group)


class _GatherLast(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp, ctx.n = tp, x.shape[-1]
        return gather_dim(x, x.dim() - 1, tp)

    @staticmethod
    def backward(ctx, g):
        return g.narrow(-1, ctx.tp.index * ctx.n, ctx.n), None


class _SumInRankOrder(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        parts = gather_dim(x[None], 0, tp)
        out = parts[0].clone()
        for part in parts[1:]:
            out += part
        return out

    @staticmethod
    def backward(ctx, g):
        return g, None


def gather_last(x: torch.Tensor, tp: Optional[TP]) -> torch.Tensor:
    """Every rank's ``x`` joined along the last dim in rank order; the
    gradient is this rank's slice of the joined one (every rank computes
    the same thing from the joined tensor).  The identity without a group
    of two or more."""
    if tp is None or not tp.active:
        return x
    return _GatherLast.apply(x, tp)


def sum_in_rank_order(x: torch.Tensor, tp: Optional[TP]) -> torch.Tensor:
    """g with a fixed order: the sum over ``tp``'s group of ``x``, added
    in rank order from an all-gather, so every rank gets the same bits;
    identity backward.  For small statistics (an all-gather moves tp
    times the bytes of a sum)."""
    if tp is None or not tp.active:
        return x
    return _SumInRankOrder.apply(x, tp)


def max_over_group(x: torch.Tensor, tp: Optional[TP]) -> torch.Tensor:
    """The elementwise max over ``tp``'s group of ``x``, detached (exact,
    so the same on every rank)."""
    x = x.detach()
    if tp is None or not tp.active:
        return x
    return _all_reduce_(x.contiguous().clone(), tp.group,
                        tdist.ReduceOp.MAX)


def vocab_parallel_rows(ids: torch.Tensor, weight: torch.Tensor,
                        tp: TP) -> torch.Tensor:
    """This rank's part of an embedding lookup whose table rows are
    sharded over ``tp``'s group (``weight``: this rank's rows, ids
    ``tp.index * n ..``): the rows of the ids it holds, zero for the
    others.  The sum of every rank's part is the lookup."""
    n = weight.shape[0]
    local = ids.long() - tp.index * n
    inside = (local >= 0) & (local < n)
    rows = F.embedding(torch.where(inside, local, torch.zeros_like(local)),
                       weight)
    return rows.masked_fill(~inside[..., None], 0.0)
