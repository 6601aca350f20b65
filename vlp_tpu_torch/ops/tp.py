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


def _all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    out = x.contiguous().clone()
    tdist.all_reduce(out, group=group)
    return out


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
