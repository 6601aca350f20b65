"""The tensor-parallel train steps: data parallel over ``dist``'s
data-parallel groups, tensor parallel within each of its tensor-parallel
groups, under either layout of ``parallel/mesh.py``.

* ``"shard_map"``: the counterpart of ``vlp_tpu/parallel/pjit_step.py``'s
  ``make_shard_map_step`` and ``make_shard_map_multi_step`` with
  ``tensor_parallel=True``.
* ``"gspmd"``: the counterpart of ``make_pjit_train_step(...,
  tensor_parallel=True)``, the whole step jitted over a ``data x model``
  mesh with the GSPMD layout, where XLA inserts the collectives.  Here the
  model inserts them where GSPMD would (``VLPModel.shard_``): the
  vocab-parallel embedding lookup, the all-gather before the MLM head's
  LayerNorm, the vocab-parallel loss, the region and answer heads' f/g,
  and the masked-LM loss normalised over the data-parallel group's global
  batch.  K1 (dropout) and K2 run on each rank's heads, where the JAX
  CLI runs XLA attention (GSPMD cannot partition a Mosaic call).  It has
  no K-step form, as in the JAX package.

The model holds this rank's shard (``VLPModel.shard_``) and inserts the
collectives itself (``ops/tp.py``), so every gradient is exact without a
collective over the tensor-parallel group: a sharded parameter's gradient
is its shard of the full gradient, a replicated one's is full and the
same on every rank of the group.  The gradients and the metrics are
mean-all-reduced over the data-parallel group only
(``Dist.all_reduce_grads``), and BertAdam's clip sums the squared norms of
the sharded parameters over the tensor-parallel group
(``BertAdam(clip_group=...)``), so it sees whole-parameter norms, as JAX's
global arrays do under GSPMD.  The ranks of a tensor-parallel group take
the same batch and the same dropout seed (``Dist.rank_seed`` folds the
data-parallel index); the attention kernels' seeds fold the
tensor-parallel index (``DropoutRNG``), hidden dropout does not.

On ``cuda`` the K-step form captures the f/g all-reduces inside the CUDA
graph, which needs an NCCL group (``dp_step.make_dp_multi_step``).
"""

from __future__ import annotations

from typing import Callable

from vlp_tpu_torch.models.model import VLPModel
from vlp_tpu_torch.optim import BertAdam
from vlp_tpu_torch.parallel import mesh
from vlp_tpu_torch.parallel.dist import Dist
from vlp_tpu_torch.parallel.dp_step import (make_dp_multi_step,
                                            make_dp_train_step)


def sharded_names(model: VLPModel):
    """The names of the model's parameters that its tensor-parallel layout
    shards (``BertAdam(clip_sharded=...)``; ``model.tp_specs``)."""
    return [n for n, _ in model.named_parameters()
            if model.tp_specs.get(n) is not None]


def _check_tp_args(model: VLPModel, optimizer: BertAdam, dist: Dist) -> None:
    """JAX ``_check_tp_args``, as ValueErrors."""
    if dist.tp < 2:
        raise ValueError("a tensor-parallel step needs a Dist with tp > 1 "
                         "(Dist.with_tensor_parallel)")
    tp = model.tp
    if tp is None or tp.size != dist.tp or tp.index != dist.tp_index:
        raise ValueError("shard the step model to this rank first "
                         "(model.shard_(dist.tensor_parallel)) so that it "
                         "inserts the f/g collectives")
    if (optimizer.clip_group is not dist.tp_group
            or set(optimizer.clip_sharded) != set(sharded_names(model))):
        raise ValueError("build the optimizer with clip_group=dist.tp_group "
                         "and clip_sharded=sharded_names(model), so that "
                         "BertAdam's per-parameter clip sees whole-parameter "
                         "norms")


def make_tp_train_step(model: VLPModel, optimizer: BertAdam, dist: Dist,
                       **kw) -> Callable:
    """``train_step(batch, seed, drop_worst_ratio) -> metrics`` over this
    rank's shard and its data-parallel share of the batch (``kw``: those
    of ``dp_step.make_dp_train_step``, without ``loss_scale``), under the
    model's layout (JAX ``make_shard_map_step`` or
    ``make_pjit_train_step``, whose masked-LM loss is normalised over
    the data-parallel group's global batch: ``model.loss_group``)."""
    _check_tp_args(model, optimizer, dist)
    model.loss_group = (dist.data_parallel if model.tp_layout == "gspmd"
                        else None)
    return make_dp_train_step(model, optimizer, dist, **kw)


def make_tp_multi_step(model: VLPModel, optimizer: BertAdam, dist: Dist, *,
                       K: int, **kw) -> Callable:
    """K tensor-parallel steps per call (``dp_step.make_dp_multi_step``):
    eager on the CPU, one CUDA graph over an NCCL group on ``cuda``.  The
    shard_map layout only: the JAX package's GSPMD step has no K-step
    form (its CLI coerces ``--device_loop_steps`` to 1)."""
    _check_tp_args(model, optimizer, dist)
    if model.tp_layout == "gspmd":
        raise ValueError("the GSPMD tensor-parallel step has no K-step "
                         "form: step one batch at a time")
    return make_dp_multi_step(model, optimizer, dist, K=K, **kw)
