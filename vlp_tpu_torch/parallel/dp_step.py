"""The data-parallel train step (counterpart of
``vlp_tpu/parallel/pjit_step.py:make_shard_map_step``, data axis only),
and its K-step device loop (``make_shard_map_multi_step``).

Each rank runs ``train_step.grads_with_accum`` on its own slice of the
global batch (drop-worst per rank, as JAX does per shard), then one mean
all-reduce of the gradients and one of the metrics, then the optimizer
step: the gradients are reduced once per optimizer step, as the JAX step
``pmean``s once after its accumulation.  With a loss scale the reduced
(scaled) gradients are unscaled and checked after the all-reduce, so an
overflow on any rank reaches every rank and all of them skip the step.  A rank's dropout seed is
``Dist.rank_seed``, so a world of one is the single-card step bit for bit.
"""

from __future__ import annotations

from typing import Callable, Optional

from vlp_tpu_torch import train_step as ts
from vlp_tpu_torch.models.model import VLPModel
from vlp_tpu_torch.optim import BertAdam, DynamicLossScale
from vlp_tpu_torch.parallel.dist import Dist


def make_dp_train_step(model: VLPModel, optimizer: BertAdam, dist: Dist, *,
                       mask_image_regions: bool = False,
                       task: str = "img2txt", grad_accum: int = 1,
                       loss_scale: Optional[DynamicLossScale] = None
                       ) -> Callable:
    """Returns ``train_step(batch, seed, drop_worst_ratio) -> metrics`` over
    this rank's ``batch`` (its leading dim ``grad_accum * micro_batch``);
    the metrics are the means over the ranks."""
    return ts.make_train_step(
        model, optimizer, mask_image_regions=mask_image_regions, task=task,
        grad_accum=grad_accum, loss_scale=loss_scale, dist=dist)


def make_dp_multi_step(model: VLPModel, optimizer: BertAdam, dist: Dist, *,
                       K: int, mask_image_regions: bool = False,
                       task: str = "img2txt", grad_accum: int = 1,
                       loss_scale: Optional[DynamicLossScale] = None
                       ) -> Callable:
    """K data-parallel steps per call (``train_step.make_multi_step`` with
    the all-reduce inside each step): on ``cuda`` one CUDA graph holding
    the bucketed NCCL all-reduces.  The agreement on which parameters have
    a gradient (a host sync, fixed for a task) is checked once, before the
    capture, and not inside the graph.  On ``cuda`` a group must be
    NCCL's: gloo's collectives run on the host and cannot be
    captured (gloo on the CPU runs the K steps eagerly); the reductions
    are not timed inside a graph (``Dist.time_reductions`` raises)."""
    captured = dist.device.type == "cuda"
    if captured and dist.grouped and dist.backend != "nccl":
        raise ValueError(f"--device_loop_steps {K} on cuda captures the "
                         "gradient all-reduce in a CUDA graph, which needs "
                         f"an NCCL group, not {dist.backend}")
    if captured and dist.time_reductions:
        raise ValueError("the all-reduce of a captured group cannot be "
                         "timed: unset Dist.time_reductions")
    return ts.make_multi_step(
        model, optimizer, K=K, mask_image_regions=mask_image_regions,
        task=task, grad_accum=grad_accum, loss_scale=loss_scale, dist=dist)
