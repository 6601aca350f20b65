"""The data-parallel train step (counterpart of
``vlp_tpu/parallel/pjit_step.py:make_shard_map_step``, data axis only).

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
    ts.attach_loss_scale(optimizer, loss_scale)

    def train_step(batch, seed: int, drop_worst_ratio: float = 0.0):
        model.train()
        metrics = ts.grads_with_accum(
            model, batch, dist.rank_seed(seed),
            drop_worst_ratio=drop_worst_ratio,
            mask_image_regions=mask_image_regions, task=task,
            grad_accum=grad_accum,
            scale=ts.loss_scale_of(optimizer, loss_scale))
        dist.all_reduce_grads(model.parameters())
        metrics = dist.all_reduce_mean(metrics)
        return ts.apply_grads(optimizer, loss_scale, metrics)

    return train_step
