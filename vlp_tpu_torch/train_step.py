"""One training step on PyTorch (counterpart of
``vlp_tpu/parallel/train_step.py``): forward + backward + BertAdam, on one
device, with optional gradient accumulation over micro-batches.

PyTorch runs eagerly, so where the JAX package returns a new train state,
the step here updates the model's parameters and the optimizer's moments in
place.  The dropout of a step follows from one 64-bit seed
(:func:`step_seed` of the run seed, epoch and step), so a resumed run takes
the same draws as an uninterrupted one.

With a :class:`~vlp_tpu_torch.optim.DynamicLossScale` (``--true_fp16``)
the step scales the loss before the backward, unscales the fp32 gradients
once (after the last micro-batch), and on a non-finite gradient skips the
update of the parameters, BertAdam's moments and its schedule step and
halves the scale, as JAX ``_apply_grads`` does; the decision stays on the
device.
"""

from __future__ import annotations

from typing import Callable, Dict, Optional

import torch

from vlp_tpu_torch.config import VLPConfig
from vlp_tpu_torch.models.model import DropoutRNG, VLPModel
from vlp_tpu_torch.ops.philox import step_seed
from vlp_tpu_torch.optim import BertAdam, DynamicLossScale


def dummy_batch(cfg: VLPConfig, batch_size: int, device="cpu",
                task: str = "img2txt") -> Dict[str, torch.Tensor]:
    """An all-zero batch of the training shapes; ``task="vqa2"`` adds the
    answer scores ``ans_scores`` [B, num_answers]."""
    B, L, nv = batch_size, cfg.seq_len, cfg.len_vis_input

    def z(*shape, dtype=torch.int32):
        return torch.zeros(shape, dtype=dtype, device=device)

    b = dict(
        input_ids=z(B, L), segment_ids=z(B, L),
        mode=torch.ones((B,), dtype=torch.int32, device=device),
        text_end=torch.full((B,), cfg.prefix_len + 5, dtype=torch.int32,
                            device=device),
        vis_keep=torch.ones((B, nv), device=device),
        vis_masked_pos=torch.ones((B, max(nv // 4, 1)), dtype=torch.int32,
                                  device=device),
        masked_pos=z(B, cfg.max_pred), masked_ids=z(B, cfg.max_pred),
        masked_weights=z(B, cfg.max_pred, dtype=torch.float32),
        task_idx=torch.full((B,), 3, dtype=torch.int32, device=device),
        vis_feats=z(B, nv, cfg.vis_feat_dim, dtype=torch.float32),
        vis_pe=z(B, nv, cfg.vis_pe_dim, dtype=torch.float32),
    )
    if task == "vqa2":
        b["ans_scores"] = z(B, cfg.num_answers, dtype=torch.float32)
    return b


def loss_fn(model: VLPModel, batch, seed: int, *, drop_worst_ratio: float,
            mask_image_regions: bool, task: str = "img2txt"):
    """(loss, metrics) of one training forward whose dropout follows from
    ``seed``."""
    drop = DropoutRNG(seed, batch["input_ids"].device)
    out = model.pretrain_losses(batch, drop=drop,
                                drop_worst_ratio=drop_worst_ratio,
                                mask_image_regions=mask_image_regions,
                                task=task)
    return out["loss"], out


def grads_with_accum(model: VLPModel, batch, seed: int, *,
                     drop_worst_ratio: float, mask_image_regions: bool,
                     task: str = "img2txt", grad_accum: int = 1,
                     scale: Optional[torch.Tensor] = None
                     ) -> Dict[str, torch.Tensor]:
    """Leave the step's gradients in the parameters' ``.grad``: averaged
    over ``grad_accum`` micro-batches (the batch's leading dim is
    ``grad_accum * micro_batch``), with drop-worst per micro-batch, as the
    reference normalises loss / accum (run_img2txt_dist.py:566-575).
    ``scale`` (a loss scale) multiplies each loss before its backward, so
    the gradients left are scaled; the metrics are not.  Returns the
    metrics, averaged over the micro-batches (detached)."""
    for p in model.parameters():
        p.grad = None

    def backward(loss):
        (loss if scale is None else loss * scale).backward()

    if grad_accum <= 1:
        _, metrics = loss_fn(model, batch, seed,
                             drop_worst_ratio=drop_worst_ratio,
                             mask_image_regions=mask_image_regions, task=task)
        backward(metrics["loss"])
        return {k: v.detach() for k, v in metrics.items()}
    B = batch["input_ids"].shape[0]
    if B % grad_accum:
        raise ValueError(f"batch {B} does not split into {grad_accum} "
                         "micro-batches")
    mb = B // grad_accum
    sums: Dict[str, torch.Tensor] = {}
    for i in range(grad_accum):
        micro = {k: v[i * mb:(i + 1) * mb] for k, v in batch.items()}
        _, metrics = loss_fn(model, micro, step_seed(seed, i),
                             drop_worst_ratio=drop_worst_ratio,
                             mask_image_regions=mask_image_regions, task=task)
        backward(metrics["loss"])
        for k, v in metrics.items():
            sums[k] = sums.get(k, 0.0) + v.detach()
    with torch.no_grad():
        for p in model.parameters():
            if p.grad is not None:
                p.grad.div_(grad_accum)
    return {k: v / grad_accum for k, v in sums.items()}


def attach_loss_scale(optimizer: BertAdam,
                      loss_scale: Optional[DynamicLossScale]) -> None:
    """Put ``loss_scale.init()`` on the optimizer, on its parameters'
    device: the one place a run's scale state is made (the step builders
    call it; a resume then restores the saved state over it)."""
    if loss_scale is not None and optimizer.loss_scale is None:
        dev = next(iter(optimizer.params.values())).device
        optimizer.loss_scale = loss_scale.init(dev)


def loss_scale_of(optimizer: BertAdam,
                  loss_scale: Optional[DynamicLossScale]
                  ) -> Optional[torch.Tensor]:
    """The scale this step multiplies its loss by (None without loss
    scaling)."""
    return None if loss_scale is None else optimizer.loss_scale["scale"]


def apply_grads(optimizer: BertAdam, loss_scale: Optional[DynamicLossScale],
                metrics: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """The optimizer step on the gradients in ``.grad`` (JAX
    ``_apply_grads``).  With ``loss_scale``: unscale them, step only if
    every one is finite (``BertAdam.step(finite=...)``), update the scale
    on the optimizer, and add ``loss_scale`` (the new scale) and
    ``skipped_step`` (1.0 on an overflow) to the metrics."""
    if loss_scale is None:
        optimizer.step()
        return metrics
    state = optimizer.loss_scale
    params = {n: p for n, p in optimizer.params.items() if p.grad is not None}
    grads, finite = loss_scale.unscale_and_check(
        {n: p.grad for n, p in params.items()}, state)
    for n, p in params.items():
        p.grad = grads[n]
    optimizer.step(finite=finite)
    optimizer.loss_scale = loss_scale.update(state, finite)
    return dict(metrics, loss_scale=optimizer.loss_scale["scale"],
                skipped_step=1.0 - finite.float())


def make_train_step(model: VLPModel, optimizer: BertAdam, *,
                    mask_image_regions: bool = False, task: str = "img2txt",
                    grad_accum: int = 1,
                    loss_scale: Optional[DynamicLossScale] = None
                    ) -> Callable:
    """Returns ``train_step(batch, seed, drop_worst_ratio) -> metrics``,
    which updates ``model`` and ``optimizer`` in place; ``loss_scale``
    switches on the loss-scaled update (:func:`apply_grads`)."""
    attach_loss_scale(optimizer, loss_scale)

    def train_step(batch, seed: int, drop_worst_ratio: float = 0.0):
        model.train()
        metrics = grads_with_accum(model, batch, seed,
                                   drop_worst_ratio=drop_worst_ratio,
                                   mask_image_regions=mask_image_regions,
                                   task=task, grad_accum=grad_accum,
                                   scale=loss_scale_of(optimizer, loss_scale))
        return apply_grads(optimizer, loss_scale, metrics)

    return train_step
