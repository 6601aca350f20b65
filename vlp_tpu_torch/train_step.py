"""One training step on PyTorch (counterpart of
``vlp_tpu/parallel/train_step.py``): forward + backward + BertAdam, on one
device, with optional gradient accumulation over micro-batches.

PyTorch runs eagerly, so where the JAX package returns a new train state,
the step here updates the model's parameters and the optimizer's moments in
place.  The dropout of a step follows from one 64-bit seed
(:func:`step_seed` of the run seed, epoch and step), so a resumed run takes
the same draws as an uninterrupted one.
"""

from __future__ import annotations

from typing import Callable, Dict

import torch

from vlp_tpu_torch.config import VLPConfig
from vlp_tpu_torch.models.model import DropoutRNG, VLPModel
from vlp_tpu_torch.optim import BertAdam

MASK64 = (1 << 64) - 1


def _splitmix64(x: int) -> int:
    x = (x + 0x9E3779B97F4A7C15) & MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & MASK64
    return x ^ (x >> 31)


def step_seed(seed: int, *path: int) -> int:
    """A 64-bit seed derived from ``seed`` and the integers ``path`` (the
    counterpart of ``jax.random.fold_in``)."""
    x = _splitmix64(seed & MASK64)
    for p in path:
        x = _splitmix64(x ^ (p & MASK64))
    return x


def dummy_batch(cfg: VLPConfig, batch_size: int,
                device="cpu") -> Dict[str, torch.Tensor]:
    """An all-zero caption batch of the training shapes."""
    B, L, nv = batch_size, cfg.seq_len, cfg.len_vis_input

    def z(*shape, dtype=torch.int32):
        return torch.zeros(shape, dtype=dtype, device=device)

    return dict(
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
                     task: str = "img2txt", grad_accum: int = 1
                     ) -> Dict[str, torch.Tensor]:
    """Leave the step's gradients in the parameters' ``.grad``: averaged
    over ``grad_accum`` micro-batches (the batch's leading dim is
    ``grad_accum * micro_batch``), with drop-worst per micro-batch, as the
    reference normalises loss / accum (run_img2txt_dist.py:566-575).
    Returns the metrics, averaged over the micro-batches (detached)."""
    for p in model.parameters():
        p.grad = None
    if grad_accum <= 1:
        _, metrics = loss_fn(model, batch, seed,
                             drop_worst_ratio=drop_worst_ratio,
                             mask_image_regions=mask_image_regions, task=task)
        metrics["loss"].backward()
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
        metrics["loss"].backward()
        for k, v in metrics.items():
            sums[k] = sums.get(k, 0.0) + v.detach()
    with torch.no_grad():
        for p in model.parameters():
            if p.grad is not None:
                p.grad.div_(grad_accum)
    return {k: v / grad_accum for k, v in sums.items()}


def make_train_step(model: VLPModel, optimizer: BertAdam, *,
                    mask_image_regions: bool = False, task: str = "img2txt",
                    grad_accum: int = 1) -> Callable:
    """Returns ``train_step(batch, seed, drop_worst_ratio) -> metrics``,
    which updates ``model`` and ``optimizer`` in place."""

    def train_step(batch, seed: int, drop_worst_ratio: float = 0.0):
        model.train()
        metrics = grads_with_accum(model, batch, seed,
                                   drop_worst_ratio=drop_worst_ratio,
                                   mask_image_regions=mask_image_regions,
                                   task=task, grad_accum=grad_accum)
        optimizer.step()
        return metrics

    return train_step
