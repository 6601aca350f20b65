"""Masked-LM losses in PyTorch (counterpart of ``vlp_tpu/losses.py``).

* ``mlm_position_loss`` — per-position cross entropy, optionally label
  smoothed as the reference's KL(q_smoothed || p) with smoothing mass
  ``ls / (V - 2)`` and ignore index 0 (reference ``loss.py:12-48``).
* ``mask_and_normalize_loss`` — weighted reduction with drop-worst
  filtering (reference ``modeling.py:1083-1093``).
* ``scst_reward_loss`` — the SCST policy-gradient loss (reference
  ``scst_utils.py:66-78``).
"""

from __future__ import annotations

import torch


def mlm_position_loss(logits: torch.Tensor, targets: torch.Tensor,
                      label_smoothing: float, vocab_size: int,
                      ignore_index: int = 0) -> torch.Tensor:
    """Per-position masked-LM loss [B, P] (reduction='none').

    logits: fp32 [B, P, V]; targets: int [B, P].  With smoothing, positions
    whose target is ``ignore_index`` get exactly 0 loss."""
    logp = torch.log_softmax(logits.float(), dim=-1)
    tgt_logp = torch.gather(logp, -1, targets.long()[..., None])[..., 0]
    if not label_smoothing or label_smoothing <= 0.0:
        return -tgt_logp
    ls = float(label_smoothing)
    smooth = ls / (vocab_size - 2)
    confidence = 1.0 - ls
    ign_logp = logp[..., ignore_index]
    sum_logp = logp.sum(dim=-1)
    # sum_v q_v (log q_v - log p_v): the cross term, then q's entropy term
    # (constant per non-ignored position; 0 log 0 := 0)
    cross = -(smooth * (sum_logp - tgt_logp - ign_logp)
              + confidence * tgt_logp)
    f32 = lambda x: torch.tensor(x, dtype=torch.float32)  # noqa: E731
    ent = (confidence * torch.log(f32(max(confidence, 1e-20)))
           + (vocab_size - 2) * smooth * torch.log(f32(max(smooth, 1e-20))))
    # a 0-d CPU tensor: the add takes it as a scalar, with no host copy
    loss = cross + ent
    return torch.where(targets == ignore_index, torch.zeros_like(loss), loss)


def mask_and_normalize_loss(loss: torch.Tensor, weights: torch.Tensor,
                            drop_worst_ratio: float) -> torch.Tensor:
    """loss, weights: [B, P].  Keeps the ``floor(B * (1 - ratio))``
    examples with the smallest per-example loss sums and normalises by the
    kept examples' total mask weight + 1e-5."""
    w = weights.to(loss.dtype)
    loss = loss * w
    per_ex = loss.sum(dim=-1)                                   # [B]
    B = per_ex.shape[0]
    # in fp32, as the JAX package computes it (B * (1 - 0.1) rounds to 9
    # in fp32 but floors to 8 in float64)
    ratio = torch.tensor(drop_worst_ratio, dtype=torch.float32)
    k = int(torch.floor(B * (1.0 - ratio)))
    order = torch.argsort(per_ex, stable=True)                  # ascending
    rank = torch.empty_like(order)
    rank[order] = torch.arange(B, device=order.device)
    keep = (rank < k).to(loss.dtype)
    denom = (w.sum(dim=-1) * keep).sum() + 1e-5
    return (per_ex * keep).sum() / denom


def scst_reward_loss(sample_logprobs: torch.Tensor, gen_result: torch.Tensor,
                     reward: torch.Tensor) -> torch.Tensor:
    """Policy-gradient SCST loss.  sample_logprobs, reward: [B, T];
    gen_result: int [B, T] sampled ids.  The mask is ``(seq > 0)`` shifted
    right by one behind a leading 1, so the first EOS step is still
    rewarded."""
    mask = (gen_result > 0).float()
    mask = torch.cat([torch.ones_like(mask[:, :1]), mask[:, :-1]], dim=1)
    out = -sample_logprobs.float() * reward.float() * mask
    return out.sum() / mask.sum()
