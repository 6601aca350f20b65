"""Masked-LM losses in PyTorch (counterpart of ``vlp_tpu/losses.py``).

* ``mlm_position_loss`` — per-position cross entropy, optionally label
  smoothed as the reference's KL(q_smoothed || p) with smoothing mass
  ``ls / (V - 2)`` and ignore index 0 (reference ``loss.py:12-48``).
* ``mlm_position_loss_vocab_parallel`` — the same on logits whose vocab
  is sharded over a tensor-parallel group (the GSPMD layout), from the
  reductions of a sharded log-sum-exp (``ops/tp.py``).
* ``mask_and_normalize_loss`` — weighted reduction with drop-worst
  filtering (reference ``modeling.py:1083-1093``), per rank or, as JAX's
  GSPMD step computes it, over a data-parallel group's global batch.
* ``scst_reward_loss`` — the SCST policy-gradient loss (reference
  ``scst_utils.py:66-78``).
"""

from __future__ import annotations

from typing import Optional

import torch

from vlp_tpu_torch.ops import tp as tp_ops


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
    return _smoothed(tgt_logp, logp[..., ignore_index], logp.sum(dim=-1),
                     targets, label_smoothing, vocab_size, ignore_index)


def _smoothed(tgt_logp, ign_logp, sum_logp, targets, label_smoothing: float,
              vocab_size: int, ignore_index: int) -> torch.Tensor:
    """KL(q_smoothed || p) per position from the target's, the ignore
    index's and the sum of the log-probabilities."""
    ls = float(label_smoothing)
    smooth = ls / (vocab_size - 2)
    confidence = 1.0 - ls
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


def mlm_position_loss_vocab_parallel(logits: torch.Tensor,
                                     targets: torch.Tensor,
                                     label_smoothing: float,
                                     vocab_size: int, tp: tp_ops.TP,
                                     ignore_index: int = 0) -> torch.Tensor:
    """:func:`mlm_position_loss` on logits whose vocab is sharded over
    ``tp``'s group: ``logits`` [B, P, V / tp] are this rank's, vocab ids
    ``tp.index * V / tp ..``; every rank gets the per-position loss of the
    full logits, bit for bit the same on every rank.

    The log-sum-exp is the group's max (detached) plus the log of the
    group's sum of exp; the target's logit and the ignore index's come
    from the rank that holds them, and the sum of the log-probabilities
    is the sum of the logits less V times the log-sum-exp.  The four
    sums are one :func:`ops.tp.sum_in_rank_order`, so they carry the
    same bits on every rank, as the drop-worst selection and the
    replicated parameters need."""
    z = logits.float()
    n = z.shape[-1]
    lo = tp.index * n
    m = tp_ops.max_over_group(z.amax(dim=-1), tp)

    def held(ids):
        """z at vocab ids ``ids`` where this rank holds them, else 0."""
        local = ids - lo
        inside = (local >= 0) & (local < n)
        v = torch.gather(z, -1, torch.where(
            inside, local, torch.zeros_like(local))[..., None])[..., 0]
        return torch.where(inside, v, torch.zeros_like(v))

    targets = targets.long()
    parts = [torch.exp(z - m[..., None]).sum(dim=-1), held(targets)]
    smoothing = label_smoothing and label_smoothing > 0.0
    if smoothing:
        parts += [held(torch.full_like(targets, ignore_index)),
                  z.sum(dim=-1)]
    sums = tp_ops.sum_in_rank_order(torch.stack(parts), tp)
    lse = m + torch.log(sums[0])
    tgt_logp = sums[1] - lse
    if not smoothing:
        return -tgt_logp
    return _smoothed(tgt_logp, sums[2] - lse, sums[3] - vocab_size * lse,
                     targets, label_smoothing, vocab_size, ignore_index)


def mask_and_normalize_loss(loss: torch.Tensor, weights: torch.Tensor,
                            drop_worst_ratio: float,
                            group: Optional[tp_ops.TP] = None
                            ) -> torch.Tensor:
    """loss, weights: [B, P].  Keeps the ``floor(B * (1 - ratio))``
    examples with the smallest per-example loss sums and normalises by the
    kept examples' total mask weight + 1e-5.

    ``group`` (a data-parallel group of two or more, each rank holding
    ``B`` rows of one global batch, in rank order): the selection and the
    weight run over the global batch, as JAX's GSPMD step computes the
    loss of its global batch, and the result is this rank's share of the
    global loss times the group's size, so that the mean over the group
    (of the loss and of its gradients) is the global loss's."""
    w = weights.to(loss.dtype)
    loss = loss * w
    per_ex = loss.sum(dim=-1)                                   # [B]
    if group is None or not group.active:
        keep = _keep_best(per_ex, drop_worst_ratio).to(loss.dtype)
        denom = (w.sum(dim=-1) * keep).sum() + 1e-5
        return (per_ex * keep).sum() / denom
    B = per_ex.shape[0]
    # [size, 2, B]: every rank's per-example losses and weights, exact
    every = tp_ops.gather_dim(torch.stack([per_ex.detach(),
                                           w.sum(dim=-1)])[None], 0, group)
    keep = _keep_best(every[:, 0].reshape(-1),
                      drop_worst_ratio).to(loss.dtype)
    denom = (every[:, 1].reshape(-1) * keep).sum() + 1e-5
    mine = keep[group.index * B:(group.index + 1) * B]
    return group.size * (per_ex * mine).sum() / denom


def _keep_best(per_ex: torch.Tensor, drop_worst_ratio: float
               ) -> torch.Tensor:
    """Bool [B]: the ``floor(B * (1 - ratio))`` smallest entries (ties in
    index order)."""
    B = per_ex.shape[0]
    # in fp32, as the JAX package computes it (B * (1 - 0.1) rounds to 9
    # in fp32 but floors to 8 in float64)
    ratio = torch.tensor(drop_worst_ratio, dtype=torch.float32)
    k = int(torch.floor(B * (1.0 - ratio)))
    order = torch.argsort(per_ex, stable=True)                  # ascending
    rank = torch.empty_like(order)
    rank[order] = torch.arange(B, device=order.device)
    return rank < k


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
