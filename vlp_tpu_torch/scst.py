"""Self-critical sequence training on PyTorch (counterpart of
``vlp_tpu/scst.py``, the fused replay only).

One step, as the reference SCST branch (run_img2txt_dist.py:486-523 and
scst_utils.py):
  1. a greedy rollout without dropout (the baseline) and a multinomial
     sampled rollout with dropout on, both without autograd;
  2. the reward CIDEr(sample) - CIDEr(greedy) per example on the host,
     broadcast over the timesteps;
  3. the teacher-forced replay of the RAW sampled ids under autograd: the
     prefill again, then every caption row in ONE dual-block pass
     (``VLPModel.scst_replay_hidden``) and one batched ``lm_logits`` -- the
     sample's log-probs with a gradient path to the parameters (REINFORCE
     treats the sampled ids as constants, so forcing is exact);
  4. the policy-gradient loss ``losses.scst_reward_loss``, backward and
     BertAdam.

Raw vs cleaned ids: the reference pairs the log-probs of the RAW sampling
pass with the CLEANED sequence's mask ``[1, (seq > 0)[:, :-1]]``, so the
position right after a terminating EOS is still unmasked and its log-prob is
that of the raw continuation token the policy sampled there, not of the pad
the cleanup wrote.  The replay therefore forces the raw ids while the loss
masks with the cleaned ones (JAX ``scst.py:19-29``).

Dropout: the sampled rollout and the replay take one
:class:`~vlp_tpu_torch.models.model.ExplicitDropout` per step, so the replay
applies exactly the masks the rollout drew (K5's attention multipliers come
back through K6) and its log-probs equal the rollout's.

Data parallelism (``dist``, one process per GPU; the JAX trainer's
``mesh``): each rank rolls out and replays its own slice of the global
batch, its sampling generator and dropout seeded with ``step_seed(seed,
rank)``.  The CIDEr reward is scored once over the global batch: its
document frequencies come from the references it is given, so the ranks
all-gather the cleaned greedy and sampled ids and the ground truth (small
int arrays), score the whole batch, and each takes its own rows, as the
JAX mesh path scores the gathered rollouts.  The gradients and the loss are
mean-all-reduced before the optimizer step.

The JAX package's ``replay="scan"`` and ``remat`` are under ROADMAP A "Not
to port"; the trainer raises on them.  ``clean_rollout``, ``array_to_str``
and ``get_self_critical_reward`` are rewritten here because the JAX module
imports JAX.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from vlp_tpu_torch import losses as losses_lib
from vlp_tpu_torch.config import VLPConfig
from vlp_tpu_torch.decode import DecodeParams, Decoder
from vlp_tpu_torch.evals.cider import CiderScorer
from vlp_tpu_torch.models.model import ExplicitDropout, VLPModel
from vlp_tpu_torch.ops.philox import step_seed
from vlp_tpu_torch.optim import BertAdam
from vlp_tpu_torch.parallel.dist import Dist


def clean_rollout(ids: np.ndarray, eos_id: int, pad_id: int) -> np.ndarray:
    """Zero everything after the first EOS/PAD, keeping a terminating EOS
    (run_img2txt_dist.py:497-515 semantics, vectorised)."""
    ids = np.asarray(ids)
    B, T = ids.shape
    term = (ids == eos_id) | (ids == pad_id)
    first = np.where(term.any(axis=1), term.argmax(axis=1), T)
    out = np.where(np.arange(T)[None, :] < first[:, None], ids, 0)
    # a row whose first terminator is EOS keeps that EOS
    keeps_eos = (first < T) & (ids[np.arange(B), np.minimum(first, T - 1)]
                               == eos_id)
    out[keeps_eos, first[keeps_eos]] = eos_id
    return out


def array_to_str(arr) -> str:
    """Token ids as a string, stopping after the first 0
    (scst_utils.py:27-33)."""
    out = []
    for x in arr:
        out.append(str(int(x)))
        if int(x) == 0:
            break
    return " ".join(out)


def get_self_critical_reward(greedy_res: np.ndarray, gt_ids: np.ndarray,
                             gen_result: np.ndarray) -> np.ndarray:
    """CIDEr(sample) - CIDEr(greedy) broadcast over timesteps
    (scst_utils.py:36-63); fp32 [B, T]."""
    B, T = np.asarray(gen_result).shape
    res = {i: [array_to_str(gen_result[i])] for i in range(B)}
    res.update({B + i: [array_to_str(greedy_res[i])] for i in range(B)})
    gts = {i: [array_to_str(gt_ids[i])] for i in range(B)}
    gts.update({B + i: [array_to_str(gt_ids[i])] for i in range(B)})
    _, scores = CiderScorer().compute_score(gts, res)
    scores = np.asarray(scores)
    rewards = scores[:B] - scores[B:]
    return np.repeat(rewards[:, None], T, axis=1).astype(np.float32)


def global_reward(greedy_res: np.ndarray, gt_ids: np.ndarray,
                  gen_result: np.ndarray, dist: Optional[Dist] = None
                  ) -> Tuple[np.ndarray, float]:
    """This rank's rows of ``get_self_critical_reward`` scored over every
    rank's rollouts (the global batch, in rank order), and the global mean
    reward."""
    if dist is None or not dist.grouped:
        reward = get_self_critical_reward(greedy_res, gt_ids, gen_result)
        return reward, float(reward[:, 0].mean())
    parts = dist.all_gather_objects((np.asarray(greedy_res),
                                     np.asarray(gt_ids),
                                     np.asarray(gen_result)))
    reward = get_self_critical_reward(
        *(np.concatenate([p[i] for p in parts]) for i in range(3)))
    lo = sum(len(p[0]) for p in parts[:dist.rank])
    return (reward[lo:lo + len(greedy_res)], float(reward[:, 0].mean()))


class SCSTTrainer:
    """SCST loss, gradients and (with ``optimizer``) the update for one
    batch of decode-shaped tensors on the model's device.  The randomness of
    a step follows from one 64-bit ``seed``: the sampling generator and the
    dropout contract are derived from it.  With ``dist`` the batch is this
    rank's slice of the global batch (module docstring)."""

    def __init__(self, model: VLPModel, cfg: VLPConfig, *, mask_id: int,
                 eos_id: int, pad_id: int = 0, max_tgt_length: int = 20,
                 optimizer: Optional[BertAdam] = None, replay: str = "fused",
                 remat: bool = False, dist: Optional[Dist] = None):
        if replay != "fused":
            raise NotImplementedError(
                f"replay={replay!r}: the scan replay is under ROADMAP A "
                "'Not to port'; the port has the fused replay (A9)")
        if remat:
            raise NotImplementedError(
                "remat: rematerialising the scan replay is under ROADMAP A "
                "'Not to port'; the fused replay (A9) has no scan body")
        if max_tgt_length < 2:
            raise ValueError("the fused replay needs max_tgt_length >= 2")
        self.model = model
        self.cfg = cfg
        self.eos_id = eos_id
        self.pad_id = pad_id
        self.optimizer = optimizer
        self.dist = dist or Dist()
        self.dp = DecodeParams(mask_id=mask_id, eos_id=eos_id, pad_id=pad_id,
                               max_tgt_length=max_tgt_length)
        self.decoder = Decoder(model, cfg, self.dp)

    def dropout(self, seed: int, device) -> ExplicitDropout:
        """The step's explicit-dropout contract; the rollout and the replay
        each build it from the same ``seed``."""
        return ExplicitDropout(step_seed(seed, 1), self.cfg, device)

    def rollouts(self, batch, seed: int):
        """Greedy baseline without dropout, then the sample with dropout on
        (run_img2txt_dist.py:494-507).  Returns ``(greedy_clean,
        sample_clean, sample_raw)`` as int64 numpy [B, T] and the sampling
        pass's own log-probs (fp32 [B, T] on the device): the cleaned pair
        feeds the reward and the loss mask, the raw sample is what the
        replay forces."""
        dev = batch["input_ids"].device
        greedy_ids, _ = self.decoder.greedy(batch)
        gen = torch.Generator(device=dev)
        gen.manual_seed(step_seed(seed, 0))
        raw, logprobs = self.decoder.sample(batch, gen,
                                            self.dropout(seed, dev))
        raw = raw.cpu().numpy()
        greedy = clean_rollout(greedy_ids.cpu().numpy(), self.eos_id,
                               self.pad_id)
        return (greedy, clean_rollout(raw, self.eos_id, self.pad_id), raw,
                logprobs)

    def forced_logprobs(self, batch, forced_ids: torch.Tensor,
                        drop: Optional[ExplicitDropout] = None
                        ) -> torch.Tensor:
        """Log-probs fp32 [B, T] of ``forced_ids`` (int64 [B, T]) through
        the prefill and the dual-block replay, differentiable (JAX
        ``_forced_logprobs_fused``, scst.py:307).  With the rollout's
        ``drop`` they equal the sampling pass's log-probs."""
        m = self.model
        mask_id = self.dp.mask_id
        hidden0, pk, pv = m.prefill(
            batch["input_ids"], batch["segment_ids"], batch["position_ids"],
            batch["vis_feats"], batch["vis_pe"], mask_id,
            None if drop is None else drop.prefill_rng())
        hid = m.scst_replay_hidden(forced_ids, batch["segment_ids"],
                                   batch["position_ids"], pk, pv, mask_id,
                                   drop)
        logits = m.lm_logits(torch.cat([hidden0, hid], dim=1),
                             batch["task_idx"])
        logp = torch.log_softmax(logits, dim=-1)
        return torch.gather(logp, -1, forced_ids.long()[..., None])[..., 0]

    def pg_loss(self, batch, gen_raw: torch.Tensor, gen_clean: torch.Tensor,
                reward: torch.Tensor,
                drop: Optional[ExplicitDropout] = None) -> torch.Tensor:
        """The policy-gradient loss: the RAW rollout's replayed log-probs,
        the CLEANED rollout's mask (JAX ``_pg_loss``, scst.py:335)."""
        return losses_lib.scst_reward_loss(
            self.forced_logprobs(batch, gen_raw, drop), gen_clean, reward)

    def loss_and_grads(self, batch, gt_ids: np.ndarray, seed: int
                       ) -> Tuple[torch.Tensor, Dict[str, float]]:
        """Rollouts, reward and the replay's backward; leaves the gradients
        (mean over the ranks) in the parameters' ``.grad``.  ``gt_ids`` are
        the ground-truth caption ids [B, T+1] (everything after the prompt,
        the final [SEP] included).  Returns (loss, metrics)."""
        seed = self.dist.rank_seed(seed)
        greedy, sample, raw, _ = self.rollouts(batch, seed)
        reward, mean_reward = global_reward(greedy, gt_ids, sample,
                                            self.dist)
        loss = self.replay_grads(batch, raw, sample, reward, seed)
        return loss, {"scst_loss": loss, "mean_reward": mean_reward}

    def replay_grads(self, batch, raw: np.ndarray, sample: np.ndarray,
                     reward: np.ndarray, seed: int) -> torch.Tensor:
        """The policy-gradient loss of given rollouts (raw and cleaned ids,
        reward, numpy [B, T]) under ``seed``'s dropout, its backward, and
        the mean over the ranks of the gradients and the loss."""
        dev = batch["input_ids"].device
        for p in self.model.parameters():
            p.grad = None
        loss = self.pg_loss(batch, torch.from_numpy(raw).to(dev),
                            torch.from_numpy(sample).to(dev),
                            torch.from_numpy(reward).to(dev),
                            self.dropout(seed, dev))
        loss.backward()
        self.dist.all_reduce_grads(self.model.parameters())
        return self.dist.all_reduce_mean({"loss": loss.detach()})["loss"]

    def step(self, batch, gt_ids: np.ndarray, seed: int
             ) -> Tuple[float, Dict[str, float]]:
        """One full SCST update: rollouts -> host CIDEr reward -> replay
        backward -> BertAdam.  Returns (loss, metrics)."""
        if self.optimizer is None:
            raise ValueError("SCSTTrainer.step needs an optimizer")
        loss, metrics = self.loss_and_grads(batch, gt_ids, seed)
        self.optimizer.step()
        return float(loss), metrics
