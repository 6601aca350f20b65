"""Caption generation: greedy, sampled and beam search decoding over the
split KV cache (counterpart of ``vlp_tpu/decode.py``).

* The prompt ``[CLS] regions [SEP]`` is encoded once (``VLPModel.prefill``)
  and its K/V cached per example — never beam-expanded, never reordered.
* Each step feeds [prev_token, [MASK] probe] and predicts at the probe; the
  S = 2 new tokens' K/V go to a small per-beam generated cache of G slots.
* Beams reorder only through an ancestry map (the JAX package's
  ``reorder_impl="fused"``): ``anc[bk, j]`` names the in-example beam row
  whose cache holds beam bk's lineage at slot j, and the decode kernel turns
  it into an additive bias.  So the generated caches are written in place
  by the kernel and never gathered; only the small int map is permuted.
* Sampling (the SCST rollout) draws from the fp32 softmax with
  ``torch.multinomial`` and an explicit ``torch.Generator``; with an
  :class:`~vlp_tpu_torch.models.model.ExplicitDropout` it runs with dropout
  on (K1 dropout in the prefill, K5 in the steps).
* A Python loop takes the place of ``lax.scan``; ``torch.topk`` is exact, so
  the TPU top-k workarounds (``topk_impl="blocks"``, ``approx_topk``) have no
  counterpart.  The back-trace (modeling.py:1436-1472) runs on the host.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from vlp_tpu_torch import tracing
from vlp_tpu_torch.config import VLPConfig
from vlp_tpu_torch.host_copy import fetch, fetched
from vlp_tpu_torch.models.model import ExplicitDropout, VLPModel

NEG = -10000.0


@dataclasses.dataclass(frozen=True)
class DecodeParams:
    mask_id: int = 103
    eos_id: int = 102
    pad_id: int = 0
    beam_size: int = 1
    length_penalty: float = 0.0
    forbid_duplicate_ngrams: bool = False
    ngram_size: int = 3
    min_len: int = 0
    max_tgt_length: int = 20
    # ids the duplicate-ngram forbid logic ignores
    forbid_ignore_ids: Tuple[int, ...] = ()


def _expand_beams(x: torch.Tensor, K: int) -> torch.Tensor:
    """[B, ...] -> [B*K, ...], each row repeated K times."""
    return torch.repeat_interleave(x, K, dim=0)


class Decoder:
    """Greedy / beam caption decoder bound to a model (weights live in the
    model; batches are dicts of tensors on the model's device)."""

    def __init__(self, model: VLPModel, cfg: VLPConfig, dp: DecodeParams):
        self.model = model
        self.cfg = cfg
        self.dp = dp

    # -- shared primitives -------------------------------------------------
    def _prefill(self, batch, drop=None):
        return self.model.prefill(batch["input_ids"], batch["segment_ids"],
                                  batch["position_ids"], batch["vis_feats"],
                                  batch["vis_pe"], self.dp.mask_id, drop)

    def _init_gen_cache(self, rows: int, device
                        ) -> Tuple[List[torch.Tensor], List[torch.Tensor]]:
        """Per-layer generated-token K/V caches [rows, G, H*D]."""
        cfg = self.cfg
        G = VLPModel.gen_cache_slots(self.dp.max_tgt_length)
        shape = (rows, G, cfg.hidden_size)
        n = cfg.num_hidden_layers

        def zeros():
            return torch.zeros(shape, dtype=self.model.dtype, device=device)

        return [zeros() for _ in range(n)], [zeros() for _ in range(n)]

    def _logits(self, hidden, task_idx) -> torch.Tensor:
        return self.model.lm_logits(hidden, task_idx)[:, 0, :]  # [B, V]

    # -- greedy / sample ---------------------------------------------------
    def _rollout(self, batch, choose, drop: Optional[ExplicitDropout]
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
        dp = self.dp
        B = batch["input_ids"].shape[0]
        hidden, pk, pv = self._prefill(
            batch, None if drop is None else drop.prefill_rng())
        gk, gv = self._init_gen_cache(B, hidden.device)

        def select(logits):
            logp = torch.log_softmax(logits, dim=-1)
            ids = choose(logits)
            return ids, torch.gather(logp, 1, ids[:, None])[:, 0]

        ids, lp = select(self._logits(hidden, batch["task_idx"]))
        all_ids, all_lp = [ids], [lp]
        for t in range(dp.max_tgt_length - 1):
            hidden = self.model.decode_step(
                ids[:, None], batch["segment_ids"], batch["position_ids"],
                pk, pv, gk, gv, t, dp.mask_id, drop=drop)
            ids, lp = select(self._logits(hidden, batch["task_idx"]))
            all_ids.append(ids)
            all_lp.append(lp)
        return torch.stack(all_ids, dim=1), torch.stack(all_lp, dim=1)

    @torch.no_grad()
    def greedy(self, batch) -> Tuple[torch.Tensor, torch.Tensor]:
        """Returns (ids int64 [B, T], log-probs fp32 [B, T])."""
        return self._rollout(batch, lambda lg: torch.argmax(lg, dim=-1), None)

    @torch.no_grad()
    def sample(self, batch, generator: torch.Generator,
               drop: Optional[ExplicitDropout] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Multinomial sampling from the fp32 softmax of each step's logits
        (JAX ``_run_greedy(sample=True)``), the draws from ``generator``
        (on the model's device).  ``drop`` runs the rollout in train mode
        under the SCST explicit-dropout contract (JAX ``train_mode`` with
        ``explicit_dropout``).  Returns (ids int64 [B, T], the rollout's
        log-probs fp32 [B, T])."""
        def choose(logits):
            return torch.multinomial(torch.softmax(logits, dim=-1), 1,
                                     generator=generator)[:, 0]
        return self._rollout(batch, choose, drop)

    # -- beam search -------------------------------------------------------
    def _forbidden_candidates(self, seqs: torch.Tensor, t: int, V: int
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Duplicate-ngram forbid set as (candidate ids, flags) [B*K, W].

        seqs: int64 [T, B*K] committed tokens, time-major (rows > t are
        stale).  Token ``seqs[i+n-1, b]`` is forbidden iff window i matches
        the current tail seqs[t-n+2 : t+1], with the reference's ignore-set
        exemptions (modeling.py:1391-1406)."""
        dp = self.dp
        n = dp.ngram_size
        T, BK = seqs.shape
        W = T - n + 1
        # the JAX dynamic slice clamps its start into range
        start = min(max(t - (n - 2), 0), T - (n - 1))
        tail = seqs[start:start + n - 1]
        ignore = torch.zeros(V, dtype=torch.bool, device=seqs.device)
        for tok in dp.forbid_ignore_ids:
            ignore[tok] = True
        tail_has_ignore = ignore[tail].any(dim=0)                  # [BK]
        eq = torch.ones((W, BK), dtype=torch.bool, device=seqs.device)
        for j in range(n - 1):
            eq = eq & (seqs[j:j + W] == tail[j:j + 1])
        win = torch.arange(W, device=seqs.device)[:, None]
        valid = win + (n - 1) <= t
        cand = seqs[n - 1:n - 1 + W]
        flag = eq & valid & ~ignore[cand] & ~tail_has_ignore[None, :]
        return cand.t(), flag.t()

    def _candidate_topk(self, logits: torch.Tensor, seqs: torch.Tensor,
                        t: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """Exact top-K of the masked log-probs: at most W = T-n+1 tokens per
        row are ngram-forbidden and one more (EOS) min-len-suppressed, so the
        masked top-K lies inside the unmasked top-(K+W+1)."""
        dp = self.dp
        K = dp.beam_size
        V = logits.shape[-1]
        m = logits.amax(dim=-1)
        lse = m + torch.log(torch.exp(logits - m[:, None]).sum(dim=-1))
        C = K
        if dp.forbid_duplicate_ngrams:
            C += seqs.shape[0] - dp.ngram_size + 1
        if dp.min_len:
            C += 1
        C = min(C, V)
        topv, topi = torch.topk(logits, C, dim=-1)
        vals = topv - lse[:, None]
        if dp.forbid_duplicate_ngrams and t >= dp.ngram_size:
            cand, flag = self._forbidden_candidates(seqs, t - 1, V)
            hit = ((topi[:, :, None] == cand[:, None, :])
                   & flag[:, None, :]).any(dim=-1)
            vals = vals + hit * NEG
        if dp.min_len and t + 1 <= dp.min_len:
            vals = torch.where(topi == dp.eos_id,
                               torch.full_like(vals, NEG), vals)
        kk_scores, idx = torch.topk(vals, K, dim=-1)
        return kk_scores, torch.gather(topi, 1, idx)

    @torch.no_grad()
    def beam_trace(self, batch) -> Tuple[torch.Tensor, ...]:
        """The beam loop; returns (step_ids, step_ptrs, step_scores), each
        [T, B, K], on the device.  The prompt's encoding and first logits
        are the span ``decode.prefill``, each step's decode and logits
        ``decode.model``; the rest is the beam bookkeeping."""
        cfg, dp = self.cfg, self.dp
        K = dp.beam_size
        B = batch["input_ids"].shape[0]
        T = dp.max_tgt_length
        G = VLPModel.gen_cache_slots(T)

        with tracing.span("decode.prefill"):
            hidden, pk, pv = self._prefill(batch)
            logits = self._logits(hidden, batch["task_idx"])
        dev = hidden.device
        logp0 = torch.log_softmax(logits, dim=-1)
        if dp.min_len and 1 <= dp.min_len:
            logp0[:, dp.eos_id] = NEG
        k_scores, k_ids = torch.topk(logp0, K, dim=-1)              # [B, K]

        # only the generated-token caches live at beam granularity
        gk, gv = self._init_gen_cache(B * K, dev)
        seg = _expand_beams(batch["segment_ids"], K)
        pos = _expand_beams(batch["position_ids"], K)
        task_idx = _expand_beams(batch["task_idx"], K)

        seqs = torch.zeros((T, B * K), dtype=torch.int64, device=dev)
        seqs[0] = k_ids.reshape(-1)
        own = torch.arange(B * K, device=dev) % K                   # [BK]
        anc = own[:, None].expand(B * K, G).clone()
        beams = torch.arange(K, device=dev)[None, :, None]
        base = torch.arange(B, device=dev)[:, None] * K
        eos = (k_ids == dp.eos_id).float()
        ids_r, ptrs_r, scores_r = [k_ids], [torch.zeros_like(k_ids)], \
            [k_scores]
        for t in range(1, T):
            # slots t-1 (committed previous token) and t (probe) are
            # written to each beam's own row this step
            anc[:, t - 1:t + 1] = own[:, None]
            abias = torch.full((B * K, K, G), NEG, device=dev)
            abias = abias.masked_fill(anc[:, None, :] == beams, 0.0)
            with tracing.span("decode.model"):
                hidden = self.model.decode_step(
                    k_ids.reshape(-1, 1), seg, pos, pk, pv, gk, gv, t - 1,
                    dp.mask_id, beam_bias=abias.reshape(B * K, K * G))
                logits = self._logits(hidden, task_idx)
            kk_scores, kk_ids = self._candidate_topk(logits, seqs, t)
            kk_scores = (kk_scores + eos.reshape(-1, 1) * NEG
                         + k_scores.reshape(-1, 1))
            k_scores, k_idx = torch.topk(kk_scores.reshape(B, K * K), K,
                                         dim=-1)
            back_ptrs = torch.div(k_idx, K, rounding_mode="floor")
            k_ids = torch.gather(kk_ids.reshape(B, K * K), 1, k_idx)
            flat = (base + back_ptrs).reshape(-1)
            anc = anc[flat]
            seqs = seqs[:, flat]
            seqs[t] = k_ids.reshape(-1)
            eos = (k_ids == dp.eos_id).float()
            ids_r.append(k_ids)
            ptrs_r.append(back_ptrs)
            scores_r.append(k_scores)
        return (torch.stack(ids_r), torch.stack(ptrs_r),
                torch.stack(scores_r))

    def beam_dispatch(self, batch):
        """Queue the beam loop and its trace's copy to the host, and return
        at once, with no host sync (JAX ``beam_dispatch``): a caller
        dispatches batch N+1 before it collects batch N, so the host's
        back-trace overlaps the device.  The copy waits only for the work
        queued before it, where a ``.cpu()`` at collect would also wait
        for whatever was queued since.  Pair with :meth:`beam_collect`.
        The span ``decode.dispatch`` (n: the batch's rows)."""
        with tracing.span("decode.dispatch", batch["input_ids"].shape[0]):
            ids, ptrs, scores = self.beam_trace(batch)
            return fetch(dict(ids=ids, ptrs=ptrs, scores=scores))

    def beam_collect(self, handle) -> Dict[str, np.ndarray]:
        """Wait for a :meth:`beam_dispatch` trace on the host and run the
        back-trace (the span ``decode.backtrace``)."""
        t = fetched(handle)
        with tracing.span("decode.backtrace"):
            return self._backtrace(t["ids"], t["ptrs"], t["scores"])

    def beam_search(self, batch) -> Dict[str, np.ndarray]:
        return self.beam_collect(self.beam_dispatch(batch))

    def _backtrace(self, step_ids, step_ptrs, step_scores
                   ) -> Dict[str, np.ndarray]:
        """Host-side trace reconstruction (modeling.py:1436-1472)."""
        dp = self.dp
        T, B, K = step_ids.shape
        pred = np.zeros((B, T), np.int64)
        for b in range(B):
            wids = step_ids[:, b, :]
            ptrs = step_ptrs[:, b, :]
            scores = step_scores[:, b, :]
            last_frame = T - 1
            for t in range(T):
                if (wids[t] == dp.eos_id).all():
                    last_frame = t
                    break
            best, frame_id, pos = -np.inf, -1, -1
            for fid in range(last_frame + 1):
                for i in range(K):
                    if wids[fid, i] == dp.eos_id or fid == last_frame:
                        s = scores[fid, i] + dp.length_penalty * (fid + 1)
                        if s > best:
                            best, frame_id, pos = s, fid, i
            if frame_id == -1:
                pred[b, 0] = 0
                continue
            seq = [wids[frame_id, pos]]
            for fid in range(frame_id, 0, -1):
                pos = ptrs[fid, pos]
                seq.append(wids[fid - 1, pos])
            seq.reverse()
            pred[b, :len(seq)] = seq
        return {"pred_seq": pred, "wids": step_ids.transpose(1, 0, 2),
                "ptrs": step_ptrs.transpose(1, 0, 2),
                "scores": step_scores.transpose(1, 0, 2)}

    # -- unified entry -----------------------------------------------------
    def __call__(self, batch):
        if self.dp.beam_size > 1:
            return self.beam_search(batch)
        return self.greedy(batch)
