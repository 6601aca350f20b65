"""The unified VLP transformer in PyTorch: the training forward with its
losses, and the inference primitives (counterpart of
``vlp_tpu/models/model.py``).

Submodules carry the reference state-dict names
(``bert.encoder.layer.{i}.attention.self.query``,
``cls.predictions.transform.dense``, ``vis_embed.0`` ...; see
``vlp_tpu/checkpoint.py:_torch_to_flax_map``), so a reference ``.bin``
loads with ``load_state_dict`` after the shared ``apply_surgery``.

Precision policy, as in the JAX package: parameters fp32, activations in
``cfg.dtype`` (bf16 on the card; fp16 under ``--true_fp16``), every
LayerNorm (eps 1e-5) and GELU (erf) in fp32 with the result cast back
(``cfg.hidden_act`` relu and swish run in the activation dtype, as JAX's
``ACT`` table does), attention softmax in fp32, and the tied
MLM vocab product accumulated and returned in fp32.  Dense layers and
embedding tables are used in the activation dtype, cast per call, so that
gradients reach the fp32 parameters; :meth:`VLPModel.cast_for_inference`
stores them cast once for decoding, which gives the same values.

Attention goes through ``ops.attention.attention`` (prefill, encode),
``ops.attention.FusedAttention`` (the training forward and backward, and
the prefill of an SCST rollout and replay) and
``ops.decode_attention.decode_attention`` (decode steps, with dropout in
SCST sampled rollouts): the CUDA kernels for CUDA tensors, their plain
versions for CPU tensors.  The SCST teacher-forced replay
(:meth:`VLPModel.scst_replay_hidden`) is plain PyTorch with autograd, as in
the JAX package it is XLA einsums.

Dropout follows the JAX package's sites: embeddings, region projections,
attention probabilities, attention output and FFN output.  A training
forward takes a :class:`DropoutRNG`; without one the forward is
deterministic.  An SCST step takes an :class:`ExplicitDropout`, the
contract under which the sampled rollout and its one-pass replay draw the
same masks.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from vlp_tpu_torch import losses as losses_lib
from vlp_tpu_torch import torch_dtype
from vlp_tpu_torch.config import MODE_S2S, VLPConfig
from vlp_tpu_torch.ops import attention as attn_ops
from vlp_tpu_torch.ops import decode_attention as decode_attn_ops
from vlp_tpu_torch.ops.masks import NEG_INF
from vlp_tpu_torch.ops.philox import step_seed

LN_EPS = 1e-5


def _draw64(gen: torch.Generator) -> int:
    """The next 64-bit seed of a host generator."""
    lo, hi = torch.randint(0, 2 ** 32, (2,), generator=gen).tolist()
    return lo | (hi << 32)


class DropoutRNG:
    """The randomness of one training forward (the JAX package's
    ``dropout`` rng stream).

    Attention-prob dropout takes one 64-bit Philox seed per attention call
    (per layer), hidden dropout draws its keep masks from a
    ``torch.Generator`` on the model's device (plain PyTorch; the JAX
    package leaves it to XLA).  Both follow from ``seed`` alone, in one of
    two forms that draw the same bits:

    * ``DropoutRNG(seed, device)``, the eager form: the seeds are drawn on
      the host from a CPU generator, so they reach the kernels without a
      device sync, and the hidden generator is seeded with the first draw;
    * :meth:`from_slots`, the form a captured CUDA graph runs (the
      counterpart of JAX's ``fold_in(rng, i)`` inside the device loop's
      scan): the attention seeds are read from device slots and hidden
      dropout draws from a generator registered with the graph, which the
      caller writes and seeds from :meth:`plan` before each replay."""

    def __init__(self, seed: int, device):
        self._host = torch.Generator().manual_seed(seed)
        self._slots = None
        self._device = torch.Generator(device=torch.device(device))
        self._device.manual_seed(_draw64(self._host))

    @classmethod
    def from_slots(cls, slots: torch.Tensor,
                   generator: torch.Generator) -> "DropoutRNG":
        """Attention seeds from ``slots`` (1-d int64 on the device, one slot
        per attention call in call order, each holding its seed's bits),
        hidden dropout from ``generator``.  With the slots and the
        generator set from ``plan(seed, len(slots))`` it draws bit for bit
        what ``DropoutRNG(seed, device)`` draws."""
        self = cls.__new__(cls)
        self._host = None
        self._slots, self._next = slots, 0
        self._device = generator
        return self

    @staticmethod
    def plan(seed: int, n_slots: int) -> Tuple[int, List[int]]:
        """(the hidden generator's seed, the first ``n_slots`` attention
        seeds) that ``DropoutRNG(seed, device)`` draws."""
        host = torch.Generator().manual_seed(seed)
        draws = [_draw64(host) for _ in range(1 + n_slots)]
        return draws[0], draws[1:]

    def seed(self):
        """The next attention call's seed: a fresh 64-bit int, or (from
        slots) the next slot, a 0-d int64 device tensor."""
        if self._slots is None:
            return _draw64(self._host)
        if self._next >= self._slots.shape[0]:
            raise RuntimeError(f"the forward made more attention calls than "
                               f"its {self._slots.shape[0]} seed slots")
        self._next += 1
        return self._slots[self._next - 1]

    def hidden(self, x: torch.Tensor, rate: float) -> torch.Tensor:
        """flax ``nn.Dropout``: keep with probability 1 - rate, kept
        entries scaled by 1 / (1 - rate)."""
        if rate == 0.0:
            return x
        keep = torch.rand(x.shape, generator=self._device,
                          device=x.device) < 1.0 - rate
        return masked_dropout(x, keep, rate)


def masked_dropout(x: torch.Tensor, keep: Optional[torch.Tensor],
                   rate: float) -> torch.Tensor:
    """Dropout with a given keep mask, flax's scaling (JAX
    ``masked_dropout``); identity at rate 0."""
    if rate == 0.0 or keep is None:
        return x
    return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


def _hidden_dropout(drop: Optional[DropoutRNG], x: torch.Tensor,
                    rate: float) -> torch.Tensor:
    return x if drop is None else drop.hidden(x, rate)


class ExplicitDropout:
    """The explicit-dropout contract of one SCST step (JAX
    ``explicit_dropout`` / ``masked_dropout``, model.py:57-93, and
    ``_scst_replay_drop`` :969): the sampled rollout draws its dropout from
    here step by step, and the teacher-forced replay re-draws exactly the
    same masks in its own (row, column) coordinates.  Everything follows
    from ``seed``:

    * the prefill: a :class:`DropoutRNG` of its own seed, fresh at each
      call, so the replay's prefill draws what the rollout's drew (the JAX
      replay re-runs the prefill with the rollout's rngs);
    * attention probabilities of decode step t in layer l: one 64-bit
      Philox seed, :meth:`attn_seed` -- K5 applies it in the rollout, K6
      (``decode_dropout_scales``) regenerates it for the replay;
    * hidden dropout of decode step t: keep masks ``[1 + 2L, B, 2, H]``
      for the embeddings (JAX fold 0) and each layer's attention output and
      FFN output (folds 1 and 2), :meth:`hidden_keep`, drawn by one
      ``torch.rand`` from a device generator seeded per step.
    """

    def __init__(self, seed: int, cfg: VLPConfig, device):
        self.seed = seed
        self.cfg = cfg
        self.device = torch.device(device)

    def prefill_rng(self) -> DropoutRNG:
        return DropoutRNG(step_seed(self.seed, 0), self.device)

    def attn_seed(self, t: int, layer: int) -> Optional[int]:
        """K5's seed in decode step t, layer ``layer`` (None at rate 0)."""
        if self.cfg.attention_probs_dropout_prob == 0.0:
            return None
        return step_seed(self.seed, 1, t, layer)

    def hidden_keep(self, t: int, B: int) -> Optional[torch.Tensor]:
        """bool ``[1 + 2L, B, 2, H]`` keep masks of decode step t: index 0
        the embeddings, 1 + 2l and 2 + 2l layer l's attention output and
        FFN output (None at rate 0)."""
        cfg = self.cfg
        rate = cfg.hidden_dropout_prob
        if rate == 0.0:
            return None
        gen = torch.Generator(device=self.device)
        gen.manual_seed(step_seed(self.seed, 2, t))
        shape = (1 + 2 * cfg.num_hidden_layers, B, 2, cfg.hidden_size)
        return torch.rand(shape, generator=gen, device=self.device) < 1 - rate


def gelu_exact(x: torch.Tensor) -> torch.Tensor:
    """erf-based gelu in fp32, cast back (model.py:gelu_exact)."""
    xf = x.float()
    return (xf * 0.5 * (1.0 + torch.erf(xf / math.sqrt(2.0)))).to(x.dtype)


# cfg.hidden_act -> the activation of every FFN and of the MLM head's
# transform (JAX model.py:53-54; a reference bert_config.json sets it)
ACT = {"gelu": gelu_exact, "relu": F.relu,
       "swish": lambda x: x * torch.sigmoid(x)}


def _linear(lin: nn.Linear, x: torch.Tensor) -> torch.Tensor:
    """Dense in the activation dtype (flax ``Dense(dtype=...)``)."""
    return F.linear(x, lin.weight.to(x.dtype), lin.bias.to(x.dtype))


def _layer_norm(ln: nn.LayerNorm, x: torch.Tensor) -> torch.Tensor:
    """fp32 LayerNorm regardless of the activation dtype; returns fp32."""
    return F.layer_norm(x.float(), ln.normalized_shape, ln.weight, ln.bias,
                        ln.eps)


class Embeddings(nn.Module):
    """Word + position + type embeddings with the region splice."""

    def __init__(self, cfg: VLPConfig):
        super().__init__()
        self.cfg = cfg
        H = cfg.hidden_size
        self.word_embeddings = nn.Embedding(cfg.vocab_size, H)
        self.position_embeddings = nn.Embedding(cfg.max_position_embeddings, H)
        self.token_type_embeddings = nn.Embedding(cfg.type_vocab_size, H)
        self.LayerNorm = nn.LayerNorm(H, eps=LN_EPS)

    def forward(self, input_ids, segment_ids, position_ids, vis_feats,
                vis_pe, dtype: torch.dtype,
                drop: Optional[DropoutRNG] = None) -> torch.Tensor:
        words = F.embedding(input_ids.long(),
                            self.word_embeddings.weight.to(dtype))
        pos = F.embedding(position_ids.long(),
                          self.position_embeddings.weight.to(dtype))
        if vis_feats is not None:
            nv = self.cfg.len_vis_input
            # projected region features / geometry take slots 1..nv
            words = torch.cat([words[:, :1], vis_feats.to(dtype),
                               words[:, nv + 1:]], dim=1)
            pos = torch.cat([pos[:, :1], vis_pe.to(dtype), pos[:, nv + 1:]],
                            dim=1)
        types = F.embedding(segment_ids.long(),
                            self.token_type_embeddings.weight.to(dtype))
        x = words + pos + types
        x = _layer_norm(self.LayerNorm, x).to(dtype)
        return _hidden_dropout(drop, x, self.cfg.hidden_dropout_prob)


class _SelfAttention(nn.Module):
    def __init__(self, H: int):
        super().__init__()
        self.query = nn.Linear(H, H)
        self.key = nn.Linear(H, H)
        self.value = nn.Linear(H, H)


class _DenseLN(nn.Module):
    def __init__(self, d_in: int, d_out: int):
        super().__init__()
        self.dense = nn.Linear(d_in, d_out)
        self.LayerNorm = nn.LayerNorm(d_out, eps=LN_EPS)


class _Attention(nn.Module):
    def __init__(self, H: int):
        super().__init__()
        self.self = _SelfAttention(H)
        self.output = _DenseLN(H, H)


class _Dense(nn.Module):
    def __init__(self, d_in: int, d_out: int):
        super().__init__()
        self.dense = nn.Linear(d_in, d_out)


class TransformerLayer(nn.Module):
    """Post-LN BERT block (``bert.encoder.layer.{i}``)."""

    def __init__(self, cfg: VLPConfig):
        super().__init__()
        self.cfg = cfg
        H = cfg.hidden_size
        self.attention = _Attention(H)
        self.intermediate = _Dense(H, cfg.intermediate_size)
        self.output = _DenseLN(cfg.intermediate_size, H)
        self.act = ACT[cfg.hidden_act]

    def _qkv(self, x):
        sa = self.attention.self
        return _linear(sa.query, x), _linear(sa.key, x), _linear(sa.value, x)

    def _post_attention(self, ctx: torch.Tensor, residual: torch.Tensor,
                        drop: Optional[DropoutRNG] = None,
                        masks=None) -> torch.Tensor:
        """Output projection + FFN, each followed by (hidden dropout and)
        residual + fp32 LN.  Hidden dropout draws from ``drop``, or takes
        the pre-drawn keep masks ``masks`` = (attention output, FFN
        output) of an SCST step."""
        rate = self.cfg.hidden_dropout_prob

        def hdrop(y, i):
            if masks is not None:
                return masked_dropout(y, masks[i], rate)
            return _hidden_dropout(drop, y, rate)

        ao = self.attention.output
        h = hdrop(_linear(ao.dense, ctx), 0)
        h = _layer_norm(ao.LayerNorm, h + residual).to(ctx.dtype)
        f = hdrop(_linear(self.output.dense,
                          self.act(_linear(self.intermediate.dense, h))), 1)
        return _layer_norm(self.output.LayerNorm, f + h).to(ctx.dtype)

    def forward(self, x, mode, text_end, colkeep,
                drop: Optional[DropoutRNG] = None) -> torch.Tensor:
        """Full-sequence attention.  Without ``drop``: the deterministic
        encode (no backward on the card).  With ``drop``: the training
        forward through ``FusedAttention`` (attention-prob dropout at
        ``attention_probs_dropout_prob``, which may be 0), differentiable
        on every device."""
        B, L, HD = x.shape
        hd = (self.cfg.num_attention_heads, self.cfg.head_dim)
        q, k, v = (t.view(B, L, *hd) for t in self._qkv(x))
        prefix = self.cfg.prefix_len
        if drop is None:
            ctx = attn_ops.attention(q, k, v, mode, text_end, colkeep,
                                     prefix=prefix)
        else:
            ctx = attn_ops.FusedAttention.apply(
                q, k, v, mode, text_end, colkeep, prefix,
                self.cfg.attention_probs_dropout_prob, drop.seed())
        return self._post_attention(ctx.reshape(B, L, HD), x, drop)

    def prefill_attend(self, x: torch.Tensor, prefix: int,
                       drop: Optional[DropoutRNG] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Prompt-window attention: ``x`` is [B, P+1, H] (prompt + [MASK]
        probe).  The decode-time visibility is the s2s mask with
        ``text_end = L``.  Returns (layer_out, k[:, :P], v[:, :P]) — the
        caches are views of the projections (batch stride (P+1)*H*D); the
        decode kernel takes that stride, nothing is copied.  With ``drop``
        (an SCST rollout or replay) dropout is on and the attention goes
        through ``FusedAttention``, so the replay's prefill is
        differentiable."""
        cfg = self.cfg
        B, L, HD = x.shape
        hd = (cfg.num_attention_heads, cfg.head_dim)
        qc, kc, vc = self._qkv(x)
        dev = x.device
        meta = (torch.full((B,), MODE_S2S, dtype=torch.int32, device=dev),
                torch.full((B,), L, dtype=torch.int32, device=dev),
                torch.ones((B, L), dtype=torch.float32, device=dev))
        q4, k4, v4 = (t.view(B, L, *hd) for t in (qc, kc, vc))
        if drop is None:
            ctx = attn_ops.attention(q4, k4, v4, *meta, prefix=prefix)
        else:
            ctx = attn_ops.FusedAttention.apply(
                q4, k4, v4, *meta, prefix, cfg.attention_probs_dropout_prob,
                drop.seed())
        out = self._post_attention(ctx.reshape(B, L, HD), x, drop)
        return out, kc[:, :prefix], vc[:, :prefix]

    def incremental_split(self, x, pk, pv, gk, gv, gen_len: int,
                          beam_bias: Optional[torch.Tensor] = None,
                          drop_seed: Optional[int] = None,
                          masks=None) -> torch.Tensor:
        """One KV-cached step: the fused decode attention writes the new
        K/V into ``gk``/``gv`` in place.  An SCST sampled rollout passes
        the step's attention seed (K5) and its hidden keep masks."""
        q, k, v = self._qkv(x)
        ctx = decode_attn_ops.decode_attention(
            q, k, v, pk, pv, gk, gv, gen_len,
            n_heads=self.cfg.num_attention_heads, beam_bias=beam_bias,
            drop_seed=drop_seed,
            drop_rate=self.cfg.attention_probs_dropout_prob)
        return self._post_attention(ctx, x, masks=masks)

    def dual_block_attend(self, x, pk, pv, bias, probs_scale=None,
                          masks=None) -> torch.Tensor:
        """SCST teacher-forced replay attention (JAX ``dual_block_attend``,
        model.py:596): one pass, no cache.  Queries are the 2W caption rows
        ``[w_0..w_{W-1} | m_1..m_W]``, keys/values the prompt caches
        ``pk/pv [B, P, H*D]`` plus the rows' own projections, visibility the
        static additive ``bias [R, P+R]``.  ``probs_scale`` [B, H, R, P+R]
        multiplies the probabilities as K5 did (K6's multipliers mapped to
        replay coordinates); ``masks`` are the hidden keep masks
        ([B, R, H], [B, R, H]).  Products in fp32 on the activations'
        values, the probabilities cast to the activation dtype, and the
        context summed as a prompt block plus a caption block, as the
        rollout sums it."""
        cfg = self.cfg
        B, R, HD = x.shape
        P = pk.shape[1]
        H, D = cfg.num_attention_heads, cfg.head_dim
        q, k, v = self._qkv(x)
        qb = q.float().view(B, R, H, D)
        scale = 1.0 / math.sqrt(D)
        sp = torch.einsum("brhd,bjhd->bhrj", qb,
                          pk.float().reshape(B, P, H, D)) * scale
        sg = torch.einsum("brhd,bjhd->bhrj", qb,
                          k.float().view(B, R, H, D)) * scale
        probs = torch.softmax(torch.cat([sp, sg], dim=-1) + bias, dim=-1)
        if probs_scale is not None:
            probs = probs * probs_scale
        probs = probs.to(x.dtype).float()
        ctx = torch.einsum("bhrj,bjhd->brhd", probs[..., :P],
                           pv.float().reshape(B, P, H, D))
        ctx = ctx + torch.einsum("bhrj,bjhd->brhd", probs[..., P:],
                                 v.float().view(B, R, H, D))
        return self._post_attention(ctx.to(x.dtype).reshape(B, R, HD), x,
                                    masks=masks)


class _Encoder(nn.Module):
    def __init__(self, cfg: VLPConfig):
        super().__init__()
        self.layer = nn.ModuleList(TransformerLayer(cfg)
                                   for _ in range(cfg.num_hidden_layers))


class _Bert(nn.Module):
    def __init__(self, cfg: VLPConfig):
        super().__init__()
        self.embeddings = Embeddings(cfg)
        self.encoder = _Encoder(cfg)
        self.pooler = _Dense(cfg.hidden_size, cfg.hidden_size)


class _Transform(nn.Module):
    def __init__(self, H: int, r: int):
        super().__init__()
        self.dense = nn.Linear(H, H * r)
        self.LayerNorm = nn.LayerNorm(H * r, eps=LN_EPS)


class _Predictions(nn.Module):
    def __init__(self, cfg: VLPConfig):
        super().__init__()
        self.transform = _Transform(cfg.hidden_size,
                                    max(cfg.relax_projection, 1))
        self.bias = nn.Parameter(torch.zeros(cfg.vocab_size))
        # tied to the word embeddings (VLPModel.__init__)
        self.decoder = nn.Linear(cfg.hidden_size, cfg.vocab_size, bias=False)


class MLMHead(nn.Module):
    """Transform + relax-projection select + tied decode (``cls``)."""

    def __init__(self, cfg: VLPConfig):
        super().__init__()
        self.cfg = cfg
        self.predictions = _Predictions(cfg)
        self.act = ACT[cfg.hidden_act]

    def forward(self, hidden, task_idx, word_embedding) -> torch.Tensor:
        """hidden: [B, P, H]; task_idx: int[B]; returns fp32 [B, P, V]."""
        cfg = self.cfg
        r = max(cfg.relax_projection, 1)
        t = self.predictions.transform
        h = self.act(_linear(t.dense, hidden))
        h = _layer_norm(t.LayerNorm, h).to(hidden.dtype)  # LN over r*H
        if cfg.relax_projection > 1:
            B, P, _ = h.shape
            h = h.view(B, P, r, cfg.hidden_size)
            idx = task_idx.long().view(B, 1, 1, 1).expand(
                B, P, 1, cfg.hidden_size)
            h = torch.gather(h, 2, idx)[:, :, 0]
        # the JAX package multiplies in the activation dtype with fp32
        # accumulation and returns fp32: fp32 product of the rounded
        # operands (a bf16 matmul would return bf16 logits and flip beams)
        w = word_embedding.to(h.dtype).float()
        logits = torch.matmul(h.float(), w.t())
        return logits + self.predictions.bias.float()


class VLPModel(nn.Module):
    """Backbone + MLM head + region projections, and with ``with_vqa`` the
    VQA answer head ``ans_classifier`` (JAX ``VLPModel(cfg, with_vqa)``).
    Training: ``pretrain_losses`` (``task`` "img2txt" or "vqa2").
    Inference: ``encode``, ``vqa_logits`` / ``vqa_inference``, and the
    generation primitives ``prefill``, ``decode_step`` and ``lm_logits``."""

    def __init__(self, cfg: VLPConfig, with_vqa: bool = False):
        super().__init__()
        self.cfg = cfg
        self.with_vqa = with_vqa
        self.dtype = torch_dtype(cfg.dtype)
        H = cfg.hidden_size
        self.bert = _Bert(cfg)
        self.cls = MLMHead(cfg)
        self.cls.predictions.decoder.weight = \
            self.bert.embeddings.word_embeddings.weight
        self.vis_embed = nn.Sequential(
            nn.Linear(cfg.vis_feat_dim, cfg.vis_feat_dim), nn.ReLU(),
            nn.Linear(cfg.vis_feat_dim, H), nn.ReLU())
        self.vis_pe_embed = nn.Sequential(nn.Linear(cfg.vis_pe_dim, H),
                                          nn.ReLU())
        if with_vqa:
            # the reference's answer head, under its keys ans_classifier.0/.2
            self.ans_classifier = nn.Sequential(
                nn.Linear(H, 2 * H), nn.ReLU(),
                nn.Linear(2 * H, cfg.num_answers))

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """The JAX package's initialisation: dense kernels and embedding
        tables N(0, initializer_range), biases 0, LayerNorm 1/0."""
        std = self.cfg.initializer_range
        for m in self.modules():
            if isinstance(m, (nn.Linear, nn.Embedding)):
                m.weight.normal_(0.0, std, generator=generator)
                if getattr(m, "bias", None) is not None:
                    m.bias.zero_()
            elif isinstance(m, nn.LayerNorm):
                m.weight.fill_(1.0)
                m.bias.zero_()
            elif isinstance(m, _Predictions):
                m.bias.zero_()

    def cast_for_inference(self) -> "VLPModel":
        """Store dense layers and embedding tables in the activation dtype
        (LayerNorms and the MLM bias stay fp32).  Values are those the
        per-call cast would give; the tie of the decoder is kept, since
        ``Module.to`` converts parameters in place."""
        for m in self.modules():
            if isinstance(m, (nn.Linear, nn.Embedding)):
                m.to(self.dtype)
        return self

    @property
    def layers(self) -> nn.ModuleList:
        return self.bert.encoder.layer

    # ------------------------------------------------------------------
    def project_regions(self, vis_feats, vis_pe,
                        drop: Optional[DropoutRNG] = None):
        dt = self.dtype
        rate = self.cfg.hidden_dropout_prob
        f = vis_feats.to(dt)
        f = F.relu(_linear(self.vis_embed[2],
                           F.relu(_linear(self.vis_embed[0], f))))
        f = _hidden_dropout(drop, f, rate)
        p = F.relu(_linear(self.vis_pe_embed[0], vis_pe.to(dt)))
        return f, _hidden_dropout(drop, p, rate)

    def pooled(self, seq_out: torch.Tensor) -> torch.Tensor:
        return torch.tanh(_linear(self.bert.pooler.dense, seq_out[:, 0]))

    def _answer_logits(self, seq_out: torch.Tensor) -> torch.Tensor:
        """fp32 [B, num_answers]: the head on [CLS] o the first text token
        (the token after the regions' [SEP]), in the activation dtype."""
        if not self.with_vqa:
            raise ValueError("VQA needs VLPModel(cfg, with_vqa=True)")
        nv = self.cfg.len_vis_input
        vqa_embed = seq_out[:, 0] * seq_out[:, nv + 1]
        h = F.relu(_linear(self.ans_classifier[0], vqa_embed))
        return _linear(self.ans_classifier[2], h).float()

    def encode(self, input_ids, segment_ids, mode, text_end, vis_feats,
               vis_pe, vis_keep=None, position_ids=None,
               drop: Optional[DropoutRNG] = None,
               return_projections: bool = False):
        """Full-sequence forward -> (seq_out, pooled), plus the region
        projections before the masked regions are zeroed with
        ``return_projections`` (the pretext loss takes those)."""
        cfg = self.cfg
        B, L = input_ids.shape
        dev = input_ids.device
        if position_ids is None:
            position_ids = torch.arange(L, device=dev).expand(B, L)
        if vis_keep is None:
            vis_keep = torch.ones((B, cfg.len_vis_input), device=dev)
        vf, vp = self.project_regions(vis_feats, vis_pe, drop)
        keep = vis_keep[..., None]
        x = self.bert.embeddings(input_ids, segment_ids, position_ids,
                                 vf * keep.to(vf.dtype),
                                 vp * keep.to(vp.dtype), self.dtype, drop)
        attn_keep = (vis_keep if cfg.block_masked_regions_in_attention
                     else torch.ones_like(vis_keep))
        colkeep = attn_ops.colkeep_from_vis_keep(attn_keep.float(), L)
        for layer in self.layers:
            x = layer(x, mode, text_end, colkeep, drop)
        if return_projections:
            return x, self.pooled(x), vf, vp
        return x, self.pooled(x)

    def pretrain_losses(self, batch: Dict[str, torch.Tensor], *,
                        drop: Optional[DropoutRNG],
                        drop_worst_ratio: float = 0.0,
                        mask_image_regions: bool = False,
                        task: str = "img2txt") -> Dict[str, torch.Tensor]:
        """Training forward (JAX ``pretrain_losses``): for ``task="img2txt"``
        the masked-LM loss on the gathered ``masked_pos`` only; for
        ``task="vqa2"`` the VQA loss, BCE with logits against the soft
        ``ans_scores`` summed over answers and averaged over the batch
        (``masked_lm_loss`` is 0).  Plus the region pretext loss under
        ``mask_image_regions``."""
        if task not in ("img2txt", "vqa2"):
            raise ValueError(f"unknown task {task!r}")
        cfg = self.cfg
        seq_out, pooled, vf, vp = self.encode(
            batch["input_ids"], batch["segment_ids"], batch["mode"],
            batch["text_end"], batch["vis_feats"], batch["vis_pe"],
            vis_keep=batch.get("vis_keep"), drop=drop,
            return_projections=True)
        out: Dict[str, torch.Tensor] = {}
        zero = torch.zeros((), device=seq_out.device)
        if task == "vqa2":
            x = self._answer_logits(seq_out)
            y = batch["ans_scores"].float()
            # the stable BCE-with-logits; BCEWithLogitsLoss (mean over all)
            # times num_answers is the batch mean of per-example sums
            # (reference modeling.py:1140)
            bce = x.clamp(min=0) - x * y + torch.log1p(torch.exp(-x.abs()))
            out["vqa2_loss"] = bce.sum(dim=-1).mean()
            out["masked_lm_loss"] = zero
        else:
            pos = batch["masked_pos"].long()
            hidden = torch.gather(
                seq_out, 1, pos[:, :, None].expand(-1, -1, seq_out.shape[-1]))
            logits = self.cls(hidden, batch["task_idx"],
                              self.bert.embeddings.word_embeddings.weight)
            per_pos = losses_lib.mlm_position_loss(
                logits, batch["masked_ids"], cfg.label_smoothing,
                cfg.vocab_size)
            out["masked_lm_loss"] = losses_lib.mask_and_normalize_loss(
                per_pos, batch["masked_weights"], drop_worst_ratio)
            out["vqa2_loss"] = zero
        if mask_image_regions:
            H = vf.shape[-1]
            vpos = (batch["vis_masked_pos"] - 1).long()[:, :, None].expand(
                -1, -1, H)
            mf = torch.gather(vf, 1, vpos)
            me = torch.gather(vp, 1, vpos) + pooled[:, None, :].to(vp.dtype)
            sim = torch.einsum("bmh,bnh->bmn", me.float(), mf.float())
            logp = torch.log_softmax(sim, dim=-1)
            diag = torch.diagonal(logp, dim1=1, dim2=2)
            out["pretext_loss"] = -diag.mean(dim=-1).mean()
        else:
            out["pretext_loss"] = zero
        out["loss"] = (out["masked_lm_loss"] + out["pretext_loss"]
                       + out["vqa2_loss"])
        return out

    def vqa_logits(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        """fp32 answer logits [B, num_answers] of the deterministic encode
        (no backward on the card)."""
        seq_out, _ = self.encode(
            batch["input_ids"], batch["segment_ids"], batch["mode"],
            batch["text_end"], batch["vis_feats"], batch["vis_pe"])
        return self._answer_logits(seq_out)

    def vqa_inference(self, batch: Dict[str, torch.Tensor]) -> torch.Tensor:
        """Answer ids int64[B], the argmax over answers 1.. (answer 0 is
        ``<unk>``; JAX ``vqa_inference``, reference modeling.py:1039-1047)."""
        return self.vqa_logits(batch)[:, 1:].argmax(dim=-1) + 1

    # ------------------------------------------------------------------
    # Incremental generation primitives
    # ------------------------------------------------------------------
    @staticmethod
    def gen_cache_slots(max_tgt_length: int) -> int:
        """Generated-token cache size: max committed tokens + probe slot,
        rounded up to a multiple of 8."""
        return -(-max_tgt_length // 8) * 8

    def prefill(self, input_ids, segment_ids, position_ids, vis_feats,
                vis_pe, mask_id: int, drop: Optional[DropoutRNG] = None
                ) -> Tuple[torch.Tensor, List[torch.Tensor],
                           List[torch.Tensor]]:
        """Encode [CLS] regions [SEP] plus the first [MASK] probe.  Returns
        (probe hidden [B, 1, H], per-layer prompt K and V caches
        [B, P, H*D]); the probe's own K/V are dropped.  ``drop`` turns
        dropout on (an SCST rollout and its replay)."""
        B = input_ids.shape[0]
        prefix = self.cfg.prefix_len
        probe = torch.full((B, 1), mask_id, dtype=input_ids.dtype,
                           device=input_ids.device)
        ids = torch.cat([input_ids[:, :prefix], probe], dim=1)
        vf, vp = self.project_regions(vis_feats, vis_pe, drop)
        x = self.bert.embeddings(ids, segment_ids[:, :prefix + 1],
                                 position_ids[:, :prefix + 1], vf, vp,
                                 self.dtype, drop)
        ks, vs = [], []
        for layer in self.layers:
            x, k, v = layer.prefill_attend(x, prefix, drop)
            ks.append(k)
            vs.append(v)
        return x[:, -1:], ks, vs

    def decode_step(self, prev_ids, segment_ids, position_ids, pk, pv, gk,
                    gv, gen_len: int, mask_id: int,
                    beam_bias: Optional[torch.Tensor] = None,
                    drop: Optional[ExplicitDropout] = None) -> torch.Tensor:
        """Feed [prev_token, MASK probe] at absolute positions
        prefix+gen_len and +1; returns the probe hidden [BK, 1, H].  The
        generated caches ``gk``/``gv`` (per-layer lists) are updated in
        place; the prompt caches are read-only.  ``drop``: the SCST
        contract, whose step ``gen_len`` dropout the step applies."""
        BK = prev_ids.shape[0]
        c = self.cfg.prefix_len + gen_len
        probe = torch.full((BK, 1), mask_id, dtype=prev_ids.dtype,
                           device=prev_ids.device)
        ids = torch.cat([prev_ids, probe], dim=1)
        x = self.bert.embeddings(ids, segment_ids[:, c:c + 2],
                                 position_ids[:, c:c + 2], None, None,
                                 self.dtype)
        keep = None if drop is None else drop.hidden_keep(gen_len, BK)
        rate = self.cfg.hidden_dropout_prob
        if keep is not None:
            x = masked_dropout(x, keep[0], rate)
        for i, layer in enumerate(self.layers):
            x = layer.incremental_split(
                x, pk[i], pv[i], gk[i], gv[i], gen_len, beam_bias=beam_bias,
                drop_seed=None if drop is None else drop.attn_seed(gen_len, i),
                masks=None if keep is None else keep[1 + 2 * i:3 + 2 * i])
        return x[:, -1:]

    def lm_logits(self, hidden, task_idx) -> torch.Tensor:
        """MLM logits for generation (fp32, [B, S, V])."""
        return self.cls(hidden, task_idx,
                        self.bert.embeddings.word_embeddings.weight)

    # ------------------------------------------------------------------
    # SCST teacher-forced replay (one dual-block pass, no decode loop)
    # ------------------------------------------------------------------
    def _scst_replay_drop(self, drop: ExplicitDropout, B: int, T: int):
        """The rollout's dropout in dual-block coordinates (JAX
        ``_scst_replay_drop``, model.py:969).  Rollout step t feeds rows
        (w_t [s=0], m_{t+1} [s=1]) and draws over columns [prompt P | slots
        G], where slot j holds w_j and slot t+1 the step's own probe; so the
        replay's columns map row-independently: the prompt to itself, w_j
        to P+j, and probe m_{u+1}'s own column P+W+u to slot u+1.  Returns
        (embedding keep mask [B, R, H] or None, ``layer_drop(l)`` ->
        (probs_scale [B, H, R, P+R] or None, (attn-out, ffn-out) masks or
        None)), rows ordered [w_0..w_{W-1} | m_1..m_W]."""
        cfg = self.cfg
        W = T - 1
        P = cfg.prefix_len
        G = VLPModel.gen_cache_slots(T)
        dev = drop.device
        keep = None
        if cfg.hidden_dropout_prob > 0.0:
            keep = torch.stack([drop.hidden_keep(t, B) for t in range(W)])

        def rows2(m):             # [W, B, 2, H] -> [B, 2W, H]
            return torch.cat([m[:, :, 0].transpose(0, 1),
                              m[:, :, 1].transpose(0, 1)], dim=1)

        ar = torch.arange(W, device=dev)
        row_step = torch.cat([ar, ar])
        row_s = torch.cat([torch.zeros_like(ar), torch.ones_like(ar)])
        col_src = torch.cat([torch.arange(P + W, device=dev), P + 1 + ar])

        def layer_drop(layer: int):
            scale = None
            if cfg.attention_probs_dropout_prob > 0.0:
                scales = decode_attn_ops.decode_dropout_scales(
                    [drop.attn_seed(t, layer) for t in range(W)], B,
                    n_heads=cfg.num_attention_heads, S=2, P=P, G=G,
                    rate=cfg.attention_probs_dropout_prob, device=dev)
                scales = scales.view(W, B, cfg.num_attention_heads, 2, P + G)
                sel = scales[row_step, :, :, row_s]       # [R, B, H, P+G]
                scale = sel.index_select(-1, col_src).permute(1, 2, 0, 3)
            masks = None
            if keep is not None:
                masks = (rows2(keep[:, 1 + 2 * layer]),
                         rows2(keep[:, 2 + 2 * layer]))
            return scale, masks

        return (None if keep is None else rows2(keep[:, 0])), layer_drop

    def scst_replay_hidden(self, forced_ids, segment_ids, position_ids, pk,
                           pv, mask_id: int,
                           drop: Optional[ExplicitDropout] = None
                           ) -> torch.Tensor:
        """Teacher-forced SCST replay as one dual-block pass (JAX
        ``scst_replay_hidden``, model.py:1044): rows [w_0..w_{T-2} |
        m_1..m_{T-1}] attend to [prompt caches | those rows] under the
        decode visibility (w_t sees the prompt and w_<=t; m_t the prompt,
        w_<t and itself), giving the incremental decoder's probe hiddens
        without the decode loop.  With ``drop`` it applies exactly the
        masks the sampled rollout drew under the same contract.  Returns
        [B, T-1, H], the hiddens of probes m_1..m_{T-1}."""
        cfg = self.cfg
        B, T = forced_ids.shape
        if T < 2:
            raise ValueError("the teacher-forced replay needs T >= 2")
        W, R, P = T - 1, 2 * (T - 1), cfg.prefix_len
        dev = forced_ids.device
        ids = torch.cat([forced_ids[:, :W],
                         torch.full((B, W), mask_id, dtype=forced_ids.dtype,
                                    device=dev)], dim=1)
        seg = torch.cat([segment_ids[:, P:P + W],
                         segment_ids[:, P + 1:P + 1 + W]], dim=1)
        pos = torch.cat([position_ids[:, P:P + W],
                         position_ids[:, P + 1:P + 1 + W]], dim=1)
        x = self.bert.embeddings(ids, seg, pos, None, None, self.dtype)
        emb_mask, layer_drop = None, None
        if drop is not None:
            emb_mask, layer_drop = self._scst_replay_drop(drop, B, T)
            x = masked_dropout(x, emb_mask, cfg.hidden_dropout_prob)

        # the static dual-block visibility as an additive bias [R, P+R]
        r = torch.arange(R, device=dev)[:, None]
        c = torch.arange(P + R, device=dev)[None, :]
        step = torch.where(r < W, r, r - W)
        vis = ((c < P) | ((c >= P) & (c < P + W) & (c - P <= step))
               | ((r >= W) & (c == P + W + step)))
        bias = torch.full(vis.shape, NEG_INF, device=dev).masked_fill(vis,
                                                                      0.0)
        for i, layer in enumerate(self.layers):
            scale, masks = (None, None) if layer_drop is None \
                else layer_drop(i)
            x = layer.dual_block_attend(x, pk[i], pv[i], bias, scale, masks)
        return x[:, W:]
