"""The unified VLP transformer in PyTorch: the training forward with its
losses, and the inference primitives (counterpart of
``vlp_tpu/models/model.py``).

Submodules carry the reference state-dict names
(``bert.encoder.layer.{i}.attention.self.query``,
``cls.predictions.transform.dense``, ``vis_embed.0`` ...; see
``vlp_tpu/checkpoint.py:_torch_to_flax_map``), so a reference ``.bin``
loads with ``load_state_dict`` after the shared ``apply_surgery``.

Precision policy, as in the JAX package: parameters fp32, activations in
``cfg.dtype`` (bf16 on the card), every LayerNorm (eps 1e-5) and GELU (erf)
in fp32 with the result cast back, attention softmax in fp32, and the tied
MLM vocab product accumulated and returned in fp32.  Dense layers and
embedding tables are used in the activation dtype, cast per call, so that
gradients reach the fp32 parameters; :meth:`VLPModel.cast_for_inference`
stores them cast once for decoding, which gives the same values.

Attention goes through ``ops.attention.attention`` (prefill, encode),
``ops.attention.FusedAttention`` (the training forward and backward) and
``ops.decode_attention.decode_attention`` (decode steps): the CUDA kernels
for CUDA tensors, their plain versions for CPU tensors.

Dropout follows the JAX package's sites: embeddings, region projections,
attention probabilities, attention output and FFN output.  A training
forward takes a :class:`DropoutRNG`; without one the forward is
deterministic.
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

LN_EPS = 1e-5


class DropoutRNG:
    """The randomness of one training forward (the JAX package's
    ``dropout`` rng stream).

    Attention-prob dropout takes one 64-bit Philox seed per layer, drawn on
    the host from a CPU generator, so it reaches the kernel as an argument
    without a device sync.  Hidden dropout draws its keep masks from a
    ``torch.Generator`` on the model's device (plain PyTorch; the JAX
    package leaves it to XLA).  Both follow from ``seed`` alone."""

    def __init__(self, seed: int, device):
        self._host = torch.Generator().manual_seed(seed)
        self._device = torch.Generator(device=torch.device(device))
        self._device.manual_seed(self.seed())

    def seed(self) -> int:
        """A fresh 64-bit seed."""
        lo, hi = torch.randint(0, 2 ** 32, (2,), generator=self._host).tolist()
        return lo | (hi << 32)

    def hidden(self, x: torch.Tensor, rate: float) -> torch.Tensor:
        """flax ``nn.Dropout``: keep with probability 1 - rate, kept
        entries scaled by 1 / (1 - rate)."""
        if rate == 0.0:
            return x
        keep = torch.rand(x.shape, generator=self._device,
                          device=x.device) < 1.0 - rate
        return torch.where(keep, x / (1.0 - rate), torch.zeros_like(x))


def _hidden_dropout(drop: Optional[DropoutRNG], x: torch.Tensor,
                    rate: float) -> torch.Tensor:
    return x if drop is None else drop.hidden(x, rate)


def gelu_exact(x: torch.Tensor) -> torch.Tensor:
    """erf-based gelu in fp32, cast back (model.py:gelu_exact)."""
    xf = x.float()
    return (xf * 0.5 * (1.0 + torch.erf(xf / math.sqrt(2.0)))).to(x.dtype)


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
        if cfg.hidden_act != "gelu":
            raise NotImplementedError(f"hidden_act {cfg.hidden_act!r}")

    def _qkv(self, x):
        sa = self.attention.self
        return _linear(sa.query, x), _linear(sa.key, x), _linear(sa.value, x)

    def _post_attention(self, ctx: torch.Tensor, residual: torch.Tensor,
                        drop: Optional[DropoutRNG] = None) -> torch.Tensor:
        """Output projection + FFN, each followed by (hidden dropout and)
        residual + fp32 LN."""
        rate = self.cfg.hidden_dropout_prob
        ao = self.attention.output
        h = _hidden_dropout(drop, _linear(ao.dense, ctx), rate)
        h = _layer_norm(ao.LayerNorm, h + residual).to(ctx.dtype)
        f = _linear(self.output.dense,
                    gelu_exact(_linear(self.intermediate.dense, h)))
        f = _hidden_dropout(drop, f, rate)
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

    def prefill_attend(self, x: torch.Tensor, prefix: int
                       ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
        """Prompt-window attention: ``x`` is [B, P+1, H] (prompt + [MASK]
        probe).  The decode-time visibility is the s2s mask with
        ``text_end = L``.  Returns (layer_out, k[:, :P], v[:, :P]) — the
        caches are views of the projections (batch stride (P+1)*H*D); the
        decode kernel takes that stride, nothing is copied."""
        B, L, HD = x.shape
        hd = (self.cfg.num_attention_heads, self.cfg.head_dim)
        qc, kc, vc = self._qkv(x)
        dev = x.device
        ctx = attn_ops.attention(
            qc.view(B, L, *hd), kc.view(B, L, *hd), vc.view(B, L, *hd),
            torch.full((B,), MODE_S2S, dtype=torch.int32, device=dev),
            torch.full((B,), L, dtype=torch.int32, device=dev),
            torch.ones((B, L), dtype=torch.float32, device=dev),
            prefix=prefix)
        out = self._post_attention(ctx.reshape(B, L, HD), x)
        return out, kc[:, :prefix], vc[:, :prefix]

    def incremental_split(self, x, pk, pv, gk, gv, gen_len: int,
                          beam_bias: Optional[torch.Tensor] = None
                          ) -> torch.Tensor:
        """One KV-cached step: the fused decode attention writes the new
        K/V into ``gk``/``gv`` in place."""
        q, k, v = self._qkv(x)
        ctx = decode_attn_ops.decode_attention(
            q, k, v, pk, pv, gk, gv, gen_len,
            n_heads=self.cfg.num_attention_heads, beam_bias=beam_bias)
        return self._post_attention(ctx, x)


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

    def forward(self, hidden, task_idx, word_embedding) -> torch.Tensor:
        """hidden: [B, P, H]; task_idx: int[B]; returns fp32 [B, P, V]."""
        cfg = self.cfg
        r = max(cfg.relax_projection, 1)
        t = self.predictions.transform
        h = gelu_exact(_linear(t.dense, hidden))
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
    """Backbone + MLM head + region projections; inference primitives
    ``encode``, ``prefill``, ``decode_step`` and ``lm_logits``."""

    def __init__(self, cfg: VLPConfig):
        super().__init__()
        self.cfg = cfg
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
        self.cls.predictions.bias.zero_()

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
        """Training forward for ``task="img2txt"``: the masked-LM loss on
        the gathered ``masked_pos`` only, plus the region pretext loss
        under ``mask_image_regions`` (JAX ``pretrain_losses``)."""
        if task != "img2txt":
            raise NotImplementedError(
                f"task {task!r}: the VQA head is ROADMAP item A8")
        cfg = self.cfg
        seq_out, pooled, vf, vp = self.encode(
            batch["input_ids"], batch["segment_ids"], batch["mode"],
            batch["text_end"], batch["vis_feats"], batch["vis_pe"],
            vis_keep=batch.get("vis_keep"), drop=drop,
            return_projections=True)
        out: Dict[str, torch.Tensor] = {}
        pos = batch["masked_pos"].long()
        hidden = torch.gather(
            seq_out, 1, pos[:, :, None].expand(-1, -1, seq_out.shape[-1]))
        logits = self.cls(hidden, batch["task_idx"],
                          self.bert.embeddings.word_embeddings.weight)
        per_pos = losses_lib.mlm_position_loss(
            logits, batch["masked_ids"], cfg.label_smoothing, cfg.vocab_size)
        out["masked_lm_loss"] = losses_lib.mask_and_normalize_loss(
            per_pos, batch["masked_weights"], drop_worst_ratio)
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
            out["pretext_loss"] = torch.zeros((), device=seq_out.device)
        out["loss"] = out["masked_lm_loss"] + out["pretext_loss"]
        return out

    # ------------------------------------------------------------------
    # Incremental generation primitives
    # ------------------------------------------------------------------
    @staticmethod
    def gen_cache_slots(max_tgt_length: int) -> int:
        """Generated-token cache size: max committed tokens + probe slot,
        rounded up to a multiple of 8."""
        return -(-max_tgt_length // 8) * 8

    def prefill(self, input_ids, segment_ids, position_ids, vis_feats,
                vis_pe, mask_id: int
                ) -> Tuple[torch.Tensor, List[torch.Tensor],
                           List[torch.Tensor]]:
        """Encode [CLS] regions [SEP] plus the first [MASK] probe.  Returns
        (probe hidden [B, 1, H], per-layer prompt K and V caches
        [B, P, H*D]); the probe's own K/V are dropped."""
        B = input_ids.shape[0]
        prefix = self.cfg.prefix_len
        probe = torch.full((B, 1), mask_id, dtype=input_ids.dtype,
                           device=input_ids.device)
        ids = torch.cat([input_ids[:, :prefix], probe], dim=1)
        vf, vp = self.project_regions(vis_feats, vis_pe)
        x = self.bert.embeddings(ids, segment_ids[:, :prefix + 1],
                                 position_ids[:, :prefix + 1], vf, vp,
                                 self.dtype)
        ks, vs = [], []
        for layer in self.layers:
            x, k, v = layer.prefill_attend(x, prefix)
            ks.append(k)
            vs.append(v)
        return x[:, -1:], ks, vs

    def decode_step(self, prev_ids, segment_ids, position_ids, pk, pv, gk,
                    gv, gen_len: int, mask_id: int,
                    beam_bias: Optional[torch.Tensor] = None
                    ) -> torch.Tensor:
        """Feed [prev_token, MASK probe] at absolute positions
        prefix+gen_len and +1; returns the probe hidden [BK, 1, H].  The
        generated caches ``gk``/``gv`` (per-layer lists) are updated in
        place; the prompt caches are read-only."""
        BK = prev_ids.shape[0]
        c = self.cfg.prefix_len + gen_len
        probe = torch.full((BK, 1), mask_id, dtype=prev_ids.dtype,
                           device=prev_ids.device)
        ids = torch.cat([prev_ids, probe], dim=1)
        x = self.bert.embeddings(ids, segment_ids[:, c:c + 2],
                                 position_ids[:, c:c + 2], None, None,
                                 self.dtype)
        for i, layer in enumerate(self.layers):
            x = layer.incremental_split(x, pk[i], pv[i], gk[i], gv[i],
                                        gen_len, beam_bias=beam_bias)
        return x[:, -1:]

    def lm_logits(self, hidden, task_idx) -> torch.Tensor:
        """MLM logits for generation (fp32, [B, S, V])."""
        return self.cls(hidden, task_idx,
                        self.bert.embeddings.word_embeddings.weight)
