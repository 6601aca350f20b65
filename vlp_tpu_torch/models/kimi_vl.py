"""Kimi-VL-A3B's language model on the port's training path
(``moonshotai/Kimi-VL-A3B-Instruct``, ``config.json``: the DeepSeek-V3
block), with VLP's region MLPs in its projector's place, trained with VLP's
objective.

The layers, as the published configuration states them (``KimiVLConfig``):

* pre-RMSNorm layers (eps 1e-5) over a residual stream in the activation
  dtype;
* MLA attention in its expanded training form: ``q_proj`` to 16 heads of
  q.k 192 (no q low-rank), ``kv_a_proj_with_mqa`` to a latent of 512 and
  one 64-d RoPE key shared by every head, RMSNorm on the latent,
  ``kv_b_proj`` to 16 x (128 keys without position + 128 values), RoPE
  (theta 800,000, DeepSeek's interleaved pairs) on the 64-d parts, then
  K1 / K2 at (192, 128) (``ops.attention``) under VLP's s2s / bi masks,
  and ``o_proj``;
* layer 0 a dense SwiGLU of 11,264; every later layer a mixture of 64
  routed experts of width 1,408 (top-6) and 2 shared experts (one SwiGLU of
  2,816) on every token;
* the router: fp32 logits over all 64 experts, sigmoid scores, the top 6
  of score + ``e_score_correction_bias`` (``noaux_tc``, one group), the
  picked scores normalised to sum 1 and scaled by 2.446;
* a final RMSNorm and an untied head.

Expert parallelism: a layer is told which experts it holds
(``n_routed_experts_held`` of them from ``ep_rank``; EP8 holds 8 of 64),
routes over all of them, and computes only its own experts' part of the
result for the tokens routed to them; what the absent experts would add
is left out (the rest of the layer lies on the other chips of the
deployment).  It drops none of its (token, expert) pairs: rows are sorted
by expert on the device into a buffer of the most pairs a layer can hold
(tokens x min(top-k, held)), the two grouped products (gate and up
together, then down) take the expert offsets from device memory
(``torch._grouped_mm`` on the card; a loop over the experts for CPU
tensors), and the gather of the tokens' rows, the SwiGLU between the
products and the weighted combine back onto the tokens are
``ops/moe_rows.py``'s passes, which stop at the held-row count the device
holds (``offs[-1]``, ~1/8 of the buffer at EP8); the intermediates are
recomputed in the backward (:class:`HeldRows`).  Nothing in the step
reads a device value on the host, so ``train_step.CapturedSteps``
captures it.

Training-only state, outside autograd, on the device: each MoE layer
counts how often each of the 64 experts was picked in the step
(``load``), and after the optimizer step (:meth:`KimiVLModel.after_step`)
moves its bias by ``bias_update_speed * sign(mean load - load)``
(DeepSeek-V3's auxiliary-loss-free balancing; the rate and the balance
loss's coefficient are from its report, arXiv:2412.19437, since the
configuration leaves them unstated); each counts the rows its held
experts took (``rows``, read by a benchmark once after its window) and
the rows of its buffer (``buffer_rows``).  The
sequence-wise balance loss (``aux_loss_alpha``, over all 64 experts'
selections and normalised scores) is added to the loss.

Departures from Kimi-VL, each forced by running VLP's fine-tune on it:
the objective is VLP's s2s masked-LM over at most ``max_pred`` caption
positions, not next-token prediction; the 100 regions attend to each other
bidirectionally under VLP's s2s mask; there is no vision tower (VLP's
region MLPs project the detector features to 2,048 and take the region
slots of the sequence, with RoPE positions 0..L-1 over the whole
sequence); padded positions are routed like tokens (the batch has static
shapes); dropout is 0, as in the source.  The vocabulary is a slice of
the published one (the traffic draws ids from it), and BertAdam's decay
mask (everything but biases and ``.LayerNorm.``) decays the RMSNorm
scales too.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Dict, List, Optional

import torch
import torch.nn.functional as F
from torch import nn

from vlp_tpu_torch import losses as losses_lib
from vlp_tpu_torch import torch_dtype, tracing
from vlp_tpu_torch.config import VLPConfig
from vlp_tpu_torch.ops import attention as attn_ops
from vlp_tpu_torch.ops import moe_rows

MODEL_TYPE = "kimi_vl"


@dataclasses.dataclass(frozen=True)
class KimiVLConfig:
    """The language model's published settings (HF ``config.json`` keys),
    the share this chip holds, VLP's region inputs and task geometry, and
    the two balancing rates the configuration leaves unstated."""
    vocab_size: int = 163840
    hidden_size: int = 2048
    intermediate_size: int = 11264
    moe_intermediate_size: int = 1408
    num_hidden_layers: int = 27
    num_attention_heads: int = 16
    n_shared_experts: int = 2
    n_routed_experts: int = 64
    num_experts_per_tok: int = 6
    first_k_dense_replace: int = 1
    routed_scaling_factor: float = 2.446
    norm_topk_prob: bool = True
    kv_lora_rank: int = 512
    q_lora_rank: Optional[int] = None
    qk_nope_head_dim: int = 128
    qk_rope_head_dim: int = 64
    v_head_dim: int = 128
    rms_norm_eps: float = 1e-5
    rope_theta: float = 800000.0
    initializer_range: float = 0.02
    # the chip's share of expert parallelism: experts ep_rank * held ..
    n_routed_experts_held: int = 64
    ep_rank: int = 0
    # DeepSeek-V3's report (arXiv:2412.19437): alpha and gamma
    aux_loss_alpha: float = 1e-4
    bias_update_speed: float = 1e-3
    # VLP's region inputs and caption geometry
    len_vis_input: int = 100
    vis_feat_dim: int = 2048
    vis_cls_dim: int = 1601
    vis_pe_dim: int = 1607
    max_len_b: int = 20
    max_pred: int = 20
    dtype: str = "bfloat16"

    # settings of the source this model takes only at these values
    FIXED = {"q_lora_rank": None, "scoring_func": "sigmoid",
             "topk_method": "noaux_tc", "n_group": 1, "topk_group": 1,
             "hidden_act": "silu", "moe_layer_freq": 1, "rope_scaling": None,
             "attention_bias": False, "tie_word_embeddings": False,
             "norm_topk_prob": True, "seq_aux": True,
             "hidden_dropout_prob": 0.0, "attention_probs_dropout_prob": 0.0}

    def __post_init__(self):
        if self.n_routed_experts % self.n_routed_experts_held:
            raise ValueError("the held experts must divide the routed ones")
        if not 0 <= self.ep_rank < self.ep_size:
            raise ValueError(f"ep_rank {self.ep_rank} outside 0..{self.ep_size}")

    @property
    def ep_size(self) -> int:
        return self.n_routed_experts // self.n_routed_experts_held

    @property
    def qk_head_dim(self) -> int:
        return self.qk_nope_head_dim + self.qk_rope_head_dim

    @property
    def held(self) -> range:
        n = self.n_routed_experts_held
        return range(self.ep_rank * n, (self.ep_rank + 1) * n)

    @property
    def prefix_len(self) -> int:
        return self.len_vis_input + 2

    @property
    def seq_len(self) -> int:
        return self.vlp_config().seq_len

    @classmethod
    def from_dict(cls, d: dict) -> "KimiVLConfig":
        """The configuration from a json dict; keys it does not model are
        ignored, and a key that sets a mechanism this model does not have
        raises."""
        for k, want in cls.FIXED.items():
            if k in d and d[k] != want:
                raise ValueError(f"{MODEL_TYPE}: {k} = {d[k]!r} is not "
                                 f"supported (only {want!r})")
        known = {f.name for f in dataclasses.fields(cls)}
        return cls(**{k: v for k, v in d.items() if k in known})

    @classmethod
    def from_json_file(cls, path: str) -> "KimiVLConfig":
        with open(path, encoding="utf-8") as f:
            return cls.from_dict(json.load(f))

    def vlp_config(self) -> VLPConfig:
        """The geometry VLP's example builder and loader read: the same
        vocabulary, regions, caption budget and masked positions."""
        return VLPConfig(
            vocab_size=self.vocab_size, hidden_size=self.hidden_size,
            num_hidden_layers=self.num_hidden_layers,
            num_attention_heads=self.num_attention_heads,
            intermediate_size=self.intermediate_size,
            hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0,
            type_vocab_size=6, relax_projection=0,
            len_vis_input=self.len_vis_input, vis_feat_dim=self.vis_feat_dim,
            vis_cls_dim=self.vis_cls_dim, vis_pe_dim=self.vis_pe_dim,
            max_len_b=self.max_len_b, max_pred=self.max_pred,
            dtype=self.dtype)


def is_kimi_config(path: Optional[str]) -> bool:
    """Whether the json at ``path`` names this model (``model_type``)."""
    if not path:
        return False
    with open(path, encoding="utf-8") as f:
        return json.load(f).get("model_type") == MODEL_TYPE


# ----------------------------------------------------------------------
# pieces
# ----------------------------------------------------------------------

def _linear(w: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """A product in the activation dtype, the fp32 weight cast per call."""
    return F.linear(x, w.to(x.dtype))


class RMSNorm(nn.Module):
    def __init__(self, n: int, eps: float):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(n))
        self.eps = eps

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """fp32 arithmetic, the result in x's dtype."""
        xf = x.float()
        xf = xf * torch.rsqrt(xf.pow(2).mean(-1, keepdim=True) + self.eps)
        return (self.weight * xf).to(x.dtype)


def rope_tables(L: int, dim: int, theta: float, device):
    """fp32 (cos, sin) [L, dim] of positions 0..L-1."""
    inv = 1.0 / (theta ** (torch.arange(0, dim, 2, device=device,
                                        dtype=torch.float32) / dim))
    freqs = torch.outer(torch.arange(L, device=device, dtype=torch.float32),
                        inv)
    emb = torch.cat([freqs, freqs], dim=-1)
    return emb.cos(), emb.sin()


def apply_rope(x: torch.Tensor, cos: torch.Tensor,
               sin: torch.Tensor) -> torch.Tensor:
    """RoPE on x [B, L, heads, d] as DeepSeek-V3's code applies it: the
    interleaved pairs (0, 1), (2, 3) .. first regrouped into halves, then
    x cos + rotate_half(x) sin, in fp32; the result in x's dtype."""
    B, L, h, d = x.shape
    xf = x.float().view(B, L, h, d // 2, 2).transpose(-1, -2).reshape(
        B, L, h, d)
    rot = torch.cat([-xf[..., d // 2:], xf[..., :d // 2]], dim=-1)
    c, s = cos[None, :, None, :], sin[None, :, None, :]
    return (xf * c + rot * s).to(x.dtype)


class SwiGLU(nn.Module):
    """down(silu(gate(x)) * up(x)), no biases."""

    def __init__(self, H: int, inter: int):
        super().__init__()
        self.gate_proj = nn.Linear(H, inter, bias=False)
        self.up_proj = nn.Linear(H, inter, bias=False)
        self.down_proj = nn.Linear(inter, H, bias=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        g = _linear(self.gate_proj.weight, x)
        u = _linear(self.up_proj.weight, x)
        return _linear(self.down_proj.weight, F.silu(g) * u)


class MLA(nn.Module):
    """Multi-head latent attention in its expanded training form."""

    def __init__(self, cfg: KimiVLConfig):
        super().__init__()
        self.cfg = cfg
        H, nh = cfg.hidden_size, cfg.num_attention_heads
        self.q_proj = nn.Linear(H, nh * cfg.qk_head_dim, bias=False)
        self.kv_a_proj_with_mqa = nn.Linear(
            H, cfg.kv_lora_rank + cfg.qk_rope_head_dim, bias=False)
        self.kv_a_layernorm = RMSNorm(cfg.kv_lora_rank, cfg.rms_norm_eps)
        self.kv_b_proj = nn.Linear(
            cfg.kv_lora_rank, nh * (cfg.qk_nope_head_dim + cfg.v_head_dim),
            bias=False)
        self.o_proj = nn.Linear(nh * cfg.v_head_dim, H, bias=False)

    def forward(self, x, mode, text_end, colkeep, rope) -> torch.Tensor:
        cfg = self.cfg
        B, L, _ = x.shape
        nh, dn, dr = (cfg.num_attention_heads, cfg.qk_nope_head_dim,
                      cfg.qk_rope_head_dim)
        q = _linear(self.q_proj.weight, x).view(B, L, nh, dn + dr)
        c, k_pe = _linear(self.kv_a_proj_with_mqa.weight, x).split(
            [cfg.kv_lora_rank, dr], dim=-1)
        kv = _linear(self.kv_b_proj.weight, self.kv_a_layernorm(c)).view(
            B, L, nh, dn + cfg.v_head_dim)
        k_nope, v = kv.split([dn, cfg.v_head_dim], dim=-1)
        q_nope, q_pe = q.split([dn, dr], dim=-1)
        q_pe = apply_rope(q_pe, *rope)
        k_pe = apply_rope(k_pe.view(B, L, 1, dr), *rope)
        q = torch.cat([q_nope, q_pe], dim=-1)
        k = torch.cat([k_nope, k_pe.expand(B, L, nh, dr)], dim=-1)
        o = attn_ops.FusedAttention.apply(q, k, v.contiguous(), mode,
                                          text_end, colkeep, cfg.prefix_len,
                                          0.0, None)
        return _linear(self.o_proj.weight, o.reshape(B, L, -1))


class Router(nn.Module):
    """Sigmoid scores over every routed expert and the selection bias."""

    def __init__(self, cfg: KimiVLConfig):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(cfg.n_routed_experts,
                                               cfg.hidden_size))
        self.register_buffer("e_score_correction_bias",
                             torch.zeros(cfg.n_routed_experts))


class HeldExperts(nn.Module):
    """This chip's routed experts, stacked: ``gate_up_proj`` [held, 2 I, H]
    (the gate's rows, then the up projection's), ``down_proj`` [held, H, I]."""

    def __init__(self, cfg: KimiVLConfig):
        super().__init__()
        n, H, inter = (cfg.n_routed_experts_held, cfg.hidden_size,
                       cfg.moe_intermediate_size)
        self.gate_up_proj = nn.Parameter(torch.empty(n, 2 * inter, H))
        self.down_proj = nn.Parameter(torch.empty(n, H, inter))


def grouped_mm(a: torch.Tensor, w: torch.Tensor,
               offs: torch.Tensor) -> torch.Tensor:
    """Rows a[offs[e-1]:offs[e]] times w[e]^T for each expert e (w
    [experts, N, K] fp32, cast to a's dtype), offsets on the device: one
    ``torch._grouped_mm`` for CUDA tensors (rows past the last offset are
    not computed: their values are undefined), a loop over the experts
    for CPU tensors (zeros there)."""
    w = w.to(a.dtype)
    if a.is_cuda:
        return torch._grouped_mm(a, w.transpose(-2, -1), offs=offs)
    ends = offs.tolist()
    parts, lo = [], 0
    for e, hi in enumerate(ends):
        parts.append(a[lo:hi] @ w[e].t())
        lo = hi
    parts.append(a.new_zeros(a.shape[0] - lo, w.shape[1]))
    return torch.cat(parts)


def sort_pairs(idx: torch.Tensor, held: range):
    """The picks idx [T, k] as (token, expert) pairs p = t k + j sorted by
    held expert, the others last (stable, on the device): (``order``, the
    pair of each sorted row; ``row_of``, its inverse, each pair's row; the
    rows of each held expert, int64; ``offs``, the end of each held
    expert's rows, int32).  A pair is held iff its row is below
    ``offs[-1]``."""
    n = len(held)
    local = idx.reshape(-1) - held.start
    key = torch.where((local >= 0) & (local < n), local, n)
    order = torch.sort(key, stable=True).indices
    counts = torch.zeros(n + 1, dtype=torch.int64,
                         device=idx.device).scatter_add_(
        0, key, torch.ones_like(key))[:n]
    row_of = torch.empty_like(order).scatter_(
        0, order, torch.arange(order.numel(), device=idx.device))
    return order, row_of, counts, torch.cumsum(counts, 0).to(torch.int32)


def _expert_rows(x, order, row_of, k, offs, gate_up, down):
    """The held experts' SwiGLU over their sorted rows [R, H]: row r < the
    held-row count ``offs[-1]`` is expert e's product of the token of pair
    ``order[r]`` (e's rows ending at ``offs[e]``); the rows past the count
    are undefined, and no pass here or in the backward reads them."""
    xg = moe_rows.GatherRows.apply(x, order, row_of, offs, k)
    h = moe_rows.SwiGLURows.apply(grouped_mm(xg, gate_up, offs), offs)
    return grouped_mm(h, down, offs)


class HeldRows(torch.autograd.Function):
    """The held experts' part of the layer, weighted and combined onto the
    tokens, plus ``base`` (the shared experts' output): y [T, H].  The
    intermediates are recomputed in the backward rather than kept: the
    rows are sized for the most pairs a layer can hold (tokens x min(k,
    held), 8x the even share at EP8), so the gathered rows and the two
    products' outputs would hold ~1.5 GB a layer at the Kimi cell's 128
    sequences."""

    @staticmethod
    def forward(ctx, x, order, row_of, k, offs, w, gate_up, down, base):
        ctx.save_for_backward(x, order, row_of, offs, w, gate_up, down)
        ctx.k = k
        with tracing.span("moe.experts", order.shape[0]):
            y_rows = _expert_rows(x, order, row_of, k, offs, gate_up, down)
        with tracing.span("moe.combine"):
            return moe_rows.combine(y_rows, w, row_of, offs, k, base)

    @staticmethod
    def backward(ctx, dy):
        x, order, row_of, offs, w, gate_up, down = ctx.saved_tensors
        dy = dy.contiguous()
        leaves = [t.detach().requires_grad_() for t in (x, gate_up, down)]
        with torch.enable_grad():
            y_rows = _expert_rows(leaves[0], order, row_of, ctx.k, offs,
                                  *leaves[1:])
        dy_rows, dw = moe_rows.combine_bwd(dy, y_rows.detach(), w, row_of,
                                           offs, ctx.k)
        dx, dgu, dd = torch.autograd.grad(y_rows, leaves, dy_rows)
        return dx, None, None, None, None, dw, dgu, dd, dy


class MoE(nn.Module):
    """The expert layer of one chip: routes over all experts, computes its
    held experts' part for the tokens routed to them, plus the shared
    experts on every token."""

    def __init__(self, cfg: KimiVLConfig):
        super().__init__()
        self.cfg = cfg
        self.gate = Router(cfg)
        self.experts = HeldExperts(cfg)
        self.shared_experts = SwiGLU(
            cfg.hidden_size, cfg.moe_intermediate_size * cfg.n_shared_experts)
        # picks of each expert this step, and rows each held expert took
        # (counters, not checkpointed)
        self.register_buffer("load", torch.zeros(cfg.n_routed_experts),
                             persistent=False)
        self.register_buffer("rows", torch.zeros(
            cfg.n_routed_experts_held, dtype=torch.int64), persistent=False)
        # rows of the buffer: R a training step, of which ``rows`` were held
        self.register_buffer("buffer_rows", torch.zeros((), dtype=torch.int64),
                             persistent=False)

    def route(self, x: torch.Tensor):
        """(top-k expert ids [T, k], their weights fp32 [T, k], the sigmoid
        scores fp32 [T, E]) of the rows x [T, H]."""
        cfg = self.cfg
        scores = torch.sigmoid(F.linear(x.float(), self.gate.weight))
        pick = scores.detach() + self.gate.e_score_correction_bias
        idx = torch.topk(pick, cfg.num_experts_per_tok, dim=-1).indices
        w = scores.gather(1, idx)
        w = w / (w.sum(dim=-1, keepdim=True) + 1e-20)
        return idx, w * cfg.routed_scaling_factor, scores

    def balance_loss(self, idx: torch.Tensor, scores: torch.Tensor,
                     B: int) -> torch.Tensor:
        """DeepSeek-V3's sequence-wise balance loss: alpha times, per
        sequence, sum_i f_i P_i with f_i = E / (k T) x the picks of expert
        i and P_i the mean over the sequence of its normalised score;
        averaged over the sequences."""
        cfg = self.cfg
        E, k = cfg.n_routed_experts, cfg.num_experts_per_tok
        T = idx.shape[0] // B
        picks = torch.zeros(B, E, device=idx.device).scatter_add_(
            1, idx.view(B, T * k), torch.ones(B, T * k, device=idx.device))
        f = picks * (E / (k * T))
        p = (scores / scores.sum(dim=-1, keepdim=True)).view(B, T, E).mean(1)
        return cfg.aux_loss_alpha * (f * p).sum(dim=-1).mean()

    def forward(self, x: torch.Tensor):
        """(the layer's output [B, L, H], the balance loss or None outside
        training)."""
        cfg = self.cfg
        B, L, H = x.shape
        T, k, n = B * L, cfg.num_experts_per_tok, cfg.n_routed_experts_held
        xt = x.reshape(T, H)
        with tracing.span("moe.route"):
            idx, w, scores = self.route(xt)
            aux = None
            if self.training:
                aux = self.balance_loss(idx, scores, B)
                with torch.no_grad():
                    self.load += torch.zeros_like(self.load).scatter_add_(
                        0, idx.reshape(-1),
                        torch.ones(T * k, device=x.device))
        R = T * min(k, n)   # the most (token, held expert) pairs
        with tracing.span("moe.dispatch"):
            order, row_of, counts, offs = sort_pairs(idx, cfg.held)
            if self.training:
                with torch.no_grad():
                    self.rows += counts
                    self.buffer_rows += R
        y = HeldRows.apply(xt, order[:R], row_of, k, offs, w.contiguous(),
                           self.experts.gate_up_proj, self.experts.down_proj,
                           self.shared_experts(xt))
        return y.view(B, L, H), aux

    @torch.no_grad()
    def update_bias(self) -> None:
        """bias += speed * sign(mean load - load), then the load is
        cleared (after each optimizer step)."""
        self.gate.e_score_correction_bias.add_(
            self.cfg.bias_update_speed
            * torch.sign(self.load.mean() - self.load))
        self.load.zero_()


class DecoderLayer(nn.Module):
    def __init__(self, cfg: KimiVLConfig, i: int):
        super().__init__()
        self.input_layernorm = RMSNorm(cfg.hidden_size, cfg.rms_norm_eps)
        self.self_attn = MLA(cfg)
        self.post_attention_layernorm = RMSNorm(cfg.hidden_size,
                                                cfg.rms_norm_eps)
        self.mlp = (SwiGLU(cfg.hidden_size, cfg.intermediate_size)
                    if i < cfg.first_k_dense_replace else MoE(cfg))

    def forward(self, x, mode, text_end, colkeep, rope):
        with tracing.span("attn.mla"):
            x = x + self.self_attn(self.input_layernorm(x), mode, text_end,
                                   colkeep, rope)
        h = self.post_attention_layernorm(x)
        if isinstance(self.mlp, MoE):
            y, aux = self.mlp(h)
        else:
            y, aux = self.mlp(h), None
        return x + y, aux


class KimiVLModel(nn.Module):
    """VLP's region MLPs, Kimi-VL's language model (this chip's share) and
    its head; trains through ``train_step`` as ``VLPModel`` does
    (:meth:`pretrain_losses`, :meth:`after_step`)."""

    tp_fold = None       # no tensor parallelism

    def __init__(self, cfg: KimiVLConfig):
        super().__init__()
        self.cfg = cfg
        self.dtype = torch_dtype(cfg.dtype)
        H = cfg.hidden_size
        self.embed_tokens = nn.Embedding(cfg.vocab_size, H)
        self.vis_embed = nn.Sequential(
            nn.Linear(cfg.vis_feat_dim, cfg.vis_feat_dim), nn.ReLU(),
            nn.Linear(cfg.vis_feat_dim, H), nn.ReLU())
        self.vis_pe_embed = nn.Sequential(nn.Linear(cfg.vis_pe_dim, H),
                                          nn.ReLU())
        self.layers = nn.ModuleList(DecoderLayer(cfg, i)
                                    for i in range(cfg.num_hidden_layers))
        self.norm = RMSNorm(H, cfg.rms_norm_eps)
        self.lm_head = nn.Linear(H, cfg.vocab_size, bias=False)

    @property
    def moe_layers(self) -> List[MoE]:
        return [l.mlp for l in self.layers if isinstance(l.mlp, MoE)]

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> None:
        """Matrices, stacked experts and tables N(0, initializer_range),
        biases 0, RMSNorm scales 1, selection biases 0."""
        std = self.cfg.initializer_range
        for n, p in self.named_parameters():
            if p.dim() >= 2:
                p.normal_(0.0, std, generator=generator)
            else:
                p.fill_(1.0 if n.endswith("norm.weight") else 0.0)
        for m in self.moe_layers:
            m.gate.e_score_correction_bias.zero_()

    def align_replicated_grads(self) -> None:
        """Nothing: no tensor parallelism."""

    def embed(self, input_ids, vis_feats, vis_pe) -> torch.Tensor:
        """Word rows with the projected regions in slots 1..nv."""
        dt = self.dtype
        nv = self.cfg.len_vis_input
        words = F.embedding(input_ids.long(), self.embed_tokens.weight.to(dt))
        f = vis_feats.to(dt)
        f = F.relu(F.linear(F.relu(F.linear(
            f, self.vis_embed[0].weight.to(dt), self.vis_embed[0].bias.to(dt))),
            self.vis_embed[2].weight.to(dt), self.vis_embed[2].bias.to(dt)))
        p = F.relu(F.linear(vis_pe.to(dt), self.vis_pe_embed[0].weight.to(dt),
                            self.vis_pe_embed[0].bias.to(dt)))
        return torch.cat([words[:, :1], f + p, words[:, nv + 1:]], dim=1)

    def hidden(self, batch) -> tuple:
        """(the last layer's output [B, L, H], the summed balance loss or
        None)."""
        ids = batch["input_ids"]
        B, L = ids.shape
        x = self.embed(ids, batch["vis_feats"], batch["vis_pe"])
        rope = rope_tables(L, self.cfg.qk_rope_head_dim, self.cfg.rope_theta,
                           ids.device)
        colkeep = torch.ones((B, L), dtype=torch.float32, device=ids.device)
        aux = None
        for layer in self.layers:
            x, a = layer(x, batch["mode"], batch["text_end"], colkeep, rope)
            if a is not None:
                aux = a if aux is None else aux + a
        return x, aux

    def pretrain_losses(self, batch: Dict[str, torch.Tensor], *, drop=None,
                        drop_worst_ratio: float = 0.0,
                        mask_image_regions: bool = False,
                        task: str = "img2txt") -> Dict[str, torch.Tensor]:
        """VLP's masked-LM loss over the gathered ``masked_pos`` through
        the final RMSNorm and the untied head (fp32 logits), plus the
        balance loss in training; ``drop`` is unused (dropout 0)."""
        if task != "img2txt" or mask_image_regions:
            raise ValueError(f"{MODEL_TYPE} trains the caption task "
                             "(img2txt) without region masking")
        x, aux = self.hidden(batch)
        pos = batch["masked_pos"].long()
        h = torch.gather(x, 1, pos[:, :, None].expand(-1, -1, x.shape[-1]))
        logits = _linear(self.lm_head.weight, self.norm(h)).float()
        per_pos = losses_lib.mlm_position_loss(
            logits, batch["masked_ids"], 0.0, self.cfg.vocab_size)
        mlm = losses_lib.mask_and_normalize_loss(
            per_pos, batch["masked_weights"], drop_worst_ratio)
        aux = torch.zeros((), device=x.device) if aux is None else aux
        return {"loss": mlm + aux, "masked_lm_loss": mlm, "aux_loss": aux}

    def after_step(self, dist=None) -> None:
        """The selection biases' update from the step's load (inside a
        captured step too: device ops only); over data-parallel ranks
        (``dist``) from the load summed over them, so that every rank
        moves its biases alike."""
        layers = self.moe_layers
        if dist is not None and dist.dp_grouped:
            import torch.distributed as tdist
            loads = torch.stack([m.load for m in layers])
            tdist.all_reduce(loads, group=dist.dp_group)
            for m, load in zip(layers, loads):
                m.load.copy_(load)
        for m in layers:
            m.update_bias()

    @torch.no_grad()
    def selections(self, batch) -> List[torch.Tensor]:
        """Each MoE layer's top-k expert ids [B * L, k] in a deterministic
        forward of ``batch`` (the routing the next training step takes;
        nothing counted)."""
        was, out = self.training, []
        hooks = [m.register_forward_hook(
            lambda mod, inp, _: out.append(mod.route(
                inp[0].reshape(-1, inp[0].shape[-1]))[0]))
            for m in self.moe_layers]
        try:
            self.eval()
            self.hidden(batch)
        finally:
            for h in hooks:
                h.remove()
            self.train(was)
        return out

    def rows_per_expert(self) -> torch.Tensor:
        """int64 [MoE layers, held]: the rows each held expert took in
        training since the counters were last cleared (device)."""
        return torch.stack([m.rows for m in self.moe_layers])

    def read_rows_per_expert(self) -> List[List[int]]:
        """:meth:`rows_per_expert` on the host (one sync), each also kept
        as the counter ``moe.rows_per_expert.<layer>.<expert>``, and each
        layer's ``buffer_rows`` as ``moe.buffer_rows.<layer>``: over the
        same steps, the held rows over the buffer's is the share of the
        buffer that the row passes touched."""
        both = torch.cat([self.rows_per_expert(), torch.stack(
            [m.buffer_rows for m in self.moe_layers])[:, None]], 1).tolist()
        for layer, counts in zip((i for i, l in enumerate(self.layers)
                                  if isinstance(l.mlp, MoE)), both):
            for e, n in enumerate(counts[:-1]):
                tracing.counter(f"moe.rows_per_expert.{layer}.{e}", n)
            tracing.counter(f"moe.buffer_rows.{layer}", counts[-1])
        return [counts[:-1] for counts in both]
