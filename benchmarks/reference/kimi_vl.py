"""Kimi-VL-A3B's language model (``moonshotai/Kimi-VL-A3B-Instruct``,
``config.json``; the DeepSeek-V3 block, arXiv:2412.19437) in plain PyTorch
and float32, as VLP's caption fine-tune trains it: the loss of a training
forward, the routing it takes and the load that moves the routers'
selection biases.  It reads nothing of the program and runs no kernel;
``no_tf32`` keeps every float32 product in float32.

It works over a dict of weights under the program's state-dict names
(``layers.{i}.self_attn.q_proj.weight`` ...; :func:`param_shapes`), made by
:func:`make_weights` from a seed, and the selection biases
(``layers.{i}.mlp.gate.e_score_correction_bias``) apart from them.

The layer equations, uncut:

* h = RMSNorm(x) (eps from the configuration), pre-norm residuals;
* MLA: q = h Wq (heads of 128 + 64), [c, k_r] = h Wkv_a (512 + 64, k_r
  one key shared by every head), [k_c, v] = RMSNorm(c) Wkv_b (heads of
  128 + 128); RoPE (DeepSeek-V3's interleaved pairs, theta from the
  configuration) on q's and k_r's 64 columns at positions 0..L-1; scores
  q.k / sqrt(192) plus -10000 where VLP's s2s / bi mask hides a key;
  softmax; P v; then Wo;
* layer 0: SwiGLU, down(silu(gate h) * up h); each later layer: sigmoid
  scores s = sigmoid(h Wr^T) over all experts, the top k of s + bias, the
  picked scores normalised to sum 1 times the scaling factor, and the sum
  over the picked experts this chip holds of weight x SwiGLU_e(h), by a
  loop over the held experts, plus the shared experts' SwiGLU on every
  token;
* the loss: VLP's masked-LM (the gathered positions through the final
  RMSNorm and the head, log-softmax, the weighted mean over the masked
  positions) plus, per MoE layer, the sequence-wise balance loss alpha x
  mean over sequences of sum_i f_i P_i (f_i = E / (k T) x picks of expert
  i, P_i the sequence's mean of s_i / sum_j s_j);
* after each optimizer step, bias += gamma x sign(mean load - load), the
  load being every expert's picks in the step.

Departures from Kimi-VL are the program's (``vlp_tpu_torch/models/
kimi_vl.py``): VLP's objective and regions, no vision tower, this chip's
share of the experts and a slice of the vocabulary, padded positions
routed like tokens.  ``capacity_factor`` is not the model's: it drops each
held expert's rows past that factor of its even share (in token order),
the fault a dropping expert layer would have.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

import torch
import torch.nn.functional as F

from benchmarks.reference.model import NEG, Precision, _visible, no_tf32

__all__ = ["Precision", "no_tf32", "param_shapes", "make_weights",
           "bias_names", "moe_layers", "held", "forward", "update_biases",
           "selection_mismatch"]


def moe_layers(cfg: dict) -> List[int]:
    return list(range(cfg["first_k_dense_replace"],
                      cfg["num_hidden_layers"]))


def held(cfg: dict) -> range:
    n = cfg["n_routed_experts_held"]
    r = cfg.get("ep_rank", 0)
    return range(r * n, (r + 1) * n)


def param_shapes(cfg: dict) -> Dict[str, tuple]:
    """Every trainable weight, name -> shape, in the program's order."""
    H, V = cfg["hidden_size"], cfg["vocab_size"]
    nh, dn, dr, dv = (cfg["num_attention_heads"], cfg["qk_nope_head_dim"],
                      cfg["qk_rope_head_dim"], cfg["v_head_dim"])
    r, fd, pd = cfg["kv_lora_rank"], cfg["vis_feat_dim"], cfg["vis_pe_dim"]
    I, n = cfg["moe_intermediate_size"], cfg["n_routed_experts_held"]
    s = {"embed_tokens.weight": (V, H),
         "vis_embed.0.weight": (fd, fd), "vis_embed.0.bias": (fd,),
         "vis_embed.2.weight": (H, fd), "vis_embed.2.bias": (H,),
         "vis_pe_embed.0.weight": (H, pd), "vis_pe_embed.0.bias": (H,)}
    for i in range(cfg["num_hidden_layers"]):
        p = f"layers.{i}."
        s[p + "input_layernorm.weight"] = (H,)
        s[p + "self_attn.q_proj.weight"] = (nh * (dn + dr), H)
        s[p + "self_attn.kv_a_proj_with_mqa.weight"] = (r + dr, H)
        s[p + "self_attn.kv_a_layernorm.weight"] = (r,)
        s[p + "self_attn.kv_b_proj.weight"] = (nh * (dn + dv), r)
        s[p + "self_attn.o_proj.weight"] = (H, nh * dv)
        s[p + "post_attention_layernorm.weight"] = (H,)
        if i < cfg["first_k_dense_replace"]:
            F_ = cfg["intermediate_size"]
            s[p + "mlp.gate_proj.weight"] = (F_, H)
            s[p + "mlp.up_proj.weight"] = (F_, H)
            s[p + "mlp.down_proj.weight"] = (H, F_)
        else:
            S = I * cfg["n_shared_experts"]
            s[p + "mlp.gate.weight"] = (cfg["n_routed_experts"], H)
            s[p + "mlp.experts.gate_up_proj"] = (n, 2 * I, H)
            s[p + "mlp.experts.down_proj"] = (n, H, I)
            s[p + "mlp.shared_experts.gate_proj.weight"] = (S, H)
            s[p + "mlp.shared_experts.up_proj.weight"] = (S, H)
            s[p + "mlp.shared_experts.down_proj.weight"] = (H, S)
    s["norm.weight"] = (H,)
    s["lm_head.weight"] = (V, H)
    return s


def bias_names(cfg: dict) -> List[str]:
    return [f"layers.{i}.mlp.gate.e_score_correction_bias"
            for i in moe_layers(cfg)]


def make_weights(cfg: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """name -> fp32 tensor: every matrix, stacked expert and table N(0,
    initializer_range) from one flat buffer drawn by one device generator,
    biases 0, RMSNorm scales 1.  The program and the reference get the
    same values from the same seed."""
    shapes = param_shapes(cfg)
    mats = [n for n, s in shapes.items() if len(s) >= 2]
    total = sum(math.prod(shapes[n]) for n in mats)
    g = torch.Generator(device=device).manual_seed(seed)
    flat = torch.empty(total, device=device)
    flat.normal_(0.0, cfg["initializer_range"], generator=g)
    out, at = {}, 0
    for n in mats:
        k = math.prod(shapes[n])
        out[n] = flat[at:at + k].view(shapes[n])
        at += k
    for n, s in shapes.items():
        if len(s) == 1:
            out[n] = (torch.ones if n.endswith("norm.weight")
                      else torch.zeros)(s, device=device)
    return {n: out[n] for n in shapes}


def _rms(x, w, eps):
    return w * (x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps))


def _rope(x, L, dim, theta):
    """x [B, L, h, dim]: DeepSeek-V3's interleaved pairs regrouped into
    halves, then x cos + rotate_half(x) sin at positions 0..L-1."""
    B, _, h, d = x.shape
    inv = 1.0 / (theta ** (torch.arange(0, dim, 2, device=x.device,
                                        dtype=torch.float32) / dim))
    freqs = torch.outer(torch.arange(L, device=x.device,
                                     dtype=torch.float32), inv)
    emb = torch.cat([freqs, freqs], -1)
    cos, sin = emb.cos()[None, :, None], emb.sin()[None, :, None]
    x = x.view(B, L, h, d // 2, 2).transpose(-1, -2).reshape(B, L, h, d)
    rot = torch.cat([-x[..., d // 2:], x[..., :d // 2]], -1)
    return x * cos + rot * sin


def _swiglu(x, wg, wu, wd, q):
    return F.linear(q(F.silu(F.linear(q(x), q(wg))) * F.linear(q(x), q(wu))),
                    q(wd))


def _attention(W, cfg, p, h, bias, q):
    B, L, _ = h.shape
    nh, dn, dr, dv = (cfg["num_attention_heads"], cfg["qk_nope_head_dim"],
                      cfg["qk_rope_head_dim"], cfg["v_head_dim"])
    r, eps = cfg["kv_lora_rank"], cfg["rms_norm_eps"]
    qh = F.linear(q(h), q(W[p + "q_proj.weight"])).view(B, L, nh, dn + dr)
    kv_a = F.linear(q(h), q(W[p + "kv_a_proj_with_mqa.weight"]))
    c, k_r = kv_a[..., :r], kv_a[..., r:]
    kv = F.linear(q(_rms(c, W[p + "kv_a_layernorm.weight"], eps)),
                  q(W[p + "kv_b_proj.weight"])).view(B, L, nh, dn + dv)
    k_c, v = kv[..., :dn], kv[..., dn:]
    q_r = _rope(qh[..., dn:], L, dr, cfg["rope_theta"])
    k_r = _rope(k_r.reshape(B, L, 1, dr), L, dr, cfg["rope_theta"])
    qf = torch.cat([qh[..., :dn], q_r], -1)
    kf = torch.cat([k_c, k_r.expand(B, L, nh, dr)], -1)
    s = torch.einsum("blhd,bmhd->bhlm", q(qf), q(kf)) / math.sqrt(dn + dr)
    probs = torch.softmax(s + bias[:, None], dim=-1)
    o = torch.einsum("bhlm,bmhd->blhd", q(probs), q(v)).reshape(B, L, -1)
    return F.linear(q(o), q(W[p + "o_proj.weight"]))


def _moe(W, cfg, p, h, sel_bias, q, capacity_factor):
    """(output [B, L, H], balance loss per sequence [B], picks per expert
    [E], top-k ids [T, k])."""
    B, L, H = h.shape
    T, E, k = B * L, cfg["n_routed_experts"], cfg["num_experts_per_tok"]
    x = h.reshape(T, H)
    scores = torch.sigmoid(F.linear(x, W[p + "gate.weight"]))
    idx = torch.topk(scores.detach() + sel_bias, k, dim=-1).indices
    w = scores.gather(1, idx)
    w = w / (w.sum(-1, keepdim=True) + 1e-20) * cfg["routed_scaling_factor"]
    picks = torch.zeros(B, E, device=h.device).scatter_add_(
        1, idx.view(B, L * k), torch.ones(B, L * k, device=h.device))
    f = picks * (E / (k * L))
    P = (scores / scores.sum(-1, keepdim=True)).view(B, L, E).mean(1)
    seq_aux = cfg["aux_loss_alpha"] * (f * P).sum(-1)
    y = torch.zeros_like(x)
    gu, dn = W[p + "experts.gate_up_proj"], W[p + "experts.down_proj"]
    I = cfg["moe_intermediate_size"]
    cap = (None if capacity_factor is None
           else math.ceil(capacity_factor * T * k / E))
    for j, e in enumerate(held(cfg)):
        hit = idx == e
        tok = torch.nonzero(hit.any(-1)).squeeze(-1)
        if cap is not None:
            tok = tok[:cap]
        if not len(tok):
            continue
        we = (w * hit).sum(-1)[tok]
        out = _swiglu(x[tok], gu[j, :I], gu[j, I:], dn[j], q)
        y = y.index_add(0, tok, we[:, None] * out)
    y = y + _swiglu(x, W[p + "shared_experts.gate_proj.weight"],
                    W[p + "shared_experts.up_proj.weight"],
                    W[p + "shared_experts.down_proj.weight"], q)
    return y.view(B, L, H), seq_aux, picks.sum(0), idx


def forward(W: Dict[str, torch.Tensor], cfg: dict, batch,
            biases: Dict[str, torch.Tensor], *, q: Precision,
            weight_total: float, seqs_total: int,
            capacity_factor: Optional[float] = None) -> dict:
    """One training forward over ``batch`` (built batches on the device,
    ``reference.data.train_batch``), a block of a step's sequences: its
    share of the step's loss (the masked-LM sum over the step's total mask
    weight ``weight_total``, the balance losses summed over the step's
    ``seqs_total`` sequences), so that the blocks' losses and gradients
    add up to the step's; with each MoE layer's picks per expert
    (``load``, {bias name: [E]}) and top-k ids (``selections``)."""
    ids = batch["input_ids"]
    B, L = ids.shape
    nv, eps = cfg["len_vis_input"], cfg["rms_norm_eps"]
    words = F.embedding(ids, q(W["embed_tokens.weight"]))
    f = F.relu(F.linear(q(F.relu(F.linear(
        q(batch["vis_feats"]), q(W["vis_embed.0.weight"]),
        W["vis_embed.0.bias"]))), q(W["vis_embed.2.weight"]),
        W["vis_embed.2.bias"]))
    pe = F.relu(F.linear(q(batch["vis_pe"]), q(W["vis_pe_embed.0.weight"]),
                         W["vis_pe_embed.0.bias"]))
    x = torch.cat([words[:, :1], f + pe, words[:, nv + 1:]], 1)
    vis = _visible(batch["mode"], batch["text_end"], nv + 2, L)
    bias = torch.where(vis, 0.0, NEG)
    aux = torch.zeros((), device=ids.device)
    load, selections = {}, {}
    for i in range(cfg["num_hidden_layers"]):
        p = f"layers.{i}."
        x = q(x + _attention(W, cfg, p + "self_attn.",
                             _rms(x, W[p + "input_layernorm.weight"], eps),
                             bias, q))
        h = _rms(x, W[p + "post_attention_layernorm.weight"], eps)
        if i < cfg["first_k_dense_replace"]:
            y = _swiglu(h, W[p + "mlp.gate_proj.weight"],
                        W[p + "mlp.up_proj.weight"],
                        W[p + "mlp.down_proj.weight"], q)
        else:
            name = p + "mlp.gate.e_score_correction_bias"
            y, seq_aux, load[name], selections[name] = _moe(
                W, cfg, p + "mlp.", h, biases[name], q, capacity_factor)
            aux = aux + seq_aux.sum() / seqs_total
        x = q(x + y)
    hid = torch.gather(x, 1, batch["masked_pos"][:, :, None].expand(
        -1, -1, x.shape[-1]))
    hid = _rms(hid, W["norm.weight"], eps)
    logp = torch.log_softmax(F.linear(q(hid), q(W["lm_head.weight"])), -1)
    tgt = torch.gather(logp, -1, batch["masked_ids"][..., None])[..., 0]
    mlm = (-tgt * batch["masked_weights"]).sum() / (weight_total + 1e-5)
    return {"loss": mlm + aux, "load": load, "selections": selections}


@torch.no_grad()
def update_biases(cfg: dict, biases: Dict[str, torch.Tensor],
                  load: Dict[str, torch.Tensor]) -> None:
    """bias += gamma sign(mean load - load), each MoE layer, the load
    being the step's picks per expert."""
    for n, b in biases.items():
        b.add_(cfg["bias_update_speed"] * torch.sign(load[n].mean() - load[n]))


def selection_mismatch(a: torch.Tensor, b: torch.Tensor) -> float:
    """The share of (token, expert) pairs of the top-k ids ``a`` [T, k]
    that ``b`` [T, k] does not pick."""
    same = (a[:, :, None] == b[:, None, :]).any(-1)
    return float((~same).float().mean())
