"""The VLP transformer in plain PyTorch and float32 (Zhou et al., "Unified
Vision-Language Pre-Training for Image Captioning and VQA", AAAI 2020;
BERT-base, post-LN): the training losses (masked-LM over the caption, or
the VQA answer BCE), and the log-probabilities of a caption under the
decoder's visibility, for judging a served caption.

It works over a dict of weights under the reference checkpoint's names
(``bert.encoder.layer.{i}.attention.self.query.weight`` ...), made by the
benchmark (``benchmarks/weights.py``), and reads nothing of the program.
Every product runs in float32 with TF32 off (``no_tf32``).

``Precision`` rounds the operands of every product and the activations
between the layers; ``Precision("fp8")`` (e4m3, one scale per tensor) is
the control that a check has to fail: the step below the configuration's
bfloat16.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional

import torch
import torch.nn.functional as F

from benchmarks.reference import philox

LN_EPS = 1e-5
NEG = -10000.0


def no_tf32() -> None:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


class Precision:
    """Rounding of products' operands and stored activations: ``"fp32"``
    leaves them as they are; ``"fp8"`` rounds each tensor to float8 e4m3
    with one scale (its largest magnitude over 448), the gradient passing
    straight through."""

    def __init__(self, kind: str = "fp32"):
        if kind not in ("fp32", "fp8"):
            raise ValueError(f"unknown precision {kind!r}")
        self.kind = kind

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        if self.kind == "fp32":
            return x
        with torch.no_grad():
            scale = x.detach().abs().amax().clamp(min=1e-30) / 448.0
            r = (x.detach() / scale).to(torch.float8_e4m3fn).float() * scale
        return x + (r - x).detach()


def param_shapes(cfg: dict, with_vqa: bool) -> Dict[str, tuple]:
    """Every trainable weight of the model, name -> shape, in the order of
    the reference checkpoint; the MLM decoder's weight is the word table
    and is not listed again."""
    H, F_, V = cfg["hidden_size"], cfg["intermediate_size"], cfg["vocab_size"]
    fd, pd = cfg["vis_feat_dim"], cfg["vis_pe_dim"]
    r = max(cfg["relax_projection"], 1)
    s = {"bert.embeddings.word_embeddings.weight": (V, H),
         "bert.embeddings.position_embeddings.weight":
             (cfg["max_position_embeddings"], H),
         "bert.embeddings.token_type_embeddings.weight":
             (cfg["type_vocab_size"], H),
         "bert.embeddings.LayerNorm.weight": (H,),
         "bert.embeddings.LayerNorm.bias": (H,)}
    for i in range(cfg["num_hidden_layers"]):
        p = f"bert.encoder.layer.{i}."
        for n in ("query", "key", "value"):
            s[p + f"attention.self.{n}.weight"] = (H, H)
            s[p + f"attention.self.{n}.bias"] = (H,)
        s[p + "attention.output.dense.weight"] = (H, H)
        s[p + "attention.output.dense.bias"] = (H,)
        s[p + "attention.output.LayerNorm.weight"] = (H,)
        s[p + "attention.output.LayerNorm.bias"] = (H,)
        s[p + "intermediate.dense.weight"] = (F_, H)
        s[p + "intermediate.dense.bias"] = (F_,)
        s[p + "output.dense.weight"] = (H, F_)
        s[p + "output.dense.bias"] = (H,)
        s[p + "output.LayerNorm.weight"] = (H,)
        s[p + "output.LayerNorm.bias"] = (H,)
    s["bert.pooler.dense.weight"] = (H, H)
    s["bert.pooler.dense.bias"] = (H,)
    s["cls.predictions.bias"] = (V,)
    s["cls.predictions.transform.dense.weight"] = (H * r, H)
    s["cls.predictions.transform.dense.bias"] = (H * r,)
    s["cls.predictions.transform.LayerNorm.weight"] = (H * r,)
    s["cls.predictions.transform.LayerNorm.bias"] = (H * r,)
    s["vis_embed.0.weight"] = (fd, fd)
    s["vis_embed.0.bias"] = (fd,)
    s["vis_embed.2.weight"] = (H, fd)
    s["vis_embed.2.bias"] = (H,)
    s["vis_pe_embed.0.weight"] = (H, pd)
    s["vis_pe_embed.0.bias"] = (H,)
    if with_vqa:
        s["ans_classifier.0.weight"] = (2 * H, H)
        s["ans_classifier.0.bias"] = (2 * H,)
        s["ans_classifier.2.weight"] = (cfg["num_answers"], 2 * H)
        s["ans_classifier.2.bias"] = (cfg["num_answers"],)
    return s


class Dropout:
    """The masks of one training forward, from its step seed: hidden
    dropout from a device generator seeded with the seed's first draw, in
    the order the forward drops (region features, geometry, embeddings,
    then each layer's attention output and FFN output); attention dropout
    from Philox under each layer's own draw."""

    def __init__(self, seed: int, rate: float, n_layers: int, device):
        hidden, self.attn = philox.forward_seeds(seed, n_layers)
        self.gen = torch.Generator(device=device)
        self.gen.manual_seed(hidden)
        self.rate = rate

    def hidden(self, x: torch.Tensor) -> torch.Tensor:
        keep = torch.rand(x.shape, generator=self.gen,
                          device=x.device) < 1.0 - self.rate
        return torch.where(keep, x / (1.0 - self.rate), torch.zeros_like(x))


def _lin(W, name, x, q):
    b = W.get(name + ".bias")
    return F.linear(q(x), q(W[name + ".weight"]), b)


def _ln(W, name, x):
    return F.layer_norm(x, x.shape[-1:], W[name + ".weight"],
                        W[name + ".bias"], LN_EPS)


def _gelu(x):
    return x * 0.5 * (1.0 + torch.erf(x / math.sqrt(2.0)))


def _visible(mode, text_end, prefix: int, L: int) -> torch.Tensor:
    """bool [B, L, L]: bi rows see every column before text_end; s2s rows
    see the prompt, and caption rows the caption up to themselves."""
    i = torch.arange(L, device=mode.device)[:, None]
    j = torch.arange(L, device=mode.device)[None, :]
    te = text_end.long()[:, None, None]
    bi = j < te
    s2s = (j < prefix) | ((j >= prefix) & (j <= i) & (i[None] < te))
    return torch.where((mode == 1)[:, None, None], s2s, bi)


def _layer(W, cfg, i, x, bias, q, drop: Optional[Dropout],
           attn_scale=None):
    """One post-LN layer over rows ``x`` [B, R, H] attending to the keys
    and values of the same rows (``bias`` [B or 1, R, R] additive)."""
    p = f"bert.encoder.layer.{i}."
    B, R, Hd = x.shape
    nh = cfg["num_attention_heads"]
    D = Hd // nh
    qh, kh, vh = (_lin(W, p + f"attention.self.{n}", x, q).view(B, R, nh, D)
                  for n in ("query", "key", "value"))
    s = torch.einsum("blhd,bmhd->bhlm", q(qh), q(kh)) / math.sqrt(D)
    probs = torch.softmax(s + bias[:, None], dim=-1)
    if attn_scale is not None:
        probs = probs * attn_scale
    ctx = torch.einsum("bhlm,bmhd->blhd", q(probs), q(vh)).reshape(B, R, Hd)
    h = _lin(W, p + "attention.output.dense", ctx, q)
    if drop is not None:
        h = drop.hidden(h)
    h = q(_ln(W, p + "attention.output.LayerNorm", h + x))
    f = _gelu(_lin(W, p + "intermediate.dense", h, q))
    f = _lin(W, p + "output.dense", f, q)
    if drop is not None:
        f = drop.hidden(f)
    return q(_ln(W, p + "output.LayerNorm", f + h))


def _regions(W, vis_feats, vis_pe, q, drop):
    f = F.relu(_lin(W, "vis_embed.2",
                    F.relu(_lin(W, "vis_embed.0", vis_feats, q)), q))
    if drop is not None:
        f = drop.hidden(f)
    pe = F.relu(_lin(W, "vis_pe_embed.0", vis_pe, q))
    if drop is not None:
        pe = drop.hidden(pe)
    return f, pe


def train_loss(W: Dict[str, torch.Tensor], cfg: dict, batch, *, task: str,
               seed: Optional[int], q: Precision) -> torch.Tensor:
    """The loss of one training forward: ``batch`` holds the built batch
    on the device (``reference.data.train_batch``), ``seed`` the step's
    dropout seed (None: no dropout)."""
    ids, seg = batch["input_ids"], batch["segment_ids"]
    B, L = ids.shape
    nv = cfg["len_vis_input"]
    dev = ids.device
    rate_h = cfg["hidden_dropout_prob"]
    rate_a = cfg["attention_probs_dropout_prob"]
    nl = cfg["num_hidden_layers"]
    drop = None if seed is None else Dropout(seed, rate_h, nl, dev)
    f, pe = _regions(W, batch["vis_feats"], batch["vis_pe"], q, drop)
    words = F.embedding(ids, q(W["bert.embeddings.word_embeddings.weight"]))
    pos = F.embedding(torch.arange(L, device=dev).expand(B, L),
                      q(W["bert.embeddings.position_embeddings.weight"]))
    words = torch.cat([words[:, :1], f, words[:, nv + 1:]], dim=1)
    pos = torch.cat([pos[:, :1], pe, pos[:, nv + 1:]], dim=1)
    x = words + pos + F.embedding(
        seg, q(W["bert.embeddings.token_type_embeddings.weight"]))
    x = q(_ln(W, "bert.embeddings.LayerNorm", x))
    if drop is not None:
        x = drop.hidden(x)
    vis = _visible(batch["mode"], batch["text_end"], nv + 2, L)
    bias = torch.where(vis, 0.0, NEG)
    nh = cfg["num_attention_heads"]
    for i in range(nl):
        scale = (philox.keep_scale(drop.attn[i], B, nh, L, rate_a, dev)
                 if drop is not None and rate_a > 0 else None)
        x = _layer(W, cfg, i, x, bias, q, drop, scale)
    if task == "vqa2":
        e = x[:, 0] * x[:, nv + 1]
        h = F.relu(_lin(W, "ans_classifier.0", e, q))
        z = _lin(W, "ans_classifier.2", h, q)
        y = batch["ans_scores"]
        bce = z.clamp(min=0) - z * y + torch.log1p(torch.exp(-z.abs()))
        return bce.sum(-1).mean()
    hid = torch.gather(x, 1, batch["masked_pos"][:, :, None].expand(
        -1, -1, x.shape[-1]))
    logp = _mlm_logp(W, cfg, hid, q)
    tgt = torch.gather(logp, -1, batch["masked_ids"][..., None])[..., 0]
    w = batch["masked_weights"]
    return (-tgt * w).sum() / (w.sum() + 1e-5)


def _mlm_logp(W, cfg, hid, q):
    """log-softmax over the vocabulary of the MLM head at ``hid``."""
    if cfg["relax_projection"] > 1:
        raise NotImplementedError("relax projections are not in these "
                                  "configurations")
    h = _gelu(_lin(W, "cls.predictions.transform.dense", hid, q))
    h = q(_ln(W, "cls.predictions.transform.LayerNorm", h))
    logits = (q(h) @ q(W["bert.embeddings.word_embeddings.weight"]).t()
              + W["cls.predictions.bias"])
    return torch.log_softmax(logits, dim=-1)


@torch.no_grad()
def caption_logprobs(W: Dict[str, torch.Tensor], cfg: dict, prompt,
                     tokens: torch.Tensor, q: Precision) -> torch.Tensor:
    """fp32 [B, T]: log p(w_t | prompt, w_<t) of the caption ``tokens``
    [B, T] under the decoder's visibility, in one pass.  Rows are the
    prompt ``[CLS] regions [SEP]`` (P rows, seeing the prompt), the
    caption tokens w_0..w_{T-2} (seeing the prompt and w_<=t) and the
    probes m_0..m_{T-1}, [MASK] at position P + t (seeing the prompt,
    w_<t and itself); the log-probabilities are read at the probes.
    ``prompt``: input_ids [B, P], segment_ids [B, L], vis_feats, vis_pe,
    mask_id (int)."""
    B, T = tokens.shape
    nv = cfg["len_vis_input"]
    P = nv + 2
    dev = tokens.device
    W_ = T - 1
    f, pe = _regions(W, prompt["vis_feats"], prompt["vis_pe"], q, None)
    probe = torch.full((B, T), prompt["mask_id"], dtype=torch.int64,
                       device=dev)
    ids = torch.cat([prompt["input_ids"][:, :P], tokens[:, :W_], probe], 1)
    pos_ids = torch.cat([torch.arange(P + W_, device=dev),
                         P + torch.arange(T, device=dev)])
    seg = prompt["segment_ids"]
    seg_ids = torch.cat([seg[:, :P + W_], seg[:, P:P + T]], 1)
    words = F.embedding(ids, q(W["bert.embeddings.word_embeddings.weight"]))
    pos = F.embedding(pos_ids, q(W["bert.embeddings.position_embeddings"
                                   ".weight"]))[None].expand(B, -1, -1)
    words = torch.cat([words[:, :1], f, words[:, nv + 1:]], 1)
    pos = torch.cat([pos[:, :1], pe, pos[:, nv + 1:]], 1)
    x = words + pos + F.embedding(
        seg_ids, q(W["bert.embeddings.token_type_embeddings.weight"]))
    x = q(_ln(W, "bert.embeddings.LayerNorm", x))
    R = P + W_ + T
    r = torch.arange(R, device=dev)[:, None]
    c = torch.arange(R, device=dev)[None, :]
    # caption row P + t (w_t) sees w_<=t; probe row P + W_ + u (m_u)
    # sees w_<u and itself
    u_row = r - P - W_
    see = c < P
    see = see | ((r >= P) & (r < P + W_) & (c >= P) & (c <= r))
    see = see | ((r >= P + W_) & (c >= P) & (c < P + W_)
                 & (c - P < u_row))
    see = see | ((r >= P + W_) & (c == r))
    bias = torch.where(see, 0.0, NEG)[None]
    for i in range(cfg["num_hidden_layers"]):
        x = _layer(W, cfg, i, x, bias, q, None)
    logp = _mlm_logp(W, cfg, x[:, P + W_:], q)
    return torch.gather(logp, -1, tokens[..., None])[..., 0]


def grads(loss: torch.Tensor, W: Dict[str, torch.Tensor],
          names: List[str]) -> Dict[str, Optional[torch.Tensor]]:
    """d loss / d W[name] for the trainable ``names`` (None where the loss
    does not reach a weight)."""
    g = torch.autograd.grad(loss, [W[n] for n in names], allow_unused=True)
    return dict(zip(names, g))
