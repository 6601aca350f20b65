"""The yardstick: the H100's published peaks, the least time a piece of
work can take on it, and the operations and bytes of the work a cell
does, computed from its shapes.

A least time is the larger of the bytes (each input read once, each
output written once) over the memory bandwidth and the operations over
the peak of their type.  Shares of it (rooflines) and of the peak (MFU)
therefore cannot pass 100% unless the work is counted too high or the
time too low.
"""

from __future__ import annotations

from typing import Sequence

# NVIDIA H100 SXM data sheet, dense rates at the full 700 W
HBM_BYTES_PER_S = 3.35e12
BF16_FLOP_PER_S = 989e12
TF32_FLOP_PER_S = 495e12
FP32_FLOP_PER_S = 67e12
MODE_S2S = 1


def bound_ms(nbytes: float, flops: float,
             flop_rate: float = BF16_FLOP_PER_S) -> float:
    return max(nbytes / HBM_BYTES_PER_S, flops / flop_rate) * 1e3


def visible_entries(mode: int, text_end: int, prefix: int, L: int) -> int:
    """(row, key) pairs an example's attention mask leaves visible: a bi
    row sees the text_end columns before text_end; an s2s row the prefix,
    and a caption row i < text_end also columns prefix..i.  A row that
    sees nothing spreads over all L keys and counts L."""
    if mode != MODE_S2S:
        return L * max(text_end, 1) if text_end > 0 else L * L
    n = 0
    for i in range(L):
        seen = prefix + (i - prefix + 1 if prefix <= i < text_end else 0)
        n += seen if seen else L
    return n


def product_flop(modes: Sequence[int], text_ends: Sequence[int], prefix: int,
                 L: int, H: int, D: int = 64) -> int:
    """FLOP of one L x L x D attention product (QK^T or PV) over the
    visible entries, summed over the batch and H heads."""
    return 2 * D * H * sum(visible_entries(int(m), int(t), prefix, L)
                           for m, t in zip(modes, text_ends))


def attention_fwd_ms(B: int, L: int, H: int, modes, text_ends, prefix: int,
                     D: int = 64, elem: int = 2) -> float:
    """K1: q, k, v read and the output written, 4 [B, L, H, D] tensors,
    plus mode/text_end/colkeep; QK^T and PV."""
    act = B * L * H * D * elem
    pd = product_flop(modes, text_ends, prefix, L, H, D)
    return bound_ms(4 * act + 8 * B + 4 * B * L, 2 * pd)


def attention_bwd_ms(B: int, L: int, H: int, modes, text_ends, prefix: int,
                     D: int = 64, elem: int = 2) -> float:
    """K2: q, k, v, out, dout read and dq, dk, dv written (7 tensors);
    the five products of the backward."""
    act = B * L * H * D * elem
    pd = product_flop(modes, text_ends, prefix, L, H, D)
    return bound_ms(7 * act + 8 * B + 4 * B * L, 5 * pd)


def decode_work(B: int, K: int, S: int, P: int, G: int, H: int,
                gen_len: int, elem: int, anc: bool, D: int = 64):
    """(bytes, FLOP) of one decode step over the visible slots: q read and
    out written (B*K*S rows); the prompt's K/V once per example; each
    beam's committed slots' K/V; the new tokens' K/V that get a slot, read
    and written; with ``anc`` (beam search) the ancestry bias of each
    row's visible columns."""
    BK, HD = B * K, H * D
    vis = min(G, gen_len + S)
    new = vis - min(G, gen_len)
    cols = P + (K * vis if anc else vis)
    nbytes = (2 * BK * S * HD * elem + 2 * B * P * HD * elem
              + 2 * BK * (vis - new) * HD * elem
              + 4 * BK * new * HD * elem
              + (BK * K * vis * 4 if anc else 0))
    return nbytes, 4 * BK * S * H * cols * D


def decode_step_ms(B, K, S, P, G, H, gen_len, elem=2, anc=True) -> float:
    return bound_ms(*decode_work(B, K, S, P, G, H, gen_len, elem, anc))


def gen_slots(T: int) -> int:
    """The decoder's generated-token cache: T slots rounded up to 8."""
    return -(-T // 8) * 8


# ---------------------------------------------------------------------
# model FLOPs (matrix products and attention; 2 per multiply-add)
# ---------------------------------------------------------------------

def layer_flop(rows: int, keys: int, cfg: dict) -> int:
    """One encoder layer over ``rows`` query rows attending ``keys``
    columns each: Q/K/V/output projections, FFN, QK^T and PV."""
    H, F_ = cfg["hidden_size"], cfg["intermediate_size"]
    return 2 * rows * (4 * H * H + 2 * H * F_) + 4 * rows * keys * H


def regions_flop(cfg: dict) -> int:
    nr, fd, pd, H = (cfg["len_vis_input"], cfg["vis_feat_dim"],
                     cfg["vis_pe_dim"], cfg["hidden_size"])
    return 2 * nr * (fd * fd + fd * H + pd * H)


def mlm_head_flop(positions: int, cfg: dict) -> int:
    H, V = cfg["hidden_size"], cfg["vocab_size"]
    return 2 * positions * (H * H + H * V)


def train_flop_per_sample(cfg: dict, task: str, L: int) -> int:
    """Forward plus backward (three times the forward's products) of one
    training example at sequence length L: regions, every layer over all
    L rows and keys, and the MLM head at max_pred positions or the VQA
    head."""
    fwd = regions_flop(cfg) + cfg["num_hidden_layers"] * layer_flop(L, L,
                                                                    cfg)
    H = cfg["hidden_size"]
    if task == "vqa2":
        fwd += 2 * (H * 2 * H + 2 * H * cfg["num_answers"])
    else:
        fwd += mlm_head_flop(cfg["max_pred"], cfg)
    return 3 * fwd


def beam_flop_per_caption(cfg: dict, K: int, T: int) -> int:
    """One caption's beam search: the prefill (prompt + probe rows over
    P+1 keys), then T-1 steps of K beams x 2 rows, each row over the
    prompt and the generated slots it sees, and the MLM head over the
    probe rows (1 in the prefill, K per step)."""
    P = cfg["len_vis_input"] + 2
    nl = cfg["num_hidden_layers"]
    f = regions_flop(cfg) + nl * layer_flop(P + 1, P + 1, cfg)
    f += mlm_head_flop(1, cfg)
    G = gen_slots(T)
    for t in range(T - 1):
        keys = P + min(G, t + 2)
        f += nl * layer_flop(2 * K, keys, cfg) + mlm_head_flop(K, cfg)
    return f
