"""The operations and bytes of Kimi-VL's new kernels and of its training
step, from their shapes and the counted rows (``work.py``'s yardstick:
each input read once, each output written once; a least time is the larger
of the bytes over the memory bandwidth and the operations over the bf16
peak).

* MLA's K1 / K2 at q.k 192, v 128 over the visible (row, key) entries;
* the grouped expert products of a step: gate and up together (H ->
  2 x 1,408), then down (1,408 -> H), over the rows the held experts took,
  forward and backward (dA and dW, each the forward's operations);
* the model FLOPs of a training sample.
"""

from __future__ import annotations

from typing import Sequence

from benchmarks.work import bound_ms, visible_entries

ELEM = 2   # bf16


def _visible(modes, text_ends, prefix: int, L: int) -> int:
    return sum(visible_entries(int(m), int(t), prefix, L)
               for m, t in zip(modes, text_ends))


def mla_fwd_ms(B: int, L: int, H: int, modes: Sequence[int],
               text_ends: Sequence[int], prefix: int, dqk: int = 192,
               dv: int = 128) -> float:
    """K1: q and k read (dqk a head), v read and out written (dv); QK^T
    and PV over the visible entries."""
    nbytes = B * L * H * (2 * dqk + 2 * dv) * ELEM + 8 * B + 4 * B * L
    vis = _visible(modes, text_ends, prefix, L)
    return bound_ms(nbytes, 2 * H * vis * (dqk + dv))


def mla_bwd_ms(B: int, L: int, H: int, modes: Sequence[int],
               text_ends: Sequence[int], prefix: int, dqk: int = 192,
               dv: int = 128) -> float:
    """K2: q, k, v and dO read, dq, dk and dv written; S = QK^T, dP =
    dO V^T, dV = P^T dO, dQ = dS K and dK = dS^T Q over the visible
    entries."""
    nbytes = (B * L * H * (4 * dqk + 3 * dv) * ELEM + 8 * B + 4 * B * L)
    vis = _visible(modes, text_ends, prefix, L)
    return bound_ms(nbytes, 2 * H * vis * (3 * dqk + 2 * dv))


def grouped_product_ms(rows: int, experts: int, k: int, n: int) -> float:
    """One grouped product of ``rows`` rows of k columns by ``experts``
    [k, n] matrices: A and the weights read, the [rows, n] result
    written."""
    nbytes = (rows * k + experts * k * n + rows * n) * ELEM
    return bound_ms(nbytes, 2 * rows * k * n)


def expert_products_ms(rows: int, cfg: dict, calls: int) -> float:
    """The least time of one MoE layer's grouped products over ``calls``
    training steps whose held experts took ``rows`` rows in all: forward
    (gate-up, down) and backward (each product's dA and dW, which read and
    write what the forward does, in another arrangement)."""
    H, inter = cfg["hidden_size"], cfg["moe_intermediate_size"]
    E = cfg["n_routed_experts_held"]
    per = rows / calls if calls else 0
    one = (grouped_product_ms(per, E, H, 2 * inter)
           + grouped_product_ms(per, E, inter, H))
    return 3 * one * calls


def train_flop_per_sample(cfg: dict, L: int) -> float:
    """Forward plus backward (3 x the forward's products) of one training
    sequence of L tokens: the region MLPs over the regions; in every layer
    MLA's projections and its QK^T / PV over all L keys; the dense layer's
    SwiGLU; in each MoE layer the router, the shared experts and the held
    experts at their even share (k x held / E rows a token); the head at
    max_pred positions."""
    H, nh = cfg["hidden_size"], cfg["num_attention_heads"]
    dn, dr, dv = (cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"],
                  cfg["v_head_dim"])
    r, E = cfg["kv_lora_rank"], cfg["n_routed_experts"]
    inter = cfg["moe_intermediate_size"]
    attn = 2 * (H * nh * (dn + dr) + H * (r + dr) + r * nh * (dn + dv)
                + nh * dv * H) + 2 * L * nh * (dn + dr + dv)
    dense = 3 * 2 * H * cfg["intermediate_size"]
    held_rows = (cfg["num_experts_per_tok"] * cfg["n_routed_experts_held"]
                 / E)
    moe = (2 * H * E + 3 * 2 * H * inter * cfg["n_shared_experts"]
           + held_rows * 3 * 2 * H * inter)
    n_dense = cfg["first_k_dense_replace"]
    n_moe = cfg["num_hidden_layers"] - n_dense
    per_token = cfg["num_hidden_layers"] * attn + n_dense * dense + n_moe * moe
    fd, pd = cfg["vis_feat_dim"], cfg["vis_pe_dim"]
    regions = 2 * cfg["len_vis_input"] * (fd * fd + fd * H + pd * H)
    head = 2 * cfg["max_pred"] * H * cfg["vocab_size"]
    return 3 * (L * per_token + regions + head)
