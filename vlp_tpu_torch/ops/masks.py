"""Structural attention masks (counterpart of ``vlp_tpu/ops/masks.py``).

The mask is a function of three small per-example quantities — ``mode``,
``text_end``, ``vis_keep`` — and is additive: 0 where visible, -10000 where
not, exactly as in the reference.  A row with every column masked then
still gets the softmax of its shifted scores, where -inf would give NaN;
never replace it by -inf or a select.
"""

from __future__ import annotations

import torch

from vlp_tpu_torch.config import MODE_S2S

NEG_INF = -10000.0  # matches the reference's additive-mask constant


def structural_visibility(mode: torch.Tensor, text_end: torch.Tensor,
                          prefix: int, seq_len: int) -> torch.Tensor:
    """bool[B, L, L] from (mode, text_end) alone: s2s rows see the prefix
    and, for caption rows, the caption causally; bi rows see every column
    before text_end."""
    dev = mode.device
    L = seq_len
    i = torch.arange(L, device=dev)[:, None]
    j = torch.arange(L, device=dev)[None, :]
    te = text_end.long()[:, None, None]
    bi_vis = j < te
    causal = (j >= prefix) & (j <= i) & (i[None] < te)
    s2s_vis = (j < prefix) | causal
    return torch.where((mode == MODE_S2S)[:, None, None], s2s_vis, bi_vis)


def visibility(mode: torch.Tensor, text_end: torch.Tensor,
               vis_keep: torch.Tensor, prefix: int,
               seq_len: int) -> torch.Tensor:
    """bool[B, L, L]: [b, i, j] True iff query i may attend key j.

    mode/text_end: int[B]; vis_keep: float[B, nv] (1 = region visible);
    masked regions' columns are blocked for every row."""
    nv = vis_keep.shape[-1]
    col_keep = torch.ones((vis_keep.shape[0], seq_len), dtype=torch.bool,
                          device=mode.device)
    col_keep[:, 1:nv + 1] = vis_keep > 0.5
    return (structural_visibility(mode, text_end, prefix, seq_len)
            & col_keep[:, None, :])


def attention_bias(mode: torch.Tensor, text_end: torch.Tensor,
                   vis_keep: torch.Tensor, prefix: int, seq_len: int,
                   dtype=torch.float32) -> torch.Tensor:
    """Additive attention bias [B, 1, L, L]: 0 where visible, -10000 where
    not."""
    vis = visibility(mode, text_end, vis_keep, prefix, seq_len)
    bias = torch.full(vis.shape, NEG_INF, dtype=dtype, device=vis.device)
    return bias.masked_fill(vis, 0.0)[:, None]
