"""chip_smoke.product_flop: the FLOP of one attention product over the
(row, key) entries that the structural mask and colkeep leave visible,
against a count written out from the mask's definition."""

import numpy as np
import torch

import chip_smoke
from vlp_tpu_torch.config import MODE_BI, MODE_S2S


def _visible_count(mode, text_end, colkeep, prefix, L):
    """Visible entries summed over the batch, a row that sees nothing
    counting L: s2s rows see the prefix and, below text_end, the caption
    causally; bi rows every column before text_end; colkeep drops
    columns."""
    total = 0
    for b in range(len(mode)):
        for i in range(L):
            seen = 0
            for j in range(L):
                if mode[b] == MODE_S2S:
                    vis = j < prefix or (j <= i and i < text_end[b])
                else:
                    vis = j < text_end[b]
                seen += vis and colkeep[b, j] > 0.5
            total += seen if seen else L
    return total


def test_product_flop_counts_the_visible_entries():
    rng = np.random.default_rng(0)
    B, L, P, H, D = 4, 24, 10, 3, 8
    mode = np.array([MODE_S2S, MODE_BI, MODE_S2S, MODE_BI])
    text_end = rng.integers(P + 1, L + 1, size=B)
    colkeep = (rng.random((B, L)) > 0.3).astype(np.float32)
    colkeep[:, 0] = 1.0
    colkeep[3] = 0.0          # every row of example 3 sees nothing
    got = chip_smoke.product_flop(
        torch.tensor(mode, dtype=torch.int32),
        torch.tensor(text_end, dtype=torch.int32),
        torch.tensor(colkeep), P, L, H, D)
    assert got == 2 * D * H * _visible_count(mode, text_end, colkeep, P, L)
    # the structural mask alone hides entries: less than the full L x L
    assert got < 2 * D * H * B * L * L
