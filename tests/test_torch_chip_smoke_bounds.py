"""chip_smoke's yardsticks against counts made by hand: product_flop (the
FLOP of one attention product over the (row, key) entries that the
structural mask and colkeep leave visible, against a count written out from
the mask's definition), decode_work (the decode step's bytes and FLOP at the
recipes' shapes) and dropout_mask_bound."""

import numpy as np
import pytest
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


ROW = 12 * 64 * 4     # bytes of one fp32 [H*D] row at H=12, D=64


# The recipes' fp32 decode steps (P=102, G=24, S=2, H=12) counted by hand.
# Bytes: q read and out written (2 rows per query row); the prompt's K and V
# once per example (2 * P rows); each beam's committed slots' K and V
# (2 * gen_len rows); the two new tokens' K and V read and written (8 rows a
# beam; both get a slot below G); K4's bias, 4 bytes per (query row, beam,
# visible slot).  FLOP: 4 * D per (query row, head, column), the columns
# being the prompt and the visible slots (K4: of all five beams).
DECODE_CASES = {
    # beam 5, B=100: 1,000 query rows, 500 beam rows
    "K4_gen0": ((100, 5, 0, True),
                (2000 + 20400 + 0 + 4000) * ROW + 500 * 5 * 2 * 4,
                4 * 1000 * 12 * (102 + 5 * 2) * 64, 0.0242),
    "K4_gen9": ((100, 5, 9, True),
                (2000 + 20400 + 9000 + 4000) * ROW + 500 * 5 * 11 * 4,
                4 * 1000 * 12 * (102 + 5 * 11) * 64, 0.0325),
    "K4_gen18": ((100, 5, 18, True),
                 (2000 + 20400 + 18000 + 4000) * ROW + 500 * 5 * 20 * 4,
                 4 * 1000 * 12 * (102 + 5 * 20) * 64, 0.0408),
    # greedy, B=100: 200 query rows
    "K3_gen18": ((100, 1, 18, False), (400 + 20400 + 3600 + 800) * ROW,
                 4 * 200 * 12 * (102 + 20) * 64, 0.0231),
    # the SCST rollout, B=64: 128 query rows
    "K5_gen18": ((64, 1, 18, False), (256 + 13056 + 2304 + 512) * ROW,
                 4 * 128 * 12 * (102 + 20) * 64, 0.0148),
}


@pytest.mark.parametrize("case", DECODE_CASES)
def test_decode_work_counts_the_visible_slots(case):
    (B, K, gen_len, anc), nbytes, flops, bound_ms = DECODE_CASES[case]
    got = chip_smoke.decode_work(B, K, 2, 102, 24, 12, gen_len, 4, anc)
    assert got == (nbytes, flops)
    b = chip_smoke.fp32_bound(*got)
    assert b["bound_by"] == "bytes"
    assert round(b["bound_ms"], 4) == bound_ms


def test_dropout_mask_bound_is_its_output_written_once():
    b = chip_smoke.dropout_mask_bound(64, 12, 128)
    assert b == chip_smoke.bound(64 * 12 * 128 * 128 * 4, 0)   # 50.3 MB
    assert b["bound_by"] == "bytes" and round(b["bound_ms"], 4) == 0.0150
