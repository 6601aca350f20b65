"""The copied bound arithmetic against the kernel table's bounds, and the
FLOP counts against a hand count."""

import pytest

from benchmarks import harness, work


def test_attention_bounds_match_the_kernel_table():
    modes, ends = [1] * 64, [120] * 64
    assert work.attention_fwd_ms(64, 128, 12, modes, ends, 102) == \
        pytest.approx(0.0150, abs=5e-5)
    assert work.attention_bwd_ms(64, 128, 12, modes, ends, 102) == \
        pytest.approx(0.0263, abs=5e-5)


def test_k4_bound_matches_the_kernel_table():
    steps = [work.decode_step_ms(100, 5, 2, 102, 24, 12, t)
             for t in (0, 9, 18)]
    assert [round(s, 4) for s in steps] == [0.0121, 0.0163, 0.0204]
    mean = sum(work.decode_step_ms(100, 5, 2, 102, 24, 12, t)
               for t in range(19)) / 19
    assert mean == pytest.approx(0.0163, abs=5e-5)


def test_prefill_bound_matches_the_kernel_table():
    assert work.attention_fwd_ms(100, 103, 12, [1] * 100, [103] * 100,
                                 102) == pytest.approx(0.0189, abs=5e-5)


def test_visible_entries():
    # bi: every row sees the text_end first columns
    assert work.visible_entries(0, 5, 2, 8) == 8 * 5
    # s2s, prefix 2, text_end 5: rows 0,1 see 2; rows 2,3,4 see 3,4,5;
    # rows 5..7 see the prefix only
    assert work.visible_entries(1, 5, 2, 8) == 2 + 2 + 3 + 4 + 5 + 3 * 2


def _cfg(name):
    man = harness.manifest()
    return harness.config(man, name)


def test_train_flop_hand_count():
    c = _cfg("vlp-base-coco-cap")
    H, F, L, nl = 768, 3072, 128, 12
    layer = 2 * L * (4 * H * H + 2 * H * F) + 4 * L * L * H
    regions = 2 * 100 * (2048 * 2048 + 2048 * H + 1607 * H)
    head = 2 * 20 * (H * H + H * 28996)
    assert work.train_flop_per_sample(c, "img2txt", L) == \
        3 * (nl * layer + regions + head)
    assert 73e9 < work.train_flop_per_sample(c, "img2txt", L) < 75e9
    v = _cfg("vlp-base-vqa2")
    vqa_head = 2 * (H * 2 * H + 2 * H * 3129)
    assert work.train_flop_per_sample(v, "vqa2", L) == \
        3 * (nl * layer + regions + vqa_head)


def test_beam_flop_hand_count():
    c = _cfg("vlp-base-coco-cap")
    H, F, nl, P, K, T = 768, 3072, 12, 102, 5, 20

    def layer(rows, keys):
        return 2 * rows * (4 * H * H + 2 * H * F) + 4 * rows * keys * H

    total = (2 * 100 * (2048 * 2048 + 2048 * H + 1607 * H)
             + nl * layer(P + 1, P + 1) + 2 * (H * H + H * 28996))
    for t in range(T - 1):
        total += nl * layer(2 * K, P + min(24, t + 2))
        total += 2 * K * (H * H + H * 28996)
    assert work.beam_flop_per_caption(c, K, T) == total


def test_bound_picks_the_larger_side():
    assert work.bound_ms(3.35e9, 0) == pytest.approx(1.0)
    assert work.bound_ms(0, 989e9) == pytest.approx(1.0)
