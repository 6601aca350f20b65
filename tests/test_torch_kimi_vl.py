"""Kimi-VL-A3B's language model (``vlp_tpu_torch/models/kimi_vl.py``) at a
small size on the CPU, in fp32: against the plain reference
(``benchmarks/reference/kimi_vl.py``) in loss, gradients, one BertAdam step
and the routers' bias update; its expert-parallel share against the uncut
layer; the router's rules; no pair dropped, with no pick or every pick
held; the expert-row passes' plain versions (``ops/moe_rows.py``) against
the masked full-buffer passes they replaced, in bf16, with the rows past
the held-row count NaN; MLA's widths through the attention op's plain
versions; the train CLI's normal path and its device loop."""

import dataclasses
import json
import math
import os

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from benchmarks.reference import kimi_vl as ref
from benchmarks.reference import optim as ref_optim
from vlp_tpu_torch import optim as optim_lib
from vlp_tpu_torch import train_step as ts
from vlp_tpu_torch.cli import common
from vlp_tpu_torch.cli import train as train_cli
from vlp_tpu_torch.config import MODE_BI, MODE_S2S
from vlp_tpu_torch.models import kimi_vl
from vlp_tpu_torch.ops import attention as attn
from vlp_tpu_torch.ops import moe_rows

# hidden 64, 2 heads of q.k 24 (16 + 8 RoPE) and v 16, 8 experts of which
# 4 held, top-2, 1 shared expert, 3 layers (one dense)
TINY = dict(
    model_type="kimi_vl", vocab_size=160, hidden_size=64,
    intermediate_size=96, moe_intermediate_size=32, num_hidden_layers=3,
    num_attention_heads=2, n_shared_experts=1, n_routed_experts=8,
    n_routed_experts_held=4, num_experts_per_tok=2, first_k_dense_replace=1,
    routed_scaling_factor=2.446, kv_lora_rank=16, q_lora_rank=None,
    qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16,
    rms_norm_eps=1e-5, rope_theta=800000.0, initializer_range=0.02,
    aux_loss_alpha=1e-4, bias_update_speed=1e-3, len_vis_input=6,
    vis_feat_dim=20, vis_cls_dim=11, vis_pe_dim=17, max_len_b=5, max_pred=3,
    dtype="float32", scoring_func="sigmoid", topk_method="noaux_tc",
    n_group=1, topk_group=1, hidden_act="silu")


def program(cfg=TINY, seed=0, **over):
    """The program's model on the CPU with the reference's weights."""
    cfg = dict(cfg, **over)
    model = kimi_vl.KimiVLModel(kimi_vl.KimiVLConfig.from_dict(cfg))
    w = ref.make_weights(cfg, seed, "cpu")
    missing = model.load_state_dict(w, strict=False)
    assert not missing.unexpected_keys
    assert set(missing.missing_keys) == set(ref.bias_names(cfg))
    return model, w


def batch(cfg=TINY, B=4, seed=1):
    g = torch.Generator().manual_seed(seed)
    L = kimi_vl.KimiVLConfig.from_dict(cfg).seq_len
    nv, P = cfg["len_vis_input"], cfg["max_pred"]
    te = torch.randint(nv + 3, nv + 3 + cfg["max_len_b"], (B,), generator=g)
    return dict(
        input_ids=torch.randint(104, cfg["vocab_size"], (B, L), generator=g),
        segment_ids=torch.zeros(B, L, dtype=torch.int64),
        mode=torch.tensor([MODE_S2S, MODE_BI] * (B // 2)),
        text_end=te.to(torch.int32),
        vis_feats=torch.randn(B, nv, cfg["vis_feat_dim"], generator=g),
        vis_pe=torch.randn(B, nv, cfg["vis_pe_dim"], generator=g),
        masked_pos=torch.stack([torch.randperm(3, generator=g) + nv + 2
                                for _ in range(B)]),
        masked_ids=torch.randint(104, cfg["vocab_size"], (B, P),
                                 generator=g),
        masked_weights=(torch.rand(B, P, generator=g) > 0.2).float(),
        task_idx=torch.full((B,), 3))


def reference_loss(w, cfg, b, biases, blocks=1, **kw):
    """The reference's step loss and gradients, its blocks summed."""
    names = list(w)
    W = {n: t.clone().requires_grad_() for n, t in w.items()}
    B = b["input_ids"].shape[0]
    total, grads, load = 0.0, None, None
    for lo in range(0, B, B // blocks):
        part = {k: v[lo:lo + B // blocks] for k, v in b.items()}
        out = ref.forward(W, cfg, part, biases, q=ref.Precision("fp32"),
                          weight_total=float(b["masked_weights"].sum()),
                          seqs_total=B, **kw)
        g = torch.autograd.grad(out["loss"], [W[n] for n in names],
                                allow_unused=True)
        total += float(out["loss"].detach())
        grads = g if grads is None else [
            a if c is None else a + c for a, c in zip(grads, g)]
        load = out["load"] if load is None else {
            n: load[n] + out["load"][n] for n in load}
    return total, dict(zip(names, grads)), load


def zero_biases(cfg=TINY):
    return {n: torch.zeros(cfg["n_routed_experts"])
            for n in ref.bias_names(cfg)}


def test_port_matches_the_reference_in_loss_gradients_and_a_step():
    model, w = program()
    b = batch()
    out = model.pretrain_losses(b)
    out["loss"].backward()
    loss, grads, load = reference_loss(w, TINY, b, zero_biases())
    assert float(out["loss"]) == pytest.approx(loss, rel=1e-5)
    for n, p in model.named_parameters():
        torch.testing.assert_close(p.grad, grads[n], rtol=1e-4, atol=1e-7)
    # one BertAdam step on each side, then the bias update
    opt = optim_lib.BertAdam(dict(model.named_parameters()), 1e-3,
                             warmup=0.1, t_total=10)
    ropt = ref_optim.BertAdam({n: t.clone() for n, t in w.items()}, 1e-3,
                              0.1, 10, 0.01)
    # lr(step 0) is 0 under warm-up: two steps move the weights
    for _ in range(2):
        opt.step()
        ropt.step(grads)
    # Adam's m / sqrt(v) carries a gradient's round-off (1e-4 relative
    # where the gradient is tiny) into an update of up to lr = 1e-3:
    # 2e-6 is 0.2% of the largest update
    for n, p in model.named_parameters():
        torch.testing.assert_close(p.detach(), ropt.params[n], rtol=1e-5,
                                   atol=2e-6)
    model.after_step()
    biases = zero_biases()
    ref.update_biases(TINY, biases, load)
    for m, n in zip(model.moe_layers, ref.bias_names(TINY)):
        torch.testing.assert_close(m.gate.e_score_correction_bias, biases[n])
        assert float(m.load.abs().sum()) == 0.0


def test_reference_blocks_add_up_to_the_whole_step():
    _, w = program()
    b = batch(B=4)
    whole, g1, load1 = reference_loss(w, TINY, b, zero_biases())
    split, g2, load2 = reference_loss(w, TINY, b, zero_biases(), blocks=2)
    assert split == pytest.approx(whole, rel=1e-6)
    for n in g1:
        torch.testing.assert_close(g2[n], g1[n], rtol=1e-5, atol=1e-8)
    for n in load1:
        torch.testing.assert_close(load2[n], load1[n])


def test_expert_shares_add_up_to_the_uncut_layer():
    """Each EP share's MoE output (its held experts' part plus the shared
    expert) summed over the shares, the shared expert counted once, is the
    uncut reference layer's output."""
    full = dict(TINY, n_routed_experts_held=8)
    w = ref.make_weights(full, 0, "cpu")
    p = "layers.1.mlp."
    h = torch.randn(2, 5, TINY["hidden_size"], generator=torch.Generator()
                    .manual_seed(3))
    want, _, _, _ = ref._moe(w, full, p, h, torch.zeros(8),
                             ref.Precision("fp32"), None)
    shares = []
    for r in range(2):
        cfg = kimi_vl.KimiVLConfig.from_dict(dict(TINY, ep_rank=r))
        moe = kimi_vl.MoE(cfg).eval()
        sd = {k[len(p):]: v for k, v in w.items() if k.startswith(p)}
        for k in ("experts.gate_up_proj", "experts.down_proj"):
            sd[k] = sd[k][4 * r:4 * r + 4]
        moe.load_state_dict(sd, strict=False)
        shares.append(moe(h)[0])
    shared = moe.shared_experts(h)
    torch.testing.assert_close(shares[0] + shares[1] - shared, want,
                               rtol=1e-5, atol=1e-6)


def _moe(cfg=TINY):
    model, _ = program(cfg)
    return model.moe_layers[0]


def test_router_bias_picks_but_does_not_weight():
    moe = _moe()
    x = torch.randn(10, TINY["hidden_size"],
                    generator=torch.Generator().manual_seed(4))
    idx0, w0, scores = moe.route(x)
    moe.gate.e_score_correction_bias[5] = 10.0   # expert 5 always picked
    idx, w, _ = moe.route(x)
    assert (idx == 5).any(-1).all()
    picked = scores.gather(1, idx)
    torch.testing.assert_close(
        w, picked / picked.sum(-1, keepdim=True) * 2.446)
    torch.testing.assert_close(w.sum(-1), torch.full((10,), 2.446))
    # without the bias, the top-k of the scores themselves
    torch.testing.assert_close(idx0.sort(-1).values,
                               scores.topk(2, -1).indices.sort(-1).values)


def test_bias_update_follows_the_sign_rule():
    moe = _moe()
    moe.load.copy_(torch.tensor([3., 5., 4., 4., 4., 2., 6., 4.]))
    moe.update_bias()
    torch.testing.assert_close(
        moe.gate.e_score_correction_bias,
        1e-3 * torch.tensor([1., -1., 0., 0., 0., 1., -1., 0.]))
    assert float(moe.load.sum()) == 0.0


def test_balance_loss_matches_the_hand_formula():
    moe = _moe()
    B, L, E, k = 2, 3, 8, 2
    g = torch.Generator().manual_seed(5)
    scores = torch.rand(B * L, E, generator=g)
    idx = torch.stack([torch.randperm(E, generator=g)[:k]
                       for _ in range(B * L)])
    want = 0.0
    for b in range(B):
        s, ids = scores[b * L:(b + 1) * L], idx[b * L:(b + 1) * L]
        for i in range(E):
            f = E / (k * L) * float((ids == i).sum())
            P = float((s[:, i] / s.sum(-1)).mean())
            want += f * P
    want = 1e-4 * want / B
    assert float(moe.balance_loss(idx, scores, B)) == pytest.approx(
        want, rel=1e-5)


def test_no_pair_is_dropped_when_every_token_picks_one_held_expert():
    """Every token routes to held expert 0 (its bias): the layer takes all
    T rows for it and matches the reference, which drops nothing."""
    model, w = program()
    model.train()
    moe = model.moe_layers[0]
    moe.gate.e_score_correction_bias[0] = 10.0
    h = torch.randn(3, 7, TINY["hidden_size"],
                    generator=torch.Generator().manual_seed(6))
    y, _ = moe(h)
    assert int(moe.rows[0]) == 21
    bias = torch.zeros(8)
    bias[0] = 10.0
    want, _, _, _ = ref._moe(w, TINY, "layers.1.mlp.", h, bias,
                             ref.Precision("fp32"), None)
    torch.testing.assert_close(y, want, rtol=1e-5, atol=1e-6)
    dropped, _, _, _ = ref._moe(w, TINY, "layers.1.mlp.", h, bias,
                                ref.Precision("fp32"), 1.0)
    assert not torch.allclose(dropped, want)


@pytest.mark.parametrize("held", ["none", "every"])
def test_layer_matches_the_reference_when_no_or_every_pick_is_held(held):
    """The selection biases make every pick another chip's expert (the
    held-row count 0: the layer is its shared expert) or one of this
    chip's (the count fills the buffer): output and input gradient as the
    reference's, and the row counters say so."""
    model, w = program()
    model.train()
    moe = model.moe_layers[0]
    bias = torch.zeros(8)
    bias[(slice(4, 8) if held == "none" else slice(0, 4))] = 10.0
    moe.gate.e_score_correction_bias.copy_(bias)
    h = torch.randn(3, 7, TINY["hidden_size"],
                    generator=torch.Generator().manual_seed(8))
    leaves = [h.clone().requires_grad_() for _ in range(2)]
    y, _ = moe(leaves[0])
    want, _, _, _ = ref._moe(w, TINY, "layers.1.mlp.", leaves[1], bias,
                             ref.Precision("fp32"), None)
    torch.testing.assert_close(y, want, rtol=1e-5, atol=1e-6)
    dy = torch.randn(y.shape, generator=torch.Generator().manual_seed(9))
    got, = torch.autograd.grad(y, leaves[0], dy)
    ref_dh, = torch.autograd.grad(want, leaves[1], dy)
    torch.testing.assert_close(got, ref_dh, rtol=1e-5, atol=1e-6)
    T = 21
    assert int(moe.rows.sum()) == (0 if held == "none" else 2 * T)
    assert int(moe.buffer_rows) == 2 * T


# the expert-row passes: 12 tokens, top-2 of 8 experts, 4 held (0..3)
ROWS_T, ROWS_K, ROWS_H, ROWS_I = 12, 2, 16, 8


def _row_case(case: str, seed=10):
    """Picks [T, k] of one routing case, sorted as the layer sorts them:
    (order[:R], row_of, offs, count)."""
    g = torch.Generator().manual_seed(seed)
    T, k = ROWS_T, ROWS_K
    pool = {"random": range(8), "none_held": range(4, 8),
            "every_held": range(4), "one_expert": None}[case]
    if pool is None:    # expert 0 and one of another chip's
        idx = torch.stack([torch.zeros(T, dtype=torch.int64),
                           torch.randint(4, 8, (T,), generator=g)], 1)
    else:
        pool = torch.tensor(list(pool))
        idx = torch.stack([pool[torch.randperm(len(pool), generator=g)[:k]]
                           for _ in range(T)])
    order, row_of, _, offs = kimi_vl.sort_pairs(idx, range(4))
    return order[:T * k], row_of, offs, int(offs[-1])


def _poisoned(R, width, count, g):
    t = torch.randn(R, width, generator=g).bfloat16()
    t[count:] = float("nan")
    return t


@pytest.mark.parametrize("case", ["random", "none_held", "every_held",
                                  "one_expert"])
@pytest.mark.parametrize("what", ["gather", "swiglu", "combine"])
def test_row_passes_match_the_masked_passes(what, case):
    """Each plain pass, forward and backward, against the full-buffer pass
    it replaced (``where`` masks, ``index_select``, the weighting), in
    bf16, with the buffer's rows past the held-row count NaN: the rows
    below the count and every token agree, and no NaN gets through."""
    order, row_of, offs, count = _row_case(case)
    T, k, H, inter = ROWS_T, ROWS_K, ROWS_H, ROWS_I
    R = T * k
    g = torch.Generator().manual_seed(11)
    valid = torch.arange(R) < count
    tol = dict(rtol=1e-2, atol=2e-2)

    def held_rows(t):
        return t[:count] if t.shape[0] == R else t

    if what == "gather":
        x = torch.randn(T, H, generator=g).bfloat16().requires_grad_()
        want = torch.where(valid[:, None], x.index_select(0, order // k), 0.0)
        got = moe_rows.gather_plain(x.detach(), order, offs, k)
        d_out = _poisoned(R, H, count, g)
        want_d = torch.autograd.grad(want, x, d_out)
        got_d = (moe_rows.gather_bwd_plain(d_out, row_of, offs, k),)
    elif what == "swiglu":
        gu = _poisoned(R, 2 * inter, count, g).requires_grad_()
        a, b = gu.split(inter, dim=-1)
        want = F.silu(a) * b
        got = moe_rows.swiglu_plain(gu.detach(), offs)
        d_out = _poisoned(R, inter, count, g)
        want_d = torch.autograd.grad(want, gu, d_out)
        got_d = (moe_rows.swiglu_bwd_plain(d_out, gu.detach(), offs),)
    else:
        y_rows = _poisoned(R, H, count, g).requires_grad_()
        w = torch.rand(T, k, generator=g).requires_grad_()
        base = torch.randn(T, H, generator=g).bfloat16().requires_grad_()
        w_row = torch.where(valid, w.reshape(-1)[order], 0.0)
        yw = torch.where(valid[:, None], y_rows, 0.0) * w_row[:, None].to(
            y_rows.dtype)
        want = torch.cat([yw, yw.new_zeros(T * k - R, H)]).index_select(
            0, row_of).view(T, k, H).sum(1) + base
        got = moe_rows.combine_plain(y_rows.detach(), w.detach(), row_of,
                                     offs, k, base.detach())
        d_out = torch.randn(T, H, generator=g).bfloat16()
        want_d = torch.autograd.grad(want, [y_rows, w], d_out)
        got_d = moe_rows.combine_bwd_plain(d_out, y_rows.detach(),
                                           w.detach(), row_of, offs, k)
        assert bool((got_d[1][row_of.view(T, k) >= count] == 0).all())
    for a, b in [(got, want)] + list(zip(got_d, want_d)):
        a, b = held_rows(a), held_rows(b)
        assert a.shape == b.shape and bool(torch.isfinite(a).all())
        torch.testing.assert_close(a.float(), b.float(), **tol)


def test_attention_plain_at_mla_widths_matches_an_einsum():
    g = torch.Generator().manual_seed(7)
    B, L, H, P = 2, 12, 3, 5
    q, k = (torch.randn(B, L, H, 192, generator=g) for _ in range(2))
    v = torch.randn(B, L, H, 128, generator=g)
    mode = torch.tensor([MODE_S2S, MODE_BI])
    te = torch.tensor([9, 11])
    ck = torch.ones(B, L)
    got = attn.attention_plain(q, k, v, mode, te, ck, prefix=P)
    i, j = torch.arange(L)[:, None], torch.arange(L)[None]
    s2s = (j < P) | ((j >= P) & (j <= i) & (i < 9))
    vis = torch.stack([s2s, (j < 11).expand(L, L)])
    s = torch.einsum("blhd,bmhd->bhlm", q, k) / math.sqrt(192)
    s = s + torch.where(vis, 0.0, -10000.0)[:, None]
    want = torch.einsum("bhlm,bmhd->blhd", s.softmax(-1), v)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    dout = torch.randn(B, L, H, 128, generator=g)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    s = torch.einsum("blhd,bmhd->bhlm", *leaves[:2]) / math.sqrt(192)
    s = s + torch.where(vis, 0.0, -10000.0)[:, None]
    out = torch.einsum("bhlm,bmhd->blhd", s.softmax(-1), leaves[2])
    want_g = torch.autograd.grad(out, leaves, dout)
    got_g = attn.attention_bwd_plain(q, k, v, mode, te, ck, dout, prefix=P)
    for a, b in zip(got_g, want_g):
        assert a.shape == b.shape
        torch.testing.assert_close(a, b, rtol=1e-4, atol=1e-5)


def test_selection_mismatch_counts_pairs():
    a = torch.tensor([[0, 1], [2, 3]])
    assert ref.selection_mismatch(a, torch.tensor([[1, 0], [2, 4]])) == 0.25


def test_device_loop_on_the_cpu_equals_eager_steps():
    """make_multi_step (K = 2, eager on the CPU) against two calls of the
    train step: the same losses and weights, biases included."""
    runs = []
    for K in (1, 2):
        model, _ = program()
        opt = optim_lib.BertAdam(dict(model.named_parameters()), 1e-3,
                                 warmup=0.1, t_total=10)
        bs = [batch(seed=s) for s in (1, 2)]
        if K == 1:
            step = ts.make_train_step(model, opt)
            losses = [float(step(b, 0)["loss"]) for b in bs]
        else:
            step = ts.make_multi_step(model, opt, K=2)
            stacked = {k: torch.stack([b[k] for b in bs]) for k in bs[0]}
            losses = step(stacked, [0, 0])["loss"].tolist()
        runs.append((losses, model.state_dict()))
    assert runs[0][0] == runs[1][0]
    for n, t in runs[0][1].items():
        assert torch.equal(t, runs[1][1][n]), n
    assert any(float(t.abs().sum()) > 0 for n, t in runs[0][1].items()
               if n.endswith("e_score_correction_bias"))


def test_the_train_cli_runs_kimi_from_its_config(tmp_path):
    vocab = str(tmp_path / "vocab.txt")
    common.write_synthetic_vocab(vocab)
    n_words = sum(1 for _ in open(vocab))
    cfg = str(tmp_path / "kimi.json")
    with open(cfg, "w") as f:
        json.dump(dict(TINY, vocab_size=max(n_words, 160)), f)
    out = str(tmp_path / "out")
    args = ["--do_train", "--synthetic_data", "--enable_butd",
            "--bert_model", vocab, "--config_path", cfg, "--output_dir", out,
            "--train_batch_size", "4", "--new_segment_ids",
            "--len_vis_input", "6", "--max_len_b", "5", "--max_pred", "3",
            "--num_train_epochs", "1", "--steps_per_epoch", "2",
            "--learning_rate", "1e-3", "--device", "cpu"]
    result = train_cli.main(args)
    assert isinstance(result["model"], kimi_vl.KimiVLModel)
    assert len(result["losses"]) == 2
    assert all(np.isfinite(result["losses"]))
    assert os.path.exists(os.path.join(out, "model.1.bin"))
    with pytest.raises(ValueError, match="--tasks vqa2"):
        train_cli.main(args + ["--tasks", "vqa2", "--answer_vocab_file",
                               vocab])


def test_config_refuses_what_the_model_does_not_have():
    with pytest.raises(ValueError, match="q_lora_rank"):
        kimi_vl.KimiVLConfig.from_dict(dict(TINY, q_lora_rank=1536))
    with pytest.raises(ValueError, match="scoring_func"):
        kimi_vl.KimiVLConfig.from_dict(dict(TINY, scoring_func="softmax"))
    cfg = kimi_vl.KimiVLConfig.from_dict(dict(TINY, ep_rank=1))
    assert cfg.held == range(4, 8) and cfg.ep_size == 2
    assert dataclasses.replace(cfg, ep_rank=0).held == range(0, 4)


def test_spans_and_the_row_counter_are_recorded():
    from vlp_tpu_torch import tracing
    model, _ = program()
    model.train()
    b = batch()
    tracing.counter("outside", 3)           # a no-op outside recording()
    with tracing.recording() as spans:
        model.pretrain_losses(b)
        rows = model.read_rows_per_expert()
    names = {s.name for s in spans}
    assert {"attn.mla", "moe.route", "moe.dispatch", "moe.experts",
            "moe.combine"} <= names and "outside" not in names
    kept = {s.name: s.n for s in spans if s.name.startswith("moe.rows")}
    assert kept["moe.rows_per_expert.2.3"] == rows[1][3]
    B, L = b["input_ids"].shape
    # the buffer's rows, R = tokens x min(k, held) a step, and the share of
    # them held (the rows the row passes touched)
    buffers = {s.name: s.n for s in spans if s.name.startswith("moe.buffer")}
    assert buffers == {"moe.buffer_rows.1": B * L * 2,
                       "moe.buffer_rows.2": B * L * 2}
    for layer, counts in zip((1, 2), rows):
        assert 0 < sum(counts) / buffers[f"moe.buffer_rows.{layer}"] <= 1
    assert [s.n for s in spans if s.name == "moe.experts"] == [B * L * 2] * 2
    # every pick of a held expert is one row
    idx = model.selections(b)
    assert rows == [[int((i == e).sum()) for e in range(4)] for i in idx]


def test_bias_update_over_data_parallel_ranks_takes_the_summed_load(
        monkeypatch):
    """Over a data-parallel group the biases move by the load summed over
    the ranks (here a stand-in all-reduce adds another rank's load), so
    that every rank moves them alike."""
    import torch.distributed as tdist
    model, _ = program()
    moe = model.moe_layers[0]
    mine = torch.tensor([3., 5., 4., 4., 4., 2., 6., 4.])
    theirs = torch.tensor([5., 1., 4., 4., 4., 6., 2., 4.])
    for m in model.moe_layers:
        m.load.copy_(mine)
    monkeypatch.setattr(tdist, "all_reduce",
                        lambda t, group=None: t.add_(theirs))

    class Group:
        dp_grouped, dp_group = True, None

    model.after_step(Group())
    # summed 8 6 8 8 8 8 8 8, mean 7.75: expert 1 up, the others down
    torch.testing.assert_close(
        moe.gate.e_score_correction_bias,
        1e-3 * torch.tensor([-1., 1., -1., -1., -1., -1., -1., -1.]))
