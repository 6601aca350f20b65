"""The Kimi-VL cell's driver (``drivers/train_loop_kimi.py``) at a tiny
size on the CPU (fp32, the program's plain paths): its window runs, its
comparison with the plain reference passes, the control (fp8) and the
fault (rows past a capacity factor of 1.0 dropped) fail it, and so does a
step that leaves the state unchanged."""

import tempfile

import torch

from benchmarks import harness

TINY_KIMI = dict(
    model_type="kimi_vl", vocab_size=300, hidden_size=64,
    intermediate_size=96, moe_intermediate_size=32, num_hidden_layers=3,
    num_attention_heads=2, n_shared_experts=1, n_routed_experts=8,
    n_routed_experts_held=4, num_experts_per_tok=2, first_k_dense_replace=1,
    routed_scaling_factor=2.446, kv_lora_rank=16, q_lora_rank=None,
    qk_nope_head_dim=16, qk_rope_head_dim=8, v_head_dim=16,
    rms_norm_eps=1e-5, rope_theta=800000, initializer_range=0.02,
    aux_loss_alpha=1e-4, bias_update_speed=1e-3, len_vis_input=10,
    vis_feat_dim=64, vis_cls_dim=33, vis_pe_dim=39, max_len_b=20,
    max_pred=20, dtype="float32")
TRAFFIC = dict(images=8, examples=256, batch_size=4, reference_block=2,
               setup_groups=1, learning_rate=1e-3)
CELL = "kimi-vl-ep8-cap-loop2"


def run_kimi(seconds=4.0, controls=False):
    torch.set_num_threads(2)
    tr = dict(harness.traffic(CELL), **TRAFFIC)
    with tempfile.TemporaryDirectory() as work:
        ctx = harness.Context(CELL, dict(TINY_KIMI), tr, 20261018, seconds,
                              False, work, "cpu")
        ctx.controls = controls
        harness.driver(tr["driver"]).run(ctx)
    return ctx.record


def failing(rec):
    return [c["name"] for c in rec["checks"] if c["value"] > c["limit"]]


def test_sound_run_is_correct():
    rec = run_kimi(controls=True)
    assert rec["attempted"] > 0 and rec["failed"] == 0 and rec["done"]
    assert failing(rec) == [], rec["checks"]
    assert len(rec["rows_per_expert"]) == 2
    assert rec["flop_per_sample"] > 0
    assert {c["name"] for c in rec["checks"]} == {
        "loss_gap", "moment_gap", "change_gap", "route_mismatch"}
    limits = {c["name"]: c["limit"] for c in rec["checks"]}
    for name, got in rec["control"].items():
        assert any(got[n] > limits[n] for n in got), name


def test_state_left_unchanged_fails(monkeypatch):
    from vlp_tpu_torch import optim
    monkeypatch.setattr(optim.BertAdam, "step",
                        lambda self, finite=None: None)
    assert "change_gap" in failing(run_kimi())
