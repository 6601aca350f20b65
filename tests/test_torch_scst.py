"""The port's SCST (vlp_tpu_torch/scst.py and the model's replay) against
the JAX package's, ``VLPConfig.tiny`` with the Pallas prefill and decode
kernels on the JAX side (interpret mode), fp32 on the CPU.

* The replay layer ``dual_block_attend`` against JAX's, fed the same
  attention multipliers and hidden masks: 1e-5.
* Dropout off, the same forced raw and cleaned ids and reward: the SCST loss
  against JAX ``SCSTTrainer._loss_grad`` (replay="fused") at rtol 1e-5 and
  every gradient at rtol 1e-4 / atol 1e-6; the greedy baselines identical.
* The SCST invariant with all dropout on: the replay's log-probs equal the
  sampled rollout's (rtol 1e-5), and another seed moves them by > 1e-4.
* ``clean_rollout``, ``get_self_critical_reward`` and ``scst_reward_loss``
  equal JAX's on random inputs.
* ``python -m vlp_tpu_torch.cli.train --scst`` on the CPU writes
  ``model.1.bin``; ``--scst_replay scan`` raises."""

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vlp_tpu import losses as jlosses
from vlp_tpu import scst as jscst
from vlp_tpu.checkpoint import params_to_torch
from vlp_tpu_torch import losses, scst
from vlp_tpu_torch.cli import common
from vlp_tpu_torch.cli import train as train_cli
from vlp_tpu_torch.models.model import VLPModel
from vlp_tpu_torch.ops import philox

from tests.test_torch_model import EOS, MASK, decode_batch, make_pair, \
    tiny_cfg

T = 5


def _batches(cfg, B, rng):
    nb = decode_batch(cfg, B, rng)
    return ({k: jnp.asarray(v) for k, v in nb.items()},
            {k: torch.from_numpy(v) for k, v in nb.items()})


def test_dual_block_attend_matches_jax(rng):
    cfg = tiny_cfg(max_len_b=T)
    jmodel, params, model = make_pair(cfg, seed=5)
    B, W, P, HD = 2, T - 1, cfg.prefix_len, cfg.hidden_size
    R, H = 2 * W, cfg.num_attention_heads
    x = rng.normal(size=(B, R, HD)).astype(np.float32)
    pk, pv = (rng.normal(size=(B, P, HD)).astype(np.float32)
              for _ in range(2))
    r = np.arange(R)[:, None]
    c = np.arange(P + R)[None, :]
    step = np.where(r < W, r, r - W)
    vis = ((c < P) | ((c >= P) & (c < P + W) & (c - P <= step))
           | ((r >= W) & (c == P + W + step)))
    bias = np.where(vis, 0.0, -10000.0).astype(np.float32)
    scale = philox.decode_keep_scale(7, B, H, R, P, R, 0.2)
    mh, mf = (rng.random((B, R, HD)) > 0.1 for _ in range(2))
    out_j = jmodel.apply(
        {"params": params}, *(jnp.asarray(a) for a in (x, pk, pv, bias)),
        {"probs_scale": jnp.asarray(scale.numpy()),
         "hidden": (jnp.asarray(mh), jnp.asarray(mf))},
        method=lambda m, *a: m.layers[0].dual_block_attend(*a))
    with torch.no_grad():
        out = model.layers[0].dual_block_attend(
            *(torch.from_numpy(a) for a in (x, pk, pv, bias)), scale,
            (torch.from_numpy(mh), torch.from_numpy(mf)))
    np.testing.assert_allclose(out.numpy(), np.asarray(out_j), rtol=1e-5,
                               atol=1e-5)


def _by_name(tree, cfg):
    return {k: torch.from_numpy(np.array(v))
            for k, v in params_to_torch(tree, cfg).items()}


def test_loss_grads_and_greedy_match_jax(rng):
    cfg = tiny_cfg(max_len_b=T, hidden_dropout_prob=0.0,
                   attention_probs_dropout_prob=0.0)
    jmodel, params, model = make_pair(cfg, seed=6)
    B = 3
    jb, tb = _batches(cfg, B, rng)
    kw = dict(mask_id=MASK, eos_id=EOS, max_tgt_length=T)
    jtr = jscst.SCSTTrainer(jmodel, cfg, replay="fused", **kw)
    tr = scst.SCSTTrainer(model, cfg, **kw)
    greedy_j, _ = jtr.decoder.greedy(params, jb)
    greedy, _ = tr.decoder.greedy(tb)
    np.testing.assert_array_equal(greedy.numpy(), np.asarray(greedy_j))

    raw = rng.integers(6, cfg.vocab_size, size=(B, T))
    raw[0, 2] = EOS         # a live token after EOS: raw and cleaned differ
    raw[1, 1] = 0
    clean = scst.clean_rollout(raw, EOS, 0)
    reward = np.repeat(rng.normal(size=(B, 1)), T, 1).astype(np.float32)
    (loss_j, _), grads_j = jtr._loss_grad(
        params, jb, jnp.asarray(raw, jnp.int32), jnp.asarray(clean, jnp.int32),
        jnp.asarray(reward), jax.random.PRNGKey(3))
    loss = tr.pg_loss(tb, torch.from_numpy(raw), torch.from_numpy(clean),
                      torch.from_numpy(reward), tr.dropout(3, "cpu"))
    loss.backward()
    np.testing.assert_allclose(float(loss.detach()), float(loss_j),
                               rtol=1e-5)
    want = _by_name(grads_j, cfg)
    for name, p in model.named_parameters():
        g = torch.zeros_like(p) if p.grad is None else p.grad
        np.testing.assert_allclose(g.numpy(), want[name].numpy(), rtol=1e-4,
                                   atol=1e-6, err_msg=name)


def test_replay_reproduces_the_sampled_rollout(rng):
    """Both dropouts on: the forced replay under the rollout's contract
    gives the rollout's own log-probs; another seed's masks do not."""
    cfg = tiny_cfg(max_len_b=T, hidden_dropout_prob=0.1,
                   attention_probs_dropout_prob=0.1)
    model = VLPModel(cfg)
    model.init_weights(torch.Generator().manual_seed(2))
    _, tb = _batches(cfg, 4, rng)
    tr = scst.SCSTTrainer(model, cfg, mask_id=MASK, eos_id=EOS,
                          max_tgt_length=T)
    _, _, raw, lps = tr.rollouts(tb, 11)
    forced = torch.from_numpy(raw)
    replay = tr.forced_logprobs(tb, forced, tr.dropout(11, "cpu"))
    np.testing.assert_allclose(replay.detach().numpy(), lps.numpy(),
                               rtol=1e-5, atol=1e-6)
    other = tr.forced_logprobs(tb, forced, tr.dropout(12, "cpu"))
    assert np.abs(other.detach().numpy() - lps.numpy()).max() > 1e-4
    # and the replay's gradient reaches the embeddings and every layer
    replay.sum().backward()
    for name in ("bert.embeddings.word_embeddings.weight",
                 "bert.encoder.layer.0.attention.self.key.weight",
                 f"bert.encoder.layer.{cfg.num_hidden_layers - 1}"
                 ".output.dense.weight"):
        assert float(dict(model.named_parameters())[name].grad.abs().sum()) > 0


def test_host_helpers_match_jax():
    r = np.random.default_rng(4)
    ids = r.integers(0, 8, size=(64, 24))
    np.testing.assert_array_equal(scst.clean_rollout(ids, 4, 0),
                                  jscst.clean_rollout(ids, 4, 0))
    assert scst.array_to_str([5, 6, 0, 7]) == \
        jscst.array_to_str([5, 6, 0, 7]) == "5 6 0"
    B, L = 6, 8
    gt = r.integers(1, 9, (B, L))
    greedy = gt.copy()
    greedy[::2, -3:] = r.integers(1, 9, (B // 2, 3))
    sample = r.integers(1, 9, (B, L))
    sample[1] = gt[1]
    got = scst.get_self_critical_reward(greedy, gt, sample)
    assert got.dtype == np.float32 and got.shape == (B, L)
    np.testing.assert_array_equal(
        got, jscst.get_self_critical_reward(greedy, gt, sample))
    logp = r.normal(-2, 1, (B, L)).astype(np.float32)
    seq = scst.clean_rollout(r.integers(0, 6, (B, L)), 4, 0)
    rew = np.repeat(r.normal(0, 2, (B, 1)), L, 1).astype(np.float32)
    np.testing.assert_allclose(
        float(losses.scst_reward_loss(torch.from_numpy(logp),
                                      torch.from_numpy(seq),
                                      torch.from_numpy(rew))),
        float(jlosses.scst_reward_loss(jnp.asarray(logp), jnp.asarray(seq),
                                       jnp.asarray(rew))), rtol=1e-6)


def test_trainer_refuses_what_the_port_leaves_out():
    cfg = tiny_cfg()
    model = VLPModel(cfg)
    kw = dict(mask_id=MASK, eos_id=EOS)
    with pytest.raises(NotImplementedError, match="Not to port"):
        scst.SCSTTrainer(model, cfg, replay="scan", **kw)
    with pytest.raises(NotImplementedError, match="Not to port"):
        scst.SCSTTrainer(model, cfg, remat=True, **kw)
    with pytest.raises(ValueError, match="optimizer"):
        scst.SCSTTrainer(model, cfg, **kw).step({}, None, 0)


TINY = {"vocab_size": 120, "hidden_size": 32, "num_hidden_layers": 2,
        "num_attention_heads": 2, "intermediate_size": 64,
        "max_position_embeddings": 512, "vis_feat_dim": 24,
        "vis_cls_dim": 10, "vis_pe_dim": 16}


def test_scst_cli_on_the_cpu(tmp_path):
    vocab = str(tmp_path / "vocab.txt")
    common.write_synthetic_vocab(vocab, size=120)
    cfg_json = str(tmp_path / "bert_config.json")
    with open(cfg_json, "w") as f:
        json.dump(TINY, f)
    out = str(tmp_path / "scst")
    args = ["--do_train", "--scst", "--dataset", "coco", "--max_pred", "0",
            "--mask_prob", "0", "--synthetic_data", "--enable_butd",
            "--bert_model", vocab, "--config_path", cfg_json,
            "--new_segment_ids", "--len_vis_input", "6", "--max_len_b", "5",
            "--train_batch_size", "4", "--learning_rate", "1e-6",
            "--num_train_epochs", "1", "--steps_per_epoch", "2",
            "--output_dir", out, "--device", "cpu"]
    res = train_cli.main(args)
    assert len(res["losses"]) == 2 and np.isfinite(res["losses"]).all()
    assert os.path.isfile(os.path.join(out, "model.1.bin"))
    with open(os.path.join(out, "metrics.jsonl")) as f:
        rec = json.loads(f.readline())
    assert {"loss", "scst_loss", "mean_reward"} <= set(rec)
    with pytest.raises(NotImplementedError, match="Not to port"):
        train_cli.main(args + ["--scst_replay", "scan"])
    masked = list(args)
    masked[masked.index("--max_pred") + 1] = "3"
    with pytest.raises(ValueError, match="max_pred"):
        train_cli.main(masked)
