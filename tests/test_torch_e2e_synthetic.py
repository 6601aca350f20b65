"""The port's end-to-end learnability tool (``python -m
vlp_tpu_torch.cli.e2e_synthetic``) on the CPU, at the JAX tool's tiny
configuration, fp32:

* (a) against the JAX package, dropout off: the same JAX init (through
  ``checkpoint.state_dict_from_flax``) and the same ``TrainLoader``
  batches (the shared copy of the loader, the same seed) go through two
  device-loop groups of K = 10, JAX ``make_multi_step`` (XLA attention, as
  the JAX tool runs it) against the tool's ``train_mle``: every step's loss
  within 1e-4 relative; then the greedy decode of the 32 eval images gives
  identical ids, and the two CIDEr scorers agree within 1e-6;
* (b) the tool itself at its defaults, dropout on (300 MLE steps), prints
  PASS; then 20 SCST steps from the trained model at the tool's CPU lr
  draw non-zero rewards (the SCST decode batch and its ground truth line
  up; an off-by-one there makes every reward 0) and keep greedy CIDEr
  above the MLE bar.

Torch runs on two intra-op threads here, which fixes the order of a run's
float sums.  The MLE rule does not lean on that order: with the tool's
seeds, 300 steps ended at greedy CIDEr 5.58, 10.00, 7.77 and 8.83 on 1, 2,
4 and 8 threads (the bar is 1.12).  Nor do (b)'s SCST checks: after 20
SCST steps CIDEr stayed at 5.08 or more in each of seven trained runs
(four thread counts, other seeds).  The tool's SCST rule (CIDEr up by
0.25) is held on the card (``chip_smoke.py`` phase 8) and not here: from
the tiny model, SCST at 1e-4 lowered CIDEr in six of those seven runs."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vlp_tpu.config import VLPConfig as JaxConfig
from vlp_tpu.decode import DecodeParams as JaxDecodeParams
from vlp_tpu.decode import Decoder as JaxDecoder
from vlp_tpu.evals.cider import CiderScorer as JaxCiderScorer
from vlp_tpu.parallel import train_step as jts
from vlp_tpu_torch.checkpoint import state_dict_from_flax
from vlp_tpu_torch.cli import e2e_synthetic as e2e
from vlp_tpu_torch.cli.decode import to_device
from vlp_tpu_torch.decode import DecodeParams, Decoder
from vlp_tpu_torch.data.example_builder import TrainExampleBuilder
from vlp_tpu_torch.models.model import VLPModel

K, GROUPS = 10, 2
CPU = torch.device("cpu")


@pytest.fixture(autouse=True)
def two_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def test_mle_groups_and_greedy_match_jax():
    steps = K * GROUPS
    args = e2e.build_parser().parse_args(
        ["--device", "cpu", "--steps", str(steps)])
    cfg = e2e.make_config(CPU, len(e2e.make_vocab())).replace(
        hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
    task = e2e.ClusterTask(cfg, args.clusters, args.eval_images)

    # JAX: the tool's init, optimizer and K-step groups
    jcfg = JaxConfig(**dataclasses.asdict(cfg))
    jmodel = jts.create_model(jcfg)
    state, tx = jts.create_train_state(jmodel, jcfg, jax.random.PRNGKey(0),
                                       lr=e2e.CPU_LR, warmup=0.05,
                                       t_total=steps)
    params0 = jax.tree_util.tree_map(np.asarray, state.params)
    multi = jax.jit(jts.make_multi_step(jmodel, tx), donate_argnums=(0,))
    loader = task.loader(TrainExampleBuilder(cfg, task.vocab, mode="s2s",
                                             mask_prob=0.5),
                         args.batch, seed=1)
    batches, epoch = [], 0
    while len(batches) < steps:
        for b in loader.epoch(epoch):
            batches.append(b)
            if len(batches) == steps:
                break
        epoch += 1
    want = []
    for g in range(GROUPS):
        stacked = {k: jnp.asarray(v) for k, v in
                   jts.stack_batches(batches[g * K:(g + 1) * K]).items()}
        state, m = multi(state, stacked, jax.random.PRNGKey(g), 0.0)
        want.append(np.asarray(m["loss"]))

    # the port: the tool's MLE phase from the same init
    model = VLPModel(cfg)
    model.load_state_dict(state_dict_from_flax(params0, cfg), strict=True)
    got, done = e2e.train_mle(model, task, args, e2e.CPU_LR, CPU)
    assert done == steps
    np.testing.assert_allclose(np.concatenate(got), np.concatenate(want),
                               rtol=1e-4)

    v = task.vocab
    jdec = JaxDecoder(jmodel, jcfg, JaxDecodeParams(
        mask_id=v["[MASK]"], eos_id=v["[SEP]"], pad_id=v["[PAD]"],
        max_tgt_length=cfg.max_len_b))
    jids, _ = jdec.greedy(state.params, {k: jnp.asarray(x) for k, x in
                                         task.eval_batch.items()})
    jcider, _ = JaxCiderScorer().compute_score(
        task.gts, task.captions(np.asarray(jids)))
    cider, res = task.score(model)
    assert res == task.captions(np.asarray(jids))
    assert abs(cider - jcider) <= 1e-6
    # the greedy ids themselves, not only their captions
    ids, _ = Decoder(model, cfg, DecodeParams(
        mask_id=v["[MASK]"], eos_id=v["[SEP]"], pad_id=v["[PAD]"],
        max_tgt_length=cfg.max_len_b)).greedy(to_device(task.eval_batch,
                                                        CPU))
    np.testing.assert_array_equal(ids.numpy(), np.asarray(jids))


def test_tool_passes_with_scst(capsys):
    out = e2e.main(["--device", "cpu"])
    printed = capsys.readouterr().out
    assert out["ok"], printed
    assert printed.strip().splitlines()[-1] == "PASS"
    bar = max(1.0, out["untrained_cider"] + 1.0)
    assert out["cider"] > bar
    assert out["loss_last"] < out["loss_first"]
    assert out["steps"] == 300

    args = e2e.build_parser().parse_args(["--device", "cpu",
                                          "--scst_steps", "20"])
    rewards, done = e2e.train_scst(out["model"], out["task"], args,
                                   e2e.CPU_SCST_LR, CPU)
    assert done == 20
    assert np.isfinite(rewards).all() and np.abs(rewards).max() > 0
    assert out["task"].score(out["model"])[0] > bar
