"""The port's data parallelism (vlp_tpu_torch/parallel/ and the SCST
trainer's ``dist``) on two CPU processes under gloo, against the JAX
package on its virtual CPU mesh and against the port's single-process
step.  ``VLPConfig.tiny`` (2 layers, hidden 32, 2 heads), fp32, dropout 0.

* ``make_dp_train_step`` on 2 ranks against JAX ``make_shard_map_step`` on
  ``make_mesh(data=2, model=1)``, one step at constant lr (``t_total=-1``,
  so the update is not 0), global B=8, for ``grad_accum`` 1 and 2: the
  parameters within rtol 1e-4 / atol 1e-5 (fp32 reassociation, the
  tolerance of tests/test_torch_train_step.py), and the same against the
  port's single-process step on the global batch with ``grad_accum``
  2 x that (each rank's micro-batches are the global batch's, in order).
* The SCST reward on 2 ranks, scored over the gathered global batch,
  equals JAX ``get_self_critical_reward`` on the whole batch.
* The SCST gradient of fixed rollouts on 2 ranks is the mean of the
  per-rank gradients (JAX ``pmean``s per-shard losses): it equals the
  single-process gradient of the global batch when every rank's loss mask
  has the same weight, and the mean of the two halves' when the masks
  differ (a sampled EOS and a pad).
* The loss-scaled step (``--true_fp16``): an inf in one rank's rows
  skips the step on both ranks.
* The helpers: the mean all-reduce with a parameter that has no gradient
  (and the refusal when the ranks disagree on it), the broadcasts, the
  metric mean, the gathers' rank order and the ceil-split.
"""

import dataclasses
import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vlp_tpu import scst as jscst
from vlp_tpu.checkpoint import params_to_torch
from vlp_tpu.parallel import mesh as mesh_lib
from vlp_tpu.parallel import pjit_step
from vlp_tpu.parallel import train_step as jts
from vlp_tpu_torch import optim as topt
from vlp_tpu_torch import scst
from vlp_tpu_torch import train_step as tts
from vlp_tpu_torch.config import VLPConfig as TorchConfig
from vlp_tpu_torch.models.model import VLPModel
from vlp_tpu_torch.ops.philox import step_seed
from vlp_tpu_torch.parallel import Dist

from tests.test_torch_model import EOS, MASK, decode_batch
from tests.test_torch_train_step import TOL, init_params, make_batch, tiny_cfg

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD, B, T, LR = 2, 8, 5, 1e-3
ACCUMS = (1, 2)

CHILD = r"""
import sys
import numpy as np
import torch
torch.set_num_threads(1)
from vlp_tpu_torch import optim, parallel, scst
from vlp_tpu_torch.models.model import VLPModel
from vlp_tpu_torch.parallel.dp_step import make_dp_train_step

job_path, rank, port, out = sys.argv[1], int(sys.argv[2]), sys.argv[3], \
    sys.argv[4]
job = torch.load(job_path, weights_only=False)
world = job["world"]
dist = parallel.init("cpu", init_method=f"tcp://127.0.0.1:{port}",
                     world_size=world, rank=rank)
res = {}


def rows(x):
    n = len(x) // world
    return x[rank * n:(rank + 1) * n]


for accum, (state, batch) in job["steps"].items():
    model = VLPModel(job["cfg"])
    model.load_state_dict(state)
    opt = optim.BertAdam(dict(model.named_parameters()), job["lr"],
                         warmup=0.1, t_total=-1)
    step = make_dp_train_step(model, opt, dist, grad_accum=accum)
    m = step({k: torch.from_numpy(rows(v)) for k, v in batch.items()}, 7)
    res[("step", accum)] = ({k: v.detach().clone()
                             for k, v in model.state_dict().items()},
                            float(m["loss"]))

# the loss-scaled step: an inf in one rank's rows skips the step everywhere
state, good, bad = job["skip"]
model = VLPModel(job["cfg"])
model.load_state_dict(state)
opt = optim.BertAdam(dict(model.named_parameters()), job["lr"], warmup=0.1,
                     t_total=-1)
step = make_dp_train_step(model, opt, dist,
                          loss_scale=optim.DynamicLossScale(init_scale=8.0))
res["skip"] = []
for b in (good, bad):
    before = {k: v.detach().clone() for k, v in model.state_dict().items()}
    m = step({k: torch.from_numpy(rows(v)) for k, v in b.items()}, 7)
    res["skip"].append((
        float(m["skipped_step"]), float(opt.loss_scale["scale"]),
        int(opt.loss_scale["good_steps"]), int(opt.step_count),
        all(torch.equal(v, before[k]) for k, v in model.state_dict().items())))

greedy, gt, sample = job["reward"]
res["reward"] = scst.global_reward(rows(greedy), rows(gt), rows(sample),
                                   dist)

model = VLPModel(job["scst_cfg"])
model.load_state_dict(job["scst_state"])
tr = scst.SCSTTrainer(model, job["scst_cfg"], mask_id=job["mask"],
                      eos_id=job["eos"], max_tgt_length=job["T"], dist=dist)
batch = {k: torch.from_numpy(rows(v)) for k, v in job["scst_batch"].items()}
for case, (raw, clean, reward) in job["scst_rollouts"].items():
    loss = tr.replay_grads(batch, rows(raw), rows(clean), rows(reward), 3)
    res[("scst", case)] = (float(loss), {
        n: (torch.zeros_like(p) if p.grad is None else p.grad.clone())
        for n, p in model.named_parameters()})

# the helpers
lin = torch.nn.Linear(3, 2)
torch.manual_seed(rank)           # different weights on each rank
lin2 = torch.nn.Linear(3, 2)
dist.broadcast_params(lin2)
lin.weight.grad = torch.full((2, 3), float(rank + 1))
dist.all_reduce_grads(lin.parameters())   # bias: no grad on any rank
res["grads"] = (lin.weight.grad.clone(), lin.bias.grad)
lin.bias.grad = torch.ones(2) if rank == 0 else None
try:
    dist.all_reduce_grads(lin.parameters())
    res["disagree"] = "no error"
except RuntimeError as e:
    res["disagree"] = str(e)
res["bcast_params"] = lin2.weight.detach().clone()
res["ints"] = dist.broadcast_ints([rank + 5, 2 * rank])
res["mean"] = dist.all_reduce_mean({"a": torch.tensor(float(rank)),
                                    "b": 3.0 * rank})
res["gather"] = dist.gather_objects(("rank", rank))
res["all_gather"] = dist.all_gather_objects(rank * 10)
res["shard"] = [list(dist.shard(n)) for n in (7, 8, 1)]
res["rank_seed"] = dist.rank_seed(7)
dist.barrier()
dist.destroy()
torch.save(res, out)
"""


def free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def spawn(script, args_of_rank, world=WORLD, env_of_rank=None, timeout=300):
    """Run ``script`` in ``world`` processes (args and env per rank);
    returns their (returncode, output) in rank order."""
    env = dict(os.environ, OMP_NUM_THREADS="1")
    env["PYTHONPATH"] = ROOT + os.pathsep + env.get("PYTHONPATH", "")
    procs = [subprocess.Popen(
        [sys.executable, "-c", script, *args_of_rank(r)], cwd=ROOT,
        env=dict(env, **(env_of_rank(r) if env_of_rank else {})),
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
        for r in range(world)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=timeout)[0].decode(
                errors="replace"))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    return [(p.returncode, o) for p, o in zip(procs, outs)]


def torch_cfg(cfg):
    return TorchConfig(**dataclasses.asdict(cfg))


def _by_name(tree, cfg):
    return {k: torch.from_numpy(np.array(v))
            for k, v in params_to_torch(tree, cfg).items()}


def scst_rollouts(rng, vocab_size):
    """Fixed (raw, cleaned, reward) of the global batch: full loss masks on
    both ranks, or a sampled EOS and a pad that make them differ."""
    out = {}
    for case in ("equal_masks", "eos_and_pad"):
        raw = rng.integers(6, vocab_size, size=(B, T))
        if case == "eos_and_pad":
            raw[0, 2] = EOS
            raw[1, 1] = 0
        clean = scst.clean_rollout(raw, EOS, 0)
        reward = np.repeat(rng.normal(size=(B, 1)), T, 1).astype(np.float32)
        out[case] = (raw, clean, reward)
    return out


@pytest.fixture(scope="module")
def dp(tmp_path_factory):
    """The inputs, and what two gloo ranks computed from them."""
    d = tmp_path_factory.mktemp("dp")
    rng = np.random.default_rng(0)
    cfg = tiny_cfg()
    params = init_params(cfg, 0)
    state = _by_name(params, cfg)
    batches = {a: make_batch(cfg, B, rng, 0.0) for a in ACCUMS}
    scfg = tiny_cfg(max_len_b=T, len_vis_input=6, use_pallas_decode=True,
                    relax_projection=0)
    sparams = init_params(scfg, 6)
    sbatch = decode_batch(scfg, B, rng)
    gt = rng.integers(1, 9, (B, T + 1))
    greedy = gt[:, :T].copy()
    greedy[::2, -3:] = rng.integers(1, 9, (B // 2, 3))
    sample = rng.integers(1, 9, (B, T))
    sample[1] = gt[1, :T]
    bad = {k: v.copy() for k, v in batches[1].items()}
    bad["vis_feats"][B - 3, 0, 0] = np.inf     # a row of rank 1 only
    job = dict(world=WORLD, cfg=torch_cfg(cfg), lr=LR,
               steps={a: (state, batches[a]) for a in ACCUMS},
               skip=(state, batches[2], bad),
               reward=(greedy, gt, sample),
               scst_cfg=torch_cfg(scfg), scst_state=_by_name(sparams, scfg),
               scst_batch=sbatch, mask=MASK, eos=EOS, T=T,
               scst_rollouts=scst_rollouts(rng, scfg.vocab_size))
    job_path = str(d / "job.pt")
    torch.save(job, job_path)
    port = str(free_port())
    runs = spawn(CHILD, lambda r: [job_path, str(r), port,
                                   str(d / f"out{r}.pt")])
    for rc, text in runs:
        assert rc == 0, text[-4000:]
    outs = [torch.load(str(d / f"out{r}.pt"), weights_only=False)
            for r in range(WORLD)]
    return dict(cfg=cfg, params=params, batches=batches, outs=outs,
                scfg=scfg, sparams=sparams, job=job)


@pytest.mark.parametrize("accum", ACCUMS)
def test_dp_step_matches_jax_shard_map_and_the_global_step(dp, accum):
    cfg, params, batch = dp["cfg"], dp["params"], dp["batches"][accum]
    (p0, loss0), (p1, loss1) = (o[("step", accum)] for o in dp["outs"])
    # the replicas hold the same parameters and report the same mean loss
    for name in p0:
        assert torch.equal(p0[name], p1[name]), name
    assert loss0 == loss1

    jmodel = jts.create_model(cfg)
    tx = jts.make_optimizer(cfg, params, lr=LR, warmup=0.1, t_total=-1)
    state = jts.TrainState(params=params, opt_state=tx.init(params),
                           step=jnp.zeros((), jnp.int32))
    mesh = mesh_lib.make_mesh(data=WORLD, model=1,
                              devices=jax.devices()[:WORLD])
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    step = pjit_step.make_shard_map_step(jmodel, tx, mesh, grad_accum=accum)
    new, metrics = step(state, jb)(state, jb, jax.random.PRNGKey(7), 0.0)
    np.testing.assert_allclose(loss0, float(metrics["loss"]), rtol=1e-5,
                               atol=1e-6)
    want = _by_name(new.params, cfg)
    moved = 0.0
    for name, p in p0.items():
        np.testing.assert_allclose(p.numpy(), want[name].numpy(), **TOL,
                                   err_msg=name)
        moved = max(moved, float((p - dp["job"]["steps"][accum][0][name])
                                 .abs().max()))
    assert moved > 1e-4   # the step did move the parameters

    model = VLPModel(cfg)
    model.load_state_dict(dp["job"]["steps"][accum][0])
    opt = topt.BertAdam(dict(model.named_parameters()), LR, warmup=0.1,
                        t_total=-1)
    m = tts.make_train_step(model, opt, grad_accum=WORLD * accum)(
        {k: torch.from_numpy(v) for k, v in batch.items()}, 7)
    np.testing.assert_allclose(loss0, float(m["loss"]), rtol=1e-5, atol=1e-6)
    for name, p in model.state_dict().items():
        np.testing.assert_allclose(p0[name].numpy(), p.numpy(), **TOL,
                                   err_msg=name)


def test_dp_loss_scaled_step_skips_on_every_rank(dp):
    """--true_fp16 under data parallel: the ranks unscale and check the
    all-reduced gradients, so an overflow in rank 1's rows alone skips the
    step (parameters, moments and BertAdam's step kept, scale halved) on
    rank 0 too, and the replicas stay equal."""
    want = [(0.0, 8.0, 1, 1, False), (1.0, 4.0, 0, 1, True)]
    assert [o["skip"] for o in dp["outs"]] == [want, want]


def test_reward_is_scored_over_the_global_batch(dp):
    greedy, gt, sample = dp["job"]["reward"]
    want = jscst.get_self_critical_reward(greedy, gt, sample)
    got = np.concatenate([o["reward"][0] for o in dp["outs"]])
    np.testing.assert_array_equal(got, want)
    for o in dp["outs"]:
        assert o["reward"][1] == float(want[:, 0].mean())
    # a per-rank score differs: CIDEr's document frequencies are the batch's
    half = jscst.get_self_critical_reward(greedy[:B // 2], gt[:B // 2],
                                          sample[:B // 2])
    assert not np.array_equal(half, want[:B // 2])


@pytest.mark.parametrize("case", ["equal_masks", "eos_and_pad"])
def test_dp_scst_gradient_is_the_mean_of_the_ranks(dp, case):
    cfg = dp["scfg"]
    raw, clean, reward = dp["job"]["scst_rollouts"][case]
    batch = {k: torch.from_numpy(v) for k, v in dp["job"]["scst_batch"].items()}

    def grads(rows):
        model = VLPModel(cfg)
        model.load_state_dict(dp["job"]["scst_state"])
        tr = scst.SCSTTrainer(model, cfg, mask_id=MASK, eos_id=EOS,
                              max_tgt_length=T)
        loss = tr.replay_grads({k: v[rows] for k, v in batch.items()},
                               raw[rows], clean[rows], reward[rows], 3)
        return float(loss), {n: (torch.zeros_like(p) if p.grad is None
                                 else p.grad)
                             for n, p in model.named_parameters()}

    (l0, g0), (l1, g1) = (o[("scst", case)] for o in dp["outs"])
    assert l0 == l1 and all(torch.equal(g0[n], g1[n]) for n in g0)
    halves = [grads(slice(r * B // 2, (r + 1) * B // 2)) for r in range(2)]
    want_loss = (halves[0][0] + halves[1][0]) / 2
    want = {n: (halves[0][1][n] + halves[1][1][n]) / 2 for n in g0}
    if case == "equal_masks":
        want_loss, want = grads(slice(None))
    np.testing.assert_allclose(l0, want_loss, rtol=1e-5)
    for n, g in g0.items():
        np.testing.assert_allclose(g.numpy(), want[n].numpy(), **TOL,
                                   err_msg=n)
    assert max(float(g.abs().max()) for g in g0.values()) > 1e-3


def test_helpers(dp):
    o0, o1 = dp["outs"]
    for o in (o0, o1):
        w, b = o["grads"]
        assert torch.equal(w, torch.full((2, 3), 1.5)) and b is None
        assert "disagree" in o["disagree"]
        assert o["ints"] == [5, 0]
        assert float(o["mean"]["a"]) == 0.5 and o["mean"]["b"] == 1.5
        assert torch.is_tensor(o["mean"]["a"])
        assert isinstance(o["mean"]["b"], float)
        assert o["all_gather"] == [0, 10]
        assert o["shard"][0] == ([0, 1, 2, 3] if o is o0 else [4, 5, 6])
        assert o["shard"][1] == ([0, 1, 2, 3] if o is o0 else [4, 5, 6, 7])
        assert o["shard"][2] == ([0] if o is o0 else [])
        assert o["rank_seed"] == step_seed(7, 0 if o is o0 else 1)
    assert Dist().rank_seed(7) == 7      # a world of one: the seed itself
    assert torch.equal(o0["bcast_params"], o1["bcast_params"])
    assert o0["gather"] == [("rank", 0), ("rank", 1)]
    assert o1["gather"] is None
