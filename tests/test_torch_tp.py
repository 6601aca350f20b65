"""The port's manual tensor parallelism (``ops/tp.py``,
``parallel/mesh.py``, ``parallel/tp_step.py``, the model's f/g and the
clip's all-reduce) on four gloo CPU processes, against the JAX package's
shard_map tensor parallelism on its virtual CPU mesh and against the
port's single-process step.  ``VLPConfig.tiny`` (2 layers, hidden 32, 2
heads: one a rank at tp = 2), fp32, dropout 0 unless stated.

The four processes first form dp x tp = 2 x 2, then two worlds of
dp x tp = 1 x 2 (ranks 0-1 and 2-3, one for each accumulation).

* f and g against ``vlp_tpu/ops/tp.py`` under shard_map on a 1 x 2 mesh:
  a column-parallel then row-parallel product, forward and every
  gradient, within 1e-6.
* The shard rules equal ``mesh.tp_param_specs`` leaf for leaf (JAX's
  ``[in, out]`` kernels transposed); shard -> gather is exact; widths that
  do not divide raise.
* One TP step against JAX ``make_shard_map_step(..., tensor_parallel=
  True)`` at 1 x 2 and 2 x 2, accumulation 1 and 2, global B=8, from the
  same JAX init: loss within rtol 1e-5 / atol 1e-6, the gathered
  parameters within rtol 1e-4 / atol 1e-5 (fp32 reassociation, the
  tolerance of ``test_dp_step_matches_jax_shard_map_and_the_global_step``),
  and the same against the port's single-process step on the global batch.
* BertAdam's clip sees the whole parameter's norm: uniform gradients of
  norm > 1 give the single-process update's shard, and a clip without the
  all-reduce does not.
* The K-step loop (K = 2, eager on the CPU) at 2 x 2 equals two single TP
  steps bit for bit and JAX ``make_shard_map_multi_step`` within the step
  tolerances.
* Dropout 0.1 at 2 x 2: the ranks of a tp group draw identical hidden
  masks and different attention seeds, and their replicated parameters
  stay bit-identical over two steps; the seed slots of a captured replay
  (``DropoutRNG.plan``) carry the same fold as the eager seeds.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vlp_tpu.checkpoint import _torch_to_flax_map
from vlp_tpu.ops import tp as jtp
from vlp_tpu.parallel import mesh as jmesh
from vlp_tpu.parallel import pjit_step
from vlp_tpu.parallel import train_step as jts
from vlp_tpu_torch import optim as topt
from vlp_tpu_torch import train_step as tts
from vlp_tpu_torch.models.model import DropoutRNG, VLPModel
from vlp_tpu_torch.ops.philox import step_seed
from vlp_tpu_torch.ops.tp import TP
from vlp_tpu_torch.parallel import Dist, mesh

from tests.test_torch_parallel import _by_name, free_port, spawn, torch_cfg
from tests.test_torch_train_step import (LOSS_TOL, TOL, init_params,
                                         make_batch, tiny_cfg)

WORLD, TPN, B, LR, K = 4, 2, 8, 1e-3, 2
ACCUMS = (1, 2)
LAYOUTS = ("1x2", "2x2")

CHILD = r"""
import hashlib, sys
import torch
torch.set_num_threads(1)
import torch.distributed as tdist
from vlp_tpu_torch import optim, parallel
from vlp_tpu_torch import train_step as ts
from vlp_tpu_torch.models import model as mm
from vlp_tpu_torch.ops import tp as tp_ops
from vlp_tpu_torch.parallel import mesh
from vlp_tpu_torch.parallel.tp_step import (make_tp_multi_step,
                                            make_tp_train_step,
                                            sharded_names)

job_path, rank, out = sys.argv[1], int(sys.argv[2]), sys.argv[3]
ports = sys.argv[4:]
job = torch.load(job_path, weights_only=False)
res = {}


def local(batch, dist, stacked=False):
    # this data-parallel rank's rows (of each step's, when stacked)
    out = {}
    for k, v in batch.items():
        n = v.shape[int(stacked)] // dist.dp_world
        rows = slice(dist.dp_index * n, (dist.dp_index + 1) * n)
        out[k] = torch.from_numpy(v[:, rows] if stacked else v[rows])
    return out


def sharded(cfg, dist, clip=True):
    model = mm.VLPModel(cfg)
    model.load_state_dict(job["state"])
    model.shard_(dist.tensor_parallel)
    kw = (dict(clip_group=dist.tp_group, clip_sharded=sharded_names(model))
          if clip else {})
    opt = optim.BertAdam(dict(model.named_parameters()), job["lr"],
                         warmup=0.1, t_total=-1, **kw)
    return model, opt


def gathered(model, dist):
    return {k: v.detach().clone() for k, v in mesh.gather_full(
        model.state_dict(), dist.tp_index, dist.tp, dist.tp_group,
        model.tp_specs).items()}


def sha(t):
    return hashlib.sha256(t.detach().contiguous().numpy().tobytes()
                          ).hexdigest()


# ---- dp x tp = 2 x 2 over the four processes -----------------------------
world = parallel.init("cpu", init_method=f"tcp://127.0.0.1:{ports[0]}",
                      world_size=4, rank=rank)
dist = world.with_tensor_parallel(2)
res["layout"] = (dist.dp_index, dist.tp_index, dist.dp_world)
t = torch.full((3,), float(rank))
tp_ops.broadcast_from_first([t], dist.tensor_parallel)
res["bcast"] = t
for accum in job["accums"]:
    model, opt = sharded(job["cfg"], dist)
    step = make_tp_train_step(model, opt, dist, grad_accum=accum)
    m = step(local(job["batches"][accum], dist), 7)
    res[("2x2", accum)] = (gathered(model, dist), float(m["loss"]))

# the clip: uniform gradients, the whole parameter's norm (and without the
# all-reduce, the shard's)
for clip in (True, False):
    model, opt = sharded(job["cfg"], dist, clip=clip)
    for p in model.parameters():
        p.grad = torch.full_like(p, 0.37)
    opt.step()
    res[("clip", clip)] = gathered(model, dist)

# the K-step loop against K single steps
stacked = job["stacked"]
model, opt = sharded(job["cfg"], dist)
multi = make_tp_multi_step(model, opt, dist, K=len(job["seeds"]))
ms = multi(local(stacked, dist, stacked=True), job["seeds"])
res["multi"] = (gathered(model, dist), [float(x) for x in ms["loss"]])
model, opt = sharded(job["cfg"], dist)
step = make_tp_train_step(model, opt, dist)
one = local(stacked, dist, stacked=True)
singles = [float(step({k: v[i] for k, v in one.items()}, s)["loss"])
           for i, s in enumerate(job["seeds"])]
res["singles"] = (gathered(model, dist), singles)

# dropout on: hidden masks and attention seeds as each rank draws them
seeds, masks = [], []
seed0, hidden0 = mm.DropoutRNG.seed, mm.DropoutRNG.hidden


def seed_rec(self):
    s = seed0(self)
    seeds.append(int(s))
    return s


def hidden_rec(self, x, rate):
    y = hidden0(self, x, rate)
    masks.append(sha(y == 0))
    return y


mm.DropoutRNG.seed, mm.DropoutRNG.hidden = seed_rec, hidden_rec
model, opt = sharded(job["drop_cfg"], dist)
step = make_tp_train_step(model, opt, dist)
drop_losses = [float(step(local(job["batches"][1], dist), s)["loss"])
               for s in (3, 4)]
mm.DropoutRNG.seed, mm.DropoutRNG.hidden = seed0, hidden0
res["drop"] = dict(
    seeds=seeds, masks=masks, losses=drop_losses,
    replicated={n: sha(p) for n, p in model.named_parameters()
                if mesh.shard_dim(n) is None},
    params=gathered(model, dist))
world.destroy()

# ---- two worlds of dp x tp = 1 x 2: ranks 0-1 and 2-3 ----------------------
pair = rank // 2
world = parallel.init("cpu",
                      init_method=f"tcp://127.0.0.1:{ports[1 + pair]}",
                      world_size=2, rank=rank % 2)
dist = world.with_tensor_parallel(2)
accum = job["accums"][pair]
model, opt = sharded(job["cfg"], dist)
step = make_tp_train_step(model, opt, dist, grad_accum=accum)
m = step({k: torch.from_numpy(v) for k, v in job["batches"][accum].items()},
         7)
res[("1x2", accum)] = (gathered(model, dist), float(m["loss"]))

# f and g on a column- then row-parallel product (world = one tp group)
x, w1, w2, c = (torch.from_numpy(a) for a in job["fg"])
tp = tp_ops.TP(index=rank % 2, size=2, group=None)
w1 = w1[:, tp.index * 3:(tp.index + 1) * 3].clone().requires_grad_()
w2 = w2[tp.index * 3:(tp.index + 1) * 3].clone().requires_grad_()
x = x.clone().requires_grad_()
y = tp_ops.sum_partial(tp_ops.replicate_for_branch(x, tp) @ w1 @ w2, tp)
loss = (y * c).sum()
loss.backward()
res["fg"] = (y.detach(), float(loss), x.grad, w1.grad, w2.grad)
tdist.barrier()
world.destroy()
torch.save(res, out)
"""


@pytest.fixture(scope="module")
def tp(tmp_path_factory):
    """The inputs, and what the four gloo processes computed from them."""
    d = tmp_path_factory.mktemp("tp")
    rng = np.random.default_rng(0)
    cfg = tiny_cfg()
    params = init_params(cfg, 0)
    batches = {a: make_batch(cfg, B, rng, 0.0) for a in ACCUMS}
    group = [make_batch(cfg, B, rng, 0.0) for _ in range(K)]
    stacked = {k: np.stack([b[k] for b in group]) for k in group[0]}
    fg = (rng.normal(size=(5, 4)), rng.normal(size=(4, 6)),
          rng.normal(size=(6, 7)), rng.normal(size=(5, 7)))
    fg = tuple(a.astype(np.float32) for a in fg)
    drop_cfg = cfg.replace(hidden_dropout_prob=0.1,
                           attention_probs_dropout_prob=0.1)
    job = dict(cfg=torch_cfg(cfg), drop_cfg=torch_cfg(drop_cfg), lr=LR,
               state=_by_name(params, cfg), batches=batches, accums=ACCUMS,
               stacked=stacked, seeds=[11, 12], fg=fg)
    job_path = str(d / "job.pt")
    torch.save(job, job_path)
    ports = []
    while len(ports) < 3:
        p = free_port()
        if p not in ports:
            ports.append(p)
    runs = spawn(CHILD, lambda r: [job_path, str(r), str(d / f"out{r}.pt"),
                                   *map(str, ports)], world=WORLD)
    for rc, text in runs:
        assert rc == 0, text[-4000:]
    outs = [torch.load(str(d / f"out{r}.pt"), weights_only=False)
            for r in range(WORLD)]
    return dict(cfg=cfg, params=params, job=job, outs=outs)


def _jax_state(cfg, params, tp_axis):
    tx = jts.make_optimizer(cfg, params, lr=LR, warmup=0.1, t_total=-1,
                            clip_psum_axis=tp_axis)
    return jts.TrainState(params=params, opt_state=tx.init(params),
                          step=jnp.zeros((), jnp.int32)), tx


def _jax_mesh(dp):
    return jmesh.make_mesh(data=dp, model=TPN,
                           devices=jax.devices()[:dp * TPN])


def test_f_and_g_match_jax_shard_map(tp):
    """Megatron f (identity forward, psum backward) and g (psum forward,
    identity backward) around x @ W1[:, cols] @ W2[rows, :]: the output,
    the loss and the gradients of x (replicated) and of each rank's shards
    equal JAX's under shard_map on a 1 x 2 mesh."""
    from jax import shard_map
    from jax.sharding import PartitionSpec as P
    x, w1, w2, c = (jnp.asarray(a) for a in tp["job"]["fg"])

    def local(x, w1, w2, c):
        def loss(x, w1, w2):
            y = jtp.sum_partial(jtp.replicate_for_branch(x, "model") @ w1
                                @ w2, "model")
            return jnp.sum(y * c), y
        (val, y), grads = jax.value_and_grad(loss, argnums=(0, 1, 2),
                                             has_aux=True)(x, w1, w2)
        return y, val, grads

    col, row = P(None, "model"), P("model", None)
    fn = shard_map(local, mesh=jmesh.make_mesh(data=1, model=2,
                                               devices=jax.devices()[:2]),
                   in_specs=(P(), col, row, P()),
                   out_specs=(P(), P(), (P(), col, row)), check_vma=False)
    y, val, (gx, g1, g2) = jax.jit(fn)(x, w1, w2, c)
    outs = [o["fg"] for o in tp["outs"]]
    for r, (ty, tloss, tgx, tg1, tg2) in enumerate(outs):
        t = r % 2
        np.testing.assert_allclose(ty.numpy(), np.asarray(y), rtol=1e-6,
                                   atol=1e-6)
        np.testing.assert_allclose(tloss, float(val), rtol=1e-6)
        np.testing.assert_allclose(tgx.numpy(), np.asarray(gx), rtol=1e-6,
                                   atol=1e-6)
        np.testing.assert_allclose(tg1.numpy(),
                                   np.asarray(g1)[:, t * 3:(t + 1) * 3],
                                   rtol=1e-6, atol=1e-6)
        np.testing.assert_allclose(tg2.numpy(),
                                   np.asarray(g2)[t * 3:(t + 1) * 3],
                                   rtol=1e-6, atol=1e-6)
    # the replicated gradient is the same on both ranks of a group
    assert torch.equal(outs[0][2], outs[1][2])


def test_shard_rules_match_jax_and_round_trip(tp):
    cfg, params = tp["cfg"], tp["params"]
    specs = jmesh.tp_param_specs(params, TPN)
    want = {}
    for name, (path, transpose) in _torch_to_flax_map(cfg).items():
        node = specs
        for p in path:
            node = node[p] if isinstance(node, dict) and p in node else None
            if node is None:
                break
        if node is None:
            continue
        dims = [i for i, a in enumerate(node) if a == "model"]
        assert len(dims) <= 1
        d = dims[0] if dims else None
        if d is not None and transpose:
            d = 1 - d                    # [in, out] -> [out, in]
        want[name] = d
    state = tp["job"]["state"]
    got = mesh.tp_param_specs({k: v.shape for k, v in state.items()}, TPN)
    assert {k: got[k] for k in want} == want
    sharded = {k for k, d in got.items() if d is not None}
    assert len(sharded) == 2 * 10 and all(".encoder.layer." in k
                                         for k in sharded)
    shards = [mesh.shard_state_dict(state, t, TPN) for t in range(TPN)]
    assert shards[0]["bert.encoder.layer.0.attention.self.query.weight"
                     ].shape == (16, 32)
    assert shards[1]["bert.encoder.layer.1.output.dense.weight"
                     ].shape == (32, 32)
    back = mesh.gather_state_dict(shards, got)
    assert back.keys() == state.keys()
    for k in state:
        assert torch.equal(back[k], state[k]), k
    with pytest.raises(ValueError, match="divide"):
        mesh.shard_state_dict(state, 0, 3)
    model = VLPModel(torch_cfg(cfg.replace(num_attention_heads=1)))
    with pytest.raises(ValueError, match="divide"):
        model.shard_(TP(index=0, size=2))


@pytest.mark.parametrize("layout", LAYOUTS)
@pytest.mark.parametrize("accum", ACCUMS)
def test_tp_step_matches_jax_shard_map_and_the_global_step(tp, layout,
                                                           accum):
    cfg, params = tp["cfg"], tp["params"]
    batch = tp["job"]["batches"][accum]
    dp = int(layout[0])
    ranks = range(WORLD) if dp == 2 else (
        (0, 1) if accum == ACCUMS[0] else (2, 3))
    got = [tp["outs"][r][(layout, accum)] for r in ranks]
    p0, loss0 = got[0]
    for p, loss in got[1:]:          # every rank gathers the same model
        assert loss == loss0
        assert all(torch.equal(p[k], p0[k]) for k in p0)

    state, _ = _jax_state(cfg, params, None)
    _, tx = _jax_state(cfg, params, "model")
    jmodel = jts.create_model(cfg.replace(tp_axis="model"))
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    step = pjit_step.make_shard_map_step(jmodel, tx, _jax_mesh(dp),
                                         grad_accum=accum,
                                         tensor_parallel=True)
    new, metrics = step(state, jb)(state, jb, jax.random.PRNGKey(7), 0.0)
    np.testing.assert_allclose(loss0, float(metrics["loss"]), **LOSS_TOL)
    want = _by_name(new.params, cfg)
    init = tp["job"]["state"]
    moved = 0.0
    for name, p in p0.items():
        np.testing.assert_allclose(p.numpy(), want[name].numpy(), **TOL,
                                   err_msg=name)
        moved = max(moved, float((p - init[name]).abs().max()))
    assert moved > 1e-4

    model = VLPModel(torch_cfg(cfg))
    model.load_state_dict(init)
    opt = topt.BertAdam(dict(model.named_parameters()), LR, warmup=0.1,
                        t_total=-1)
    m = tts.make_train_step(model, opt, grad_accum=dp * accum)(
        {k: torch.from_numpy(v) for k, v in batch.items()}, 7)
    np.testing.assert_allclose(loss0, float(m["loss"]), **LOSS_TOL)
    for name, p in model.state_dict().items():
        np.testing.assert_allclose(p0[name].numpy(), p.numpy(), **TOL,
                                   err_msg=name)


def test_clip_sees_the_whole_parameter_norm(tp):
    """tests/test_parallel.py's clip test on the port: a uniform gradient
    of 0.37 has norm > 1 on every sharded leaf, and its shard's norm is
    the whole one over sqrt(2), so a clip without the all-reduce scales it
    differently."""
    model = VLPModel(torch_cfg(tp["cfg"]))
    model.load_state_dict(tp["job"]["state"])
    opt = topt.BertAdam(dict(model.named_parameters()), LR, warmup=0.1,
                        t_total=-1)
    for p in model.parameters():
        p.grad = torch.full_like(p, 0.37)
    opt.step()
    want = model.state_dict()
    for o in tp["outs"]:
        got = o[("clip", True)]
        for k in want:
            np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                       rtol=1e-6, atol=1e-7, err_msg=k)
    local = tp["outs"][0][("clip", False)]
    name = "bert.encoder.layer.0.intermediate.dense.weight"
    assert not np.allclose(local[name].numpy(), want[name].numpy(),
                           rtol=1e-6, atol=1e-7)


def test_tp_multi_step_matches_single_steps_and_jax(tp):
    cfg, params = tp["cfg"], tp["params"]
    stacked = tp["job"]["stacked"]
    for o in tp["outs"]:
        (pm, lm), (ps, ls) = o["multi"], o["singles"]
        assert lm == ls
        assert all(torch.equal(pm[k], ps[k]) for k in pm)
    state, _ = _jax_state(cfg, params, None)
    _, tx = _jax_state(cfg, params, "model")
    mesh2 = _jax_mesh(2)
    sharded = pjit_step.shard_stacked_batch(
        {k: jnp.asarray(v) for k, v in stacked.items()}, mesh2)
    fn = pjit_step.make_shard_map_multi_step(
        jts.create_model(cfg.replace(tp_axis="model")), tx, mesh2,
        tensor_parallel=True)(state, sharded)
    new, metrics = fn(jax.tree_util.tree_map(jnp.array, state), sharded,
                      jax.random.PRNGKey(9), 0.0)
    pm, lm = tp["outs"][0]["multi"]
    np.testing.assert_allclose(lm, np.asarray(metrics["loss"]), **LOSS_TOL)
    want = _by_name(new.params, cfg)
    for name, p in pm.items():
        np.testing.assert_allclose(p.numpy(), want[name].numpy(), **TOL,
                                   err_msg=name)


def test_rank_layout_and_the_groups_first_rank(tp):
    """rank -> (dp, tp) = (rank // 2, rank % 2), and
    ``broadcast_from_first`` (the embedding tables' gradients) puts the
    group's first rank's values on both ranks of each group."""
    for r, o in enumerate(tp["outs"]):
        assert o["layout"] == (r // 2, r % 2, 2)
        assert torch.equal(o["bcast"], torch.full((3,), float(r - r % 2)))


def test_data_parallel_collectives_follow_the_layout():
    """The data-parallel means run where there is a data-parallel group: a
    formed group without tensor parallelism, whatever its size (a world
    of one over NCCL still reduces, as before), and under tensor
    parallelism only with more than one data-parallel rank."""
    assert not Dist().dp_grouped
    assert Dist(world=1, backend="nccl").dp_grouped
    assert Dist(world=2, backend="gloo").dp_grouped
    assert not Dist(world=2, backend="gloo", tp=2).dp_grouped
    assert Dist(world=4, rank=3, backend="gloo", tp=2).dp_grouped
    d = Dist(world=4, rank=3, backend="gloo", tp=2)
    assert (d.dp_index, d.tp_index, d.dp_world) == (1, 1, 2)
    assert d.rank_seed(7) == step_seed(7, 1)
    assert Dist(world=2, rank=1, backend="gloo", tp=2).rank_seed(7) == 7
    assert list(d.shard(7)) == [4, 5, 6]


def test_dropout_hidden_masks_shared_attention_seeds_folded(tp):
    """At 2 x 2 with dropout 0.1: ranks 0 and 1 (one tp group) draw the
    same hidden masks and different attention seeds (``step_seed`` of one
    draw and their tp index), ranks 0 and 2 (one tp index, two dp ranks)
    other masks; the replicated parameters of a group stay bit-identical
    over two steps and its ranks report one loss."""
    d = [o["drop"] for o in tp["outs"]]
    n_layers = tp["cfg"].num_hidden_layers
    for g in ((0, 1), (2, 3)):
        a, b = d[g[0]], d[g[1]]
        assert a["masks"] == b["masks"] and len(a["masks"]) > 0
        assert len(a["seeds"]) == len(b["seeds"]) == 2 * n_layers
        assert all(x != y for x, y in zip(a["seeds"], b["seeds"]))
        assert a["replicated"] == b["replicated"]
        assert a["losses"] == b["losses"]
        assert all(torch.equal(a["params"][k], b["params"][k])
                   for k in a["params"])
    assert d[0]["masks"] != d[2]["masks"]
    assert np.isfinite(d[0]["losses"]).all()


def test_seed_slots_carry_the_tp_fold():
    """A captured replay's slots (``DropoutRNG.plan``) draw what the eager
    ``DropoutRNG`` draws, with and without the fold; the fold of index t
    is ``step_seed(seed, t)`` of the unfolded draw."""
    n = 4
    for fold in (None, 0, 1):
        hidden, slots = DropoutRNG.plan(99, n, fold)
        eager = DropoutRNG(99, "cpu", attn_fold=fold)
        assert [eager.seed() for _ in range(n)] == slots
        replay = DropoutRNG.from_slots(
            torch.tensor([s - (1 << 64) if s >= 1 << 63 else s
                          for s in slots]),
            torch.Generator().manual_seed(hidden))
        x = torch.ones(64)
        assert torch.equal(replay.hidden(x, 0.5),
                           DropoutRNG(99, "cpu", attn_fold=fold).hidden(
                               x, 0.5))
        assert [int(replay.seed()) % (1 << 64) for _ in range(n)] == slots
    plain = DropoutRNG.plan(99, n)[1]
    assert DropoutRNG.plan(99, n, 1)[1] == [step_seed(s, 1) for s in plain]
    assert DropoutRNG.plan(99, n, 0)[1] != DropoutRNG.plan(99, n, 1)[1]
    assert DropoutRNG.plan(99, n, 0)[0] == DropoutRNG.plan(99, n, 1)[0]
