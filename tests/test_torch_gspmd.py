"""The port's GSPMD tensor parallelism (``--tp_impl gspmd``: the layout of
``parallel/mesh.py``, the collectives of ``ops/tp.py``, the vocab-parallel
loss of ``losses.py`` and the model's use of them) on four gloo CPU
processes, against the JAX package's ``make_pjit_train_step(...,
tensor_parallel=True)`` on its virtual CPU mesh, against the port's
single-process step and against its shard_map TP step.
``VLPConfig.tiny`` with 4 heads (so tp = 4 runs; its 6-row type table then
does not divide and stays whole), relax projection 4, label smoothing 0.1,
fp32, dropout 0 unless stated.

The four processes form dp x tp = 2 x 2, then 1 x 4 in the same world,
then two worlds of dp x tp = 1 x 2 (ranks 0-1 and 2-3, one for each
accumulation).

* The shard rules equal JAX ``param_sharding_tree(..., tensor_parallel=
  True)`` leaf for leaf at tp = 2 and 4 (JAX's ``[in, out]`` kernels
  transposed), replication where a dim does not divide included, except
  the column-parallel biases, which the port stores with their columns
  (the listed deviation); shard -> gather is exact; the tied decoder stays
  one parameter.
* The vocab-parallel MLM loss equals ``vlp_tpu.losses.mlm_position_loss``
  on the full logits, forward and the logits' gradient, at smoothing 0 and
  0.1 with targets in every shard and some at ignore index 0, at tp = 2
  and 4; its per-position losses are bit-equal across the ranks.
* One GSPMD step at 1 x 2 and 2 x 2, accumulation 1 and 2, img2txt
  (region masking) and vqa2, and at 1 x 4 (img2txt): the loss within
  rtol 1e-5 / atol 1e-6 and the gathered parameters within rtol 1e-4 /
  atol 1e-5 of JAX's GSPMD step and of the port's single-process step on
  the global batch.  The data-parallel ranks hold, of each micro-batch of
  the global batch, their block in rank order, and the masked-LM loss is
  normalised over the global micro-batch, as JAX's GSPMD step computes it
  (also with drop-worst 0.5 at 2 x 2).  The shard_map TP step gives the
  same where the two normalise alike: with one data-parallel rank, and
  for vqa2 (a mean over equal shares); with two data-parallel ranks the
  shard_map step normalises the masked-LM loss per rank, as JAX's
  ``make_shard_map_step`` does.
* BertAdam's clip sees whole-parameter norms of the vocab-sharded tables,
  and a clip without the all-reduce does not.
* Dropout 0.1 at 2 x 2: the replicated parameters of a group stay
  bit-identical over two steps.
"""

import hashlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from vlp_tpu import losses as jlosses
from vlp_tpu.checkpoint import _torch_to_flax_map
from vlp_tpu.parallel import mesh as jmesh
from vlp_tpu.parallel import pjit_step
from vlp_tpu.parallel import train_step as jts
from vlp_tpu_torch import optim as topt
from vlp_tpu_torch import train_step as tts
from vlp_tpu_torch.models.model import VLPModel
from vlp_tpu_torch.ops.tp import TP
from vlp_tpu_torch.parallel import mesh

from tests.test_torch_parallel import _by_name, free_port, spawn, torch_cfg
from tests.test_torch_train_step import (LOSS_TOL, TOL, make_batch,
                                         tiny_cfg)
from tests.test_torch_vqa import N_ANSWERS, vqa_batch

WORLD, B, LR = 4, 8, 1e-3
# (layout, accumulation, task, drop-worst ratio) of each step compared
CASES = [("1x2", 1, "img2txt", 0.0), ("1x2", 1, "vqa2", 0.0),
         ("1x2", 2, "img2txt", 0.0), ("1x2", 2, "vqa2", 0.0),
         ("2x2", 1, "img2txt", 0.0), ("2x2", 1, "vqa2", 0.0),
         ("2x2", 2, "img2txt", 0.0), ("2x2", 2, "vqa2", 0.0),
         ("2x2", 1, "img2txt", 0.5), ("1x4", 1, "img2txt", 0.0)]
LOSS_V, LOSS_TPS = 40, (2, 4)
# the column-parallel biases, stored with their columns (JAX: replicated)
BIAS_DEVIATION = ("attention.self.query.bias", "attention.self.key.bias",
                  "attention.self.value.bias", "intermediate.dense.bias",
                  "cls.predictions.transform.dense.bias",
                  "vis_embed.0.bias", "ans_classifier.0.bias",
                  "cls.predictions.bias")

CHILD = r"""
import hashlib, sys
import torch
torch.set_num_threads(1)
import torch.distributed as tdist
from vlp_tpu_torch import losses, optim, parallel
from vlp_tpu_torch.models import model as mm
from vlp_tpu_torch.parallel import mesh
from vlp_tpu_torch.parallel.tp_step import make_tp_train_step, sharded_names

job_path, rank, out = sys.argv[1], int(sys.argv[2]), sys.argv[3]
ports = sys.argv[4:]
job = torch.load(job_path, weights_only=False)
res = {}


def local(batch, dist, accum):
    # this data-parallel rank's block of each micro-batch, in order
    dp, d = dist.dp_world, dist.dp_index
    mb = next(iter(batch.values())).shape[0] // accum
    n = mb // dp
    rows = [i * mb + d * n + j for i in range(accum) for j in range(n)]
    return {k: torch.from_numpy(v[rows]) for k, v in batch.items()}


def sharded(task, dist, layout, clip=True, cfg=None):
    vqa = task == "vqa2"
    model = mm.VLPModel(cfg or job["cfg"], with_vqa=vqa)
    model.load_state_dict(job["state_vqa" if vqa else "state"])
    model.shard_(dist.tensor_parallel, layout=layout)
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


def step_case(dist, case):
    layout_name, accum, task, ratio = case
    batch = local(job["batches"][(task, accum)], dist, accum)
    for layout in ("gspmd", "shard_map"):
        model, opt = sharded(task, dist, layout)
        step = make_tp_train_step(model, opt, dist, grad_accum=accum,
                                  task=task,
                                  mask_image_regions=task == "img2txt")
        m = step(batch, 7, ratio)
        res[case + (layout,)] = (gathered(model, dist), float(m["loss"]))


def loss_case(dist):
    logits, targets, c = (torch.from_numpy(a) for a in job["loss"])
    tp = dist.tensor_parallel
    n = logits.shape[-1] // tp.size
    z = logits[..., tp.index * n:(tp.index + 1) * n].clone()
    z.requires_grad_()
    for ls in (0.0, 0.1):
        z.grad = None
        per = losses.mlm_position_loss_vocab_parallel(
            z, targets, ls, logits.shape[-1], tp)
        (per * c).sum().backward()
        res[("loss", tp.size, ls)] = (per.detach().clone(), z.grad.clone())


# ---- dp x tp = 2 x 2, then 1 x 4, over the four processes ----------------
world = parallel.init("cpu", init_method=f"tcp://127.0.0.1:{ports[0]}",
                      world_size=4, rank=rank)
dist = world.with_tensor_parallel(2)
for case in job["cases"]:
    if case[0] == "2x2":
        step_case(dist, case)

# the clip: uniform gradients, the whole parameter's norm (and without the
# all-reduce, the shard's)
for clip in (True, False):
    model, opt = sharded("vqa2", dist, "gspmd", clip=clip)
    for p in model.parameters():
        p.grad = torch.full_like(p, 0.37)
    opt.step()
    res[("clip", clip)] = gathered(model, dist)

# dropout on: two steps, the replicated parameters' bits
model, opt = sharded("img2txt", dist, "gspmd", cfg=job["drop_cfg"])
step = make_tp_train_step(model, opt, dist, mask_image_regions=True)
batch = local(job["batches"][("img2txt", 1)], dist, 1)
losses_ = [float(step(batch, s)["loss"]) for s in (3, 4)]
res["drop"] = dict(
    losses=losses_,
    replicated={n: sha(p) for n, p in model.named_parameters()
                if model.tp_specs[n] is None},
    params=gathered(model, dist))

dist = world.with_tensor_parallel(4)
for case in job["cases"]:
    if case[0] == "1x4":
        step_case(dist, case)
loss_case(dist)
world.destroy()

# ---- two worlds of dp x tp = 1 x 2: ranks 0-1 and 2-3 ----------------------
pair = rank // 2
world = parallel.init("cpu",
                      init_method=f"tcp://127.0.0.1:{ports[1 + pair]}",
                      world_size=2, rank=rank % 2)
dist = world.with_tensor_parallel(2)
for case in job["cases"]:
    if case[0] == "1x2" and case[1] == (1, 2)[pair]:
        step_case(dist, case)
if pair == 0:
    loss_case(dist)
tdist.barrier()
world.destroy()
torch.save(res, out)
"""


def _cfg(**kw):
    return tiny_cfg(num_attention_heads=4, label_smoothing=0.1,
                    num_answers=N_ANSWERS, **kw)


def _img2txt(params):
    return {k: v for k, v in params.items() if not k.startswith("ans_")}


def _state(params, cfg):
    return {k: v.clone() for k, v in _by_name(params, cfg).items()}


@pytest.fixture(scope="module")
def gspmd(tmp_path_factory):
    """The inputs, and what the four gloo processes computed from them."""
    d = tmp_path_factory.mktemp("gspmd")
    rng = np.random.default_rng(0)
    cfg = _cfg()
    xla = cfg.replace(use_pallas_attention=False)
    params = jax.jit(lambda key: jts.init_params(
        jts.create_model(xla, "vqa2"), xla, key, "vqa2"))(
            jax.random.PRNGKey(0))
    params = jax.tree_util.tree_map(np.asarray, params)
    batches = {}
    for accum in (1, 2):
        batches[("img2txt", accum)] = make_batch(cfg, B, rng, 0.3)
        batches[("vqa2", accum)] = vqa_batch(cfg, B, rng)
    logits = rng.normal(size=(3, 5, LOSS_V)).astype(np.float32) * 3
    targets = rng.integers(0, LOSS_V, size=(3, 5))
    targets[0, :2] = 0                       # ignore index
    targets[1, :4] = [1, 12, 25, 39]         # one in every shard at tp = 4
    c = rng.normal(size=(3, 5)).astype(np.float32)
    drop_cfg = cfg.replace(hidden_dropout_prob=0.1,
                           attention_probs_dropout_prob=0.1)
    job = dict(cfg=torch_cfg(cfg), drop_cfg=torch_cfg(drop_cfg), lr=LR,
               state=_state(_img2txt(params), cfg),
               state_vqa=_state(params, cfg), batches=batches, cases=CASES,
               loss=(logits, targets, c))
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


# (mesh, accumulation, task) -> JAX's compiled GSPMD step, its initial
# state and mesh: the drop-worst ratio is an argument of the one step
_JAX_STEPS = {}


def _jax_gspmd_step(cfg, params, case, batch):
    layout, accum, task, ratio = case
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    if case[:3] not in _JAX_STEPS:
        dp, tp = (int(x) for x in layout.split("x"))
        xla = cfg.replace(use_pallas_attention=False)
        tx = jts.make_optimizer(xla, params, lr=LR, warmup=0.1, t_total=-1)
        state = jts.TrainState(params=params, opt_state=tx.init(params),
                               step=jnp.zeros((), jnp.int32))
        jmesh_ = jmesh.make_mesh(data=dp, model=tp,
                                 devices=jax.devices()[:dp * tp])
        fn = pjit_step.make_pjit_train_step(
            jts.create_model(xla, task), tx, jmesh_, tensor_parallel=True,
            mask_image_regions=task == "img2txt", task=task,
            grad_accum=accum)(state, jb)
        _JAX_STEPS[case[:3]] = fn, state, jmesh_
    fn, state, jmesh_ = _JAX_STEPS[case[:3]]
    new, metrics = fn(pjit_step.shard_state(state, jmesh_, True),
                      pjit_step.shard_batch(jb, jmesh_),
                      jax.random.PRNGKey(7), jnp.float32(ratio))
    return new.params, float(metrics["loss"])


def _ranks(case):
    layout, accum = case[0], case[1]
    if layout == "1x2":
        return (0, 1) if accum == 1 else (2, 3)
    return range(WORLD)


def test_shard_rules_match_jax_param_sharding_tree(gspmd):
    """Every weight and table at tp = 2 and 4, JAX's GSPMD spec transposed
    to ``[out, in]``; the column-parallel biases are the deviation; at tp
    = 4 the type table (6 rows) stays whole, as does a vocab of 42."""
    cfg, params = gspmd["cfg"], gspmd["params"]
    state = gspmd["job"]["state_vqa"]
    shapes = {k: v.shape for k, v in state.items()}
    for tp in (2, 4):
        tree = jmesh.param_sharding_tree(
            params, jmesh.make_mesh(data=1, model=tp,
                                    devices=jax.devices()[:tp]),
            tensor_parallel=True)
        got = mesh.tp_param_specs(shapes, tp, "gspmd")
        n_checked = 0
        for name, (path, transpose) in _torch_to_flax_map(cfg).items():
            node = tree
            for p in path:
                node = node[p]
            dims = [i for i, a in enumerate(node.spec) if a == "model"]
            want = dims[0] if dims else None
            if want is not None and transpose:
                want = 1 - want
            if name.endswith(BIAS_DEVIATION):
                assert want is None
                weight = name[:-len("bias")] + "weight"
                if name == "cls.predictions.bias":
                    weight = "bert.embeddings.word_embeddings.weight"
                assert got[name] == got[weight], name
            else:
                assert got[name] == want, (name, tp)
            n_checked += 1
        assert n_checked == len(_torch_to_flax_map(cfg))
        assert got["cls.predictions.decoder.weight"] == got[
            "bert.embeddings.word_embeddings.weight"] == 0
        assert got["bert.embeddings.token_type_embeddings.weight"] == (
            0 if tp == 2 else None)
        shards = [mesh.shard_state_dict(state, t, tp, "gspmd")
                  for t in range(tp)]
        assert shards[1]["bert.embeddings.word_embeddings.weight"].shape == (
            40 // tp, 32)
        back = mesh.gather_state_dict(shards, got)
        assert back.keys() == state.keys()
        assert all(torch.equal(back[k], state[k]) for k in state)
    odd = mesh.tp_param_specs({"bert.embeddings.word_embeddings.weight":
                               (42, 32)}, 4, "gspmd")
    assert odd == {"bert.embeddings.word_embeddings.weight": None}
    with pytest.raises(ValueError, match="layout"):
        mesh.shard_dim("vis_embed.0.weight", layout="pjit")


def test_the_tied_decoder_stays_one_parameter(gspmd):
    """Sharding keeps ``decoder.weight is word_embeddings.weight``;
    ``named_parameters`` (so BertAdam and the clip's names) sees it once."""
    model = VLPModel(torch_cfg(gspmd["cfg"]), with_vqa=True)
    model.load_state_dict(gspmd["job"]["state_vqa"])
    model.shard_(TP(index=1, size=2), layout="gspmd")
    word = model.bert.embeddings.word_embeddings.weight
    assert model.cls.predictions.decoder.weight is word
    assert word.shape == (20, 32)
    names = [n for n, _ in model.named_parameters()]
    assert "cls.predictions.decoder.weight" not in names
    assert names.count("bert.embeddings.word_embeddings.weight") == 1
    opt = topt.BertAdam(dict(model.named_parameters()), LR)
    assert list(opt.params) == names
    assert torch.equal(word, gspmd["job"]["state_vqa"][
        "bert.embeddings.word_embeddings.weight"][20:])


@pytest.mark.parametrize("tp", LOSS_TPS)
def test_vocab_parallel_loss_matches_jax(gspmd, tp):
    logits, targets, c = gspmd["job"]["loss"]
    ranks = range(tp)
    for ls in (0.0, 0.1):
        def f(z):
            per = jlosses.mlm_position_loss(z, jnp.asarray(targets), ls,
                                            LOSS_V)
            return jnp.sum(per * c), per
        (_, per_j), grad_j = jax.value_and_grad(f, has_aux=True)(
            jnp.asarray(logits))
        got = [gspmd["outs"][r][("loss", tp, ls)] for r in ranks]
        for per, _ in got:                 # bit-equal across the ranks
            assert torch.equal(per, got[0][0])
        np.testing.assert_allclose(got[0][0].numpy(), np.asarray(per_j),
                                   rtol=1e-5, atol=1e-6)
        grad = torch.cat([g for _, g in got], dim=-1)
        np.testing.assert_allclose(grad.numpy(), np.asarray(grad_j),
                                   rtol=1e-5, atol=1e-6)
        if ls:
            assert (got[0][0].numpy()[0, :2] == 0).all()


@pytest.mark.parametrize("case", CASES, ids=lambda c: "-".join(map(str, c)))
def test_gspmd_step_matches_jax_the_global_step_and_shard_map(gspmd, case):
    cfg = gspmd["cfg"]
    layout, accum, task, ratio = case
    params = gspmd["params"] if task == "vqa2" else _img2txt(gspmd["params"])
    init = gspmd["job"]["state_vqa" if task == "vqa2" else "state"]
    batch = gspmd["job"]["batches"][(task, accum)]
    got = [gspmd["outs"][r][case + ("gspmd",)] for r in _ranks(case)]
    p0, loss0 = got[0]
    for p, loss in got[1:]:          # every rank gathers the same model
        assert loss == loss0
        assert all(torch.equal(p[k], p0[k]) for k in p0)

    new, jloss = _jax_gspmd_step(cfg, params, case, batch)
    np.testing.assert_allclose(loss0, jloss, **LOSS_TOL)
    want = _by_name(new, cfg)
    moved = 0.0
    for name, p in p0.items():
        np.testing.assert_allclose(p.numpy(), want[name].numpy(), **TOL,
                                   err_msg=name)
        moved = max(moved, float((p - init[name]).abs().max()))
    assert moved > 1e-4

    model = VLPModel(torch_cfg(cfg), with_vqa=task == "vqa2")
    model.load_state_dict(init)
    opt = topt.BertAdam(dict(model.named_parameters()), LR, warmup=0.1,
                        t_total=-1)
    m = tts.make_train_step(model, opt, grad_accum=accum, task=task,
                            mask_image_regions=task == "img2txt")(
        {k: torch.from_numpy(v) for k, v in batch.items()}, 7, ratio)
    np.testing.assert_allclose(loss0, float(m["loss"]), **LOSS_TOL)
    for name, p in model.state_dict().items():
        np.testing.assert_allclose(p0[name].numpy(), p.numpy(), **TOL,
                                   err_msg=name)

    if layout.startswith("1x") or task == "vqa2":
        smap, sloss = gspmd["outs"][_ranks(case)[0]][case + ("shard_map",)]
        np.testing.assert_allclose(loss0, sloss, **LOSS_TOL)
        for name, p in smap.items():
            np.testing.assert_allclose(p0[name].numpy(), p.numpy(), **TOL,
                                       err_msg=name)


def test_clip_sees_the_whole_parameter_norm(gspmd):
    """A uniform gradient of 0.37 has norm > 1 on every leaf; the shard of
    a vocab-sharded table has the whole one's norm over sqrt(2), so a clip
    without the all-reduce scales it differently."""
    model = VLPModel(torch_cfg(gspmd["cfg"]), with_vqa=True)
    model.load_state_dict(gspmd["job"]["state_vqa"])
    opt = topt.BertAdam(dict(model.named_parameters()), LR, warmup=0.1,
                        t_total=-1)
    for p in model.parameters():
        p.grad = torch.full_like(p, 0.37)
    opt.step()
    want = model.state_dict()
    for o in gspmd["outs"]:
        got = o[("clip", True)]
        for k in want:
            np.testing.assert_allclose(got[k].numpy(), want[k].numpy(),
                                       rtol=1e-6, atol=1e-7, err_msg=k)
    local = gspmd["outs"][0][("clip", False)]
    for name in ("bert.embeddings.word_embeddings.weight",
                 "vis_embed.2.weight"):
        assert not np.allclose(local[name].numpy(), want[name].numpy(),
                               rtol=1e-6, atol=1e-7)


def test_dropout_keeps_the_replicated_parameters_identical(gspmd):
    """At 2 x 2 with dropout 0.1: the ranks of a tp group keep their
    replicated parameters bit-identical over two steps, gather one model
    and report one loss."""
    d = [o["drop"] for o in gspmd["outs"]]
    for g in ((0, 1), (2, 3)):
        a, b = d[g[0]], d[g[1]]
        assert a["replicated"] == b["replicated"]
        assert len(a["replicated"]) > 10
        assert a["losses"] == b["losses"]
        assert all(torch.equal(a["params"][k], b["params"][k])
                   for k in a["params"])
    assert np.isfinite(d[0]["losses"]).all()
    h = hashlib.sha256(d[0]["params"]["vis_embed.0.weight"].numpy()
                       .tobytes()).hexdigest()
    assert h != hashlib.sha256(gspmd["job"]["state"]["vis_embed.0.weight"]
                               .numpy().tobytes()).hexdigest()


def test_the_step_builders_check_the_gspmd_model(gspmd):
    """A GSPMD step model has no K-step form (as in the JAX package), and
    its step normalises the masked-LM loss over the step's data-parallel
    group, which a shard_map step does not (no group is formed: nothing
    here runs a collective)."""
    from vlp_tpu_torch.parallel import Dist
    from vlp_tpu_torch.parallel.tp_step import (make_tp_multi_step,
                                                make_tp_train_step,
                                                sharded_names)
    cfg = torch_cfg(gspmd["cfg"])

    def built(dist, layout="gspmd"):
        model = VLPModel(cfg)
        model.load_state_dict(gspmd["job"]["state"])
        model.shard_(dist.tensor_parallel, layout=layout)
        opt = topt.BertAdam(dict(model.named_parameters()), LR,
                            clip_group=dist.tp_group,
                            clip_sharded=sharded_names(model))
        return model, opt

    dist = Dist(world=2, rank=1, backend="gloo", tp=2)
    model, opt = built(dist)
    assert "bert.embeddings.word_embeddings.weight" in opt.clip_sharded
    with pytest.raises(ValueError, match="K-step"):
        make_tp_multi_step(model, opt, dist, K=2)
    make_tp_train_step(model, opt, dist)
    assert model.loss_group is None
    wide = Dist(world=4, rank=3, backend="gloo", tp=2)
    model, opt = built(wide)
    assert model.loss_group is None
    make_tp_train_step(model, opt, wide)
    assert model.loss_group == TP(index=1, size=2)
    model, opt = built(wide, "shard_map")
    make_tp_train_step(model, opt, wide)
    assert model.loss_group is None
