"""The fused BertAdam update (``csrc/bert_adam.cu``): its host-side plan
(``optim.FusedPlan``) on the CPU, where it is built without launching
anything, and the kernel's arithmetic, emulated in numpy op for op, against
the plain update (``BertAdam._update``) bit for bit.  JAX-free; the test
marked ``cuda`` holds the kernel itself against the plain update on the
card and skips (through the ``cuda`` fixture) without a GPU:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_fused_adam.py
"""

import json
import os

import numpy as np
import pytest
import torch

from vlp_tpu_torch import optim, tracing
from vlp_tpu_torch.config import VLPConfig
from vlp_tpu_torch.models.model import VLPModel
from vlp_tpu_torch.ops import _build

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# sizes around a chunk of 8: tails, exact multiples, tensors under a chunk
SHAPES = {"emb.weight": (3, 5), "emb.bias": (8,), "l0.LayerNorm.weight": (1,),
          "l0.dense.weight": (4, 6), "l0.dense.bias": (17,),
          "l1.dense.weight": (2, 2, 3)}


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    return torch.device("cuda")


def make_params(seed=0, device="cpu"):
    g = torch.Generator().manual_seed(seed)
    return {n: torch.nn.Parameter(torch.randn(s, generator=g).to(device))
            for n, s in SHAPES.items()}


def covered(plan, t, numel):
    """The elements of tensor t that its chunks cover, each once."""
    rows = plan.tensor_chunks(t).tolist()
    assert all(r[0] == t for r in rows)
    seen = np.zeros(numel, dtype=np.int64)
    for _, start, length in rows:
        assert 0 < length <= plan.chunk and start % plan.chunk == 0
        seen[start:start + length] += 1
    return seen


@pytest.mark.parametrize("chunk", [4, 8, 12, optim.CHUNK])
def test_every_element_lies_in_exactly_one_chunk(chunk):
    params = make_params()
    plan = optim.FusedPlan(optim.BertAdam(params, 1e-3), chunk=chunk)
    assert plan.n_chunks == sum(-(-p.numel() // chunk)
                                for p in params.values())
    assert plan.host_chunks.shape == (plan.n_chunks, 3)
    for t, n in enumerate(plan.names):
        numel = params[n].numel()
        assert covered(plan, t, numel).tolist() == [1] * numel
    # the tensors' chunks tile the chunk list in table order, and the
    # device's map names each chunk's tensor
    begin = plan.host[:, 5].tolist()
    numel = plan.host[:, 6].tolist()
    assert numel == [params[n].numel() for n in plan.names]
    ends = [b + -(-k // chunk) for b, k in zip(begin, numel)]
    assert begin[0] == 0 and ends[-1] == plan.n_chunks
    assert begin[1:] == ends[:-1]
    assert plan.owner.dtype == torch.int32
    assert plan.owner.tolist() == plan.host_chunks[:, 0].tolist()


@pytest.mark.parametrize("config,vqa,tensors,numel", [
    ("vlp-base-coco-cap", False, 210, 115_939_396),
    ("vlp-base-vqa2", True, 214, 121_929_853)])
def test_the_benchmark_parameter_sets_are_covered(config, vqa, tensors,
                                                  numel):
    """Both configurations' parameters (on the meta device: no memory),
    the word table's 22.3 M elements and the 129-131 tensors under 4,096
    elements alike."""
    from benchmarks.training import CONFIG_FIELDS
    with open(os.path.join(ROOT, "benchmarks", "configs",
                           config + ".json")) as f:
        raw = json.load(f)
    cfg = VLPConfig(**{k: raw[k] for k in CONFIG_FIELDS if k in raw})
    with torch.device("meta"):
        model = VLPModel(cfg, with_vqa=vqa)
    params = dict(model.named_parameters())
    plan = optim.FusedPlan(optim.BertAdam(params, 3e-5))
    assert len(plan.names) == tensors
    assert sum(p.numel() for p in params.values()) == numel
    lengths = plan.host_chunks[:, 2]
    assert int(lengths.sum()) == numel
    for t, n in enumerate(plan.names):
        rows = plan.tensor_chunks(t)
        starts = rows[:, 1]
        assert int(rows[:, 2].sum()) == params[n].numel()
        assert starts.tolist() == list(range(0, params[n].numel(),
                                             optim.CHUNK))
    assert plan.partials.shape == (plan.n_chunks,)
    assert plan.sumsq.shape == plan.tickets.shape == (tensors,)


def test_clip_sharded_tensors_form_the_leading_slice():
    params = make_params()
    sharded = ["l1.dense.weight", "emb.bias"]
    opt = optim.BertAdam(params, 1e-3, clip_sharded=sharded)
    plan = optim.FusedPlan(opt, chunk=8)
    # in the parameters' order, then the others in theirs
    assert plan.names[:2] == ["emb.bias", "l1.dense.weight"]
    assert plan.n_sharded == 2
    assert plan.names[2:] == [n for n in params if n not in sharded]
    assert optim.FusedPlan(optim.BertAdam(params, 1e-3)).n_sharded == 0


def test_table_rows_flag_null_gradients_anchors_and_decay():
    params = make_params()
    for n, p in params.items():
        if n != "l0.dense.bias":
            p.grad = torch.ones_like(p)
    opt = optim.BertAdam(params, 1e-3)
    plan = optim.FusedPlan(opt, chunk=8)
    assert plan.refresh() == len(params)
    cols = {c: i for i, c in enumerate(optim.TABLE_COLUMNS)}
    for t, n in enumerate(plan.names):
        row = plan.table[t].tolist()
        assert row[cols["p"]] == params[n].data_ptr()
        assert row[cols["grad"]] == (0 if n == "l0.dense.bias"
                                     else params[n].grad.data_ptr())
        assert row[cols["m"]] == opt.m[n].data_ptr()
        assert row[cols["v"]] == opt.v[n].data_ptr()
        assert row[cols["anchor"]] == 0
        assert row[cols["decay"]] == int(opt.decay[n])
    assert [bool(plan.table[t, cols["decay"]])
            for t in range(len(params))] == [
        not (n.endswith("bias") or ".LayerNorm." in n) for n in plan.names]
    ft = optim.bert_adam_finetune(params, 1e-3, init_params=params)
    plan = optim.FusedPlan(ft, chunk=8)
    plan.refresh()
    assert plan.table[:, cols["anchor"]].tolist() == [
        ft.anchors[n].data_ptr() for n in plan.names]


def test_table_is_reused_until_a_gradient_is_replaced():
    params = make_params()
    for p in params.values():
        p.grad = torch.zeros_like(p)
    plan = optim.FusedPlan(optim.BertAdam(params, 1e-3), chunk=8)
    with tracing.recording() as spans:
        assert plan.refresh() == len(params)
        for p in params.values():
            p.grad.zero_()               # a step that reuses its buffers
        assert plan.refresh() == 0
        params["emb.weight"].grad = torch.ones(3, 5)
        assert plan.refresh() == 1
        params["l0.dense.bias"].grad = None
        params["emb.bias"].grad = torch.ones(8)
        assert plan.refresh() == 2
        assert plan.refresh() == 0
    assert [(s.name, s.n) for s in spans] == [
        ("optim.table", len(params)), ("optim.table", 1),
        ("optim.table", 2)]
    t = plan.names.index("l0.dense.bias")
    assert plan.table[t, 1] == 0
    assert torch.equal(plan.table, plan.host)


def test_a_table_change_during_capture_raises(monkeypatch):
    params = make_params()
    for p in params.values():
        p.grad = torch.zeros_like(p)
    plan = optim.FusedPlan(optim.BertAdam(params, 1e-3), chunk=8)
    plan.refresh()
    monkeypatch.setattr(optim, "_capturing", lambda device: True)
    assert plan.refresh() == 0           # nothing moved: nothing to do
    params["emb.weight"].grad = torch.ones(3, 5)
    with pytest.raises(RuntimeError, match="moved during a CUDA-graph"):
        plan.refresh()


def test_the_plan_refuses_what_the_kernel_does_not_take():
    params = make_params()
    params["emb.weight"] = torch.nn.Parameter(torch.randn(5, 3).t())
    with pytest.raises(ValueError, match="not contiguous"):
        optim.FusedPlan(optim.BertAdam(params, 1e-3))
    params = make_params()
    params["emb.bias"] = torch.nn.Parameter(torch.randn(8).bfloat16())
    with pytest.raises(ValueError, match="bfloat16"):
        optim.FusedPlan(optim.BertAdam(params, 1e-3))
    params = make_params()
    plan = optim.FusedPlan(optim.BertAdam(params, 1e-3))
    params["l0.dense.weight"].grad = torch.ones(6, 4).t()
    with pytest.raises(ValueError, match="gradient of 'l0.dense.weight'"):
        plan.refresh()
    with pytest.raises(ValueError, match="multiple of 4"):
        optim.FusedPlan(optim.BertAdam(params, 1e-3), chunk=6)


def test_cpu_parameters_take_the_plain_update_without_a_build():
    params = make_params()
    for p in params.values():
        p.grad = torch.ones_like(p)
    opt = optim.BertAdam(params, 1e-3)
    assert opt.plan is None
    before = {k: v.launches for k, v in _build.KERNELS.items()}
    opt.step()
    assert int(opt.step_count) == 1
    assert {k: v.launches for k, v in _build.KERNELS.items()} == before
    assert _build.KERNELS["bert_adam_update"].replaces.startswith("none")
    assert _build.library.cache_info().currsize == 0 or \
        torch.cuda.is_available()


# --- the kernel's arithmetic, emulated -------------------------------------

F = np.float32


def kernel_sumsq(plan, opt):
    """Pass 1: each tensor's squared gradient norm, fp64 over its chunks,
    rounded to fp32 once (the kernel's tree order differs from this one
    only below fp64's last bits)."""
    out = {}
    for t, n in enumerate(plan.names):
        g = opt.params[n].grad
        flat = (np.zeros(opt.params[n].numel()) if g is None
                else g.detach().numpy().astype(np.float64).ravel())
        parts = [np.sum(flat[s:s + k] ** 2)
                 for _, s, k in plan.tensor_chunks(t).tolist()]
        out[n] = F(np.sum(parts))
    return out


def kernel_update(opt, sumsq, lr, finite):
    """Pass 2 in numpy fp32, op for op as ``adam`` in the kernel: {name:
    (p, m, v)} after the update."""
    if finite is not None and not finite:
        return {n: (p.detach().numpy().copy(), opt.m[n].numpy().copy(),
                    opt.v[n].numpy().copy()) for n, p in opt.params.items()}
    out = {}
    neg_lr = -F(lr)
    for n, par in opt.params.items():
        p = par.detach().numpy().copy()
        g = (np.zeros_like(p) if par.grad is None
             else par.grad.numpy().copy())
        m, v = opt.m[n].numpy().copy(), opt.v[n].numpy().copy()
        norm = np.sqrt(sumsq[n])
        scale = (F(1) / (norm + F(optim.CLIP_EPS)) * F(optim.MAX_GRAD_NORM)
                 if norm > F(optim.MAX_GRAD_NORM) else F(1))
        g = g * F(scale)
        m = m * F(optim.B1) + F(1 - optim.B1) * g
        v = v * F(optim.B2) + (F(1 - optim.B2) * g) * g
        u = m / (np.sqrt(v) + F(optim.EPS))
        if opt.weight_decay > 0:
            a = None if opt.anchors is None else opt.anchors[n].numpy()
            base = p if a is None else p * F(2) - a
            u = u + base * F(opt.weight_decay if opt.decay[n] else 0.0)
        out[n] = (p + neg_lr * u, m, v)
    return out


@pytest.mark.parametrize("finetune", [False, True])
@pytest.mark.parametrize("weight_decay", [0.01, 0.0])
@pytest.mark.parametrize("finite", [None, True, False])
def test_kernel_arithmetic_equals_the_plain_update(finetune, weight_decay,
                                                   finite):
    """Three steps of random gradients, scaled so that some tensors clip
    and some do not, one gradient None: the emulated kernel gets the plain
    update's bits when both take the same squared norms (clipped or not),
    and the plain update's own norms clip exactly the tensors the kernel's
    do."""
    params = make_params(1)
    kw = dict(warmup=0.5, t_total=4, weight_decay=weight_decay)
    if finetune:
        init = {n: p.detach() + 0.5 for n, p in params.items()}
        opt = optim.bert_adam_finetune(params, 0.1, init_params=init,
                                       missing_key_substrings=("l1.",), **kw)
    else:
        opt = optim.BertAdam(params, 0.1, **kw)
    plan = optim.FusedPlan(opt, chunk=8)
    g = torch.Generator().manual_seed(2)
    clipped = set()
    for step in range(3):
        for i, (n, p) in enumerate(params.items()):
            scale = 0.05 if i % 2 else 3.0     # under / over norm 1
            p.grad = (None if n == "l0.dense.bias"
                      else torch.randn(p.shape, generator=g) * scale)
        sumsq = kernel_sumsq(plan, opt)
        over = {n for n, s in sumsq.items() if np.sqrt(s) > 1}
        assert over == {n for n, p in params.items() if p.grad is not None
                        and float(torch.sqrt(torch.sum(p.grad * p.grad))) > 1}
        clipped |= over
        lr = float(opt.lr_at(opt.step_count))
        want = kernel_update(opt, sumsq, lr, finite)
        count = int(opt.step_count)
        # the plain update at the kernel's norms
        opt._sharded_sumsq = lambda: {n: torch.tensor(s)
                                      for n, s in sumsq.items()}
        opt.step(None if finite is None else torch.tensor(finite))
        for n, (p, m, v) in want.items():
            assert np.array_equal(params[n].detach().numpy(), p), (step, n)
            assert np.array_equal(opt.m[n].numpy(), m), (step, n)
            assert np.array_equal(opt.v[n].numpy(), v), (step, n)
        assert int(opt.step_count) == count + (finite is not False)
    assert clipped and clipped != set(params) - {"l0.dense.bias"}


@pytest.mark.cuda
def test_fused_update_equals_the_plain_update_on_the_card(cuda):
    """The kernel against ``_update`` on CUDA tensors (the same squared
    norms for both, so every element agrees bit for bit), a None gradient
    and a skipped step included; two launches a step."""
    params = make_params(3, cuda)
    opt = optim.BertAdam(params, 0.1, warmup=0.5, t_total=4)
    ref = {n: torch.nn.Parameter(p.detach().clone())
           for n, p in params.items()}
    plain = optim.BertAdam(ref, 0.1, warmup=0.5, t_total=4)
    assert opt.plan is not None
    plain.plan = None
    g = torch.Generator(device=cuda).manual_seed(4)
    for step, finite in enumerate([None, torch.tensor(False, device=cuda),
                                   torch.tensor(True, device=cuda)]):
        for i, (n, p) in enumerate(params.items()):
            grad = (None if n == "l0.dense.bias" else
                    torch.randn(p.shape, generator=g, device=cuda)
                    * (0.05 if i % 2 else 3.0))
            p.grad = grad
            ref[n].grad = None if grad is None else grad.clone()
        before = _build.KERNELS["bert_adam_update"].launches
        opt.step(finite)
        assert _build.KERNELS["bert_adam_update"].launches == before + 1
        sumsq = dict(zip(opt.plan.names, opt.plan.sumsq.unbind()))
        plain._sharded_sumsq = lambda: sumsq
        plain.step(finite)
        for n in params:
            assert torch.equal(params[n], ref[n]), (step, n)
            assert torch.equal(opt.m[n], plain.m[n]), (step, n)
            assert torch.equal(opt.v[n], plain.v[n]), (step, n)
        assert int(opt.step_count) == int(plain.step_count)
