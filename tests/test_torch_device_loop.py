"""The port's K-step device loop (``--device_loop_steps``,
``train_step.make_multi_step``) on the CPU, where the K steps of a group
run eagerly through the plain versions (on the card they are one
CUDA-graph replay: ``chip_smoke.py`` phase 4h):

* (a) against the JAX CLI: the same step count (a trailing group of fewer
  than K batches dropped and logged) and the losses of the records that
  both write to ``metrics.jsonl``, dropout off, from one reference .bin;
* (b) bit for bit against K = 1 over the same steps, dropout on, in the
  parameters and BertAdam's moments: plain, under gradient accumulation,
  ``--tasks vqa2`` and the loss-scaled update;
* (c) a resume from a step checkpoint: at a group boundary it ends where
  the uninterrupted run does; inside a group it counts groups from the
  skipped batches, as the JAX CLI does;
* (d) two gloo ranks with K = 2 equal two ranks with K = 1;
* (e) the two forms of a dropout seed (a Python int, a 0-d int64 / uint64
  tensor) give the same plain K1, K2 and ``dropout_mask``;
* the launch counts of a captured graph (``ops._build.recording``), and
  what refuses to run.
"""

import json
import os
import shutil

import numpy as np
import pytest
import torch

from vlp_tpu.checkpoint import params_to_torch
from vlp_tpu.cli import train as jax_train
from vlp_tpu.config import VLPConfig
from vlp_tpu_torch.cli import common
from vlp_tpu_torch.cli import train as train_cli
from vlp_tpu_torch.ops import _build, philox
from vlp_tpu_torch.ops import attention as attn
from vlp_tpu_torch.parallel.dist import Dist
from vlp_tpu_torch.parallel.dp_step import make_dp_multi_step

from tests.test_torch_cli_train import TINY
from tests.test_torch_parallel_cli import _ok, run

TAIL = "dropping 1 tail batches (< device_loop_steps)"


@pytest.fixture(scope="module")
def fx(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_device_loop")
    vocab = str(d / "vocab.txt")
    common.write_synthetic_vocab(vocab, size=120)
    cfgs = {}
    nodrop = dict(hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0)
    for name, extra in (("cfg", {}), ("cfg_nodrop", nodrop)):
        cfgs[name] = str(d / f"{name}.json")
        with open(cfgs[name], "w") as f:
            json.dump(dict(TINY, **extra), f)
    answers = str(d / "answers.txt")
    with open(answers, "w") as f:
        f.write("\n".join(["<unk>"] + [f"ans{i}" for i in range(1, 30)])
                + "\n")
    return dict(dir=str(d), vocab=vocab, answers=answers, **cfgs)


def train_args(fx, out, *extra, cfg="cfg"):
    return ["--do_train", "--synthetic_data", "--enable_butd",
            "--bert_model", fx["vocab"], "--config_path", fx[cfg],
            "--output_dir", out, "--train_batch_size", "4",
            "--new_segment_ids", "--relax_projection", "--len_vis_input", "6",
            "--max_len_b", "5", "--max_pred", "3", "--learning_rate", "1e-3",
            "--num_workers", "1", *extra]


def _log(out):
    with open(os.path.join(out, "training.log")) as f:
        return f.read()


def _records(out):
    with open(os.path.join(out, "metrics.jsonl")) as f:
        return [json.loads(line) for line in f]


def test_step_count_and_losses_match_the_jax_cli(fx):
    """K = 2 with 3 batches an epoch: both CLIs take 2 steps an epoch and
    drop the third with the same log line; the losses of the records both
    write agree (dropout off, label smoothing, the pretext loss and
    drop-worst from epoch 2 on)."""
    cfg = VLPConfig.from_reference_json(fx["cfg_nodrop"])
    jout = os.path.join(fx["dir"], "jax")
    init = jax_train.main(train_args(fx, jout, cfg="cfg_nodrop")[1:])
    ref = os.path.join(fx["dir"], "ref.bin")
    torch.save({k: torch.from_numpy(np.array(v))
                for k, v in params_to_torch(init.params, cfg).items()}, ref)
    extra = ["--num_train_epochs", "2", "--steps_per_epoch", "3",
             "--device_loop_steps", "2", "--drop_prob", "0",
             "--label_smoothing", "0.1", "--vis_mask_prob", "0.5",
             "--max_drop_worst_ratio", "0.25", "--drop_after", "1",
             "--model_recover_path", ref]
    jax_train.main(train_args(fx, jout, *extra, cfg="cfg_nodrop"))
    pout = os.path.join(fx["dir"], "port")
    got = train_cli.main(train_args(fx, pout, *extra, "--device", "cpu",
                                    cfg="cfg_nodrop"))
    assert len(got["losses"]) == 4
    for out in (jout, pout):
        assert _log(out).count(TAIL) == 2, out
    want, mine = _records(jout), _records(pout)
    assert [(r["epoch"], r["step"]) for r in mine] == \
        [(r["epoch"], r["step"]) for r in want] == [(1, 1), (2, 1)]
    np.testing.assert_allclose([r["loss"] for r in mine],
                               [r["loss"] for r in want], rtol=1e-5)
    # a record holds its group's last step
    np.testing.assert_array_equal([r["loss"] for r in mine],
                                  got["losses"][1::2])


def _final(out, result):
    """The trained parameters and BertAdam's saved moments and step."""
    opt = torch.load(os.path.join(out, "optim.2.bin"), weights_only=True)
    return ({n: p.detach().clone()
             for n, p in result["model"].named_parameters()}, opt)


def _assert_same(a, b):
    (pa, oa), (pb, ob) = a, b
    for n, p in pa.items():
        assert torch.equal(p, pb[n]), n
    assert oa["step"] == ob["step"]
    for key in ("m", "v"):
        for n, t in oa[key].items():
            assert torch.equal(t, ob[key][n]), (key, n)
    assert oa.get("loss_scale") == ob.get("loss_scale")


@pytest.mark.parametrize("kind", ["plain", "accum", "vqa2", "loss_scale"])
def test_k2_equals_k1_bit_for_bit(fx, kind):
    """Dropout on (both attention and hidden, 0.1): 2 epochs of 4 steps as
    groups of 2 and one step at a time draw the same masks and end with
    the same parameters, moments and step count, bit for bit."""
    extra = {"plain": [],
             "accum": ["--gradient_accumulation_steps", "2"],
             "vqa2": ["--tasks", "vqa2", "--answer_vocab_file",
                      fx["answers"], "--s2s_prob", "0", "--bi_prob", "1"],
             "loss_scale": ["--true_fp16", "--loss_scale", "8"]}[kind]
    base = ["--num_train_epochs", "2", "--steps_per_epoch", "4",
            "--device", "cpu", *extra]
    runs = {}
    for k in (1, 2):
        out = os.path.join(fx["dir"], f"bit_{kind}_k{k}")
        res = train_cli.main(train_args(fx, out, *base,
                                        "--device_loop_steps", str(k)))
        assert len(res["losses"]) == 8
        runs[k] = (res["losses"], _final(out, res))
    assert runs[2][0] == runs[1][0]
    assert len(set(runs[1][0])) == 8
    _assert_same(runs[2][1], runs[1][1])


@pytest.mark.parametrize("kind", ["group_boundary", "inside_a_group"])
def test_resume_from_a_step_checkpoint(fx, kind):
    """``group_boundary``: a K = 2 run cut after step 6 of 8 (epoch 2,
    after its first group) and resumed ends where the uninterrupted run
    does.  ``inside_a_group``: resumed at K = 2 from a K = 1 run's
    checkpoint after step 5, epoch 2 restarts at its second batch and
    counts groups from there, (1, 2), dropping batch 3 as the tail; those
    two steps draw what the K = 1 run's steps 1 and 2 drew."""
    base = ["--num_train_epochs", "2", "--steps_per_epoch", "4",
            "--device", "cpu"]
    full = os.path.join(fx["dir"], f"resume_full_{kind}")
    first_k = "2" if kind == "group_boundary" else "1"
    save = "1" if kind == "group_boundary" else "5"
    done = train_cli.main(train_args(fx, full, *base, "--save_steps", save,
                                     "--device_loop_steps", first_k))
    tag = "s6" if kind == "group_boundary" else "s5"
    cut = os.path.join(fx["dir"], f"resume_cut_{kind}")
    os.makedirs(cut)
    for name in ("model.1.bin", "optim.1.bin", f"model.{tag}.bin",
                 f"optim.{tag}.bin"):
        shutil.copy(os.path.join(full, name), cut)
    resumed = train_cli.main(train_args(fx, cut, *base,
                                        "--device_loop_steps", "2"))
    log = _log(cut)
    assert f"Recover model: step {tag[1:]}" in log
    assert len(resumed["losses"]) == 2
    if kind == "group_boundary":
        assert TAIL not in log
        assert resumed["losses"] == done["losses"][-2:]
        _assert_same(_final(cut, resumed), _final(full, done))
    else:
        assert log.count(TAIL) == 1
        assert resumed["losses"] == done["losses"][5:7]


def test_two_gloo_ranks_k2_equal_k1(fx):
    """Data parallel on two CPU processes (gloo): groups of 2 and single
    steps give the same losses and parameters on both ranks."""
    recs = {}
    for k in (1, 2):
        out = os.path.join(fx["dir"], f"dp_k{k}")
        recs[k] = _ok(run(fx, "train", train_args(
            fx, out, "--num_train_epochs", "2", "--steps_per_epoch", "2",
            "--device", "cpu", "--device_loop_steps", str(k)),
            tag=f"dp_k{k}"))
    (a0, a1), (b0, b1) = recs[1], recs[2]
    assert a0["hash"] == a1["hash"] == b0["hash"] == b1["hash"]
    assert a0["losses"] == b0["losses"] and len(a0["losses"]) == 4


SEED = 0xC0FFEE0123456789   # past 2^63: its int64 form is negative


@pytest.mark.parametrize("form", ["int64", "uint64"])
def test_seed_as_a_tensor(form):
    """The plain K1, K2 and dropout_mask draw the same bits from a seed
    passed as a 0-d tensor as from the Python int, in both layouts;
    FusedAttention (the training op) too."""
    rng = np.random.default_rng(0)
    B, L, H, D, P = 2, 12, 2, 64, 7
    q, k, v, dout = (torch.from_numpy(rng.standard_normal(
        (B, L, H, D)).astype(np.float32)) for _ in range(4))
    mode = torch.tensor([0, 1], dtype=torch.int32)
    te = torch.tensor([10, 12], dtype=torch.int32)
    ck = torch.ones(B, L)
    ck[0, 3] = 0.0
    t = torch.tensor(philox.as_int64(SEED), dtype=torch.int64)
    if form == "uint64":
        t = t.view(torch.uint64)
    rate = 0.3
    for layout in ("blhd", "bhld"):
        x = [a if layout == "blhd" else a.transpose(1, 2).contiguous()
             for a in (q, k, v, dout)]
        kw = dict(prefix=P, dropout_rate=rate, layout=layout)
        want = attn.attention_plain(*x[:3], mode, te, ck, seed=SEED, **kw)
        got = attn.attention_plain(*x[:3], mode, te, ck, seed=t, **kw)
        assert torch.equal(got, want)
        want = attn.attention_bwd_plain(*x[:3], mode, te, ck, x[3],
                                        seed=SEED, **kw)
        got = attn.attention_bwd_plain(*x[:3], mode, te, ck, x[3], seed=t,
                                       **kw)
        for a, b in zip(got, want):
            assert torch.equal(a, b)
    mask = attn.dropout_mask(B, H, L, rate, t, "cpu")
    assert torch.equal(mask, attn.dropout_mask(B, H, L, rate, SEED, "cpu"))
    assert 0.5 < (mask > 0).float().mean() < 0.9
    grads = []
    for seed in (SEED, t):
        leaves = [a.clone().requires_grad_() for a in (q, k, v)]
        out = attn.FusedAttention.apply(*leaves, mode, te, ck, P, rate, seed)
        out.backward(dout)
        grads.append([out.detach()] + [a.grad for a in leaves])
    for a, b in zip(*grads):
        assert torch.equal(a, b)


def test_seed_slot_checks_its_seed():
    """``seed_slot`` takes the seed tensor as it is (the kernels read its
    slot) and refuses what is not a 64-bit seed."""
    t = torch.tensor(5, dtype=torch.int64)
    assert attn.seed_slot(t, "cpu").data_ptr() == t.data_ptr()
    assert int(attn.seed_slot(SEED, "cpu")) == philox.as_int64(SEED)
    for bad in (torch.zeros(2, dtype=torch.int64), torch.tensor(5.0), -1,
                2 ** 64, None):
        with pytest.raises(ValueError):
            attn.seed_slot(bad, "cpu")


def test_launch_counts_of_a_captured_graph():
    """A capture's launches are tallied apart and added at every replay;
    the warm-up's are dropped; recordings do not nest."""
    _build.reset_launch_counts()

    def step():   # the wrappers of one training step of a 2-layer model
        for _ in range(2):
            _build.count_launch("attention_fwd_drop")
        for _ in range(2):
            _build.count_launch("attention_bwd")

    step()                                   # an eager step counts
    with _build.recording():                 # the warm-up: dropped
        step()
    with _build.recording() as captured:     # the capture of K = 3 steps
        for _ in range(3):
            step()
    assert dict(captured) == {"attention_fwd_drop": 6, "attention_bwd": 6}
    assert _build.KERNELS["attention_fwd_drop"].launches == 2
    for _ in range(4):                       # four replays
        _build.add_launches(captured)
    assert _build.KERNELS["attention_fwd_drop"].launches == 2 + 4 * 6
    assert _build.KERNELS["attention_bwd"].launches == 2 + 4 * 6
    with _build.recording(), pytest.raises(RuntimeError, match="nest"):
        with _build.recording():
            pass
    step()                                   # counting resumes after
    assert _build.KERNELS["attention_bwd"].launches == 2 + 24 + 2
    _build.reset_launch_counts()


def test_what_the_device_loop_refuses():
    """gloo on cuda cannot be captured (it names NCCL), a captured
    all-reduce cannot be timed, K < 1 is no loop; all raise before
    touching a device."""
    cuda = torch.device("cuda")
    with pytest.raises(ValueError, match="NCCL"):
        make_dp_multi_step(None, None, Dist(world=2, device=cuda,
                                            backend="gloo"), K=2)
    with pytest.raises(ValueError, match="timed"):
        make_dp_multi_step(None, None, Dist(world=2, device=cuda,
                                            backend="nccl",
                                            time_reductions=True), K=2)
    with pytest.raises(ValueError, match="K >= 1"):
        make_dp_multi_step(None, None, Dist(), K=0)


def test_loss_scaled_step_keeps_its_gradient_buffers():
    """The loss-scaled update unscales the gradients in place: after each
    step every parameter's ``.grad`` is still the buffer the first step
    made (a captured step's replays zero and accumulate into those
    addresses), and the update equals the unscaled one."""
    from vlp_tpu_torch import optim, train_step as ts
    from vlp_tpu_torch.config import VLPConfig
    from vlp_tpu_torch.models.model import VLPModel

    cfg = VLPConfig.tiny(vocab_size=64, hidden_size=32, num_hidden_layers=2,
                         num_attention_heads=2, intermediate_size=48,
                         len_vis_input=6, max_len_b=5, vis_feat_dim=16,
                         vis_pe_dim=12)
    g = torch.Generator().manual_seed(0)
    batch = ts.dummy_batch(cfg, 4)
    batch["input_ids"] = torch.randint(5, 64, batch["input_ids"].shape,
                                       generator=g).int()
    batch["masked_weights"].fill_(1.0)
    batch["vis_feats"] = torch.randn(batch["vis_feats"].shape, generator=g)
    runs = []
    for ls in (None, optim.DynamicLossScale(init_scale=8.0)):
        model = VLPModel(cfg)
        model.init_weights(torch.Generator().manual_seed(1))
        opt = optim.BertAdam(dict(model.named_parameters()), 1e-3)
        step = ts.make_train_step(model, opt, loss_scale=ls)
        step(batch, 3)
        bufs = {n: p.grad for n, p in model.named_parameters()
                if p.grad is not None}
        step(batch, 4)
        assert bufs and all(p.grad is bufs[n]
                            for n, p in model.named_parameters()
                            if n in bufs)
        runs.append(dict(model.named_parameters()))
    for n, p in runs[1].items():
        assert torch.equal(p, runs[0][n]), n


@pytest.mark.parametrize("K", [1, 2, 4, 20])
def test_staging_slabs_cover_the_loaders_lead(K):
    """``GroupStaging`` allocates as many slabs as the loader's
    ``stacked_feature_slabs`` counts for the same K and prefetch."""
    from vlp_tpu_torch import train_step as ts
    from vlp_tpu_torch.data.loader import stacked_feature_slabs

    class Store:
        def get(self, key):
            return np.zeros((2, 3), np.float32), np.zeros((2, 1), np.float32)

    layout = {"vis_feats": ((2, 3), np.float32), "vis_pe": ((2, 1),
                                                           np.float32)}
    for prefetch in (1, 4, 9):
        staging = ts.GroupStaging(layout, K, 2, "cpu", prefetch=prefetch)
        feats, _, slabs = stacked_feature_slabs(Store(), "k", K, 2,
                                                prefetch=prefetch)
        assert staging.n_slots == len(feats)
        assert len(staging.feature_slabs()) == len(slabs)
