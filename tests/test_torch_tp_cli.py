"""The port's train CLI with ``--tensor_parallel 2`` on two CPU processes
under gloo (``--device cpu``, fp32, the tiny config of
tests/test_torch_cli_train.py with dropout off, 2 heads: one a rank).
Each process runs, in turn:

* through torchrun's environment (the CLI forms the group):
  ``--tensor_parallel 2``, 2 epochs of 2 steps.  Its losses equal a
  single-process run's on the same synthetic stream within rtol 1e-5, it
  logs ``shard_map training: dp=1 x tp=2``, and rank 0 writes
  ``model.N.bin`` at the reference's full shapes, which ``cli.decode``
  reads as it is;
* in a group the process formed itself (the CLI adopts it): a resume of
  that run to epoch 3, bit-equal to an uninterrupted 3-epoch run (the
  gathered checkpoints shard back exactly); ``--tasks vqa2`` with
  ``--gradient_accumulation_steps 2`` against its single-process run;
  ``--device_loop_steps 2`` (eager on the CPU), bit-equal to the first
  run's first epoch; and a config whose heads do not divide by 2, which
  raises.

What raises in one process: ``--scst`` and ``--true_fp16`` with
``--tensor_parallel 2``, a world that does not divide by the tp size (with
either ``--tp_impl``), and a tp group across nodes
(``LOCAL_WORLD_SIZE``)."""

import json
import os

import numpy as np
import pytest
import torch

from vlp_tpu_torch.cli import common
from vlp_tpu_torch.cli import decode as decode_cli
from vlp_tpu_torch.cli import train as train_cli
from vlp_tpu_torch.config import VLPConfig
from vlp_tpu_torch.models.model import VLPModel
from vlp_tpu_torch.parallel import Dist

from tests.test_torch_cli_train import TINY
from tests.test_torch_parallel import free_port, spawn

CHILD = r"""
import hashlib, json, sys
import torch
torch.set_num_threads(1)
import torch.distributed as tdist
from vlp_tpu_torch import parallel
from vlp_tpu_torch.cli import train
from vlp_tpu_torch.parallel import mesh

rank, port, out, jobs = int(sys.argv[1]), sys.argv[2], sys.argv[3], \
    json.loads(sys.argv[4])
rec = {}


def run(argv, dist=None):
    try:
        res = train.main(argv, dist=dist)
    except ValueError as e:
        return {"error": str(e)}
    # the replicated parameters: the same bits on both ranks of a group
    h = hashlib.sha256()
    for k, v in sorted(res["model"].state_dict().items()):
        if mesh.shard_dim(k) is None:
            h.update(k.encode())
            h.update(v.detach().contiguous().numpy().tobytes())
    return {"losses": res["losses"], "hash": h.hexdigest()}


first, rest = jobs[0], jobs[1:]
rec[first[0]] = run(first[1])           # torchrun's environment
tdist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                         world_size=2, rank=rank)
for name, argv, single in rest:
    rec[name] = run(argv, parallel.Dist() if single else None)
tdist.barrier()
tdist.destroy_process_group()
with open(out, "w") as f:
    json.dump(rec, f)
"""


@pytest.fixture(scope="module")
def fx(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("torch_tp_cli"))
    vocab = os.path.join(d, "vocab.txt")
    common.write_synthetic_vocab(vocab, size=120)
    cfgs = {}
    for name, extra in (("cfg", {}), ("heads1", dict(num_attention_heads=1))):
        cfgs[name] = os.path.join(d, f"{name}.json")
        with open(cfgs[name], "w") as f:
            json.dump(dict(TINY, hidden_dropout_prob=0.0,
                           attention_probs_dropout_prob=0.0, **extra), f)
    answers = os.path.join(d, "answers.txt")
    with open(answers, "w") as f:
        f.write("\n".join(["<unk>"] + [f"ans{i}" for i in range(1, 30)])
                + "\n")
    fx = dict(dir=d, vocab=vocab, answers=answers, **cfgs)

    def out(name):
        return os.path.join(d, name)

    vqa = ["--tasks", "vqa2", "--answer_vocab_file", answers, "--s2s_prob",
           "0", "--bi_prob", "1", "--gradient_accumulation_steps", "2",
           "--num_train_epochs", "1"]
    tp = ["--tensor_parallel", "2"]
    jobs = [
        ("tp", train_args(fx, out("tp"), "--num_train_epochs", "2", *tp)),
        ("resume", train_args(fx, out("tp"), "--num_train_epochs", "3", *tp),
         False),
        ("full3", train_args(fx, out("full3"), "--num_train_epochs", "3",
                             *tp), False),
        ("single", train_args(fx, out("single{rank}"), "--num_train_epochs",
                              "2"), True),
        ("vqa", train_args(fx, out("vqa"), *vqa, *tp), False),
        ("vqa_single", train_args(fx, out("vqa_single{rank}"), *vqa), True),
        ("loop", train_args(fx, out("loop"), "--num_train_epochs", "1",
                            "--device_loop_steps", "2", *tp), False),
        ("heads", train_args(fx, out("heads"), "--num_train_epochs", "1",
                             *tp, cfg="heads1"), False),
    ]
    port, env_port = free_port(), free_port()
    outs = [os.path.join(d, f"rank{r}.json") for r in range(2)]

    def argv(r):
        # one-process runs write a directory per rank
        per_rank = [(n, [x.replace("{rank}", str(r)) for x in a], *rest)
                    for n, a, *rest in jobs]
        return [str(r), str(port), outs[r], json.dumps(per_rank)]

    def environ(r):
        return dict(PYTHONHASHSEED="0", RANK=str(r), LOCAL_RANK=str(r),
                    WORLD_SIZE="2", LOCAL_WORLD_SIZE="2",
                    MASTER_ADDR="127.0.0.1", MASTER_PORT=str(env_port))

    runs = spawn(CHILD, argv, world=2, env_of_rank=environ)
    for rc, text in runs:
        assert rc == 0, text[-4000:]
    fx["recs"] = [json.load(open(o)) for o in outs]
    return fx


def train_args(fx, out, *extra, cfg="cfg"):
    # warmup_constant: the lr of a step does not depend on the run's
    # length, so a 2-epoch run is the start of a 3-epoch one
    return ["--do_train", "--sche_mode", "warmup_constant",
            "--synthetic_data", "--enable_butd",
            "--bert_model", fx["vocab"], "--config_path", fx[cfg],
            "--output_dir", out, "--train_batch_size", "4",
            "--new_segment_ids", "--len_vis_input", "6", "--max_len_b", "5",
            "--max_pred", "3", "--num_workers", "1", "--steps_per_epoch",
            "2", "--learning_rate", "1e-3", "--device", "cpu", *extra]


def test_tp_cli_matches_one_process_and_writes_full_checkpoints(fx):
    r0, r1 = fx["recs"]
    assert r0["tp"]["losses"] == r1["tp"]["losses"]
    assert len(r0["tp"]["losses"]) == 4
    np.testing.assert_allclose(r0["tp"]["losses"], r0["single"]["losses"],
                               rtol=1e-5, atol=1e-6)
    with open(os.path.join(fx["dir"], "tp", "training.log")) as f:
        assert "shard_map training: dp=1 x tp=2" in f.read()
    cfg = VLPConfig.from_reference_json(fx["cfg"], type_vocab_size=6,
                                        relax_projection=0, len_vis_input=6,
                                        max_len_b=5)
    want = {k: v.shape for k, v in VLPModel(cfg).state_dict().items()}
    for n in (1, 2, 3):
        sd = torch.load(os.path.join(fx["dir"], "tp", f"model.{n}.bin"),
                        weights_only=True)
        assert {k: v.shape for k, v in sd.items()} == want
        opt = torch.load(os.path.join(fx["dir"], "tp", f"optim.{n}.bin"),
                         weights_only=True)
        assert {k: v.shape for k, v in opt["m"].items()} == {
            k: want[k] for k in opt["m"]}
    dec_out = os.path.join(fx["dir"], "decode")
    stats = decode_cli.main([
        "--bert_model", fx["vocab"], "--config_path", fx["cfg"],
        "--new_segment_ids", "--enable_butd", "--synthetic_data",
        "--num_synthetic", "3", "--batch_size", "3", "--beam_size", "2",
        "--max_tgt_length", "5", "--len_vis_input", "6", "--device", "cpu",
        "--model_recover_path", os.path.join(fx["dir"], "tp", "model.2.bin"),
        "--output_dir", dec_out])
    assert stats["model.2.bin"]["n_images"] == 3


def test_tp_cli_resumes_runs_vqa_and_the_device_loop(fx):
    r0, r1 = fx["recs"]
    for name in ("tp", "resume", "full3", "vqa", "loop"):
        assert r0[name]["hash"] == r1[name]["hash"], name
        assert r0[name]["losses"] == r1[name]["losses"], name
    # the resume took epoch 3 only, and ended where an uninterrupted run did
    assert r0["resume"]["losses"] == r0["full3"]["losses"][4:]
    assert r0["full3"]["losses"][:4] == r0["tp"]["losses"]
    a = torch.load(os.path.join(fx["dir"], "tp", "model.3.bin"),
                   weights_only=True)
    b = torch.load(os.path.join(fx["dir"], "full3", "model.3.bin"),
                   weights_only=True)
    assert all(torch.equal(a[k], b[k]) for k in a)
    np.testing.assert_allclose(r0["vqa"]["losses"],
                               r0["vqa_single"]["losses"], rtol=1e-5,
                               atol=1e-6)
    assert r0["loop"]["losses"] == r0["tp"]["losses"][:2]
    for r in (r0, r1):
        assert "divide" in r["heads"]["error"]


def test_what_raises_with_tensor_parallel(fx, monkeypatch):
    base = train_args(fx, os.path.join(fx["dir"], "no"), "--tensor_parallel",
                      "2")
    # --tp_impl gspmd runs (tests/test_torch_gspmd_cli.py): in one
    # process it gets as far as the world's size
    with pytest.raises(ValueError, match="must divide the world"):
        train_cli.main(base + ["--tp_impl", "gspmd"])
    with pytest.raises(ValueError, match="MLM/VQA paths only"):
        train_cli.main(base + ["--scst", "--max_pred", "0", "--mask_prob",
                               "0"])
    with pytest.raises(ValueError, match="MLM/VQA paths only"):
        train_cli.main(base + ["--true_fp16"])
    with pytest.raises(ValueError, match="must divide the world"):
        train_cli.main(base)
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "3")
    with pytest.raises(ValueError, match="within a node"):
        train_cli.tensor_parallel_dist(Dist(world=6, backend="gloo"), 2)
