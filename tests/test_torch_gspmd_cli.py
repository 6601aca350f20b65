"""The port's train CLI with ``--tensor_parallel 2 --tp_impl gspmd`` on two
CPU processes under gloo (``--device cpu``, fp32, the tiny config of
tests/test_torch_cli_train.py with dropout off, 2 heads: one a rank; its
vocab of 120, 6 types and 24-wide region features all shard).  Each
process runs, in turn:

* through torchrun's environment (the CLI forms the group): 2 epochs of 2
  steps with ``--relax_projection --label_smoothing 0.1``.  Its losses
  equal a single-process run's on the same synthetic stream within rtol
  1e-5, it logs ``GSPMD training: dp=1 x tp=2``, and rank 0 writes
  ``model.N.bin`` / ``optim.N.bin`` at the reference's full shapes, which
  ``cli.decode`` reads as they are;
* in a group the process formed itself (the CLI adopts it): a resume of
  that run to epoch 3, bit-equal to an uninterrupted 3-epoch run (the
  gathered checkpoints shard back exactly); ``--tasks vqa2`` with
  ``--gradient_accumulation_steps 2`` against its single-process run;
  and ``--device_loop_steps 2``, which is coerced to 1 with the JAX CLI's
  warning and so steps as the first run's first epoch did.

The replicated parameters (``model.tp_specs``) are bit-identical on the
two ranks after every run.  ``--scst`` and ``--true_fp16`` still raise
with ``--tp_impl gspmd``."""

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

from tests.test_torch_cli_train import TINY
from tests.test_torch_parallel import free_port, spawn
from tests.test_torch_tp_cli import train_args

CHILD = r"""
import hashlib, json, sys
import torch
torch.set_num_threads(1)
import torch.distributed as tdist
from vlp_tpu_torch.cli import train

rank, port, out, jobs = int(sys.argv[1]), sys.argv[2], sys.argv[3], \
    json.loads(sys.argv[4])
rec = {}


def run(argv):
    res = train.main(argv)
    model = res["model"]
    # the replicated parameters: the same bits on both ranks of a group
    h = hashlib.sha256()
    for k, v in sorted(model.state_dict().items()):
        if model.tp_specs.get(k) is None:
            h.update(k.encode())
            h.update(v.detach().contiguous().numpy().tobytes())
    return {"losses": res["losses"], "hash": h.hexdigest(),
            "layout": model.tp_layout}


first, rest = jobs[0], jobs[1:]
rec[first[0]] = run(first[1])           # torchrun's environment
tdist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                         world_size=2, rank=rank)
for name, argv in rest:
    rec[name] = run(argv)
tdist.barrier()
tdist.destroy_process_group()
with open(out, "w") as f:
    json.dump(rec, f)
"""

GSPMD = ["--tensor_parallel", "2", "--tp_impl", "gspmd"]
MLM = ["--relax_projection", "--label_smoothing", "0.1"]


@pytest.fixture(scope="module")
def fx(tmp_path_factory):
    d = str(tmp_path_factory.mktemp("torch_gspmd_cli"))
    vocab = os.path.join(d, "vocab.txt")
    common.write_synthetic_vocab(vocab, size=120)
    cfg = os.path.join(d, "cfg.json")
    with open(cfg, "w") as f:
        json.dump(dict(TINY, hidden_dropout_prob=0.0,
                       attention_probs_dropout_prob=0.0), f)
    answers = os.path.join(d, "answers.txt")
    with open(answers, "w") as f:
        f.write("\n".join(["<unk>"] + [f"ans{i}" for i in range(1, 30)])
                + "\n")
    fx = dict(dir=d, vocab=vocab, answers=answers, cfg=cfg)

    def out(name):
        return os.path.join(d, name)

    vqa = ["--tasks", "vqa2", "--answer_vocab_file", answers, "--s2s_prob",
           "0", "--bi_prob", "1", "--gradient_accumulation_steps", "2",
           "--num_train_epochs", "1"]
    # one-process runs (on the CPU, without a group) in their own
    # processes: the reference numbers
    singles = {
        "single": train_args(fx, out("single"), "--num_train_epochs", "2",
                             *MLM),
        "vqa_single": train_args(fx, out("vqa_single"), *vqa)}
    jobs = [
        ("gspmd", train_args(fx, out("gspmd"), "--num_train_epochs", "2",
                             *MLM, *GSPMD)),
        ("resume", train_args(fx, out("gspmd"), "--num_train_epochs", "3",
                              *MLM, *GSPMD)),
        ("full3", train_args(fx, out("full3"), "--num_train_epochs", "3",
                             *MLM, *GSPMD)),
        ("vqa", train_args(fx, out("vqa"), *vqa, *GSPMD)),
        ("loop", train_args(fx, out("loop"), "--num_train_epochs", "1",
                            "--device_loop_steps", "2", *MLM, *GSPMD)),
    ]
    port, env_port = free_port(), free_port()
    outs = [os.path.join(d, f"rank{r}.json") for r in range(2)]

    def argv(r):
        return [str(r), str(port), outs[r], json.dumps(jobs)]

    def environ(r):
        return dict(PYTHONHASHSEED="0", RANK=str(r), LOCAL_RANK=str(r),
                    WORLD_SIZE="2", LOCAL_WORLD_SIZE="2",
                    MASTER_ADDR="127.0.0.1", MASTER_PORT=str(env_port))

    runs = spawn(CHILD, argv, world=2, env_of_rank=environ)
    for rc, text in runs:
        assert rc == 0, text[-4000:]
    fx["recs"] = [json.load(open(o)) for o in outs]
    single = r"""
import json, sys
import torch
torch.set_num_threads(1)
from vlp_tpu_torch.cli import train
print(json.dumps(train.main(json.loads(sys.argv[1]))["losses"]))
"""
    fx["singles"] = {}
    for name, a in singles.items():
        (rc, text), = spawn(single, lambda r: [json.dumps(a)], world=1,
                            env_of_rank=lambda r: dict(PYTHONHASHSEED="0"))
        assert rc == 0, text[-4000:]
        fx["singles"][name] = json.loads(text.strip().splitlines()[-1])
    return fx


def test_gspmd_cli_matches_one_process_and_writes_full_checkpoints(fx):
    r0, r1 = fx["recs"]
    assert r0["gspmd"]["layout"] == "gspmd"
    assert r0["gspmd"]["losses"] == r1["gspmd"]["losses"]
    assert len(r0["gspmd"]["losses"]) == 4
    np.testing.assert_allclose(r0["gspmd"]["losses"], fx["singles"]["single"],
                               rtol=1e-5, atol=1e-6)
    with open(os.path.join(fx["dir"], "gspmd", "training.log")) as f:
        assert "GSPMD training: dp=1 x tp=2" in f.read()
    cfg = VLPConfig.from_reference_json(fx["cfg"], type_vocab_size=6,
                                        relax_projection=4, len_vis_input=6,
                                        max_len_b=5)
    want = {k: v.shape for k, v in VLPModel(cfg).state_dict().items()}
    for n in (1, 2, 3):
        sd = torch.load(os.path.join(fx["dir"], "gspmd", f"model.{n}.bin"),
                        weights_only=True)
        assert {k: v.shape for k, v in sd.items()} == want
        assert torch.equal(sd["cls.predictions.decoder.weight"],
                           sd["bert.embeddings.word_embeddings.weight"])
        opt = torch.load(os.path.join(fx["dir"], "gspmd", f"optim.{n}.bin"),
                         weights_only=True)
        assert {k: v.shape for k, v in opt["m"].items()} == {
            k: want[k] for k in opt["m"]}
    dec_out = os.path.join(fx["dir"], "decode")
    stats = decode_cli.main([
        "--bert_model", fx["vocab"], "--config_path", fx["cfg"],
        "--new_segment_ids", "--enable_butd", "--synthetic_data",
        "--num_synthetic", "3", "--batch_size", "3",
        "--beam_size", "2", "--max_tgt_length", "5", "--len_vis_input", "6",
        "--device", "cpu", "--model_recover_path",
        os.path.join(fx["dir"], "gspmd", "model.2.bin"),
        "--output_dir", dec_out])
    assert stats["model.2.bin"]["n_images"] == 3


def test_gspmd_cli_resumes_and_runs_vqa(fx):
    r0, r1 = fx["recs"]
    for name in ("gspmd", "resume", "full3", "vqa", "loop"):
        assert r0[name]["hash"] == r1[name]["hash"], name
        assert r0[name]["losses"] == r1[name]["losses"], name
    # the resume took epoch 3 only, and ended where an uninterrupted run did
    assert r0["resume"]["losses"] == r0["full3"]["losses"][4:]
    assert r0["full3"]["losses"][:4] == r0["gspmd"]["losses"]
    a = torch.load(os.path.join(fx["dir"], "gspmd", "model.3.bin"),
                   weights_only=True)
    b = torch.load(os.path.join(fx["dir"], "full3", "model.3.bin"),
                   weights_only=True)
    assert all(torch.equal(a[k], b[k]) for k in a)
    np.testing.assert_allclose(r0["vqa"]["losses"],
                               fx["singles"]["vqa_single"], rtol=1e-5,
                               atol=1e-6)


def test_gspmd_cli_coerces_the_device_loop(fx):
    """The JAX CLI's rule: the GSPMD step has no device loop, so
    ``--device_loop_steps 2`` steps one batch at a time, as the first
    run's first epoch did, and says so."""
    r0 = fx["recs"][0]
    assert r0["loop"]["losses"] == r0["gspmd"]["losses"][:2]
    with open(os.path.join(fx["dir"], "loop", "training.log")) as f:
        log = f.read()
    assert "--device_loop_steps 2 coerced to 1" in log
    assert "GSPMD training: dp=1 x tp=2" in log


def test_what_raises_with_gspmd(fx):
    base = train_args(fx, os.path.join(fx["dir"], "no"), *GSPMD)
    with pytest.raises(ValueError, match="MLM/VQA paths only"):
        train_cli.main(base + ["--scst", "--max_pred", "0", "--mask_prob",
                               "0"])
    with pytest.raises(ValueError, match="MLM/VQA paths only"):
        train_cli.main(base + ["--true_fp16"])
    with pytest.raises(ValueError, match="must divide the world"):
        train_cli.main(base)
