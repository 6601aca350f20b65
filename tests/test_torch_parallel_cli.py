"""The port's CLIs data parallel on two CPU processes under gloo (``--device
cpu``, the tiny config of tests/test_torch_cli_train.py):

* ``cli.train --jax_distributed``: 2 epochs of 2 steps, then a resume for
  a third through the broadcast of rank 0's recover step.  Both ranks exit
  0, only rank 0 writes ``model.N.bin`` (once per epoch), and the two
  ranks' trained parameters are equal; the all-reduce is timed and traced
  with ``--profile_steps`` only.
* ``cli.train --scst`` launched through torchrun's environment: the
  replicas stay in sync.
* ``cli.decode`` over 7 synthetic images (an uneven split) and
  ``cli.eval_vqa2``, each through torchrun's environment: rank 0 writes
  the single-process CLI's output file, byte for byte.  Every process runs
  with one ``PYTHONHASHSEED``: the synthetic feature store seeds each
  image's features from ``hash(key)``.
* What still raises: ``--world_size 3`` with a group of 2,
  ``--tensor_parallel 2``, and ``--device cuda`` with a group on a machine
  without a GPU.
"""

import json
import os

import pytest
import torch

from vlp_tpu_torch.cli import common
from vlp_tpu_torch.cli import decode as decode_cli
from vlp_tpu_torch.cli import eval_vqa2 as eval_cli
from vlp_tpu_torch.cli import train as train_cli
from vlp_tpu_torch.models.model import VLPModel

from tests.test_torch_cli_train import TINY
from tests.test_torch_parallel import free_port, spawn

CHILD = r"""
import hashlib, json, sys
import torch
torch.set_num_threads(1)
from vlp_tpu_torch import checkpoint as ckpt
from vlp_tpu_torch.cli import decode, eval_vqa2, train

which, out, argv = sys.argv[1], sys.argv[2], sys.argv[3:]
saves = []
save = ckpt.save_checkpoint
ckpt.save_checkpoint = lambda d, tag, *a: saves.append(tag) or save(d, tag,
                                                                    *a)
rec = {"saves": saves}
if which == "train":
    res = train.main(argv)
    h = hashlib.sha256()
    for k, v in sorted(res["model"].state_dict().items()):
        h.update(k.encode())
        h.update(v.detach().contiguous().numpy().tobytes())
    rec.update(hash=h.hexdigest(), losses=res["losses"],
               reductions=len(res["allreduce_ms"]))
else:
    rec["stats"] = (decode if which == "decode" else eval_vqa2).main(argv)
with open(out, "w") as f:
    json.dump(rec, f)
"""


@pytest.fixture(scope="module")
def fx(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_parallel_cli")
    vocab = str(d / "vocab.txt")
    common.write_synthetic_vocab(vocab, size=120)
    cfg_json = str(d / "bert_config.json")
    with open(cfg_json, "w") as f:
        json.dump(TINY, f)
    answers = str(d / "answers.txt")
    with open(answers, "w") as f:
        f.write("\n".join(["<unk>"] + [f"ans{i}" for i in range(1, 30)])
                + "\n")
    return dict(dir=str(d), vocab=vocab, cfg=cfg_json, answers=answers)


def run(fx, which, argv, world=2, env="jax", tag="run"):
    """``which`` CLI on ``world`` gloo ranks (``env="jax"``: the JAX CLI's
    flags; ``"torchrun"``: torchrun's environment; ``None``: one process
    with no group); returns each rank's (returncode, log, record)."""
    port = str(free_port())
    outs = [os.path.join(fx["dir"], f"{tag}.{r}.json") for r in range(world)]

    def args(r):
        extra = (["--jax_distributed", "--coordinator_address",
                  f"127.0.0.1:{port}", "--num_processes", str(world),
                  "--process_id", str(r)] if env == "jax" else [])
        return [which, outs[r], *argv, *extra]

    def environ(r):
        e = {"PYTHONHASHSEED": "0"}
        if env == "torchrun":
            e.update(RANK=str(r), LOCAL_RANK=str(r), WORLD_SIZE=str(world),
                     MASTER_ADDR="127.0.0.1", MASTER_PORT=port)
        return e

    runs = spawn(CHILD, args, world=world, env_of_rank=environ)
    recs = []
    for (rc, log), out in zip(runs, outs):
        rec = None
        if rc == 0:
            with open(out) as f:
                rec = json.load(f)
        recs.append((rc, log, rec))
    return recs


def train_args(fx, out, *extra):
    return ["--do_train", "--synthetic_data", "--enable_butd",
            "--bert_model", fx["vocab"], "--config_path", fx["cfg"],
            "--output_dir", out, "--train_batch_size", "4",
            "--new_segment_ids", "--len_vis_input", "6", "--max_len_b", "5",
            "--num_workers", "1", "--steps_per_epoch", "2",
            "--learning_rate", "1e-3", "--device", "cpu", *extra]


def _ok(recs):
    for rc, log, _ in recs:
        assert rc == 0, log[-4000:]
    return [rec for _, _, rec in recs]


def test_two_rank_train_and_resume(fx):
    out = os.path.join(fx["dir"], "train")
    r0, r1 = _ok(run(fx, "train", train_args(
        fx, out, "--max_pred", "3", "--num_train_epochs", "2",
        "--world_size", "2", "--profile_steps", "1"), tag="train"))
    assert r0["hash"] == r1["hash"]
    assert r0["losses"] == r1["losses"] and len(r0["losses"]) == 4
    assert r0["saves"] == [1, 2] and r1["saves"] == []
    # --profile_steps times every step's all-reduce and traces its ranges
    assert r0["reductions"] == 4
    with open(os.path.join(out, "profile.txt")) as f:
        table = f.read()
    assert "dist.grad_agreement" in table and "dist.grad_buckets" in table
    for n in (1, 2):
        assert os.path.isfile(os.path.join(out, f"model.{n}.bin"))
    with open(os.path.join(out, "training.log")) as f:
        assert "2 rank(s)" in f.read()
    # the resume: both ranks take rank 0's recover step, epoch 3 only
    r0, r1 = _ok(run(fx, "train", train_args(
        fx, out, "--max_pred", "3", "--num_train_epochs", "3"),
        tag="resume"))
    assert r0["hash"] == r1["hash"] and len(r0["losses"]) == 2
    assert r0["saves"] == [3] and r1["saves"] == []
    assert r0["reductions"] == 0     # not timed without --profile_steps


def test_two_rank_scst_stays_in_sync(fx):
    out = os.path.join(fx["dir"], "scst")
    r0, r1 = _ok(run(fx, "train", train_args(
        fx, out, "--scst", "--dataset", "coco", "--max_pred", "0",
        "--mask_prob", "0", "--num_train_epochs", "1"), env="torchrun",
        tag="scst"))
    assert r0["hash"] == r1["hash"] and r0["losses"] == r1["losses"]
    assert r0["saves"] == [1] and r1["saves"] == []
    with open(os.path.join(out, "metrics.jsonl")) as f:
        assert "mean_reward" in json.loads(f.readline())


def _bin(fx, path, cfg, with_vqa=False):
    """Random weights from a seed, region projections, attention and the
    answer head made louder so that the images get different outputs."""
    model = VLPModel(cfg, with_vqa=with_vqa)
    model.init_weights(torch.Generator().manual_seed(11))
    sd = {}
    for k, v in model.state_dict().items():
        loud = k.startswith(("vis_", "ans_")) or ".attention.self." in k
        sd[k] = v * 30.0 if loud else v.clone()
    torch.save(sd, path)
    return path


@pytest.mark.parametrize("which", ["decode", "eval_vqa2"])
def test_two_rank_eval_writes_the_single_process_output(fx, which):
    common_args = ["--synthetic_data", "--num_synthetic", "7",
                   "--enable_butd", "--bert_model", fx["vocab"],
                   "--config_path", fx["cfg"], "--new_segment_ids",
                   "--batch_size", "3", "--max_tgt_length", "5",
                   "--len_vis_input", "6", "--device", "cpu"]
    if which == "decode":
        extra = ["--beam_size", "3"]
        cfg = decode_cli.make_config(decode_cli.build_parser().parse_args(
            common_args), 120, "float32")
        path = _bin(fx, os.path.join(fx["dir"], "model.5.bin"), cfg)
        name = "preds-model.5.bin-val.json"
    else:
        extra = ["--answer_vocab_file", fx["answers"]]
        args = eval_cli.build_parser().parse_args(common_args + extra)
        args.max_len_b, args.max_pred, args.label_smoothing = 5, 0, 0
        args.relax_projection, args.max_position_embeddings = False, 512
        cfg = train_cli.make_config(args, 120, "float32").replace(
            num_answers=30)
        path = _bin(fx, os.path.join(fx["dir"], "model.6.bin"), cfg, True)
        name = "vqa2-results-model.6.bin-val.json"
    outs = {}
    for mode, world, env in (("single", 1, None), ("dp", 2, "torchrun")):
        out = os.path.join(fx["dir"], f"{which}_{mode}")
        recs = _ok(run(fx, which, common_args + extra + [
            "--model_recover_path", path, "--output_dir", out], world=world,
            env=env, tag=f"{which}_{mode}"))
        with open(os.path.join(out, name), "rb") as f:
            outs[mode] = f.read()
        counts = [list(r["stats"].values())[0] for r in recs]
        key = "n_images" if which == "decode" else "n_questions"
        assert [c[key] for c in counts] == ([7] if world == 1 else [7, 3])
    assert outs["dp"] == outs["single"]
    assert len(set(p["caption" if which == "decode" else "answer"]
                   for p in json.loads(outs["dp"]))) > 1


def test_what_still_raises(fx, monkeypatch):
    recs = run(fx, "train", train_args(
        fx, os.path.join(fx["dir"], "ws3"), "--world_size", "3"), tag="ws3")
    for rc, log, _ in recs:
        assert rc != 0 and "--world_size 3 but the group has 2" in log
    with pytest.raises(NotImplementedError, match="Not to port"):
        train_cli.main(train_args(fx, os.path.join(fx["dir"], "tp"),
                                  "--tensor_parallel", "2"))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for k, v in dict(RANK="0", LOCAL_RANK="0", WORLD_SIZE="2",
                     MASTER_ADDR="127.0.0.1", MASTER_PORT="1").items():
        monkeypatch.setenv(k, v)
    argv = train_args(fx, os.path.join(fx["dir"], "nogpu"))
    with pytest.raises(RuntimeError, match="--device cpu"):
        train_cli.main(argv[:-2] + ["--device", "cuda"])
