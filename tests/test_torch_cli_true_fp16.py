"""``python -m vlp_tpu_torch.cli.train --true_fp16`` on the CPU (fp16
activations through the plain versions of the kernels):

* with ``--loss_scale 4`` it trains, logs the JAX CLI's line, keeps the
  scale at 4 and saves it in ``optim.1.bin``; rerun for 2 epochs it resumes
  at epoch 2 from step 4;
* dynamic scaling restores ``{"scale", "good_steps"}`` from the optimizer
  checkpoint and counts on from there;
* its per-step losses track the JAX CLI's ``--true_fp16`` run on the same
  reference .bin and synthetic stream, dropout off (fp16 on both sides);
* ``--tasks vqa2 --true_fp16`` fine-tunes in fp16;
* ``--true_fp16 --scst`` raises the JAX CLI's error."""

import json
import os

import numpy as np
import pytest
import torch

from tests.test_torch_cli_train import TINY, train_args
from vlp_tpu.checkpoint import params_to_torch
from vlp_tpu.cli import train as jax_train
from vlp_tpu.config import VLPConfig
from vlp_tpu_torch.cli import common
from vlp_tpu_torch.cli import train as train_cli

# fp16 on both sides, with the roundings at different points (XLA's fused
# CPU kernels, PyTorch's per-op ones): the losses within a few fp16 ulps
# (2^-11 relative each) of one another
FP16_LOSS_RTOL = 3e-3


@pytest.fixture(scope="module")
def fx(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_cli_true_fp16")
    vocab = str(d / "vocab.txt")
    common.write_synthetic_vocab(vocab, size=120)
    paths = {}
    for name, extra in (("cfg", {}), ("cfg_nodrop", dict(
            hidden_dropout_prob=0.0, attention_probs_dropout_prob=0.0))):
        paths[name] = str(d / f"{name}.json")
        with open(paths[name], "w") as f:
            json.dump(dict(TINY, **extra), f)
    return dict(dir=str(d), vocab=vocab, **paths)


def _optim(out, n):
    return torch.load(os.path.join(out, f"optim.{n}.bin"), weights_only=True)


def test_static_scale_trains_saves_and_resumes(fx):
    out = os.path.join(fx["dir"], "static")
    flags = ["--true_fp16", "--loss_scale", "4", "--steps_per_epoch", "4",
             "--device", "cpu"]
    first = train_cli.main(train_args(fx, out, "--num_train_epochs", "1",
                                      *flags))
    assert len(first["losses"]) == 4 and np.isfinite(first["losses"]).all()
    assert first["model"].dtype == torch.float16
    with open(os.path.join(out, "training.log")) as f:
        assert ("true-fp16: fp16 activations + static 4 loss scaling"
                in f.read())
    saved = _optim(out, 1)
    assert saved["step"] == 4
    assert saved["loss_scale"] == {"scale": 4.0, "good_steps": 0}
    with open(os.path.join(out, "metrics.jsonl")) as f:
        rec = json.loads(f.readline())
    assert rec["loss_scale"] == 4.0 and rec["skipped_step"] == 0.0
    resumed = train_cli.main(train_args(fx, out, "--num_train_epochs", "2",
                                        *flags))
    with open(os.path.join(out, "training.log")) as f:
        assert "Recover model: 1" in f.read()
    assert len(resumed["losses"]) == 4
    saved = _optim(out, 2)
    assert saved["step"] == 8
    assert saved["loss_scale"] == {"scale": 4.0, "good_steps": 0}


def test_dynamic_scale_is_restored_on_resume(fx):
    out = os.path.join(fx["dir"], "dynamic")
    flags = ["--true_fp16", "--steps_per_epoch", "2", "--device", "cpu"]
    train_cli.main(train_args(fx, out, "--num_train_epochs", "1", *flags))
    with open(os.path.join(out, "training.log")) as f:
        assert "true-fp16: fp16 activations + dynamic loss scaling" in f.read()
    saved = _optim(out, 1)
    assert saved["loss_scale"] == {"scale": 2.0 ** 15, "good_steps": 2}
    # a scale the run would not reach by itself, to see it come back
    saved["loss_scale"] = {"scale": 1024.0, "good_steps": 7}
    torch.save(saved, os.path.join(out, "optim.1.bin"))
    train_cli.main(train_args(fx, out, "--num_train_epochs", "2", *flags))
    saved = _optim(out, 2)
    assert saved["step"] == 4
    assert saved["loss_scale"] == {"scale": 1024.0, "good_steps": 9}


def test_losses_track_the_jax_cli(fx):
    """As tests/test_torch_cli_train.py's test: the JAX CLI's initial
    weights as a reference .bin both CLIs load, one step per epoch, dropout
    off; here both run --true_fp16 with a static scale."""
    cfg = VLPConfig.from_reference_json(fx["cfg_nodrop"])
    jout = os.path.join(fx["dir"], "jax")
    init = jax_train.main(train_args(fx, jout, cfg="cfg_nodrop")[1:])
    ref = os.path.join(fx["dir"], "ref.bin")
    torch.save({k: torch.from_numpy(np.array(v))
                for k, v in params_to_torch(init.params, cfg).items()}, ref)
    extra = ["--num_train_epochs", "4", "--steps_per_epoch", "1",
             "--drop_prob", "0", "--true_fp16", "--loss_scale", "128",
             "--model_recover_path", ref]
    jax_train.main(train_args(fx, jout, *extra, cfg="cfg_nodrop"))
    with open(os.path.join(jout, "metrics.jsonl")) as f:
        recs = [json.loads(line) for line in f]
    got = train_cli.main(train_args(fx, os.path.join(fx["dir"], "port"),
                                    *extra, "--device", "cpu",
                                    cfg="cfg_nodrop"))["losses"]
    assert len(recs) == len(got) == 4
    assert all(r["loss_scale"] == 128.0 and r["skipped_step"] == 0.0
               for r in recs)
    np.testing.assert_allclose(got, [r["loss"] for r in recs],
                               rtol=FP16_LOSS_RTOL)
    assert len(set(np.round(got, 3))) == 4


def test_vqa_fine_tune_trains_in_fp16(fx):
    """--tasks vqa2 --true_fp16: bi mode, the VQA BCE (fp32) over fp16
    activations, finite losses and the scale state in optim.1.bin."""
    answers = os.path.join(fx["dir"], "answers.txt")
    with open(answers, "w") as f:
        f.write("\n".join(["<unk>"] + [f"ans{i}" for i in range(1, 12)]))
    out = os.path.join(fx["dir"], "vqa")
    res = train_cli.main(train_args(
        fx, out, "--tasks", "vqa2", "--answer_vocab_file", answers,
        "--s2s_prob", "0", "--bi_prob", "1", "--true_fp16",
        "--num_train_epochs", "1", "--steps_per_epoch", "3",
        "--device", "cpu"))
    assert len(res["losses"]) == 3 and np.isfinite(res["losses"]).all()
    assert res["model"].dtype == torch.float16
    assert _optim(out, 1)["loss_scale"] == {"scale": 2.0 ** 15,
                                            "good_steps": 3}


def test_true_fp16_with_scst_raises(fx):
    with pytest.raises(ValueError, match="--true_fp16 is not supported with "
                                         "--scst"):
        train_cli.main(train_args(fx, os.path.join(fx["dir"], "scst"),
                                  "--true_fp16", "--scst", "--max_pred", "0",
                                  "--mask_prob", "0", "--device", "cpu"))
