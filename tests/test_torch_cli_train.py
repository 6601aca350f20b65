"""The port's train CLI (vlp_tpu_torch/cli/train.py) on the CPU: a tiny
synthetic run whose per-step losses track the JAX CLI's from the same
reference .bin with dropout off; an interrupted run resumed from its epoch
or step checkpoint ends where an uninterrupted one does; the saved
``model.N.bin`` decodes through the port's decode CLI; unported flags
raise, ``--tp_impl gspmd`` among them (SCST's own CLI run is in
tests/test_torch_scst.py; ``--tensor_parallel`` runs in
tests/test_torch_tp_cli.py)."""

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
from vlp_tpu_torch.cli import decode as decode_cli
from vlp_tpu_torch.cli import train as train_cli

TINY = {"vocab_size": 120, "hidden_size": 32, "num_hidden_layers": 2,
        "num_attention_heads": 2, "intermediate_size": 64,
        "max_position_embeddings": 512, "vis_feat_dim": 24,
        "vis_cls_dim": 10, "vis_pe_dim": 16}


@pytest.fixture(scope="module")
def fx(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_cli_train")
    vocab = str(d / "vocab.txt")
    common.write_synthetic_vocab(vocab, size=120)
    cfg_json = str(d / "bert_config.json")
    with open(cfg_json, "w") as f:
        json.dump(TINY, f)
    # with --config_path both CLIs take the dropout rates from the json,
    # not from --drop_prob
    cfg_nodrop = str(d / "bert_config_nodrop.json")
    with open(cfg_nodrop, "w") as f:
        json.dump(dict(TINY, hidden_dropout_prob=0.0,
                       attention_probs_dropout_prob=0.0), f)
    return dict(dir=str(d), vocab=vocab, cfg=cfg_json, cfg_nodrop=cfg_nodrop)


def train_args(fx, out, *extra, cfg="cfg"):
    # batch 4 does not split over the 8 virtual JAX devices, so the JAX CLI
    # trains single-device, as the port does
    return ["--do_train", "--synthetic_data", "--enable_butd",
            "--bert_model", fx["vocab"], "--config_path", fx[cfg],
            "--output_dir", out, "--train_batch_size", "4",
            "--new_segment_ids", "--relax_projection", "--len_vis_input", "6",
            "--max_len_b", "5", "--max_pred", "3", "--s2s_prob", "0.75",
            "--bi_prob", "0.25", "--learning_rate", "1e-3", *extra]


def test_losses_track_the_jax_cli(fx):
    """Dropout off, same weights (a reference .bin both CLIs load), same
    synthetic stream: one step per epoch, so the JAX CLI's metrics.jsonl
    (it logs step 0 of each epoch) holds every step's loss.  Label
    smoothing, the pretext loss and drop-worst (from epoch 2) are on."""
    # the weights: the JAX CLI's own init (without --do_train it returns
    # its initial state), written as a reference .bin that both CLIs load
    cfg = VLPConfig.from_reference_json(fx["cfg_nodrop"])
    jout = os.path.join(fx["dir"], "jax")
    init = jax_train.main(train_args(fx, jout, cfg="cfg_nodrop")[1:])
    ref = os.path.join(fx["dir"], "ref.bin")
    torch.save({k: torch.from_numpy(np.array(v))
                for k, v in params_to_torch(init.params, cfg).items()}, ref)
    extra = ["--num_train_epochs", "4", "--steps_per_epoch", "1",
             "--drop_prob", "0", "--label_smoothing", "0.1",
             "--vis_mask_prob", "0.5", "--max_drop_worst_ratio", "0.25",
             "--drop_after", "1", "--model_recover_path", ref]
    jax_train.main(train_args(fx, jout, *extra, cfg="cfg_nodrop"))
    with open(os.path.join(jout, "metrics.jsonl")) as f:
        want = [json.loads(line)["loss"] for line in f]
    got = train_cli.main(train_args(fx, os.path.join(fx["dir"], "port"),
                                    *extra, "--device", "cpu",
                                    cfg="cfg_nodrop"))["losses"]
    assert len(want) == len(got) == 4
    np.testing.assert_allclose(got, want, rtol=1e-5)
    assert len(set(np.round(got, 4))) == 4


def _params(model):
    return {n: p.detach().clone() for n, p in model.named_parameters()}


@pytest.mark.parametrize("kind", ["epoch", "step"])
def test_resume_matches_an_uninterrupted_run(fx, kind):
    """Dropout on: a run cut after epoch 1 (or after step 3 of 4) and
    resumed from its checkpoint draws the same masks and ends with the
    same parameters as the uninterrupted run."""
    extra = ["--num_train_epochs", "2", "--steps_per_epoch", "2",
             "--device", "cpu"]
    if kind == "step":
        extra += ["--save_steps", "1"]
    full = os.path.join(fx["dir"], f"full_{kind}")
    done = train_cli.main(train_args(fx, full, *extra))
    cut = os.path.join(fx["dir"], f"cut_{kind}")
    os.makedirs(cut)
    kept = (["model.1.bin", "optim.1.bin"] if kind == "epoch"
            else ["model.1.bin", "optim.1.bin", "model.s3.bin",
                  "optim.s3.bin"])
    for name in kept:
        shutil.copy(os.path.join(full, name), cut)
    resumed = train_cli.main(train_args(fx, cut, *extra))
    with open(os.path.join(cut, "training.log")) as f:
        log = f.read()
    assert ("Recover model: 1" if kind == "epoch"
            else "Recover model: step 3") in log
    assert len(resumed["losses"]) == (2 if kind == "epoch" else 1)
    np.testing.assert_array_equal(resumed["losses"],
                                  done["losses"][-len(resumed["losses"]):])
    want = _params(done["model"])
    for n, p in _params(resumed["model"]).items():
        assert torch.equal(p, want[n]), n
    saved = torch.load(os.path.join(cut, "model.2.bin"), weights_only=True)
    assert saved["cls.predictions.decoder.weight"].data_ptr() == \
        saved["bert.embeddings.word_embeddings.weight"].data_ptr()

    if kind == "epoch":
        # the saved epoch checkpoint decodes through the decode CLI
        dec_out = os.path.join(fx["dir"], "decode")
        stats = decode_cli.main([
            "--synthetic_data", "--enable_butd", "--bert_model", fx["vocab"],
            "--config_path", fx["cfg"], "--new_segment_ids",
            "--len_vis_input", "6", "--max_tgt_length", "5",
            "--beam_size", "2", "--batch_size", "3", "--num_synthetic", "3",
            "--model_recover_path", os.path.join(cut, "model.2.bin"),
            "--output_dir", dec_out, "--device", "cpu"])
        assert stats["model.2.bin"]["n_images"] == 3
        with open(os.path.join(dec_out, "preds-model.2.bin-val.json")) as f:
            assert len(json.load(f)) == 3


def test_finetune_decay_accumulation_and_profile(fx):
    """--finetune_decay anchors on --model_recover_path (and raises
    without it); --gradient_accumulation_steps and --profile_steps run."""
    base = os.path.join(fx["dir"], "ft_base")
    train_cli.main(train_args(fx, base, "--num_train_epochs", "1",
                              "--steps_per_epoch", "1", "--device", "cpu"))
    anchor = os.path.join(base, "model.1.bin")
    out = os.path.join(fx["dir"], "ft")
    with pytest.raises(ValueError, match="--model_recover_path"):
        train_cli.main(train_args(fx, out, "--finetune_decay",
                                  "--device", "cpu"))
    res = train_cli.main(train_args(
        fx, out, "--num_train_epochs", "1", "--steps_per_epoch", "3",
        "--finetune_decay", "--model_recover_path", anchor,
        "--gradient_accumulation_steps", "2", "--profile_steps", "1",
        "--device", "cpu"))
    assert len(res["losses"]) == 3 and np.isfinite(res["losses"]).all()
    with open(os.path.join(out, "profile.txt")) as f:
        assert "busy share" in f.readline()


@pytest.mark.parametrize("flag,item", [
    (["--scst", "--scst_replay", "scan"], "A9"),
    (["--scst", "--scst_remat"], "Not to")])
def test_unported_flags_raise(fx, flag, item):
    with pytest.raises(NotImplementedError, match=item):
        train_cli.main(train_args(fx, os.path.join(fx["dir"], "no"), *flag,
                                  "--device", "cpu"))


def test_device_cuda_without_a_gpu_raises(fx, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        train_cli.main(train_args(fx, os.path.join(fx["dir"], "nogpu")))
