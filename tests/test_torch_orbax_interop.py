"""Checkpoints between the JAX package's orbax ``model.N`` directories and
the port's reference ``.bin`` files, through the JAX package's convert CLI
(``python -m vlp_tpu.cli.convert``), on the CPU:

* a JAX-trained orbax directory, converted ``jax2torch``, decodes through
  the port's decode CLI into the JAX decode CLI's captions of the
  directory itself;
* the port's ``model.N.bin``, converted ``torch2jax`` (which runs the
  reference ``from_pretrained`` surgery on it), decodes through the JAX
  decode CLI into the port's captions of the ``.bin``;
* each port CLI refuses a directory with an error naming the convert
  command (``checkpoint.require_bin``)."""

import json
import os

import jax
import numpy as np
import pytest
import torch

from tests.test_torch_cli_train import TINY, train_args
from tests.test_torch_cli_vqa import stable_synthetic_features
from vlp_tpu.checkpoint import params_to_torch
from vlp_tpu.cli import common as jax_common
from vlp_tpu.cli import convert as jax_convert
from vlp_tpu.cli import decode as jax_decode
from vlp_tpu.cli import train as jax_train
from vlp_tpu.config import VLPConfig
from vlp_tpu.models.model import VLPModel as JaxVLPModel
from vlp_tpu.parallel import train_step as ts
from vlp_tpu_torch.cli import decode as decode_cli
from vlp_tpu_torch.cli import eval_vqa2 as eval_cli
from vlp_tpu_torch.cli import train as train_cli

REMEDY = "vlp_tpu.cli.convert --direction jax2torch"


@pytest.fixture(scope="module")
def fx(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_orbax_interop")
    vocab = str(d / "vocab.txt")
    jax_common.write_synthetic_vocab(vocab, size=120)
    cfg_json = str(d / "bert_config.json")
    with open(cfg_json, "w") as f:
        json.dump(TINY, f)
    cfg = VLPConfig.from_reference_json(
        cfg_json, type_vocab_size=6, relax_projection=4, len_vis_input=6,
        max_len_b=5, dtype="float32", use_pallas_attention=False)
    params = ts.init_params(JaxVLPModel(cfg), cfg, jax.random.PRNGKey(11))
    sd = params_to_torch(params, cfg)
    for k in sd:
        if k.startswith("vis_") or ".attention.self." in k:
            # louder regions and sharper attention: at the initial scale
            # every image gets the same caption
            sd[k] = sd[k] * 30.0
    start = str(d / "start.bin")
    torch.save({k: torch.from_numpy(v.copy()) for k, v in sd.items()}, start)
    return dict(dir=str(d), vocab=vocab, cfg=cfg_json, start=start)


def _train(fx, out, *extra):
    return train_args(fx, out, "--num_train_epochs", "1",
                      "--steps_per_epoch", "1", "--model_recover_path",
                      fx["start"], *extra)


def _decode_args(fx, model_path, out):
    return ["--synthetic_data", "--enable_butd", "--bert_model", fx["vocab"],
            "--config_path", fx["cfg"], "--new_segment_ids", "--batch_size",
            "3", "--max_tgt_length", "5", "--len_vis_input", "6",
            "--num_synthetic", "5", "--beam_size", "2",
            "--model_recover_path", model_path, "--output_dir", out]


def _preds(out, model_path):
    name = f"preds-{os.path.basename(model_path)}-val.json"
    with open(os.path.join(out, name)) as f:
        return json.load(f)


def _convert(fx, src, dst, direction):
    jax_convert.main(["--input", src, "--output", dst, "--direction",
                      direction, "--vocab_size", "120", "--new_segment_ids",
                      "--relax_projection", "--len_vis_input", "6",
                      "--config_path", fx["cfg"]])


def test_jax_orbax_converted_decodes_in_the_port(fx, monkeypatch):
    stable_synthetic_features(monkeypatch)
    run = os.path.join(fx["dir"], "jax_run")
    jax_train.main(_train(fx, run))
    orbax_dir = os.path.join(run, "model.1")
    assert os.path.isdir(orbax_dir)
    out_j = os.path.join(fx["dir"], "jax_dec")
    jax_decode.main(_decode_args(fx, orbax_dir, out_j))
    want = _preds(out_j, orbax_dir)
    bin_path = os.path.join(fx["dir"], "from_jax.bin")
    _convert(fx, orbax_dir, bin_path, "jax2torch")
    out = os.path.join(fx["dir"], "port_dec")
    decode_cli.main(_decode_args(fx, bin_path, out) + ["--device", "cpu"])
    got = _preds(out, bin_path)
    assert len(got) == 5
    assert got == want
    assert len({p["caption"] for p in got}) > 1


def test_port_bin_converted_decodes_in_jax(fx, monkeypatch):
    stable_synthetic_features(monkeypatch)
    run = os.path.join(fx["dir"], "port_run")
    train_cli.main(_train(fx, run, "--device", "cpu"))
    bin_path = os.path.join(run, "model.1.bin")
    out = os.path.join(fx["dir"], "port_dec2")
    decode_cli.main(_decode_args(fx, bin_path, out) + ["--device", "cpu"])
    want = _preds(out, bin_path)
    orbax_dir = os.path.join(fx["dir"], "from_port")
    _convert(fx, bin_path, orbax_dir, "torch2jax")
    out_j = os.path.join(fx["dir"], "jax_dec2")
    jax_decode.main(_decode_args(fx, orbax_dir, out_j))
    got = _preds(out_j, orbax_dir)
    assert len(got) == 5
    assert got == want
    assert len({p["caption"] for p in got}) > 1


@pytest.mark.parametrize("cli", ["decode", "eval_vqa2", "train",
                                 "train_finetune_decay"])
def test_port_clis_refuse_a_directory(fx, cli):
    orbax_dir = os.path.join(fx["dir"], "model.9")
    os.makedirs(orbax_dir, exist_ok=True)
    out = os.path.join(fx["dir"], f"refuse_{cli}")
    with pytest.raises(IsADirectoryError, match=REMEDY):
        if cli == "decode":
            decode_cli.main(_decode_args(fx, orbax_dir, out)
                            + ["--device", "cpu"])
        elif cli == "eval_vqa2":
            answers = os.path.join(fx["dir"], "answers.txt")
            with open(answers, "w") as f:
                f.write("<unk>\nyes\nno\n")
            eval_cli.main(["--synthetic_data", "--num_synthetic", "3",
                           "--enable_butd", "--bert_model", fx["vocab"],
                           "--config_path", fx["cfg"], "--new_segment_ids",
                           "--answer_vocab_file", answers,
                           "--len_vis_input", "6", "--max_tgt_length", "5",
                           "--model_recover_path", orbax_dir,
                           "--output_dir", out, "--device", "cpu"])
        else:
            extra = (["--finetune_decay"] if cli == "train_finetune_decay"
                     else [])
            train_cli.main(train_args(fx, out, "--model_recover_path",
                                      orbax_dir, *extra, "--device", "cpu"))
