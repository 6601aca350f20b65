"""The port's decode CLI (``--device cpu``) and the JAX decode CLI decode
the same reference-format ``.bin`` — written from JAX params with
``params_to_torch`` + ``torch.save``, with a 4-head relax projection that
both loaders collapse to task head 3 — into identical prediction files."""

import json
import os

import jax
import pytest
import torch

from vlp_tpu.checkpoint import params_to_torch
from vlp_tpu.cli import common as cli_common
from vlp_tpu.cli import decode as jax_cli
from vlp_tpu.config import VLPConfig
from vlp_tpu.models.model import VLPModel as JaxVLPModel
from vlp_tpu.parallel import train_step as ts
from vlp_tpu_torch.cli import decode as torch_cli


@pytest.fixture(scope="module")
def fixtures(tmp_path_factory):
    d = tmp_path_factory.mktemp("torch_cli")
    vocab = str(d / "vocab.txt")
    cli_common.write_synthetic_vocab(vocab, size=120)
    cfg_json = str(d / "bert_config.json")
    with open(cfg_json, "w") as f:
        json.dump({"vocab_size": 120, "hidden_size": 32,
                   "num_hidden_layers": 2, "num_attention_heads": 2,
                   "intermediate_size": 64, "max_position_embeddings": 512,
                   "vis_feat_dim": 24, "vis_cls_dim": 10, "vis_pe_dim": 16},
                  f)
    cfg = VLPConfig.from_reference_json(
        cfg_json, type_vocab_size=6, relax_projection=4, len_vis_input=6,
        max_len_b=5, dtype="float32", use_pallas_attention=False)
    params = ts.init_params(JaxVLPModel(cfg), cfg, jax.random.PRNGKey(11))
    sd = params_to_torch(params, cfg)
    for k in sd:
        if k.startswith("vis_") or ".attention.self." in k:
            # louder region projections and sharper attention: at the
            # initial scale every image gets the same caption
            sd[k] = sd[k] * 30.0
    bin_path = str(d / "model.7.bin")
    torch.save({k: torch.from_numpy(v.copy()) for k, v in sd.items()},
               bin_path)
    return dict(dir=str(d), vocab=vocab, cfg=cfg_json, bin=bin_path)


CASES = {
    "beam3": ["--beam_size", "3", "--length_penalty", "0.5", "--min_len",
              "2", "--forbid_duplicate_ngrams", "--ngram_size", "2"],
    "greedy": ["--beam_size", "1"],
    # three batches, the last one partial: the depth-1 pipeline's order
    "beam3_three_batches": ["--beam_size", "3", "--num_synthetic", "7"],
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_port_cli_matches_jax_cli(fixtures, case):
    args = ["--synthetic_data", "--enable_butd", "--bert_model",
            fixtures["vocab"], "--config_path", fixtures["cfg"],
            "--new_segment_ids", "--batch_size", "3", "--max_tgt_length",
            "5", "--len_vis_input", "6", "--num_synthetic", "5",
            "--model_recover_path", fixtures["bin"], *CASES[case]]
    out_j = os.path.join(fixtures["dir"], f"jax_{case}")
    out_t = os.path.join(fixtures["dir"], f"torch_{case}")
    jax_cli.main(args + ["--output_dir", out_j])
    stats = torch_cli.main(args + ["--output_dir", out_t, "--device", "cpu"])
    n = 7 if "--num_synthetic" in CASES[case] else 5
    assert stats["model.7.bin"]["n_images"] == n
    name = "preds-model.7.bin-val.json"
    with open(os.path.join(out_j, name)) as f:
        want = json.load(f)
    with open(os.path.join(out_t, name)) as f:
        got = json.load(f)
    assert len(got) == n
    assert got == want


def test_cuda_device_without_gpu_raises(fixtures, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="cuda"):
        torch_cli.main(["--bert_model", fixtures["vocab"], "--device",
                        "cuda"])
