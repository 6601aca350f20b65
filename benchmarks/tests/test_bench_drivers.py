"""Each driver kind at a tiny size on the CPU (the program's plain paths,
fp32): its inputs build, its window runs, its comparison with the plain
reference passes; and with the timed path broken underneath, the same run
comes out not correct, once for each fault its cell can have (a step
that leaves the state unchanged, half of each batch left out with the
mean over the rest, a token altered where it is produced).  One chip, so
no exchange between chips to leave out."""

import numpy as np
import pytest
import torch

from conftest import failing, run_cell

TRAIN = ["coco-cap-train", "vqa2-train-loop4"]


@pytest.mark.parametrize("workload", TRAIN + ["coco-cap-beam5"])
def test_sound_run_is_correct(workload):
    rec = run_cell(workload)
    assert rec["attempted"] > 0 and rec["failed"] == 0
    assert failing(rec) == []
    assert rec["setup_s"] > 0 and rec["done"]


@pytest.mark.parametrize("workload", TRAIN)
def test_state_left_unchanged_fails(workload, monkeypatch):
    from vlp_tpu_torch import optim
    monkeypatch.setattr(optim.BertAdam, "step",
                        lambda self, finite=None: None)
    assert "change_gap" in failing(run_cell(workload))


@pytest.mark.parametrize("workload", TRAIN)
def test_half_batch_fails(workload, monkeypatch):
    from vlp_tpu_torch import train_step as ts
    whole = ts.grads_with_accum

    def half(model, batch, seed, **kw):
        n = batch["input_ids"].shape[0] // 2
        return whole(model, {k: v[:n] for k, v in batch.items()}, seed,
                     **kw)

    monkeypatch.setattr(ts, "grads_with_accum", half)
    assert failing(run_cell(workload))


def test_altered_token_fails(monkeypatch):
    from vlp_tpu_torch import decode
    trace = decode.Decoder.beam_trace

    def altered(self, batch):
        ids, ptrs, scores = trace(self, batch)
        ids = ids.clone()
        ids[3] = (ids[3] + 1) % self.model.cfg.vocab_size
        return ids, ptrs, scores

    monkeypatch.setattr(decode.Decoder, "beam_trace", altered)
    assert "score_gap" in failing(run_cell("coco-cap-beam5"))


def test_wrong_served_caption_fails(monkeypatch):
    from vlp_tpu_torch import decode
    collect = decode.Decoder.beam_collect

    def swapped(self, handle):
        out = collect(self, handle)
        out["pred_seq"] = np.roll(out["pred_seq"], 1, axis=0)
        return out

    monkeypatch.setattr(decode.Decoder, "beam_collect", swapped)
    assert "path_mismatch" in failing(run_cell("coco-cap-beam5"))


@pytest.mark.parametrize("workload", TRAIN)
def test_control_fails(workload):
    """The control (the reference in fp8 in the program's place) fails
    one of the cell's numbers, here at a tiny size."""
    rec = run_cell(workload, controls=True)
    limits = {c["name"]: c["limit"] for c in rec["checks"]}
    fp8 = rec["control"]["fp8"]
    assert any(fp8[n] > limits[n] for n in fp8)


def test_decode_control_fails_at_the_cells_size():
    """The decode cell's control at the configuration's own width and
    depth (the reference teacher-forced over two prompts and 20 tokens,
    cheap on the CPU): fp8's cumulative log-probabilities leave the fp32
    ones by more than the cell's limit."""
    from benchmarks import harness, inputs, weights
    from benchmarks.reference import data, model
    man = harness.manifest()
    cfg = harness.config(man, "vlp-base-coco-cap")
    limit = harness.traffic("coco-cap-beam5")["limits"]["score_gap"]
    inp = inputs.make_inputs(cfg, {"images": 2}, 7, "cpu")
    W = {n: t.float() for n, t in weights.make_weights(
        cfg, False, 11, "cpu", dtype=torch.bfloat16).items()}
    toks = torch.from_numpy(np.random.default_rng(3).integers(
        inputs.FIRST_WORD, cfg["vocab_size"], (1, 20)))
    gaps = []
    for img in range(2):
        pr = {k: torch.from_numpy(np.asarray(v))[None]
              for k, v in data.decode_prompt(inp, cfg, img).items()}
        pr["mask_id"] = 103
        cums = [torch.cumsum(model.caption_logprobs(
            W, cfg, pr, toks, model.Precision(p))[0].double(), 0)
            for p in ("fp32", "fp8")]
        gaps.append(float((cums[0] - cums[1]).abs().max()))
    assert max(gaps) > limit


def test_dropout_masks_match_the_program():
    """The reference's attention-dropout bits are the program's."""
    from benchmarks.reference import philox as ref
    from vlp_tpu_torch.ops import philox as prog
    seed = 0xDEADBEEF12345678
    assert torch.equal(ref.keep_scale(seed, 2, 3, 9, 0.1),
                       prog.keep_scale(seed, 2, 3, 9, 0.1))
    assert ref.step_seed(5, 1, 2) == prog.step_seed(5, 1, 2)
