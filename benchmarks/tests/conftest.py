"""The benchmark's tests: CPU tests at tiny sizes, and tests marked
``cuda`` that need the card (the ``card`` fixture skips them without
one).

    python -m pytest benchmarks/tests -q
"""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU; the card fixture skips the "
        "test without one")


@pytest.fixture
def card():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


TINY = dict(vocab_size=300, hidden_size=128, num_hidden_layers=2,
            num_attention_heads=2, intermediate_size=256, hidden_act="gelu",
            hidden_dropout_prob=0.1, attention_probs_dropout_prob=0.1,
            max_position_embeddings=512, type_vocab_size=6,
            relax_projection=0, initializer_range=0.02, label_smoothing=0.0,
            len_vis_input=10, vis_feat_dim=64, vis_cls_dim=33, vis_pe_dim=39,
            max_len_b=20, max_pred=20, num_answers=50, dtype="float32")
TINY_TRAFFIC = dict(images=8, examples=256, batch_size=4, score_pool=16,
                    captions=64, check_captions=4)


def run_cell(workload: str, seed: int = 20261018, seconds: float = 8.0,
             controls: bool = False, **over):
    """One run of ``workload``'s driver on the CPU at a tiny size (fp32,
    the program's plain paths); returns the run's record."""
    import tempfile

    import torch

    from benchmarks import harness
    torch.set_num_threads(2)
    man = harness.manifest()
    wl = harness.workload(man, workload)
    tr = dict(harness.traffic(wl["traffic"]), **TINY_TRAFFIC)
    if tr["driver"] == "decode":
        tr["batch_size"] = 8
    tr.update(over)
    with tempfile.TemporaryDirectory() as work:
        ctx = harness.Context(workload, dict(TINY), tr, seed, seconds,
                              False, work, "cpu")
        ctx.controls = controls
        harness.driver(tr["driver"]).run(ctx)
    rec = ctx.record
    rec["spans"], rec["window"] = ctx.spans, ctx.window
    return rec


def failing(rec):
    """Names of the checks a run failed."""
    return [c["name"] for c in rec["checks"] if c["value"] > c["limit"]]
