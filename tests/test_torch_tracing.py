"""The program's spans (vlp_tpu_torch/tracing.py): off they record nothing
and enter no profiler range; on they keep name, thread, parent, times,
CPU time and count; under ``torch.profiler`` each is a range of the
exported trace at the bounds kept in memory; and the hot paths record
the spans their docstrings name (an eager step, a device-loop group's
upload, the beam loop and its collect, the decode CLI's uploads)."""

import gc
import json
import threading
import time

import numpy as np
import pytest
import torch

from vlp_tpu_torch import optim, tracing
from vlp_tpu_torch import train_step as ts
from vlp_tpu_torch.cli import decode as decode_cli
from vlp_tpu_torch.cli import train as train_cli
from vlp_tpu_torch.config import VLPConfig
from vlp_tpu_torch.data.example_builder import DecodeExampleBuilder, collate
from vlp_tpu_torch.decode import DecodeParams, Decoder
from vlp_tpu_torch.models.model import VLPModel

EOS, MASK = 4, 5


def tiny_cfg(**kw):
    base = dict(vocab_size=32, len_vis_input=6, max_len_b=5,
                vis_feat_dim=12, vis_pe_dim=10, vis_cls_dim=4)
    base.update(kw)
    return VLPConfig.tiny(**base)


def tiny_model(cfg, seed=0):
    model = VLPModel(cfg)
    model.init_weights(torch.Generator().manual_seed(seed))
    return model


def names(spans):
    return sorted(s.name for s in spans)


def test_off_records_nothing_and_enters_no_range(monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) entered")

    monkeypatch.setattr(tracing, "record_function", refuse)
    assert tracing.span("a") is tracing.span("b", 3)
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU]):
        with tracing.span("a"):
            with tracing.span("b", 7):
                pass
    with tracing.recording() as spans:
        pass
    assert spans == []


def test_recording_is_not_nestable():
    with tracing.recording():
        with pytest.raises(RuntimeError):
            with tracing.recording():
                pass
    with tracing.recording() as spans:    # usable again once left
        with tracing.span("x"):
            pass
    assert names(spans) == ["x"]


def test_parents_per_thread_and_counts():
    """Each thread keeps its own stack: a span opened in another thread
    while the main thread is inside one has no parent; nesting on each
    thread gives the parents; ``n`` is kept."""
    ready, go = threading.Event(), threading.Event()
    seen = {}

    def worker():
        with tracing.span("worker.outer"):
            ready.set()
            go.wait(10)
            with tracing.span("worker.inner", 5):
                seen["tid"] = threading.get_native_id()

    with tracing.recording() as spans:
        with tracing.span("main.outer", 11):
            t = threading.Thread(target=worker)
            t.start()
            assert ready.wait(10)
            with tracing.span("main.inner"):
                go.set()
                t.join(10)
        assert not t.is_alive()
    by = {s.name: s for s in spans}
    assert names(spans) == ["main.inner", "main.outer", "worker.inner",
                            "worker.outer"]
    assert by["main.outer"].parent is None
    assert by["main.inner"].parent == by["main.outer"].id
    assert by["worker.outer"].parent is None
    assert by["worker.inner"].parent == by["worker.outer"].id
    assert by["worker.inner"].thread == seen["tid"]
    assert by["main.outer"].thread == threading.get_native_id()
    assert by["main.outer"].n == 11 and by["worker.inner"].n == 5
    assert by["main.inner"].n is None
    for s in spans:
        assert s.end_ns >= s.start_ns and s.cpu_ns >= 0


def test_backward_spans_record_the_thread_that_ran_them():
    """A span opened inside a backward is kept on the thread autograd ran
    it on (the caller's on the CPU, a device thread on the card), with the
    parent that thread's stack gives."""
    seen = {}

    class Twice(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x):
            return 2 * x

        @staticmethod
        def backward(ctx, g):
            seen["tid"] = threading.get_native_id()
            with tracing.span("inside.backward"):
                return 2 * g

    x = torch.ones(3, requires_grad=True)
    with tracing.recording() as spans:
        with tracing.span("step.backward"):
            Twice.apply(x).sum().backward()
    by = {s.name: s for s in spans}
    inner, outer = by["inside.backward"], by["step.backward"]
    assert inner.thread == seen["tid"]
    assert inner.parent == (outer.id if inner.thread == outer.thread
                            else None)
    assert torch.equal(x.grad, torch.full((3,), 2.0))


def test_cpu_time_of_a_sleep_is_small():
    with tracing.recording() as spans:
        with tracing.span("sleep"):
            time.sleep(0.05)
    s, = spans
    assert s.end_ns - s.start_ns >= 45e6
    assert s.cpu_ns < 0.5 * (s.end_ns - s.start_ns)


def _span(id_, start, end, parent=None, name="s"):
    return tracing.Span(id_, name, 1, parent, start, end, 0, None)


def test_self_time_is_duration_minus_children():
    """Self time: the span's duration minus the part of its interval its
    children cover (a child reaching outside it counts only inside)."""
    spans = [_span(0, 0, 100), _span(1, 10, 30, 0), _span(2, 40, 45, 0),
             _span(3, 12, 20, 1), _span(4, 90, 130, 0), _span(5, 200, 210)]
    got = tracing.self_ns(spans)
    assert got == {0: 100 - 20 - 5 - 10, 1: 20 - 8, 2: 5, 3: 8, 4: 40,
                   5: 10}


def test_spans_are_ranges_of_the_profiler_trace(tmp_path):
    """Under a CPU ``torch.profiler`` each span is a ``user_annotation``
    range of the exported trace; anchored on ``bench.profiled`` (a
    benchmark's range around the profiled steps), its bounds agree with
    the span kept in memory within 200 us."""
    from torch.profiler import ProfilerActivity, profile, record_function
    with record_function("warm-up"):
        pass    # a process's first range pays a one-time set-up inside it
    # a collection or another thread between a range's start and the
    # span's would part them
    gc.collect()
    gc.disable()
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        with tracing.recording() as spans:
            with profile(activities=[ProfilerActivity.CPU]) as prof:
                with record_function("bench.profiled"):
                    anchor_m = time.monotonic_ns() / 1e3
                    for i in range(3):
                        with tracing.span("outer", i):
                            time.sleep(0.002)
                            with tracing.span("inner"):
                                torch.ones(64).sum()
                                time.sleep(0.001)
    finally:
        gc.enable()
        torch.set_num_threads(threads)
    path = str(tmp_path / "trace.json")
    prof.export_chrome_trace(path)
    with open(path) as f:
        evs = json.load(f)["traceEvents"]
    ranges = sorted((float(e["ts"]), float(e["dur"]), e["name"])
                    for e in evs if e.get("cat") == "user_annotation")
    anchor_t = ranges.pop(0)
    assert anchor_t[2] == "bench.profiled"
    mine = sorted((s.start_ns / 1e3, (s.end_ns - s.start_ns) / 1e3, s.name)
                  for s in spans)
    assert [r[2] for r in ranges] == [m[2] for m in mine] == \
        ["outer", "inner"] * 3
    for (ts_, dur, _), (start, length, _) in zip(ranges, mine):
        assert abs((ts_ - anchor_t[0]) - (start - anchor_m)) < 200
        assert abs((ts_ + dur - anchor_t[0])
                   - (start + length - anchor_m)) < 200


def test_cli_profile_table_lists_the_spans(tmp_path):
    """The train and VQA CLIs' profiled window records the program's
    spans, so ``profile.txt`` lists them."""
    prof = train_cli.start_profiler()
    with tracing.span("optim.step"):
        torch.ones(8).sum()
    train_cli.stop_profiler(prof, str(tmp_path))
    assert "optim.step" in (tmp_path / "profile.txt").read_text()
    assert tracing.span("after") is tracing.span("off")   # recording off


def test_an_eager_step_records_forward_backward_and_optimizer():
    cfg = tiny_cfg()
    model = tiny_model(cfg)
    opt = optim.BertAdam(dict(model.named_parameters()), 1e-3, warmup=0.1,
                         t_total=10)
    step = ts.make_train_step(model, opt)
    batch = ts.dummy_batch(cfg, 2)
    step(batch, 3)
    with tracing.recording() as spans:
        step(batch, 4)
    assert names(spans) == ["optim.step", "step.backward", "step.forward"]
    by = {s.name: s for s in spans}
    assert by["optim.step"].n == len(opt.params)
    assert (by["step.forward"].end_ns <= by["step.backward"].start_ns
            and by["step.backward"].end_ns <= by["optim.step"].start_ns)


def test_grad_accum_records_each_micro_batch():
    cfg = tiny_cfg()
    model = tiny_model(cfg)
    opt = optim.BertAdam(dict(model.named_parameters()), 1e-3, warmup=0.1,
                         t_total=10)
    step = ts.make_train_step(model, opt, grad_accum=2)
    with tracing.recording() as spans:
        step(ts.dummy_batch(cfg, 4), 5)
    assert names(spans) == ["optim.step"] + ["step.backward"] * 2 + \
        ["step.forward"] * 2


def _decode_batch(cfg, B, rng):
    vocab = {"[PAD]": 0, "[UNK]": 1, "[X_SEP]": 2, "[CLS]": 3, "[SEP]": EOS,
             "[MASK]": MASK}
    b = DecodeExampleBuilder(cfg, vocab, max_tgt_length=cfg.max_len_b)
    exs = [b(rng.normal(size=(cfg.len_vis_input, cfg.vis_feat_dim)),
             rng.normal(size=(cfg.len_vis_input, cfg.vis_pe_dim)))
           for _ in range(B)]
    return {k: torch.from_numpy(np.asarray(v)) for k, v in
            collate(exs).items()}


def test_beam_dispatch_and_collect_record_the_decode_spans():
    T, B = 5, 3
    cfg = tiny_cfg(max_len_b=T)
    dec = Decoder(tiny_model(cfg, seed=4), cfg, DecodeParams(
        mask_id=MASK, eos_id=EOS, beam_size=3, max_tgt_length=T,
        forbid_duplicate_ngrams=True, ngram_size=2))
    batch = _decode_batch(cfg, B, np.random.default_rng(0))
    with tracing.recording() as spans:
        dec.beam_collect(dec.beam_dispatch(batch))
    assert names(spans) == (["decode.backtrace", "decode.dispatch"]
                            + ["decode.model"] * (T - 1)
                            + ["decode.prefill", "io.wait"])
    by = {s.name: s for s in spans}
    assert by["decode.dispatch"].n == B
    for s in spans:
        want = ("decode.dispatch" if s.name in ("decode.model",
                                                "decode.prefill") else None)
        assert (by[want].id if want else None) == s.parent, s.name
    self_ns = tracing.self_ns(spans)[by["decode.dispatch"].id]
    kids = sum(s.end_ns - s.start_ns for s in spans
               if s.parent == by["decode.dispatch"].id)
    d = by["decode.dispatch"]
    assert self_ns == d.end_ns - d.start_ns - kids


def test_uploads_record_their_bytes():
    batch = {"a": np.zeros((4, 3), np.float16), "b": np.ones(5, np.int32)}
    with tracing.recording() as spans:
        decode_cli.to_device(batch, torch.device("cpu"))
        decode_cli.upload(batch, torch.device("cpu"))
    assert [(s.name, s.n) for s in spans] == [("io.upload", 44)] * 2


def test_group_staging_upload_records_its_slab():
    layout = {"input_ids": ((6,), np.int32), "vis_feats": ((2, 3),
                                                            np.float16)}
    staging = ts.GroupStaging(layout, 2, 3, "cpu", prefetch=1)
    with tracing.recording() as spans:
        staging.upload(0)
    s, = spans
    assert (s.name, s.n) == ("io.upload", staging.device_block.nbytes)
