"""``benchmarks/spans.py``: the per-layer numbers read from the program's
spans and from a profiled trace's program ranges, on synthetic spans and
a synthetic chrome trace whose numbers are worked out by hand; each is
None where the spans it reads are missing."""

import json
import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmarks import harness, spans  # noqa: E402
from vlp_tpu_torch.tracing import Span  # noqa: E402

MS = 1_000_000   # ns


def span(id_, name, start_ms, end_ms, parent=None, cpu_ms=None, n=None):
    cpu = (end_ms - start_ms) if cpu_ms is None else cpu_ms
    return Span(id_, name, 7, parent, int(start_ms * MS), int(end_ms * MS),
                int(cpu * MS), n)


def train_spans():
    """Two eager steps of 100 ms."""
    out = []
    for k in range(2):
        t, i = 100 * k, 10 * k
        out += [span(i, "io.upload", t, t + 8, n=47),
                span(i + 1, "step.forward", t + 8, t + 38, cpu_ms=24),
                span(i + 2, "step.backward", t + 38, t + 50, cpu_ms=1),
                span(i + 3, "optim.step", t + 50, t + 90, cpu_ms=36)]
    return out


def test_train_metrics_by_hand():
    got = spans.cell_metrics("train", train_spans(), None, train_spans())
    assert got["upload_host_ms.train"] == pytest.approx(8)
    assert got["forward_host_ms.train"] == pytest.approx(30)
    assert got["backward_host_ms.train"] == pytest.approx(12)
    assert got["optimizer_host_ms.train"] == pytest.approx(40)
    # forward and optimizer: 2 x (30 + 40) ms of wall, 2 x (24 + 36) of CPU
    assert got["host_offcpu_share.train"] == pytest.approx(100 * 10 / 70)
    assert got["optimizer_device_ms.train"] is None     # no trace


def test_metrics_are_none_without_their_spans():
    for kind, names in spans.CELL_METRICS.items():
        got = spans.cell_metrics(kind, [], None, [])
        assert sorted(got) == names
        assert set(got.values()) == {None}


def test_loop_metrics_by_hand():
    window = [span(0, "loop.replay", 0, 5), span(1, "loop.capture", 1, 4, 0),
              span(2, "io.wait", 5, 200), span(3, "loop.replay", 200, 203),
              span(4, "io.wait", 203, 400)]
    got = spans.cell_metrics("train_loop", window[3:], None, window)
    assert got == {"host_wait_ms.loop": pytest.approx(197),
                   "graph_captures.loop": 1.0}


def test_beam_metrics_by_hand():
    """The beam loop's self time leaves out the prefill and each step's
    model work; the back-trace and the wait are per batch."""
    out = []
    for k in range(2):
        t, i = 1000 * k, 100 * k
        out.append(span(i, "decode.dispatch", t, t + 200, cpu_ms=150, n=100))
        out.append(span(i + 1, "decode.prefill", t + 1, t + 11, i))
        for j in range(19):
            out.append(span(i + 2 + j, "decode.model", t + 20 + 9 * j,
                            t + 26 + 9 * j, i))
        out.append(span(i + 50, "io.wait", t + 300, t + 302))
        out.append(span(i + 51, "decode.backtrace", t + 302, t + 317))
    got = spans.cell_metrics("decode", out, None, out)
    assert got["beam_host_ms.eval"] == pytest.approx(200 - 10 - 19 * 6)
    assert got["backtrace_host_ms.eval"] == pytest.approx(15)
    assert got["host_wait_ms.eval"] == pytest.approx(2)
    assert got["host_offcpu_share.eval"] == pytest.approx(25)


def test_outside_drops_the_sub_window_and_what_lies_past_the_window():
    s = train_spans()
    kept = spans.outside(s, (0.0, 0.150), (0.099, 0.120))
    assert [x.id for x in kept] == [0, 1, 2, 3, 12]


def _trace(tmp_path):
    """A profiled window of 100 us on the benchmark's thread 1: one step
    (bench.step, 10-90) holding optim.step (50-80); autograd's thread 2
    launches inside step.backward (20-40) of thread 1."""
    main, other = 1, 2

    def x(name, cat, ts, dur, tid=main, corr=None):
        e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
             "tid": tid, "pid": 1}
        if corr is not None:
            e["args"] = {"correlation": corr}
        return e

    evs = [x("bench.profiled", "user_annotation", 0, 100),
           x("bench.step", "user_annotation", 10, 80),
           x("step.backward", "user_annotation", 20, 20),
           x("optim.step", "user_annotation", 50, 30),
           x("cudaLaunchKernel", "cuda_runtime", 25, 1, other, 1),
           x("cudaLaunchKernel", "cuda_runtime", 55, 1, main, 2),
           x("cudaMemsetAsync", "cuda_runtime", 60, 1, main, 3),
           x("cudaLaunchKernel", "cuda_runtime", 95, 1, main, 4),
           x("cudaStreamSynchronize", "cuda_runtime", 96, 1, main, 9),
           x("bwd_kernel", "kernel", 30, 5, 7, 1),
           x("adam_kernel", "kernel", 57, 6, 7, 2),
           x("Memset", "gpu_memset", 64, 2, 7, 3),
           x("tail_kernel", "kernel", 97, 2, 7, 4)]
    path = str(tmp_path / "trace.json")
    with open(path, "w") as f:
        json.dump({"traceEvents": evs}, f)
    return path


def test_reduce_program_keeps_ranges_threads_and_correlations(tmp_path):
    ev = spans.reduce_program(_trace(tmp_path))
    assert ev["window"] == (0.0, 100.0)
    assert ("optim.step", 50.0, 30.0, 1) in ev["ranges"]
    assert ("cudaLaunchKernel", 25.0, 1.0, 2, 1) in ev["launches"]
    assert len(ev["launches"]) == 4       # the sync puts no work there
    assert spans.runtime_ms(ev) == pytest.approx(
        {"cudaLaunchKernel": 0.003, "cudaMemsetAsync": 0.001,
         "cudaStreamSynchronize": 0.001})
    assert ("Memset", 64.0, 2.0, "gpu_memset", 3) in ev["device"]
    # the benchmark's own reduction reads the same device work and window
    base = harness.reduce_trace(_trace(tmp_path))
    assert base["window"] == ev["window"]
    assert [d[:4] for d in ev["device"]] == base["device"]


def test_device_time_by_span(tmp_path):
    ev = spans.reduce_program(_trace(tmp_path))
    assert spans.device_ms_by_span(ev) == pytest.approx(
        {"step.backward": 0.005, "optim.step": 0.008, "other": 0.002})
    assert spans.device_ms_by_span(ev, same_thread_only=True) == \
        pytest.approx({"other": 0.007, "optim.step": 0.008})
    assert spans.optimizer_device_ms(ev) == pytest.approx(0.008)
    ev["ranges"] = [r for r in ev["ranges"] if r[0] != "optim.step"]
    assert spans.optimizer_device_ms(ev) is None


def test_idle_gaps_are_named_by_program_span(tmp_path):
    """Busy: 30-35, 57-63, 64-66, 97-99.  Idle: 0-30, 35-57, 63-64,
    66-97, 99-100."""
    got = spans.idle(spans.reduce_program(_trace(tmp_path)))
    assert got["idle_gaps"][:2] == [["step/optim.step", 31e-6],
                                    ["other", 30e-6]]
    by = {k: round(v * 1e6, 6) for k, v in got["idle_by_span"].items()}
    assert by == {"other": 10 + 7 + 1, "step/step.backward": 10 + 5,
                  "step": 10 + 10 + 10, "step/optim.step": 7 + 1 + 14}
    assert sum(by.values()) == 100 - 15
