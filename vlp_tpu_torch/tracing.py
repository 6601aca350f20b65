"""Spans inside the program: where the host's time goes at each layer
boundary of the hot paths, on the clock a benchmark's window uses.

``span(name, n=None)`` marks one layer's work::

    with tracing.span("io.upload", nbytes):
        ...

Off (the default) it is one global check that returns a shared no-op
context: nothing is recorded and no profiler range is entered.  Inside
:func:`recording` each span is kept as a :class:`Span`: its name, the
thread that ran it, its parent (the span open on the same thread when it
began), its start and end on ``time.monotonic_ns`` (the clock of
``time.monotonic``), the thread's CPU time over it
(``time.thread_time_ns``) and an optional count ``n`` (bytes, rows,
tensors).  While a ``torch.profiler`` records, an open span is also a
``record_function`` range of its name, so it appears in the trace on the
device's clock and each launch made inside it can be tied to its kernels
by correlation id.

The spans of the port:

=================  =====================================================
``io.upload``      a batch's copy to the device (bytes)
``io.wait``        the host waiting for a queued device-to-host copy
``step.forward``   a training forward (each micro-batch)
``step.backward``  its ``.backward()``
``optim.step``     ``BertAdam.step`` (tensors)
``optim.table``    the fused update's table rewritten (tensors whose
                   pointers changed; only when one did)
``loop.capture``   a device-loop group's capture (inside ``loop.replay``)
``loop.replay``    a device-loop group's call
``decode.*``       the beam loop (``dispatch``, rows), its ``prefill``,
                   each step's ``model`` work, and the host ``backtrace``
``dist.*``         the data-parallel gradient agreement and buckets
``attn.mla``       a Kimi-VL layer's MLA sublayer (``models/kimi_vl.py``)
``moe.route``      an expert layer's router, balance loss and load count
``moe.dispatch``   its sort of the held (token, expert) rows and offsets
``moe.experts``    its gather, grouped products and SwiGLU (rows given:
                   the most it can hold; the rows taken stay on the
                   device)
``moe.combine``    the rows weighted and summed onto their tokens
=================  =====================================================

``counter(name, value)`` keeps a number the host has in hand (recorded
like a span of no duration, ``n`` the value), e.g. the held experts' row
counts that ``KimiVLModel.read_rows_per_expert`` reads off the device
once: ``moe.rows_per_expert.<layer>.<expert>``, beside each layer's
``moe.buffer_rows.<layer>`` (its row buffer's rows summed over the
training steps since that counter was cleared).
"""

from __future__ import annotations

import contextlib
import itertools
import threading
import time
from typing import Dict, Iterable, List, NamedTuple, Optional

import torch
from torch.profiler import record_function


class Span(NamedTuple):
    """One recorded span; times in nanoseconds."""
    id: int
    name: str
    thread: int               # threading.get_native_id(), the trace's tid
    parent: Optional[int]     # id of the span open on this thread
    start_ns: int             # time.monotonic_ns()
    end_ns: int
    cpu_ns: int               # the thread's CPU time between the two
    n: Optional[int]


_sink: Optional[List[Span]] = None    # the list recording() fills
_OFF = contextlib.nullcontext()
_ids = itertools.count()
_local = threading.local()


def _stack() -> List[int]:
    stack = getattr(_local, "stack", None)
    if stack is None:
        stack = _local.stack = []
    return stack


class _Open:
    """A span while it is open (only inside :func:`recording`)."""

    __slots__ = ("sink", "name", "n", "id", "parent", "start", "cpu",
                 "range")

    def __init__(self, sink: List[Span], name: str, n: Optional[int]):
        self.sink, self.name, self.n = sink, name, n

    def __enter__(self):
        stack = _stack()
        self.parent = stack[-1] if stack else None
        self.id = next(_ids)
        stack.append(self.id)
        self.range = None
        self.cpu = time.thread_time_ns()
        if torch.autograd._profiler_enabled():
            self.range = record_function(self.name)
            self.range.__enter__()
        # the clock read next to the range's own, so the two agree
        self.start = time.monotonic_ns()
        return self

    def __exit__(self, *exc):
        end = time.monotonic_ns()
        if self.range is not None:
            self.range.__exit__(*exc)
        cpu = time.thread_time_ns() - self.cpu
        _stack().pop()
        self.sink.append(Span(self.id, self.name, threading.get_native_id(),
                              self.parent, self.start, end, cpu, self.n))
        return False


def span(name: str, n: Optional[int] = None):
    """A context marking one layer's work; a no-op outside
    :func:`recording`."""
    if _sink is None:
        return _OFF
    return _Open(_sink, name, n)


def counter(name: str, value: int) -> None:
    """Keep ``value`` under ``name`` inside :func:`recording` (nothing
    outside it)."""
    if _sink is None:
        return
    stack = _stack()
    now = time.monotonic_ns()
    _sink.append(Span(next(_ids), name, threading.get_native_id(),
                      stack[-1] if stack else None, now, now, 0,
                      int(value)))


@contextlib.contextmanager
def recording():
    """Turn spans on and yield the list that collects them, each appended
    when it ends.  Not nestable."""
    global _sink
    if _sink is not None:
        raise RuntimeError("tracing.recording() is already entered")
    _sink = spans = []
    try:
        yield spans
    finally:
        _sink = None


def self_ns(spans: Iterable[Span]) -> Dict[int, int]:
    """{span id: its self time}: its duration minus the part of its
    interval that its children (spans whose parent it is) cover."""
    spans = list(spans)
    kids: Dict[int, list] = {}
    for s in spans:
        if s.parent is not None:
            kids.setdefault(s.parent, []).append((s.start_ns, s.end_ns))
    out = {}
    for s in spans:
        covered, reach = 0, s.start_ns
        for a, b in sorted(kids.get(s.id, ())):
            a, b = max(a, reach), min(b, s.end_ns)
            if b > a:
                covered += b - a
                reach = b
        out[s.id] = s.end_ns - s.start_ns - covered
    return out
