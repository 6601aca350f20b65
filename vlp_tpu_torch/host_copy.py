"""Device-to-host copies that do not hold up the host: :func:`fetch` queues
a copy of device tensors (a device-loop group's stacked metrics, a decode's
ids or beam trace) into pinned memory behind the work already on the
stream and returns at once; :func:`fetched` waits for that copy and gives
the arrays.  A loop fetches step N, dispatches step N + 1, and only then
reads step N."""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional

import numpy as np
import torch

from vlp_tpu_torch import tracing


class Fetch(NamedTuple):
    """A queued copy: the host tensors it fills, and the event recorded
    after it (None on the CPU, where nothing is queued)."""
    host: Dict[str, torch.Tensor]
    done: Optional[torch.cuda.Event]


def fetch(tensors: Dict[str, torch.Tensor]) -> Fetch:
    """Start copying ``tensors`` to pinned host memory, non-blocking; on the
    CPU the tensors themselves."""
    some = next(iter(tensors.values()))
    if some.device.type != "cuda":
        return Fetch(tensors, None)
    host = {k: torch.empty(v.shape, dtype=v.dtype, pin_memory=True)
            for k, v in tensors.items()}
    for k, v in tensors.items():
        host[k].copy_(v, non_blocking=True)
    done = torch.cuda.Event()
    done.record()
    return Fetch(host, done)


def fetched(handle: Fetch) -> Dict[str, np.ndarray]:
    """The arrays of a :func:`fetch`, once its copy is done (the wait is the
    span ``io.wait``)."""
    with tracing.span("io.wait"):
        if handle.done is not None:
            handle.done.synchronize()
    return {k: v.detach().numpy() for k, v in handle.host.items()}
