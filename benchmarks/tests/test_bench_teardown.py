"""``training.Program.close`` stops the loader before it unmaps the store:
the epoch's producer has joined by the time ``store.close()`` runs, also
while the producer is filling its queue and something else still holds
the epoch's generator (as a generator's frame can until it is
collected)."""

import threading
import time

import torch

from benchmarks import harness, training
from conftest import TINY, TINY_TRAFFIC


def _producers():
    return [t for t in threading.enumerate()
            if t.name.endswith("(producer)") and t.is_alive()]


def test_close_joins_the_producer_before_the_store(tmp_path):
    torch.set_num_threads(2)
    man = harness.manifest()
    wl = harness.workload(man, "coco-cap-train")
    tr = dict(harness.traffic(wl["traffic"]), **TINY_TRAFFIC)
    ctx = harness.Context("coco-cap-train", dict(TINY), tr, 20261019, 1.0,
                          False, str(tmp_path), "cpu")
    prog = training.Program(ctx, torch.device("cpu"))
    store = prog.store
    gather, close = store.gather_into, store.close

    def slow_gather(*a, **kw):          # a producer busy in the store
        time.sleep(0.05)
        return gather(*a, **kw)

    seen = []

    def watched_close():
        seen.append(len(_producers()))
        close()

    store.gather_into, store.close = slow_gather, watched_close
    kept = []
    epoch = prog.loader.epoch

    def keep(*a, **kw):
        g = epoch(*a, **kw)
        kept.append(g)
        return g

    prog.loader.epoch = keep
    before = len(_producers())
    next(prog.batches)
    time.sleep(0.1)                     # the queue is filling
    assert len(_producers()) == before + 1
    prog.close()
    assert seen == [before]
    assert len(_producers()) == before
