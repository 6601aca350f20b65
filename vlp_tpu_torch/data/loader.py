"""Prefetching train/eval loaders (host pipeline feeding the device).

Replaces torch DataLoader + RandomSampler/DistributedSampler
(reference vlp/run_img2txt_dist.py:292-298): a thread pool runs the
example builders (feature fetch + masking + featurization) and a bounded
queue prefetches collated fixed-shape numpy batches; per-host sharding by
``jax.process_index()`` replaces DistributedSampler.
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Dict, Iterator, Optional, Sequence

import numpy as np

from vlp_tpu_torch.data.example_builder import collate


def _put_stoppable(q: "queue.Queue", item, stop: threading.Event) -> bool:
    """Enqueue unless/until the consumer signalled stop.  Used for EVERY
    producer put — items, the terminal ``None`` sentinel and surfaced
    exceptions alike: an unconditional blocking ``q.put`` after the loop can
    wedge the daemon producer forever (pinning slabs + thread pool) when the
    consumer abandons iteration with the queue full."""
    while not stop.is_set():
        try:
            q.put(item, timeout=0.5)
            return True
        except queue.Full:
            continue
    return False


class TrainLoader:
    """Randomly samples (example, pipeline) pairs each epoch.

    ``builders`` are TrainExampleBuilder instances picked per example with
    ``builder_probs`` (the reference's joint s2s/bi sampling,
    seq2seq_loader.py:163-167).
    """

    def __init__(self, examples: Sequence, store, builders: Sequence,
                 builder_probs: Sequence[float], batch_size: int, *,
                 num_workers: int = 4, prefetch: int = 4, seed: int = 42,
                 process_index: int = 0, process_count: int = 1,
                 drop_last: bool = True, feature_slab_slots: int = 0,
                 feature_slabs: Optional[Sequence] = None):
        """``feature_slab_slots`` > 0 recycles that many preallocated
        region-feature batch buffers instead of allocating ~190MB of fresh
        arrays per batch (first-touch page faults on fresh allocations can
        throttle the host pipeline to well below the chip's consumption
        rate).  CONTRACT when enabled: a yielded batch's ``vis_feats`` /
        ``vis_pe`` are only valid until ``feature_slab_slots - prefetch - 1``
        further batches have been drawn — consumers that retain batches
        (e.g. device-loop stacking) must size the pool accordingly or copy.

        ``feature_slabs`` supplies the pool EXTERNALLY as a list of
        ``(feat [B,nr,fd], pe [B,nr,pd])`` array pairs, cycled in batch
        order — e.g. row views of the device-loop's ``[K, B, ...]`` stacked
        transfer buffers, so features land in their final host location and
        the ~90MB/batch slab->stack copy disappears.  Same validity
        contract, with ``len(feature_slabs)`` slots.
        """
        assert abs(sum(builder_probs) - 1.0) < 1e-6
        self.examples = list(examples)
        self.store = store
        self.builders = list(builders)
        self.builder_probs = list(builder_probs)
        self.batch_size = batch_size
        self.num_workers = num_workers
        self.prefetch = prefetch
        self.seed = seed
        self.process_index = process_index
        self.process_count = process_count
        self.drop_last = drop_last
        self.feature_slabs = list(feature_slabs) if feature_slabs else None
        if self.feature_slabs:
            feature_slab_slots = len(self.feature_slabs)
            for f, p in self.feature_slabs:
                assert f.shape[0] == batch_size and p.shape[0] == batch_size
        self.feature_slab_slots = feature_slab_slots
        if feature_slab_slots:
            assert feature_slab_slots >= prefetch + 2, \
                "slab pool must cover the prefetch queue plus in-flight batches"

    def epoch_indices(self, epoch: int) -> np.ndarray:
        """Shuffled, padded, per-host-sharded indices
        (DistributedSampler semantics)."""
        rng = np.random.default_rng(self.seed + epoch)
        idx = rng.permutation(len(self.examples))
        total = ((len(idx) + self.process_count - 1)
                 // self.process_count) * self.process_count
        if total > len(idx):
            idx = np.concatenate([idx, idx[:total - len(idx)]])
        return idx[self.process_index::self.process_count]

    def __len__(self) -> int:
        n = len(self.epoch_indices(0))
        if self.drop_last:
            return n // self.batch_size
        return (n + self.batch_size - 1) // self.batch_size

    def _example_seed(self, epoch: int, pos: int) -> np.random.SeedSequence:
        """Collision-free per-example RNG stream.

        Keyed on the example's position in this host's epoch stream (which
        is unique by construction) plus epoch and process index, mixed by
        ``SeedSequence`` — the previous affine formula
        ``seed*1e6+epoch*7919+i*31+j`` let ``(i, j)`` and ``(i±1, j∓31)``
        collide, giving two examples identical masking streams.
        """
        return np.random.SeedSequence(
            (self.seed, epoch, self.process_index, pos))

    def _build_one(self, ex_idx: int, sample_seed, feat_out=None,
                   pe_out=None, preloaded: bool = False
                   ) -> Dict[str, np.ndarray]:
        rng = np.random.default_rng(sample_seed)
        ex = self.examples[ex_idx]
        b = self.builders[rng.choice(len(self.builders), p=self.builder_probs)]
        if preloaded:
            # features already gathered batch-wise into the slab rows
            # (store.gather_into) — only the token side is built here
            feat, pe = feat_out, pe_out
        elif feat_out is not None:
            if hasattr(self.store, "get_into"):
                self.store.get_into(ex.feature_key, feat_out, pe_out)
            else:
                feat, pe = self.store.get(ex.feature_key)
                feat_out[:] = feat
                pe_out[:] = pe
            feat, pe = feat_out, pe_out
        else:
            feat, pe = self.store.get(ex.feature_key)
        return b(ex.tokens, feat, pe, rng, ans_scores=getattr(ex, "ans_scores",
                                                              None))

    def _make_slabs(self):
        """Preallocate the recycled region-feature buffers.  Pages fault
        lazily on the first rotation through the pool (the first
        ``feature_slab_slots`` batches run at first-touch speed, everything
        after is warm — unlike fresh per-batch allocations, which pay the
        fault cost on EVERY batch)."""
        if self.feature_slabs is not None:
            return self.feature_slabs
        feat, pe = self.store.get(self.examples[0].feature_key)
        # slab dtype follows the store: a float16 packed store keeps halves
        # end-to-end (half the memory traffic on the bandwidth-bound host,
        # half the host->device bytes; the model upcasts on device)
        return [(np.empty((self.batch_size,) + feat.shape, feat.dtype),
                 np.empty((self.batch_size,) + pe.shape, pe.dtype))
                for _ in range(self.feature_slab_slots)]

    def epoch(self, epoch: int, start_batch: int = 0
              ) -> Iterator[Dict[str, np.ndarray]]:
        """``start_batch`` skips the first N batches without building them
        (mid-epoch resume from a step checkpoint: the shuffled index order
        is deterministic per epoch, so skipping reproduces the exact
        stream a fresh run would have consumed by that point)."""
        idx = self.epoch_indices(epoch)
        nb = len(self)
        q: "queue.Queue" = queue.Queue(maxsize=self.prefetch)
        stop = threading.Event()
        slabs = self._make_slabs() if self.feature_slab_slots else None

        def build_slice(pairs, fs, ps, preloaded=False):
            return [self._build_one(i, s,
                                    feat_out=None if fs is None else fs[j],
                                    pe_out=None if ps is None else ps[j],
                                    preloaded=preloaded)
                    for j, i, s in pairs]

        def producer():
            try:
                _produce()
            except BaseException as e:  # surface in the consumer, not a hang
                _put_stoppable(q, e, stop)

        batched_gather = (slabs is not None
                          and hasattr(self.store, "gather_into"))

        can_prefetch = hasattr(self.store, "prefetch")

        def _keys(b):
            lo = b * self.batch_size
            return [self.examples[int(i)].feature_key
                    for i in idx[lo:lo + self.batch_size]]

        def _produce():
            with ThreadPoolExecutor(self.num_workers) as pool:
                if can_prefetch and nb > start_batch:
                    self.store.prefetch(_keys(start_batch))
                for b in range(start_batch, nb):
                    if can_prefetch and b + 1 < nb:
                        # advisory readahead for the NEXT batch: on
                        # disk-backed stores the page cache fills while
                        # this batch gathers/builds (madvise WILLNEED)
                        self.store.prefetch(_keys(b + 1))
                    lo = b * self.batch_size
                    chunk = idx[lo:lo + self.batch_size]
                    pairs = [(j, int(i), self._example_seed(epoch, lo + j))
                             for j, i in enumerate(chunk)]
                    # rotation is start-relative so a mid-epoch resume keeps
                    # batch->slab alignment for consumers that map slabs onto
                    # K-grouped transfer buffers (cli/train.py device loop)
                    fs, ps = (slabs[(b - start_batch) % len(slabs)]
                              if slabs else (None, None))
                    if batched_gather:
                        # whole-batch feature fetch in ONE native call
                        # (threaded C++, GIL released) instead of
                        # per-example get_into round-trips — the feature
                        # bytes dominate host pipeline time
                        n = len(chunk)
                        self.store.gather_into(
                            [self.examples[int(i)].feature_key
                             for i in chunk], fs[:n], ps[:n])
                    # one task per worker, NOT per example: a future
                    # handoff costs a GIL wake (~ms on busy hosts), which at
                    # per-example granularity starves the accelerator
                    w = max(1, self.num_workers)
                    per = -(-len(pairs) // w)
                    futs = [pool.submit(build_slice, pairs[k:k + per], fs, ps,
                                        batched_gather)
                            for k in range(0, len(pairs), per)]
                    built = [ex for f in futs for ex in f.result()]
                    if slabs is None:
                        batch = collate(built)
                    else:
                        # the feature slabs already hold every row in order;
                        # stack only the small per-example arrays
                        batch = {k: np.stack([e[k] for e in built])
                                 for k in built[0]
                                 if k not in ("vis_feats", "vis_pe")}
                        batch["vis_feats"] = fs
                        batch["vis_pe"] = ps
                    if not _put_stoppable(q, batch, stop):
                        return
            _put_stoppable(q, None, stop)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                batch = q.get()
                if batch is None:
                    return
                if isinstance(batch, BaseException):
                    raise batch
                yield batch
        finally:
            stop.set()
            # join: an abandoned epoch's producer may still be finishing a
            # batch that writes into the (possibly externally shared) slab
            # buffers; returning before it exits would let the next epoch's
            # producer — or an in-flight device transfer — race that write.
            # Bounded: stoppable puts + a single in-progress batch build.
            t.join()


def stacked_feature_slabs(store, example_key: str, k_loop: int,
                          batch_size: int, *, prefetch: int = 4):
    """Allocate the zero-copy device-loop buffers: ``n_stacks`` stacked
    ``[K, B, ...]`` feature/pe arrays plus the row-view slab list to pass
    as ``TrainLoader(feature_slabs=...)``.

    ``n_stacks`` covers the producer's maximum lead over the in-flight
    dispatch — K pending batches + the prefetch queue + one in-build —
    so a stacked buffer is never written while its previous dispatch may
    still be transferring.  This is THE one place that encodes that
    safety margin (cli/train.py, bench.py and tools/bench_loader.py all
    build their pools here).  Returns (stack_feat, stack_pe, slabs).
    """
    feat0, pe0 = store.get(example_key)
    n_stacks = max(3, 1 + -(-(k_loop + prefetch + 2) // k_loop))
    stack_feat = [np.empty((k_loop, batch_size) + feat0.shape, feat0.dtype)
                  for _ in range(n_stacks)]
    stack_pe = [np.empty((k_loop, batch_size) + pe0.shape, pe0.dtype)
                for _ in range(n_stacks)]
    slabs = [(stack_feat[s][k], stack_pe[s][k])
             for s in range(n_stacks) for k in range(k_loop)]
    return stack_feat, stack_pe, slabs


class EvalLoader:
    """Sequential batched eval loader (decode_img2txt.py:215-226 pattern).

    ``feature_slab_slots`` > 0 recycles preallocated region-feature batch
    buffers like TrainLoader (a fresh ~140MB of first-touch pages per
    batch otherwise caps the host at well below the chip's ~200
    captions/sec decode rate).  CONTRACT: a yielded batch's ``vis_feats``/
    ``vis_pe`` are only valid until ``feature_slab_slots - 1`` further
    batches are drawn — consume (transfer to device) before drawing more.
    """

    def __init__(self, examples: Sequence, store, builder: Callable,
                 batch_size: int, num_workers: int = 4,
                 feature_slab_slots: int = 0, prefetch: bool = False):
        """``prefetch=True`` builds the next batch in a background thread
        while the consumer decodes the current one (requires
        ``feature_slab_slots >= 3`` when slabs are on: queued + being-built
        + in-consumer)."""
        self.examples = list(examples)
        self.store = store
        self.builder = builder
        self.batch_size = batch_size
        self.num_workers = num_workers
        self.feature_slab_slots = feature_slab_slots
        self.prefetch = prefetch
        if prefetch and feature_slab_slots:
            assert feature_slab_slots >= 3

    def __len__(self):
        return (len(self.examples) + self.batch_size - 1) // self.batch_size

    def _slabs(self):
        feat, pe = self.store.get(self.examples[0].feature_key)
        return [(np.empty((self.batch_size,) + feat.shape, feat.dtype),
                 np.empty((self.batch_size,) + pe.shape, pe.dtype))
                for _ in range(self.feature_slab_slots)]

    def _batches(self, pool, slabs):
        def build(ex):
            feat, pe = self.store.get(ex.feature_key)
            return self.builder(feat, pe)

        def build_into(args):
            j, ex, fs, ps = args
            if hasattr(self.store, "get_into"):
                self.store.get_into(ex.feature_key, fs[j], ps[j])
            else:
                feat, pe = self.store.get(ex.feature_key)
                fs[j] = feat
                ps[j] = pe
            return self.builder(fs[j], ps[j])

        batched_gather = hasattr(self.store, "gather_into")
        for bi, lo in enumerate(range(0, len(self.examples),
                                      self.batch_size)):
            chunk = self.examples[lo:lo + self.batch_size]
            pad = self.batch_size - len(chunk)
            if slabs is None:
                exs = list(pool.map(build, chunk))
                exs = exs + [exs[-1]] * pad  # tail pad: static shapes
                yield collate(exs), chunk, pad
                continue
            fs, ps = slabs[bi % len(slabs)]
            if batched_gather:
                # one threaded native call for the whole batch (GIL
                # released in C++) instead of per-example ctypes round-trips
                self.store.gather_into([ex.feature_key for ex in chunk],
                                       fs[:len(chunk)], ps[:len(chunk)])
                exs = list(pool.map(
                    lambda j: self.builder(fs[j], ps[j]),
                    range(len(chunk))))
            else:
                exs = list(pool.map(build_into,
                                    [(j, ex, fs, ps)
                                     for j, ex in enumerate(chunk)]))
            for j in range(len(chunk), self.batch_size):
                fs[j] = fs[len(chunk) - 1]
                ps[j] = ps[len(chunk) - 1]
                exs.append(exs[-1])
            batch = {k: np.stack([e[k] for e in exs]) for k in exs[0]
                     if k not in ("vis_feats", "vis_pe")}
            batch["vis_feats"] = fs
            batch["vis_pe"] = ps
            yield batch, chunk, pad

    def __iter__(self):
        pool = ThreadPoolExecutor(self.num_workers)
        slabs = self._slabs() if (self.feature_slab_slots
                                  and self.examples) else None
        if not self.prefetch:
            try:
                yield from self._batches(pool, slabs)
            finally:
                pool.shutdown(wait=False)
            return

        q: "queue.Queue" = queue.Queue(maxsize=1)
        stop = threading.Event()

        def producer():
            try:
                for item in self._batches(pool, slabs):
                    if not _put_stoppable(q, item, stop):
                        return
                _put_stoppable(q, None, stop)
            except BaseException as e:  # surface in the consumer
                _put_stoppable(q, e, stop)

        t = threading.Thread(target=producer, daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is None:
                    return
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            stop.set()
            t.join()  # see TrainLoader.epoch: slab writes must quiesce
            pool.shutdown(wait=False)
