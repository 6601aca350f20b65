"""Region-feature stores (host side).

The reference opens three HDF5 files per example inside DataLoader workers
(reference vlp/seq2seq_loader.py:325-336) — its noted eval bottleneck
(reference README:205).  Here stores keep per-shard handles open and are
shared across loader threads; a synthetic store backs tests and benchmarks.

Layout matches upstream:
  * ``{prefix}_feat{id[-3:]}.h5``  -> [100, 2048] region features per img id
  * ``{prefix}_cls{id[-3:]}.h5``   -> [100, 1601] class probabilities
  * ``{bbox_file}.h5``             -> [100, >=6] boxes (+conf)
  * npy fallback: ``{key}.npy`` / ``{key}_cls_prob.npy`` + bbox h5
"""

from __future__ import annotations

import os
import threading
from typing import Dict, Optional, Tuple

import numpy as np

from vlp_tpu_torch.data.example_builder import featurize_regions

Record = Tuple[np.ndarray, np.ndarray]  # (vis_feats [N,2048], vis_pe [N,1607])


def _img_id_from_key(key: str) -> str:
    return key.split("/")[-1].split(".")[0]


class H5FeatureStore:
    """Sharded-HDF5 store with cached handles (thread-safe)."""

    def __init__(self, region_det_file_prefix: str, region_bbox_file: str):
        import h5py  # noqa: deferred so CPU-only envs without data never import
        self._h5py = h5py
        self.prefix = region_det_file_prefix
        self.bbox_file = region_bbox_file
        self._handles: Dict[str, object] = {}
        self._lock = threading.Lock()

    def _open(self, path: str):
        with self._lock:
            h = self._handles.get(path)
            if h is None:
                h = self._h5py.File(path, "r")
                self._handles[path] = h
            return h

    def get(self, key: str) -> Record:
        img_id = _img_id_from_key(key)
        shard = img_id[-3:]
        feat_f = self._open(f"{self.prefix}_feat{shard}.h5")
        cls_f = self._open(f"{self.prefix}_cls{shard}.h5")
        bbox_f = self._open(self.bbox_file)
        with self._lock:
            feat = np.asarray(feat_f[img_id], dtype=np.float32)
            cls = np.asarray(cls_f[img_id], dtype=np.float32)
            bbox = np.asarray(bbox_f[img_id], dtype=np.float32)
        return feat, featurize_regions(bbox, cls)

    def close(self):
        with self._lock:
            for h in self._handles.values():
                h.close()
            self._handles.clear()


class NpyFeatureStore:
    """Legacy per-image .npy features + global bbox h5
    (seq2seq_loader.py:331-336)."""

    def __init__(self, region_bbox_file: str):
        import h5py
        self._bbox = h5py.File(region_bbox_file, "r")
        self._lock = threading.Lock()

    def get(self, key: str) -> Record:
        feat = np.load(key).astype(np.float32)
        cls = np.load(key.replace(".npy", "_cls_prob.npy")).astype(np.float32)
        img_id = _img_id_from_key(key)
        with self._lock:
            bbox = np.asarray(self._bbox[img_id], dtype=np.float32)
        return feat, featurize_regions(bbox, cls)


class SyntheticFeatureStore:
    """Deterministic per-key random features — tests/benchmarks only."""

    def __init__(self, num_regions: int = 100, feat_dim: int = 2048,
                 cls_dim: int = 1601, seed: int = 0):
        self.n = num_regions
        self.feat_dim = feat_dim
        self.cls_dim = cls_dim
        self.seed = seed

    def get(self, key: str) -> Record:
        rng = np.random.default_rng(abs(hash((self.seed, key))) % (2 ** 31))
        feat = rng.normal(size=(self.n, self.feat_dim)).astype(np.float32)
        cls = rng.uniform(size=(self.n, self.cls_dim)).astype(np.float32)
        bbox = np.zeros((self.n, 6), np.float32)
        xy = rng.uniform(0, 600, size=(self.n, 2))
        wh = rng.uniform(10, 200, size=(self.n, 2))
        bbox[:, 0:2] = xy
        bbox[:, 2:4] = xy + wh
        bbox[:, 5] = rng.uniform(0.2, 1.0, self.n)
        return feat, featurize_regions(bbox, cls)


class CachedStore:
    """In-RAM LRU-less cache wrapper (fine for COCO-scale eval loops)."""

    def __init__(self, inner, max_items: Optional[int] = None):
        self.inner = inner
        self.max_items = max_items
        self._cache: Dict[str, Record] = {}
        self._lock = threading.Lock()

    def get(self, key: str) -> Record:
        with self._lock:
            if key in self._cache:
                return self._cache[key]
        rec = self.inner.get(key)
        with self._lock:
            if self.max_items is None or len(self._cache) < self.max_items:
                self._cache[key] = rec
        return rec


def make_store(region_det_file_prefix: str = "", region_bbox_file: str = "",
               synthetic: bool = False, packed_file: str = "", **kw):
    if packed_file:
        from vlp_tpu_torch.data.native_store import PackedFeatureStore
        return PackedFeatureStore(packed_file)
    if synthetic or (not region_det_file_prefix and not region_bbox_file):
        return SyntheticFeatureStore(**kw)
    if region_det_file_prefix:
        return H5FeatureStore(region_det_file_prefix, region_bbox_file)
    return NpyFeatureStore(region_bbox_file)
