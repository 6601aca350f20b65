"""Python binding (ctypes) for the native packed feature store.

``PackedFeatureStore`` is the fast-path replacement for ``H5FeatureStore``:
one mmap'ed file, an in-memory key index, threaded batch gathers, and the
geometry featurization fused in C++ (vlpstore.cpp).  ``pack_store`` writes
the format from any python store (h5/npy/synthetic) once, offline.

Falls back with a clear error if the shared library hasn't been built
(``make -C native``).
"""

from __future__ import annotations

import ctypes
import os
import struct
import subprocess
from typing import Optional, Sequence, Tuple

import numpy as np

_LIB_PATH = os.path.join(os.path.dirname(__file__), "..", "..", "native",
                         "libvlpstore.so")
_MAGIC = b"VLPS"
_VERSION = 1        # float32 records
_VERSION_F16 = 2    # float16 records (dtype flag in the former pad field)
_VERSION_PE = 3     # records are {feat, vis_pe}: featurization precomputed
_HEADER_FMT = "<4sIQIIIIII"  # magic, ver, n, regions, feat, cls, bbox, keylen, dtype
_HEADER_SIZE = struct.calcsize(_HEADER_FMT)
assert _HEADER_SIZE == 40
_DTYPES = {0: np.float32, 1: np.float16}


def _load_lib(build: bool = True):
    path = os.path.abspath(_LIB_PATH)

    def _make():
        subprocess.run(["make", "-C", os.path.dirname(path)], check=True,
                       capture_output=True)

    if not os.path.isfile(path) and build:
        _make()
    lib = ctypes.CDLL(path)
    # ABI probe: a stale prebuilt library (e.g. from a checkout that still
    # tracked the .so) lacks the newest entry point and writes fewer
    # vlps_meta slots — rebuild instead of failing later with a bare
    # AttributeError.  (make replaces the file, so the reload maps the new
    # inode rather than the already-open image.)
    def _stale(l):
        return (not hasattr(l, "vlps_abi")) or l.vlps_abi() < 4

    if _stale(lib):
        if build:
            _make()
            lib = ctypes.CDLL(path)
        if _stale(lib):
            raise OSError(
                f"{path} is stale (vlps_abi < 4); "
                "rebuild with `make -C native` and restart")
    lib.vlps_open.restype = ctypes.c_void_p
    lib.vlps_open.argtypes = [ctypes.c_char_p]
    lib.vlps_close.argtypes = [ctypes.c_void_p]
    lib.vlps_meta.argtypes = [ctypes.c_void_p,
                              ctypes.POINTER(ctypes.c_uint64)]
    lib.vlps_find.restype = ctypes.c_int64
    lib.vlps_find.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
    f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
    i64p = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    lib.vlps_get.restype = ctypes.c_int
    lib.vlps_get.argtypes = [ctypes.c_void_p, ctypes.c_char_p, f32p, f32p,
                             f32p]
    lib.vlps_batch_get.restype = ctypes.c_int
    lib.vlps_batch_get.argtypes = [ctypes.c_void_p, i64p, ctypes.c_int,
                                   f32p, f32p, f32p, ctypes.c_int]
    lib.vlps_batch_featurize.restype = ctypes.c_int
    lib.vlps_batch_featurize.argtypes = [ctypes.c_void_p, i64p, ctypes.c_int,
                                         f32p, f32p, ctypes.c_int]
    u16p = np.ctypeslib.ndpointer(np.uint16, flags="C_CONTIGUOUS")
    lib.vlps_batch_featurize16.restype = ctypes.c_int
    lib.vlps_batch_featurize16.argtypes = [ctypes.c_void_p, i64p,
                                           ctypes.c_int, u16p, u16p,
                                           ctypes.c_int]
    lib.vlps_prefetch.restype = ctypes.c_int
    lib.vlps_prefetch.argtypes = [ctypes.c_void_p, i64p, ctypes.c_int]
    return lib


def pack_store(out_path: str, keys: Sequence[str], records,
               n_regions: int = 100, feat_dim: int = 2048,
               cls_dim: int = 1601, bbox_dim: int = 6,
               key_len: int = 64, dtype=np.float32,
               precompute_pe: bool = False) -> None:
    """Write the packed file.  ``records`` maps key ->
    (feat [nr, feat], cls [nr, cls], bbox [nr, bbox]) — a dict or a callable.

    ``dtype=np.float16`` writes half-precision records (v2): the train-time
    host pipeline is memory-bandwidth bound, so fp16 storage ≈ doubles
    loader throughput and halves host→device transfer; featurization math
    stays fp32 inside the C++ kernel either way.

    ``precompute_pe=True`` writes v3: the geometry featurization
    (deterministic per record) is run ONCE here and the record stores
    ``{feat, vis_pe[nr, 6+cls_dim]}`` — the per-epoch gather hot path then
    needs no layer-norm math at all, only dtype-converting memcpys.  Raw
    cls/bbox are not retained (``PackedFeatureStore.raw`` is unavailable).
    """
    dtype = np.dtype(dtype)
    assert dtype in (np.float32, np.float16), dtype
    half = dtype == np.float16
    get = records.__getitem__ if hasattr(records, "__getitem__") else records
    if precompute_pe:
        version = _VERSION_PE
        bbox_dim = 0
    else:
        version = _VERSION_F16 if half else _VERSION
    with open(out_path, "wb") as f:
        f.write(struct.pack(_HEADER_FMT, _MAGIC, version, len(keys),
                            n_regions, feat_dim, cls_dim, bbox_dim,
                            key_len, 1 if half else 0))
        for k in keys:
            kb = k.encode()[:key_len]
            f.write(kb + b"\x00" * (key_len - len(kb)))
        if precompute_pe:
            from vlp_tpu_torch.data.example_builder import featurize_regions
            for k in keys:
                feat, cls, bbox = get(k)
                assert feat.shape == (n_regions, feat_dim)
                assert cls.shape == (n_regions, cls_dim)
                pe = featurize_regions(np.asarray(bbox, np.float32),
                                       np.asarray(cls, np.float32))
                assert pe.shape == (n_regions, 6 + cls_dim)
                f.write(np.ascontiguousarray(feat, dtype).tobytes())
                f.write(np.ascontiguousarray(pe, dtype).tobytes())
            return
        for k in keys:
            feat, cls, bbox = get(k)
            assert feat.shape == (n_regions, feat_dim)
            assert cls.shape == (n_regions, cls_dim)
            assert bbox.shape == (n_regions, bbox_dim)
            f.write(np.ascontiguousarray(feat, dtype).tobytes())
            f.write(np.ascontiguousarray(cls, dtype).tobytes())
            f.write(np.ascontiguousarray(bbox, dtype).tobytes())


class PackedFeatureStore:
    """Store API-compatible with features.H5FeatureStore (get -> (feat, pe))
    plus fast batched access."""

    def __init__(self, path: str, n_threads: Optional[int] = None):
        if n_threads is None:
            n_threads = min(8, os.cpu_count() or 1)
        self.lib = _load_lib()
        self.handle = self.lib.vlps_open(path.encode())
        if not self.handle:
            raise OSError(f"vlps_open failed for {path}")
        meta = (ctypes.c_uint64 * 7)()
        self.lib.vlps_meta(self.handle, meta)
        (self.n_records, self.n_regions, self.feat_dim, self.cls_dim,
         self.bbox_dim, self.key_len, dtype_flag) = [int(x) for x in meta]
        self.dtype = np.dtype(_DTYPES[dtype_flag])
        with open(path, "rb") as f:
            self.version = struct.unpack(
                _HEADER_FMT, f.read(_HEADER_SIZE))[1]
        self.precomputed_pe = self.version == _VERSION_PE
        self.pe_dim = 6 + self.cls_dim
        self.n_threads = n_threads
        # key -> record index memo: keys repeat every epoch, and a python
        # dict hit is ~10x cheaper than a ctypes vlps_find round-trip
        self._idx_memo: dict = {}

    def close(self):
        if getattr(self, "handle", None):
            self.lib.vlps_close(self.handle)
            self.handle = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass

    @staticmethod
    def _key(key: str) -> str:
        return key.split("/")[-1].split(".")[0]

    def find(self, key: str) -> int:
        idx = self._idx_memo.get(key)
        if idx is None:
            idx = int(self.lib.vlps_find(self.handle,
                                         self._key(key).encode()))
            self._idx_memo[key] = idx
        return idx

    def _featurize_into(self, idx: np.ndarray, feat2d: np.ndarray,
                        pe2d: np.ndarray) -> int:
        """Dispatch on the OUTPUT dtype (fp16 buffers take the f16 entry
        point; the C++ side converts from the store dtype as needed)."""
        assert feat2d.dtype == pe2d.dtype, "mixed output dtypes"
        n = len(idx)
        if feat2d.dtype == np.float16:
            return self.lib.vlps_batch_featurize16(
                self.handle, idx, n, feat2d.view(np.uint16),
                pe2d.view(np.uint16), self.n_threads if n > 1 else 1)
        assert feat2d.dtype == np.float32, feat2d.dtype
        return self.lib.vlps_batch_featurize(
            self.handle, idx, n, feat2d, pe2d,
            self.n_threads if n > 1 else 1)

    def get(self, key: str) -> Tuple[np.ndarray, np.ndarray]:
        """(vis_feats, vis_pe) in the STORE's dtype (fp16 for v2 files —
        the model upcasts on device; keeping halves end-to-end is the point)."""
        feat = np.empty((self.n_regions, self.feat_dim), self.dtype)
        pe = np.empty((self.n_regions, self.pe_dim), self.dtype)
        self.get_into(key, feat, pe)
        return feat, pe

    def get_into(self, key: str, feat_out: np.ndarray,
                 pe_out: np.ndarray) -> None:
        """Zero-allocation fetch: featurize directly into caller-provided
        C-contiguous float32 or float16 buffers of shape
        (n_regions, feat_dim) / (n_regions, pe_dim) — lets the loader
        recycle batch slabs instead of allocating per example (first-touch
        page faults on fresh allocations dominate host pipeline time
        otherwise)."""
        idx = np.asarray([self.find(key)], np.int64)
        if idx[0] < 0:
            raise KeyError(key)
        assert feat_out.shape == (self.n_regions, self.feat_dim)
        assert pe_out.shape == (self.n_regions, self.pe_dim)
        rc = self._featurize_into(idx, feat_out.reshape(1, -1),
                                  pe_out.reshape(1, -1))
        if rc != 0:
            raise KeyError(key)

    def batch_get(self, keys: Sequence[str], dtype=None
                  ) -> Tuple[np.ndarray, np.ndarray]:
        """Threaded gather + fused featurization for a whole batch.
        ``dtype`` overrides the output precision (default: store dtype)."""
        n = len(keys)
        idx = np.asarray([self.find(k) for k in keys], np.int64)
        if (idx < 0).any():
            missing = [k for k, i in zip(keys, idx) if i < 0]
            raise KeyError(f"missing keys: {missing[:5]}")
        dtype = np.dtype(dtype or self.dtype)
        feat = np.empty((n, self.n_regions * self.feat_dim), dtype)
        pe = np.empty((n, self.n_regions * self.pe_dim), dtype)
        rc = self._featurize_into(idx, feat, pe)
        if rc != 0:
            raise RuntimeError("vlps_batch_featurize failed")
        return (feat.reshape(n, self.n_regions, self.feat_dim),
                pe.reshape(n, self.n_regions, self.pe_dim))

    def gather_into(self, keys: Sequence[str], feat_batch: np.ndarray,
                    pe_batch: np.ndarray) -> None:
        """Whole-batch gather + fused featurization into caller-provided
        slabs with ONE native call (threaded in C++, GIL released) — the
        loader's hot path.  ``feat_batch``/``pe_batch``: C-contiguous
        [n, n_regions, feat_dim] / [n, n_regions, pe_dim], fp32 or fp16.
        Replaces n per-example ``get_into`` ctypes round-trips."""
        n = len(keys)
        idx = np.fromiter((self.find(k) for k in keys), np.int64, count=n)
        if (idx < 0).any():
            missing = [k for k, i in zip(keys, idx) if i < 0]
            raise KeyError(f"missing keys: {missing[:5]}")
        assert feat_batch.shape == (n, self.n_regions, self.feat_dim)
        assert pe_batch.shape == (n, self.n_regions, self.pe_dim)
        rc = self._featurize_into(idx, feat_batch.reshape(n, -1),
                                  pe_batch.reshape(n, -1))
        if rc != 0:
            raise RuntimeError("vlps_batch_featurize failed")

    def prefetch(self, keys: Sequence[str]) -> None:
        """Advise the kernel to read the records ahead (madvise WILLNEED).

        For disk-backed production stores (TB-scale at Conceptual Captions
        size), call this with batch i+1's keys before gathering batch i:
        the page cache fills during the current gather+build instead of
        faulting inside the next one.  Unknown keys are ignored (cheap
        advisory semantics); a warm page cache makes this a no-op."""
        n = len(keys)
        if n == 0:
            return
        idx = np.fromiter((self.find(k) for k in keys), np.int64, count=n)
        self.lib.vlps_prefetch(self.handle, idx, n)

    def raw(self, key: str):
        """(feat, cls, bbox) raw arrays — for repacking/debugging.
        Unavailable for v3 (precompute_pe) files, which retain only the
        featurized vis_pe."""
        if self.precomputed_pe:
            raise RuntimeError(
                "raw cls/bbox are not stored in a precompute_pe (v3) file")
        feat = np.empty((self.n_regions, self.feat_dim), np.float32)
        cls = np.empty((self.n_regions, self.cls_dim), np.float32)
        bbox = np.empty((self.n_regions, self.bbox_dim), np.float32)
        rc = self.lib.vlps_get(self.handle, self._key(key).encode(), feat,
                               cls, bbox)
        if rc != 0:
            raise KeyError(key)
        return feat, cls, bbox


def repack_precomputed(src_path: str, out_path: str, dtype=None) -> None:
    """Convert an existing v1/v2 packed store to v3 (featurization
    precomputed).  ``dtype`` defaults to the source store's dtype."""
    src = PackedFeatureStore(src_path, n_threads=1)
    try:
        if src.precomputed_pe:
            raise ValueError(f"{src_path} is already v3")
        keys = []
        with open(src_path, "rb") as f:
            f.seek(_HEADER_SIZE)
            for _ in range(src.n_records):
                kb = f.read(src.key_len)
                keys.append(kb.split(b"\x00", 1)[0].decode())
        pack_store(out_path, keys, lambda k: src.raw(k),
                   n_regions=src.n_regions, feat_dim=src.feat_dim,
                   cls_dim=src.cls_dim, bbox_dim=src.bbox_dim,
                   key_len=src.key_len, dtype=dtype or src.dtype,
                   precompute_pe=True)
    finally:
        src.close()


def pack_from_h5(out_path: str, region_det_file_prefix: str,
                 region_bbox_file: str, keys: Sequence[str], **kw):
    """Offline conversion: reference h5 shards -> packed store."""
    import h5py

    handles = {}

    def get(key):
        img_id = key.split("/")[-1].split(".")[0]
        shard = img_id[-3:]
        for name, path in (("f", f"{region_det_file_prefix}_feat{shard}.h5"),
                           ("c", f"{region_det_file_prefix}_cls{shard}.h5"),
                           ("b", region_bbox_file)):
            if path not in handles:
                handles[path] = h5py.File(path, "r")
        feat = np.asarray(
            handles[f"{region_det_file_prefix}_feat{shard}.h5"][img_id],
            np.float32)
        cls = np.asarray(
            handles[f"{region_det_file_prefix}_cls{shard}.h5"][img_id],
            np.float32)
        bbox = np.asarray(handles[region_bbox_file][img_id], np.float32)
        return feat, cls, bbox

    ids = [k.split("/")[-1].split(".")[0] for k in keys]
    pack_store(out_path, ids, lambda k: get(k), **kw)
