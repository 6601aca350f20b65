"""Build-at-first-use for the CUDA kernels in ``csrc/`` and their ctypes
binding (the ``vlp_tpu/data/native_store.py`` pattern, with ``nvcc``).

Each ``csrc/*.cu`` compiles with its own ``nvcc`` process, all started
together, and one more ``nvcc`` links the objects into ONE shared library
with a plain C interface — no PyTorch headers, so a build takes seconds, not
minutes.
The library lives in ``vlp_tpu_torch/_build/<hash>/`` where ``<hash>`` covers
the sources and the compiler flags, so an edited source never loads a stale
build.  Every pointer and the stream cross as ``c_void_p`` (a plain ctypes
int would truncate them to 32 bits); each entry point returns
``cudaGetLastError()`` and :func:`check` raises on anything but 0.

Nothing here runs at import: the CPU tests import every module on a machine
without ``nvcc``.
"""

from __future__ import annotations

import collections
import contextlib
import ctypes
import dataclasses
import functools
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile
from typing import Optional

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_ROOT = os.path.join(_PKG, "_build")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_ULL = ctypes.c_ulonglong
_U = ctypes.c_uint
_F = ctypes.c_float
# C entry point -> argument types (see the extern "C" functions in csrc/)
_SIGNATURES = {
    "vlp_attention_fwd": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _LL, _LL,
                          _I, _F, _P, _U, _F, _I, _P],
    "vlp_attention_bwd": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                          _I, _LL, _LL, _LL, _LL, _I, _F, _P, _U, _F, _I,
                          _P],
    "vlp_attention_bwd_max_len": [],
    "vlp_attention_bwd_scratch_floats": [_I, _I],   # (L, dtype code)
    "vlp_attention_fwd_blocks_per_sm": [_I, _I],   # (L, drop)
    "vlp_attention_fwd_bhld": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _LL,
                               _LL, _LL, _I, _F, _P, _U, _F, _I, _P],
    "vlp_attention_bwd_bhld": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                               _I, _I, _I, _LL, _LL, _LL, _LL, _LL, _LL, _I,
                               _F, _P, _U, _F, _I, _P],
    "vlp_dropout_mask": [_P, _I, _I, _I, _P, _U, _F, _P],
    "vlp_decode_attention": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                             _I, _I, _I, _LL, _I, _F, _I, _P],
    "vlp_decode_attention_drop": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                                  _I, _I, _LL, _I, _F, _ULL, _U, _F, _I, _P],
    "vlp_decode_attention_f32_blocks_per_sm": [_I, _I, _I, _I, _I, _I, _I],
    "vlp_decode_dropout_scales": [_P, _P, _I, _I, _I, _I, _I, _U, _F, _P],
    "vlp_bert_adam_blocks": [],
    "vlp_bert_adam_norms": [_P, _P, _I, _I, _P, _P, _P, _P],
    "vlp_bert_adam_update": [_P, _P, _I, _I, _P, _P, _P, _P, _F, _F, _F, _F,
                             _F, _F, _F, _F, _I, _I, _P],
}


@dataclasses.dataclass
class Kernel:
    """One hand-written kernel of the port and its launch count.

    ``launches`` is incremented by the wrapper at the one place it launches
    the kernel (:func:`count_launch`), and by every replay of a captured
    CUDA graph that launches it (:func:`add_launches`); ``chip_smoke.py``
    zeroes it before driving the main path and reads it after."""
    name: str
    source: str      # path in the repository
    replaces: str    # the TPU kernel, file:line, or "none: " and why
    route: str = "cuda"
    launches: int = 0


KERNELS = {
    "attention_fwd": Kernel(
        "attention_fwd", "vlp_tpu_torch/csrc/attention_fwd.cu",
        "vlp_tpu/ops/attention.py:117"),
    "decode_attention": Kernel(
        "decode_attention", "vlp_tpu_torch/csrc/decode_attention.cu",
        "vlp_tpu/ops/decode_attention.py:104"),
    "decode_attention_anc": Kernel(
        "decode_attention_anc", "vlp_tpu_torch/csrc/decode_attention.cu",
        "vlp_tpu/ops/decode_attention.py:143"),
    "attention_fwd_drop": Kernel(
        "attention_fwd_drop", "vlp_tpu_torch/csrc/attention_fwd.cu",
        "vlp_tpu/ops/attention.py:148"),
    "attention_bwd": Kernel(
        "attention_bwd", "vlp_tpu_torch/csrc/attention_bwd.cu",
        "vlp_tpu/ops/attention.py:197"),
    "dropout_mask": Kernel(
        "dropout_mask", "vlp_tpu_torch/csrc/dropout_mask.cu",
        "tests/test_tpu_dropout.py:50"),
    "decode_attention_drop": Kernel(
        "decode_attention_drop", "vlp_tpu_torch/csrc/decode_attention.cu",
        "vlp_tpu/ops/decode_attention.py:159"),
    "decode_dropout_scales": Kernel(
        "decode_dropout_scales", "vlp_tpu_torch/csrc/decode_dropout.cu",
        "vlp_tpu/ops/decode_attention.py:237"),
    "attention_fwd_bhld": Kernel(
        "attention_fwd_bhld", "vlp_tpu_torch/csrc/attention_fwd.cu",
        "vlp_tpu/ops/attention.py:95"),
    "attention_fwd_bhld_drop": Kernel(
        "attention_fwd_bhld_drop", "vlp_tpu_torch/csrc/attention_fwd.cu",
        "vlp_tpu/ops/attention.py:110"),
    "attention_bwd_bhld": Kernel(
        "attention_bwd_bhld", "vlp_tpu_torch/csrc/attention_bwd.cu",
        "vlp_tpu/ops/attention.py:155"),
}
# BertAdam's update (optim.FusedPlan): no TPU kernel, XLA fuses the JAX
# package's update (vlp_tpu/optim.py:111)
for _name in ("bert_adam_norms", "bert_adam_update"):
    KERNELS[_name] = Kernel(_name, "vlp_tpu_torch/csrc/bert_adam.cu",
                            "none: XLA fuses vlp_tpu/optim.py:111")
# the fp16 forms of K1 and K2 (--true_fp16 training): the 16-bit bodies
# instantiated for fp16, counted apart from their bf16 and fp32 forms
for _name in ("attention_fwd", "attention_fwd_drop", "attention_bwd",
              "attention_fwd_bhld", "attention_fwd_bhld_drop",
              "attention_bwd_bhld"):
    _k = KERNELS[_name]
    KERNELS[_name + "_fp16"] = Kernel(_name + "_fp16", _k.source,
                                      _k.replaces)
del _name, _k


# the tally of an open recording(), or None
_recording: Optional[collections.Counter] = None


def reset_launch_counts() -> None:
    for k in KERNELS.values():
        k.launches = 0


def count_launch(name: str) -> None:
    """One launch of kernel ``name`` by its wrapper: added to its count, or
    to the tally of the open :func:`recording`."""
    if _recording is not None:
        _recording[name] += 1
    else:
        KERNELS[name].launches += 1


@contextlib.contextmanager
def recording():
    """Tally the wrappers' launches apart from the kernels' counts: yields
    a ``Counter`` (kernel name -> launches) that takes them instead.

    A CUDA graph's capture runs the wrappers once but launches nothing; its
    replays launch what the capture recorded, and no Python runs then.  So
    the capture is recorded here and each replay adds the tally
    (:func:`add_launches`); the eager warm-up before a capture, whose
    results are thrown away, is recorded and dropped.  Not nestable."""
    global _recording
    if _recording is not None:
        raise RuntimeError("launch recordings do not nest")
    _recording = collections.Counter()
    try:
        yield _recording
    finally:
        _recording = None


def add_launches(counts) -> None:
    """One replay of a graph whose capture recorded ``counts``."""
    for name, n in counts.items():
        KERNELS[name].launches += n


def _sources():
    return sorted(glob.glob(os.path.join(CSRC, "*.cu"))
                  + glob.glob(os.path.join(CSRC, "*.cuh")))


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"), "/usr/local/cuda/bin/nvcc"):
        if cand and os.path.isfile(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built "
                       "(put the CUDA toolkit's bin/ on PATH)")


def build_dir() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in _sources():
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_ROOT, h.hexdigest()[:16])


def build() -> str:
    """Compile ``csrc/*.cu`` unless this source hash is already built;
    returns the library path.  The compiler's output (``-Xptxas -v``
    register and shared-memory report) is kept in ``build.log`` beside it."""
    out_dir = build_dir()
    lib = os.path.join(out_dir, "libvlp_kernels.so")
    if os.path.isfile(lib):
        return lib
    nvcc = _nvcc()
    os.makedirs(out_dir, exist_ok=True)
    cus = [p for p in _sources() if p.endswith(".cu")]
    # the objects and the library go to a private directory first and the
    # library is renamed into place last: a concurrent builder or a cut
    # build never leaves a half-written library under the final name
    work = tempfile.mkdtemp(dir=out_dir)
    objs = [os.path.join(work, os.path.basename(p) + ".o") for p in cus]
    cmds = [[nvcc, *NVCC_FLAGS, "-c", "-o", o, p] for p, o in zip(cus, objs)]
    tmp = os.path.join(work, "lib.so")
    link = [nvcc, *NVCC_FLAGS, "-shared", "-o", tmp, *objs]
    try:
        procs = [subprocess.Popen(c, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for c in cmds]
        runs = [(c, p.communicate()[0], p.returncode)
                for c, p in zip(cmds, procs)]
        if all(rc == 0 for _, _, rc in runs):
            proc = subprocess.run(link, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
            runs.append((link, proc.stdout, proc.returncode))
        report = "".join(" ".join(c) + "\n" + out for c, out, _ in runs)
        with open(os.path.join(out_dir, "build.log"), "w") as f:
            f.write(report)
        if any(rc != 0 for _, _, rc in runs):
            raise RuntimeError(f"nvcc failed:\n{report}")
        os.replace(tmp, lib)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return lib


@functools.lru_cache(maxsize=None)
def library() -> ctypes.CDLL:
    """The built kernel library, loaded once per process."""
    lib = ctypes.CDLL(build())
    for name, argtypes in _SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
    lib.vlp_error_string.argtypes = [ctypes.c_int]
    lib.vlp_error_string.restype = ctypes.c_char_p
    return lib


def check(err: int, what: str) -> None:
    """Raise on a non-zero ``cudaGetLastError()`` from a launch: a refused
    launch never runs, and a later synchronize would not report it."""
    if err != 0:
        text = library().vlp_error_string(err).decode()
        raise RuntimeError(f"{what}: CUDA launch failed: {text} "
                           f"(cudaError {err})")


def stream_ptr(device) -> int:
    import torch
    return torch.cuda.current_stream(device).cuda_stream
