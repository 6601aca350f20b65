"""vlp_tpu_torch — VLP caption decoding, training and self-critical
training in PyTorch, with hand-written CUDA kernels for NVIDIA Hopper
(sm_90a).

The JAX package ``vlp_tpu`` is the reference this package is held against:
module names mirror it (``ops/attention.py`` <-> ``vlp_tpu/ops/attention.py``
and so on).  Nothing here imports ``jax`` or ``vlp_tpu``: the JAX-free parts
of the reference (``config``, ``data``, ``evals``, ``cli/common`` and the
numpy half of ``checkpoint``) are kept here as copies that differ from
their originals only in their import lines (and in docstrings that cite
the reference tree without its mount path).

Each kernel wrapper launches its CUDA kernel for CUDA tensors and takes its
plain PyTorch version only for CPU tensors; there is no fallback between the
two.  Kernels build from ``csrc/`` at first use (``ops/_build.py``).
"""

import torch

__all__ = ["configure_precision", "torch_dtype"]


def configure_precision() -> None:
    """Pin float32 products to full float32 on the card.

    The JAX reference accumulates its float32 products in float32; TF32
    keeps ~3 decimal digits and flips beams.  Both switches are set
    explicitly (cuDNN's defaults to True) rather than trusted."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def torch_dtype(name: str) -> torch.dtype:
    """``VLPConfig.dtype`` string -> torch dtype."""
    dtypes = {"float32": torch.float32, "bfloat16": torch.bfloat16,
              "float16": torch.float16}
    if name not in dtypes:
        raise ValueError(f"unsupported activation dtype {name!r}")
    return dtypes[name]
