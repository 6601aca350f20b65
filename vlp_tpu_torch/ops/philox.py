"""Counter-based dropout bits: Philox4x32-10 (Salmon et al., SC'11, the
Random123 generator) in plain PyTorch.

The TPU kernels draw attention-prob dropout from the chip's own PRNG
(``pltpu.prng_seed`` / ``prng_random_bits``, ``vlp_tpu/ops/attention.py:83``).
The port draws it from Philox instead: the 64-bit seed is the key, and the
position of a draw is the counter, so the forward kernel, the backward
kernel, the ``dropout_mask`` kernel (``csrc/common.cuh``) and this plain
version produce the same bits on any device without sharing a stream.

For attention probabilities ``[B, H, L, L]`` the counter of element
``(b, h, i, j)`` is ``(j // 4, i, h, b)``; the four output words of one
counter cover columns ``4*(j//4) .. 4*(j//4)+3``.  An element is kept iff its
word is ``>= uint32(rate * 2**32)``, the threshold of the TPU kernel's
``_dropout_keep_scale``.

Words are uint32 values held in int64 tensors; ``mulhilo`` splits one factor
into 16-bit halves so that no product exceeds 2**48.
"""

from __future__ import annotations

import torch

M0, M1 = 0xD2511F53, 0xCD9E8D57   # Philox4x32 round multipliers
W0, W1 = 0x9E3779B9, 0xBB67AE85   # Weyl key increments
MASK32 = 0xFFFFFFFF
ROUNDS = 10


def _mulhilo(m: int, x: torch.Tensor):
    """(hi, lo) 32-bit words of the 64-bit product of the constant ``m`` and
    the uint32 words ``x`` (int64 tensor)."""
    lo16 = m * (x & 0xFFFF)                  # < 2**48
    hi16 = m * (x >> 16)                     # < 2**48
    low = lo16 + ((hi16 & 0xFFFF) << 16)     # < 2**49
    return (hi16 >> 16) + (low >> 32), low & MASK32


def philox4x32(c0, c1, c2, c3, seed: int):
    """Philox4x32-10 of the counter words ``(c0, c1, c2, c3)`` (int64
    tensors of uint32 values, broadcastable) under the 64-bit ``seed``
    (key words: low, high).  Returns the four output words."""
    k0, k1 = seed & MASK32, (seed >> 32) & MASK32
    for r in range(ROUNDS):
        if r:
            k0, k1 = (k0 + W0) & MASK32, (k1 + W1) & MASK32
        hi0, lo0 = _mulhilo(M0, c0)
        hi1, lo1 = _mulhilo(M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def keep_threshold(rate: float) -> int:
    """uint32 threshold: a word ``>=`` it keeps its element."""
    return min(int(rate * float(2 ** 32)), 2 ** 32 - 1)


def keep_scale(seed: int, B: int, H: int, L: int, rate: float,
               device=None) -> torch.Tensor:
    """fp32 ``[B, H, L, L]`` attention-dropout multipliers: ``1/(1-rate)``
    where kept, 0 where dropped."""
    nblk = -(-L // 4)

    def ar(n, *shape):
        return torch.arange(n, dtype=torch.int64, device=device).view(shape)

    words = philox4x32(ar(nblk, 1, 1, 1, nblk), ar(L, 1, 1, L, 1),
                       ar(H, 1, H, 1, 1), ar(B, B, 1, 1, 1), seed)
    bits = torch.stack(torch.broadcast_tensors(*words), dim=-1)
    bits = bits.reshape(B, H, L, nblk * 4)[..., :L]
    keep = bits >= keep_threshold(rate)
    scale = torch.tensor(1.0 / (1.0 - rate), dtype=torch.float32,
                         device=device)
    return torch.where(keep, scale, torch.zeros((), device=device))
