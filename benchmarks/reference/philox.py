"""The random bits a training step draws, worked out again in plain
PyTorch: Philox4x32-10 (Salmon et al., SC'11) for attention-probability
dropout, keyed by a 64-bit seed with the element's (column block, row,
head, example) as its counter, and the 64-bit seed draws of a CPU
``torch.Generator`` from which a step's seeds follow.

A frozen copy of the arithmetic the program states for its dropout (the
counter layout, the uint32 keep threshold, the seed derivation), so that
the reference draws the same masks from the same step seed without
calling the program.
"""

from __future__ import annotations

import torch

M0, M1 = 0xD2511F53, 0xCD9E8D57   # Philox4x32 round multipliers
W0, W1 = 0x9E3779B9, 0xBB67AE85   # Weyl key increments
MASK32 = 0xFFFFFFFF
MASK64 = (1 << 64) - 1
ROUNDS = 10


def _splitmix64(x: int) -> int:
    x = (x + 0x9E3779B97F4A7C15) & MASK64
    x = ((x ^ (x >> 30)) * 0xBF58476D1CE4E5B9) & MASK64
    x = ((x ^ (x >> 27)) * 0x94D049BB133111EB) & MASK64
    return x ^ (x >> 31)


def step_seed(seed: int, *path: int) -> int:
    """A 64-bit seed derived from ``seed`` and the integers ``path``."""
    x = _splitmix64(seed & MASK64)
    for p in path:
        x = _splitmix64(x ^ (p & MASK64))
    return x


def draw64(gen: torch.Generator) -> int:
    """The next 64-bit seed of a CPU generator: two 32-bit draws."""
    lo, hi = torch.randint(0, 2 ** 32, (2,), generator=gen).tolist()
    return lo | (hi << 32)


def forward_seeds(seed: int, n_layers: int):
    """(hidden-dropout generator seed, one attention seed per layer) of a
    training forward whose step seed is ``seed``: the first draw seeds the
    device generator of the hidden dropout, the next ones the layers'
    attention dropout, in layer order."""
    host = torch.Generator().manual_seed(seed)
    draws = [draw64(host) for _ in range(1 + n_layers)]
    return draws[0], draws[1:]


def _mulhilo(m: int, x: torch.Tensor):
    lo16 = m * (x & 0xFFFF)
    hi16 = m * (x >> 16)
    low = lo16 + ((hi16 & 0xFFFF) << 16)
    return (hi16 >> 16) + (low >> 32), low & MASK32


def philox4x32(c0, c1, c2, c3, seed: int):
    k0, k1 = seed & MASK32, (seed >> 32) & MASK32
    for r in range(ROUNDS):
        if r:
            k0, k1 = (k0 + W0) & MASK32, (k1 + W1) & MASK32
        hi0, lo0 = _mulhilo(M0, c0)
        hi1, lo1 = _mulhilo(M1, c2)
        c0, c1, c2, c3 = hi1 ^ c1 ^ k0, lo1, hi0 ^ c3 ^ k1, lo0
    return c0, c1, c2, c3


def keep_scale(seed: int, B: int, H: int, L: int, rate: float,
               device=None) -> torch.Tensor:
    """fp32 ``[B, H, L, L]`` multipliers: ``1/(1-rate)`` where element
    ``(b, h, i, j)``'s word (counter ``(j // 4, i, h, b)``, word ``j % 4``)
    is at least ``uint32(rate * 2**32)``, else 0."""
    nblk = -(-L // 4)

    def ar(n, *shape):
        return torch.arange(n, dtype=torch.int64, device=device).view(shape)

    words = philox4x32(ar(nblk, 1, 1, 1, nblk), ar(L, 1, 1, L, 1),
                       ar(H, 1, H, 1, 1), ar(B, B, 1, 1, 1), seed)
    bits = torch.stack(torch.broadcast_tensors(*words), dim=-1)
    bits = bits.reshape(B, H, L, nblk * 4)[..., :L]
    threshold = min(int(rate * float(2 ** 32)), 2 ** 32 - 1)
    scale = torch.tensor(1.0 / (1.0 - rate), dtype=torch.float32,
                         device=device)
    return torch.where(bits >= threshold, scale,
                       torch.zeros((), device=device))
