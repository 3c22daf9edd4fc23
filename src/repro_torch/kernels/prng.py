"""Counter-based hash PRNG of the dense encoders — port of
``repro.kernels.prng``.

``hash_u32(seed, idx)`` is the murmur3 fmix32 finalizer of
idx·0x9E3779B9 + seed, all in uint32 arithmetic; ``uniform_hash`` takes its
top 24 bits times 2⁻²⁴, a U[0, 1) float32 that is exact.  The counter is
the global flat coordinate, so a draw does not depend on how a kernel tiles
the vector.  Not a ``jax.random`` stream: the Bernoulli (kernel 14) and
binary-quantization (kernel 15) encoders draw from it, never the wire.

PyTorch has no uint32 arithmetic on the CPU, so the words live in int64
tensors holding values in [0, 2³²).  A product of two such words can reach
2⁶⁴, past int64, so each multiply splits the constant into 16-bit halves:
no intermediate exceeds 2⁴⁹ and none relies on signed overflow.  The
kernels' device function is ``csrc/prng.cuh``.
"""
from __future__ import annotations

import torch

_MASK = 0xFFFFFFFF
_GOLDEN = 0x9E3779B9
_M1 = 0x85EBCA6B
_M2 = 0xC2B2AE35


def _mul32(a, c: int):
    """(a · c) mod 2³² for int64 ``a`` in [0, 2³²) and a uint32 constant c:
    a·c = a·c_lo + 2¹⁶·a·c_hi, and 2¹⁶·a·c_hi mod 2³² = 2¹⁶·(a·c_hi mod 2¹⁶)."""
    lo, hi = c & 0xFFFF, c >> 16
    return (a * lo + (((a * hi) & 0xFFFF) << 16)) & _MASK


def hash_u32(seed: int, idx):
    """Murmur3 fmix32 of idx·0x9E3779B9 + seed.  ``idx``: int64 tensor of
    values in [0, 2³²) (taken mod 2³² otherwise), ``seed``: a uint32 int.
    Returns int64 values in [0, 2³²)."""
    h = (_mul32(idx & _MASK, _GOLDEN) + (int(seed) & _MASK)) & _MASK
    h = h ^ (h >> 16)
    h = _mul32(h, _M1)
    h = h ^ (h >> 13)
    h = _mul32(h, _M2)
    return h ^ (h >> 16)


def uniform_hash(seed: int, idx):
    """U[0, 1) float32 from the top 24 bits of :func:`hash_u32` (exact)."""
    return (hash_u32(seed, idx) >> 8).to(torch.float32) * (1.0 / (1 << 24))
