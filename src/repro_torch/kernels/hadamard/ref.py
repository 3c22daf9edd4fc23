"""Plain PyTorch fast Walsh–Hadamard transform — port of
``repro.kernels.hadamard.ref`` (Sylvester order, unnormalised).

H_1 = [1]; H_{2m} = [[H_m, H_m], [H_m, −H_m]];  fwht(x) = H_d @ x.

The butterfly is the reference's radix-2 add tree, and its order is part of
the result (the golden wire bytes pin it): stage s pairs the coordinates
whose indices differ in bit s, lowest bit first, and the lower one of a
pair gets ``lo + hi``, the upper one ``lo − hi``.  Every stage rounds once
per coordinate, so the same stages in another order (or the Kronecker
matmuls of the TPU kernel) give other last bits.  The reference fuses
stages into radix-4 superstages; that changes no operation, so one stage
at a time here gives its bits.

This is the version a CPU tensor takes (:mod:`.ops`) and the one the CUDA
kernel (``csrc/hadamard.cu``) is held against bit for bit.
"""
from __future__ import annotations

import torch


def fwht(x):
    """O(d log d) butterfly over the last axis.  x: (..., d), d = 2^m."""
    d = x.shape[-1]
    if d < 1 or d & (d - 1):
        raise ValueError(f"fwht needs a power-of-two length, got {d}")
    shape = x.shape
    x = x.reshape(-1, d)
    h = 1
    while h < d:
        v = x.reshape(-1, d // (2 * h), 2, h)
        lo, hi = v[:, :, 0, :], v[:, :, 1, :]
        x = torch.stack([lo + hi, lo - hi], dim=2).reshape(-1, d)
        h *= 2
    return x.reshape(shape)


def hadamard_matrix(d: int, dtype=torch.float32, device=None):
    """Explicit H_d by the parity trick: H[i, j] = (−1)^popcount(i & j)."""
    i = torch.arange(d, device=device)
    v = i[:, None] & i[None, :]
    parity = torch.zeros_like(v)
    while bool(v.any()):
        parity ^= v & 1
        v = v >> 1
    return (1 - 2 * parity).to(dtype)
