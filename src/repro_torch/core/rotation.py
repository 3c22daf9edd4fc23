"""Random-rotation pre-processing (§7.2 / Remark 3) — port of
``repro.core.rotation``.

Q = (1/√c)·H·D with H the Walsh–Hadamard matrix and D = diag(±1) random:
orthogonal, identified by one shared seed, computable in O(d log d).

* non-power-of-two d is zero-padded to the next power of two
  (:func:`unrotate` truncates), and
* d beyond the kernel's MAX_D (2²⁰) rotates in independent MAX_D chunks: a
  block-diagonal Q, still seed-identified.

:func:`padded_dim` is the single source of truth for the rotated length.
The op order is the reference's: signs times x, the butterfly
(:mod:`repro_torch.kernels.hadamard`), then a true division by f32 √c — as
a tensor on the data's device, since PyTorch on the card turns a division
by a host scalar into a multiplication by its reciprocal, which moves bits
where √c is not a power of two.  So rotations on the CPU equal the
reference's CPU path (and the golden wire bytes) bit for bit, and the card
gives the same bits.
"""
from __future__ import annotations

import torch

from repro_torch import random as prandom
from repro_torch.kernels.hadamard import ops as hadamard_ops

# Domain tag deriving the shared per-bucket rotation seed from the per-step
# key: distinct from the ranks and bucket indices folded elsewhere.
_ROTATION_TAG = 0x524F54  # "ROT"


def rotation_key(key):
    """The shared rotation seed: the same on every rank of the bucket."""
    return prandom.fold_in(key, _ROTATION_TAG)


def padded_dim(d: int) -> int:
    """Length after rotation: the next power of two, or — beyond MAX_D —
    the next multiple of MAX_D (block-diagonal Q)."""
    dp = 1 << max(0, (d - 1).bit_length())
    if dp <= hadamard_ops.MAX_D:
        return dp
    return -(-d // hadamard_ops.MAX_D) * hadamard_ops.MAX_D


def _pad(x, dp: int):
    d = x.shape[-1]
    if dp == d:
        return x
    return torch.nn.functional.pad(x, (0, dp - d))


def rademacher_diag(key, d: int, device=None):
    """The D of Q: iid ±1 f32 signs from the shared seed."""
    return prandom.rademacher(key, (d,), device)


def _chunked_fwht(x):
    """FWHT over the last axis, block-diagonal in MAX_D chunks beyond it;
    returns (result, chunk length c)."""
    dp = x.shape[-1]
    c = min(dp, hadamard_ops.MAX_D)
    if dp == c:
        return hadamard_ops.fwht(x), c
    z = hadamard_ops.fwht(x.reshape(x.shape[:-1] + (dp // c, c)))
    return z.reshape(x.shape[:-1] + (dp,)), c


def chunk_scale(c: int, device):
    """f32 √c as a 0-dim tensor on ``device`` (see the module docstring)."""
    return torch.sqrt(torch.tensor(float(c), dtype=torch.float32, device=device))


def rotate(key, x):
    """z = Qx.  x: (..., d) f32 → (..., padded_dim(d))."""
    xp = _pad(x, padded_dim(x.shape[-1]))
    dp = xp.shape[-1]
    signs = rademacher_diag(key, dp, xp.device)
    z, c = _chunked_fwht(xp * signs)
    return z / chunk_scale(c, xp.device)


def unrotate(key, z, d: int):
    """x = Qᵀz = (1/√c)·D·H·z, truncated back to the original d."""
    dp = z.shape[-1]
    signs = rademacher_diag(key, dp, z.device)
    h, c = _chunked_fwht(z)
    x = signs * h / chunk_scale(c, z.device)
    return x[..., :d]
