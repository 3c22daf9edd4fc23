"""Plain PyTorch versions of the fused §7.2 rotate + 1-bit encode kernels
(``csrc/rotated_encode.cu``).

* :func:`rotate_minmax` — per row (one MAX_D chunk of the block-diagonal
  rotation): signs, the butterfly of :mod:`repro_torch.kernels.hadamard.ref`,
  a true division by ``scale`` and the row's (min, max).  It follows the
  port's rotation (the reference's CPU butterfly), not the reference's
  oracle of the same name, which computes the TPU kernel's Kronecker
  matmuls: the two differ in the last bits (held within rtol 1e-5 /
  atol 1e-6 by tests/test_torch_rotated_encode.py).
* :func:`binary_plane` — the §4.5 stochastic 1-bit plane of a rotated
  vector given the global (vmin, vmax): the op chain of
  ``encoders.encode_binary`` (same Threefry stream, same guarded threshold)
  packed 32 bits per word, little-endian.

Together they equal the chain ``rotation.rotate`` → ``bitplane.binary_pack``
bit for bit, tail included.  The CUDA kernels are held against these on
the card (``chip_smoke.py``, tests/test_torch_kernels_cuda.py).
"""
from __future__ import annotations

import torch

from repro_torch import random as prandom
from repro_torch.kernels.bitplane import ref as bp_ref
from repro_torch.kernels.hadamard import ref as h_ref


def rotate_minmax(x2, signs2, scale):
    """x2, signs2: (B, c) f32; ``scale`` f32 √c (a float or 0-dim tensor).
    Returns (z2 (B, c) f32, mm (B, 2) f32) with mm[i] = (min, max) of row i
    of z2 = H(x2·signs2)/scale."""
    s = torch.as_tensor(scale, dtype=torch.float32, device=x2.device)
    z = h_ref.fwht(x2 * signs2) / s
    return z, torch.stack([torch.amin(z, dim=1), torch.amax(z, dim=1)], dim=1)


def binary_plane(z, key, vmin, vmax, dp: int):
    """(dp,) rotated z + global (vmin, vmax) → the (⌈dp/32⌉,) int32 plane."""
    vmin = torch.as_tensor(vmin, dtype=torch.float32, device=z.device)
    vmax = torch.as_tensor(vmax, dtype=torch.float32, device=z.device)
    delta = vmax - vmin
    one = torch.ones_like(delta)
    p = torch.where(delta > 0, (z - vmin) / torch.where(delta > 0, delta, one),
                    torch.zeros_like(delta))
    bits = prandom.uniform(key, dp, z.device) < p
    return bp_ref.pack_bits(bits, 1)
