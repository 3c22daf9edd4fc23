"""Plain PyTorch stochastic binary quantization (Example 4 / [10]) — port
of ``repro.kernels.binary_quant.ref``.

encode: bit_j = u_j < p_j with p_j = (x_j − vmin)/Δ (0 where Δ ≤ 0) and
u_j = ``uniform_hash(seed, j)`` over the global flat index j; the bits pack
8 to a byte, least significant bit first.  decode: Y_j = vmax where the bit
is set, else vmin.  Every operation is one f32 operation in the
reference's order, on x's device (vmin and vmax are 0-dim f32 tensors
there); ``csrc/binary_quant.cu`` computes the same bytes.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import prng


def encode_bits(x, vmin, vmax, seed: int):
    """The (n,) bool bits of the flattened ``x`` for the f32 0-dim ``vmin``
    and ``vmax``."""
    flat = x.reshape(-1).to(torch.float32)
    delta = vmax - vmin
    zero = torch.zeros_like(delta)
    dsafe = torch.where(delta > 0, delta, torch.ones_like(delta))
    p = torch.where(delta > 0, (flat - vmin) / dsafe, zero)
    idx = torch.arange(flat.shape[0], dtype=torch.int64, device=flat.device)
    return prng.uniform_hash(seed, idx) < p


def pack_bytes(bits):
    """(n,) bool, n % 8 == 0 → (n/8,) uint8, bit k of byte b = bits[8b + k]."""
    if bits.shape[0] % 8:
        raise ValueError(f"bit count {bits.shape[0]} is not a multiple of 8")
    weights = torch.tensor([1 << k for k in range(8)], dtype=torch.int32, device=bits.device)
    return torch.sum(bits.reshape(-1, 8).to(torch.int32) * weights, dim=-1).to(torch.uint8)


def binary_encode(x, seed: int):
    """x: (..., d) with 8 | numel → (numel/8 uint8, vmin, vmax), vmin and
    vmax the f32 extremes of x."""
    vmin = torch.amin(x).to(torch.float32)
    vmax = torch.amax(x).to(torch.float32)
    return pack_bytes(encode_bits(x, vmin, vmax, seed)), vmin, vmax


def binary_decode(packed, vmin, vmax, shape, dtype=torch.float32):
    """The dense Y of Example 4 from the packed bytes: (numel(shape),)
    coordinates, vmax where the bit is set, else vmin."""
    shifts = torch.arange(8, dtype=torch.uint8, device=packed.device)
    bits = (packed.reshape(-1, 1) >> shifts) & 1
    y = torch.where(bits.reshape(-1) > 0, vmax, vmin).to(dtype)
    return y.reshape(shape)
