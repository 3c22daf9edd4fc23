"""Dispatch for the fused rotate + encode path of ``RotatedCodec(binary)``
— port of ``repro.kernels.rotated_encode.ops``.

A CPU tensor takes exactly the reference's off-TPU chain
(``rotation.rotate`` → ``bitplane.binary_pack``): same butterfly, same
encoder draws, same bytes (the golden matrix).  A CUDA tensor takes the two
fused kernels of :mod:`.kernel`, with the rows' (min, max) partials reduced
between them; below dp = 256, where the reference keeps the chain, the card
runs the chain too (the FWHT kernel and the bit-plane pack kernel).  Both
routes give the same words: the kernels equal the plain versions of
:mod:`.ref`, which equal the chain bit for bit.
"""
from __future__ import annotations

import torch

from repro_torch import random as prandom
from repro_torch.core import bitplane, rotation
from repro_torch.kernels import backend
from repro_torch.kernels.hadamard import ops as hops
from repro_torch.kernels.rotated_encode import kernel


def pack_binary(flat, key, rank, wire_dtype):
    """RotatedCodec(inner=binary).pack: (d,) f32 → int32 wire buffer
    [1-bit plane of dp = padded_dim(d) coordinates ‖ (vmin, vmax)]."""
    krot = rotation.rotation_key(key)
    kenc = prandom.fold_in(key, rank)
    d = flat.shape[0]
    dp = rotation.padded_dim(d)
    if backend.use_plain(flat) or dp < 256:
        z = rotation.rotate(krot, flat)
        return bitplane.binary_pack(z, kenc, wire_dtype)
    c = min(dp, hops.MAX_D)
    scale = float(rotation.chunk_scale(c, "cpu"))
    signs = rotation.rademacher_diag(krot, dp, flat.device)
    xp = rotation._pad(flat.to(torch.float32), dp)
    z2, mm = kernel.rotate_minmax(xp.reshape(-1, c), signs.reshape(-1, c), scale)
    vmin = torch.amin(mm[:, 0])
    vmax = torch.amax(mm[:, 1])
    plane = kernel.encode_pack(z2.reshape(-1), kenc, vmin, vmax, dp)
    tail = bitplane.floats_to_words(torch.stack([vmin, vmax]), wire_dtype)
    return torch.cat([plane, tail])
