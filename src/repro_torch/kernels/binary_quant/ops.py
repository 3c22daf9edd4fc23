"""Binary quantization over any shape: encode → (packed, vmin, vmax) and its
decode — port of ``repro.kernels.binary_quant.ops``.

``binary_encode`` returns the reference's byte count: the input padded with
vmin to a multiple of :data:`TILE` coordinates, whose bits are 0.  vmin and
vmax are ``torch.amin``/``amax`` of the input, as the reference computes
them outside its kernel.  Dispatch
(:func:`repro_torch.kernels.backend.use_plain`): a CPU tensor takes the
plain version on the padded copy, a CUDA tensor the Hopper kernel on the
unpadded input (or an error); both give the same bytes.  ``binary_decode``
is plain PyTorch on every device, as the reference keeps it.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import backend
from repro_torch.kernels.binary_quant import binary_quant as _kernel
from repro_torch.kernels.binary_quant import ref as _ref

# the reference's (512, 128) tile
TILE = 512 * 128


def binary_encode(x, seed: int):
    """Stochastic 1-bit quantization of any-shape float32 or bfloat16 ``x``:
    (⌈numel/TILE⌉·TILE/8 uint8, vmin, vmax), vmin and vmax f32 0-dim."""
    vmin = torch.amin(x).to(torch.float32)
    vmax = torch.amax(x).to(torch.float32)
    flat = x.reshape(-1)
    n = flat.shape[0]
    padded = n + (-n) % TILE
    if backend.use_plain(flat):
        flat = torch.cat([flat, vmin.to(x.dtype).expand(padded - n)])
        return _ref.pack_bytes(_ref.encode_bits(flat, vmin, vmax, seed)), vmin, vmax
    return _kernel.encode(flat.contiguous(), vmin, vmax, seed, padded), vmin, vmax


def binary_decode(packed, vmin, vmax, shape, dtype=torch.float32):
    """Inverse of :func:`binary_encode`: the dense Y of Example 4 in
    ``shape``, ``dtype``."""
    n = 1
    for s in shape:
        n *= s
    y = _ref.binary_decode(packed, vmin, vmax, (packed.numel() * 8,), dtype)
    return y[:n].reshape(shape)
