"""ctypes wrapper of the Hopper binary-quantization encoder (``csrc/binary_quant.cu``).

Replaces ``binary_encode_2d`` (``repro/kernels/binary_quant/binary_quant.py:54``):
the Example 4 bits of a flat f32 or bf16 vector from the hash PRNG, packed
8 to a byte (32 to a little-endian word), bit-equal to
:func:`.ref.encode_bits` + :func:`.ref.pack_bytes` on the input padded with
vmin, whose bits are 0.  The kernel reads the vector unpadded and writes
zero bits past its end.  Counted as ``binary_encode_2d`` in
:data:`repro_torch.kernels.backend.launches`.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import backend

_LIB = "binary_quant"
_P = ctypes.c_void_p
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
# padded coordinates a call must cover: whole warps of 16-byte groups
ALIGN = 256


def _fn():
    f = backend.lib(_LIB).bq_encode
    if f.argtypes is None:
        f.argtypes = [_P, ctypes.c_int64, ctypes.c_int, _P, _P, ctypes.c_uint32, _P,
                      ctypes.c_int64, _P]
        f.restype = ctypes.c_int
    return f


def encode(flat, vmin, vmax, seed: int, padded: int):
    """flat: (n,) f32 or bf16 contiguous CUDA; vmin, vmax: f32 0-dim CUDA;
    ``padded`` ≥ n a multiple of :data:`ALIGN` → (padded/8,) uint8."""
    if flat.dtype not in DTYPES:
        raise ValueError(f"flat: expected float32 or bfloat16, got {flat.dtype}")
    backend.check(flat, "flat", flat.dtype)
    backend.check(vmin, "vmin", torch.float32, ())
    backend.check(vmax, "vmax", torch.float32, ())
    n = flat.shape[0]
    if flat.dim() != 1 or n < 1:
        raise ValueError(f"flat: expected a non-empty 1-D tensor, got {tuple(flat.shape)}")
    if padded < n or padded % ALIGN:
        raise ValueError(f"padded length {padded} must be ≥ {n} and a multiple of {ALIGN}")
    out = torch.empty(padded // 8, dtype=torch.uint8, device=flat.device)
    err = _fn()(flat.data_ptr(), n, DTYPES[flat.dtype], vmin.data_ptr(), vmax.data_ptr(),
                int(seed) & 0xFFFFFFFF, out.data_ptr(), padded, backend.stream_ptr(flat.device))
    backend.check_launch(err, "binary encode")
    backend.launches["binary_encode_2d"] += 1
    return out
