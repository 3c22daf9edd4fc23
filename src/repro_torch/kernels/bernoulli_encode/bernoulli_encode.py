"""ctypes wrapper of the Hopper dense Bernoulli encoder (``csrc/bernoulli_encode.cu``).

Replaces ``bernoulli_encode_2d``
(``repro/kernels/bernoulli_encode/bernoulli_encode.py:53``): Eq. (1) at
uniform p over a flat f32 or bf16 vector with the hash PRNG, bit-equal to
:func:`.ref.bernoulli_encode`.  The kernel reads the vector unpadded (the
counter is the global index), so no padded (R, 128) copy is made.  Counted
as ``bernoulli_encode_2d`` in :data:`repro_torch.kernels.backend.launches`.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import backend

_LIB = "bernoulli_encode"
_P = ctypes.c_void_p
DTYPES = {torch.float32: 0, torch.bfloat16: 1}


def _fn():
    f = backend.lib(_LIB).be_encode
    if f.argtypes is None:
        f.argtypes = [_P, _P, ctypes.c_int64, ctypes.c_int, ctypes.c_float, ctypes.c_float,
                      ctypes.c_uint32, _P]
        f.restype = ctypes.c_int
    return f


def encode(flat, p: float, mu: float, seed: int):
    """flat: (n,) f32 or bf16 contiguous CUDA → (n,) in its dtype; p in
    (0, 1], mu and seed as for :func:`.ref.bernoulli_encode` (p and mu are
    rounded to f32, seed taken mod 2³²)."""
    if flat.dtype not in DTYPES:
        raise ValueError(f"flat: expected float32 or bfloat16, got {flat.dtype}")
    backend.check(flat, "flat", flat.dtype)
    if flat.dim() != 1 or flat.shape[0] < 1:
        raise ValueError(f"flat: expected a non-empty 1-D tensor, got {tuple(flat.shape)}")
    if not 0.0 < p <= 1.0:
        raise ValueError(f"p must be in (0, 1], got {p}")
    out = torch.empty_like(flat)
    err = _fn()(flat.data_ptr(), out.data_ptr(), flat.shape[0], DTYPES[flat.dtype], p, mu,
                int(seed) & 0xFFFFFFFF, backend.stream_ptr(flat.device))
    backend.check_launch(err, "bernoulli encode")
    backend.launches["bernoulli_encode_2d"] += 1
    return out
