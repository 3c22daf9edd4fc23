"""ctypes wrapper of the Hopper Walsh–Hadamard kernel (``csrc/hadamard.cu``).

Replaces ``fwht_pallas`` (``repro/kernels/hadamard/hadamard.py:57``): the
unnormalised transform of each row of a (B, c) f32 tensor, c a power of two
≤ 2²⁰, bit-equal to the butterfly of :mod:`.ref` (not to the TPU kernel's
Kronecker matmuls; see the source's header).  One pass in shared memory up
to c = 2¹³, two passes beyond.  Counted as ``fwht`` in
:data:`repro_torch.kernels.backend.launches`.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import backend

_LIB = "hadamard"
_P = ctypes.c_void_p
MAX_D = 1 << 20


def _fn():
    f = backend.lib(_LIB).hd_fwht
    if f.argtypes is None:
        f.argtypes = [_P, _P, ctypes.c_int64, ctypes.c_int64, _P]
        f.restype = ctypes.c_int
    return f


def check_rows(x, name: str):
    """(B, c) f32 contiguous CUDA rows with c a power of two ≤ MAX_D."""
    backend.check(x, name, torch.float32)
    if x.dim() != 2 or x.shape[0] < 1:
        raise ValueError(f"{name}: expected a non-empty (B, c) tensor, got {tuple(x.shape)}")
    c = x.shape[1]
    if c < 1 or c & (c - 1) or c > MAX_D:
        raise ValueError(f"{name}: row length must be a power of two ≤ {MAX_D}, got {c}")
    return x.shape


def fwht(x):
    """(B, c) f32 CUDA → (B, c) f32, the unnormalised WHT of each row."""
    b, c = check_rows(x, "x")
    out = torch.empty_like(x)
    err = _fn()(x.data_ptr(), out.data_ptr(), b, c, backend.stream_ptr(x.device))
    backend.check_launch(err, "fwht")
    backend.launches["fwht"] += 1
    return out
