"""ctypes wrapper of the Hopper fixed-k gather kernel (``csrc/fixed_k_encode.cu``).

Replaces ``fixed_k_gather_2d`` (``repro/kernels/fixed_k_encode/fixed_k_encode
.py:39``): one CUDA block per selected 1024-coordinate block, 16-byte loads,
``scale·(x − μ)`` into the compacted (kb, 1024) values.  It reads the flat
vector unpadded (lanes past its end read as 0, the reference's padding), so
no padded copy of the bucket is made.  Counted as ``fixed_k_gather`` in
:data:`repro_torch.kernels.backend.launches`.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import backend

BLOCK = 1024
_LIB = "fixed_k_encode"
_P = ctypes.c_void_p


def _fn():
    f = backend.lib(_LIB).fk_gather
    if f.argtypes is None:
        f.argtypes = [_P, ctypes.c_int64, _P, ctypes.c_int64, ctypes.c_float,
                      _P, _P, _P]
        f.restype = ctypes.c_int
    return f


def fixed_k_gather(flat, block_ids, scale: float, mu):
    """flat: (n,) f32 CUDA; block_ids: (kb,) int64 ids < ⌈n/1024⌉; mu: CUDA
    f32 scalar → (kb, 1024) f32 wire values ``scale·(x − μ)``."""
    backend.check(flat, "flat", torch.float32)
    if flat.dim() != 1:
        raise ValueError(f"flat: expected 1-D, got {tuple(flat.shape)}")
    kb = block_ids.shape[0]
    backend.check(block_ids, "block_ids", torch.int64, (kb,))
    backend.check(mu, "mu", torch.float32, ())
    if kb < 1:
        raise ValueError("need at least one block id")
    out = torch.empty((kb, BLOCK), dtype=torch.float32, device=flat.device)
    err = _fn()(flat.data_ptr(), flat.shape[0], block_ids.data_ptr(), kb,
                float(torch.tensor(scale, dtype=torch.float32)), mu.data_ptr(),
                out.data_ptr(), backend.stream_ptr(flat.device))
    backend.check_launch(err, "fixed-k gather")
    backend.launches["fixed_k_gather"] += 1
    return out
