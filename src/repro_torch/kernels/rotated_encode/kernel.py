"""ctypes wrappers of the Hopper rotate + 1-bit encode kernels
(``csrc/rotated_encode.cu``).

* :func:`rotate_minmax` — ``re_rotate_minmax`` (replaces
  ``rotate_minmax_pallas``, ``repro/kernels/rotated_encode/kernel.py:70``);
  counted as ``rotate_minmax``;
* :func:`encode_pack` — ``re_encode_pack`` (replaces ``encode_pack_pallas``,
  ``kernel.py:121``); counted as ``encode_pack``.

Each takes CUDA tensors only, checks them, allocates its outputs with
``torch.empty``, launches on PyTorch's current stream and raises on a
nonzero ``cudaGetLastError``.  Both are bit-equal to :mod:`.ref`; design
and bounds are in the source's header comment.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import backend
from repro_torch.kernels.hadamard.hadamard import aligned, check_rows, scratch

_LIB = "rotated_encode"
_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_U32 = ctypes.c_uint32
_SIGS = {
    "re_rotate_minmax": ([_P, _P, _P, _P, _P, _I64, _I64, ctypes.c_float, _P], ctypes.c_int),
    "re_scratch_bytes": ([_I64, _I64], _I64),
    "re_encode_pack": ([_P, _I64, _U32, _U32, _P, _P, _P], ctypes.c_int),
}


def _fn(name: str):
    f = getattr(backend.lib(_LIB), name)
    if f.argtypes is None:
        f.argtypes, f.restype = _SIGS[name]
    return f


def rotate_minmax(x2, signs2, scale: float):
    """x2, signs2: (B, c) f32 CUDA, c = 2^m ≤ 2²⁰; ``scale`` the f32 √c →
    (z2 (B, c) f32, mm (B, 2) f32 per-row (min, max) of z2)."""
    b, c = check_rows(x2, "x2")
    backend.check(signs2, "signs2", torch.float32, (b, c))
    x2, signs2 = aligned(x2), aligned(signs2)
    z = torch.empty_like(x2)
    mm = torch.empty((b, 2), dtype=torch.float32, device=x2.device)
    work = scratch(_fn("re_scratch_bytes")(b, c), x2.device)
    err = _fn("re_rotate_minmax")(x2.data_ptr(), signs2.data_ptr(), z.data_ptr(), mm.data_ptr(),
                                  work.data_ptr(), b, c, float(scale),
                                  backend.stream_ptr(x2.device))
    backend.check_launch(err, "rotate_minmax")
    backend.launches["rotate_minmax"] += 1
    return z, mm


def encode_pack(z, key, vmin, vmax, dp: int):
    """z: (dp,) f32 CUDA rotated vector; key: the (2,) rank-folded key;
    vmin, vmax: f32 0-dim CUDA tensors → the (⌈dp/32⌉,) int32 plane."""
    backend.check(z, "z", torch.float32, (dp,))
    if dp < 1:
        raise ValueError("dp must be ≥ 1")
    vmm = torch.stack([vmin, vmax]).to(torch.float32)
    backend.check(vmm, "(vmin, vmax)", torch.float32, (2,))
    k0, k1 = (int(w) & 0xFFFFFFFF for w in torch.as_tensor(key).reshape(2))
    out = torch.empty(-(-dp // 32), dtype=torch.int32, device=z.device)
    err = _fn("re_encode_pack")(z.data_ptr(), dp, k0, k1, vmm.data_ptr(), out.data_ptr(),
                                backend.stream_ptr(z.device))
    backend.check_launch(err, "encode_pack")
    backend.launches["encode_pack"] += 1
    return out
