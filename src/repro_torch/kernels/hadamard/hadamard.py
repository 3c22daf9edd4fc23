"""ctypes wrapper of the Hopper Walsh–Hadamard kernel (``csrc/hadamard.cu``).

Replaces ``fwht_pallas`` (``repro/kernels/hadamard/hadamard.py:57``): the
unnormalised transform of each row of a (B, c) f32 tensor, c a power of two
≤ 2²⁰, bit-equal to the butterfly of :mod:`.ref` (not to the TPU kernel's
Kronecker matmuls; see the source's header).  A register-radix butterfly:
one pass up to c = 2¹³, two beyond, run by one persistent kernel that keeps
a row's intermediate in L2 between them.  Counted as ``fwht`` in
:data:`repro_torch.kernels.backend.launches`.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import backend

_LIB = "hadamard"
_P = ctypes.c_void_p
MAX_D = 1 << 20


_SIGS = {"hd_fwht": ([_P, _P, ctypes.c_int64, ctypes.c_int64, _P, _P], ctypes.c_int),
         "hd_scratch_bytes": ([ctypes.c_int64, ctypes.c_int64], ctypes.c_int64)}


def _fn(name: str = "hd_fwht"):
    f = getattr(backend.lib(_LIB), name)
    if f.argtypes is None:
        f.argtypes, f.restype = _SIGS[name]
    return f


def aligned(x):
    """x itself if its data is 16-byte aligned (the kernels load float4),
    else an aligned copy."""
    return x if x.data_ptr() % 16 == 0 else x.clone()


def scratch(nbytes: int, device):
    """A per-call scratch of ``nbytes`` (at least 8) for the kernel's
    ticket, counters and partials; the C entry point zeroes what needs it."""
    return torch.empty(max(8, nbytes), dtype=torch.uint8, device=device)


def check_rows(x, name: str):
    """(B, c) f32 contiguous CUDA rows with c a power of two ≤ MAX_D."""
    backend.check(x, name, torch.float32)
    if x.dim() != 2 or x.shape[0] < 1:
        raise ValueError(f"{name}: expected a non-empty (B, c) tensor, got {tuple(x.shape)}")
    c = x.shape[1]
    if c < 1 or c & (c - 1) or c > MAX_D:
        raise ValueError(f"{name}: row length must be a power of two ≤ {MAX_D}, got {c}")
    return x.shape


def fwht(x, out=None):
    """(B, c) f32 CUDA → (B, c) f32, the unnormalised WHT of each row; into
    ``out`` if given (which may be x itself: the transform in place)."""
    b, c = check_rows(x, "x")
    if out is None:
        x = aligned(x)
        out = torch.empty_like(x)
    else:
        backend.check(out, "out", torch.float32, (b, c))
        if x.data_ptr() % 16 or out.data_ptr() % 16:
            raise ValueError("fwht into out: x and out must be 16-byte aligned")
    work = scratch(_fn("hd_scratch_bytes")(b, c), x.device)
    err = _fn()(x.data_ptr(), out.data_ptr(), b, c, work.data_ptr(),
                backend.stream_ptr(x.device))
    backend.check_launch(err, "fwht")
    backend.launches["fwht"] += 1
    return out
