"""ctypes wrapper of the Hopper flash-attention forward
(``csrc/flash_attention.cu``).

:func:`flash_attention_fwd` replaces ``flash_attention_fwd``
(``repro/kernels/flash_attention/flash_attention.py:121``) and is counted as
``flash_attention_fwd`` in :data:`repro_torch.kernels.backend.launches`.
It takes CUDA tensors only, in the model's (B, S, H, hd) layout (the
reference kernel takes (B, H, S, hd)), checks them, allocates ``o`` and
``lse`` with ``torch.empty``, launches on PyTorch's current stream and
raises on a nonzero ``cudaGetLastError``.  bf16 runs the ``mma.sync``
kernel, f32 the SIMT one; tiles are 64 × 64 whatever the caller's block
sizes.  Design and bound are in the source's header comment.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import backend

_LIB = "flash_attention"
_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_SIG = [_P, _P, _P, _P, _P, _I64, _I64, _I64, _I64, _I64, _I64, _I64, ctypes.c_int, _I64,
        ctypes.c_float, ctypes.c_int, _P]
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (64, 128)


def _fn():
    f = backend.lib(_LIB).fa_fwd
    if f.argtypes is None:
        f.argtypes = _SIG
        f.restype = ctypes.c_int
    return f


def flash_attention_fwd(q, k, v, *, causal: bool = True, window: Optional[int] = None,
                        q_offset: int = 0):
    """q: (B, Sq, Hq, hd); k, v: (B, Sk, Hkv, hd), CUDA, one dtype (f32 or
    bf16), hd 64 or 128, Hq % Hkv == 0 → (o (B, Sq, Hq, hd) in q's dtype,
    lse (B, Hq, Sq) f32)."""
    if q.dtype not in DTYPES:
        raise ValueError(f"q: expected float32 or bfloat16, got {q.dtype}")
    if q.dim() != 4 or k.dim() != 4:
        raise ValueError(f"expected 4-D q, k, v; got {tuple(q.shape)}, {tuple(k.shape)}")
    b, sq, hq, hd = q.shape
    _, sk, hkv, _ = k.shape
    backend.check(q, "q", q.dtype)
    backend.check(k, "k", q.dtype, (b, sk, hkv, hd))
    backend.check(v, "v", q.dtype, (b, sk, hkv, hd))
    if hd not in HEAD_DIMS:
        raise ValueError(f"head dim must be one of {HEAD_DIMS}, got {hd}")
    if min(b, sq, sk, hkv) < 1 or hq % hkv:
        raise ValueError(f"bad shapes q {tuple(q.shape)}, k {tuple(k.shape)}")
    if q_offset < 0 or (window is not None and window < 1):
        raise ValueError(f"q_offset must be ≥ 0 and window ≥ 1; got {q_offset}, {window}")
    o = torch.empty_like(q)
    lse = torch.empty((b, hq, sq), dtype=torch.float32, device=q.device)
    err = _fn()(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
                b, sq, sk, hq, hkv, hd, q_offset, int(bool(causal)),
                0 if window is None else window, hd ** -0.5, DTYPES[q.dtype],
                backend.stream_ptr(q.device))
    backend.check_launch(err, "flash_attention_fwd")
    backend.launches["flash_attention_fwd"] += 1
    return o, lse
