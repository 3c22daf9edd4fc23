"""ctypes wrappers of the Hopper flash-attention kernels
(``csrc/flash_attention.cu``, ``csrc/flash_attention_bwd.cu``).

* :func:`flash_attention_fwd` replaces ``flash_attention_fwd``
  (``repro/kernels/flash_attention/flash_attention.py:121``);
* :func:`flash_attention_bwd_dkv` and :func:`flash_attention_bwd_dq`
  replace the two sweeps of ``flash_attention_bwd`` (the ``pallas_call`` at
  ``:280``, dK/dV, and at ``:318``, dQ).

Each is counted under its own name in
:data:`repro_torch.kernels.backend.launches`, and at hd 32 (lm-8m, the
training example's model), hd 16 (the smoke configs of the training CLI
and the serving example) and hd 120 (h2o-danube-3-4b) under that name with
``_hd32``, ``_hd16`` or ``_hd120`` appended: there the bf16 kernels run on
tiles of whole 64-column boxes (64 columns, or 128 at hd 120) whose columns
past hd TMA zero-fills, so their time and bound are their own.  They take CUDA tensors only,
in the model's (B, S, H, hd) layout (the reference kernels take
(B, H, S, hd)), check them, allocate their outputs with ``torch.empty``,
launch on PyTorch's current stream and raise on a nonzero
``cudaGetLastError``.  In bf16 they are the Hopper kernels (TMA tile rings,
``wgmma``; the forward over 128 × 128 tiles, the dK/dV sweep 128 keys against
64-row q tiles, the dQ sweep 128 q rows against 64-key tiles), which read q,
k, v and do by TMA and so refuse tensors that do not start on a 16-byte
boundary; f32 runs the SIMT kernels (64 × 64), whatever the caller's block
sizes.  hd is 16, 32, 64, 120 or 128.  Design and bound are in the sources' header
comments.
"""
from __future__ import annotations

import ctypes
from typing import Optional

import torch

from repro_torch.kernels import backend

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_I = ctypes.c_int
# shapes (b, sq, sk, hq, hkv, hd, q_offset), causal, window, scale, dtype, stream
_TAIL = [_I64] * 7 + [_I, _I64, ctypes.c_float, _I, _P]
_SIGS = {("flash_attention", "fa_fwd"): [_P] * 5 + _TAIL,
         ("flash_attention_bwd", "fa_bwd_dkv"): [_P] * 8 + _TAIL,
         ("flash_attention_bwd", "fa_bwd_dq"): [_P] * 7 + _TAIL}
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
HEAD_DIMS = (16, 32, 64, 120, 128)


def _fn(lib: str, name: str):
    f = getattr(backend.lib(lib), name)
    if f.argtypes is None:
        f.argtypes = _SIGS[(lib, name)]
        f.restype = ctypes.c_int
    return f


def _check(q, k, v, q_offset: int, window: Optional[int]):
    """Validate q, k, v (and the mask options); returns (b, sq, sk, hq, hkv,
    hd)."""
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
    return b, sq, sk, hq, hkv, hd


def launch_name(base: str, hd: int) -> str:
    """The name a launch at head dim ``hd`` is counted under: the instances
    whose tiles are wider than hd (16 and 32 on the hd-64 tiles, 120 on the
    hd-128 tiles) carry their head dim."""
    return base if hd in (64, 128) else f"{base}_hd{hd}"


def _check_aligned(*tensors):
    """bf16 tensors are read by TMA, which needs 16-byte aligned starts."""
    if tensors[0].dtype == torch.bfloat16 and any(t.data_ptr() % 16 for t in tensors):
        raise ValueError("bf16 q, k, v (and do) must start on 16-byte boundaries (TMA)")


def _tail(q, shape, q_offset, causal, window):
    hd = shape[-1]
    return (*shape, q_offset, int(bool(causal)), 0 if window is None else window, hd ** -0.5,
            DTYPES[q.dtype], backend.stream_ptr(q.device))


def flash_attention_fwd(q, k, v, *, causal: bool = True, window: Optional[int] = None,
                        q_offset: int = 0):
    """q: (B, Sq, Hq, hd); k, v: (B, Sk, Hkv, hd), CUDA, one dtype (f32 or
    bf16), hd 16, 32, 64, 120 or 128, Hq % Hkv == 0 → (o (B, Sq, Hq, hd) in q's dtype,
    lse (B, Hq, Sq) f32)."""
    shape = _check(q, k, v, q_offset, window)
    _check_aligned(q, k, v)
    b, sq, _, hq = shape[:4]
    o = torch.empty_like(q)
    lse = torch.empty((b, hq, sq), dtype=torch.float32, device=q.device)
    err = _fn("flash_attention", "fa_fwd")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(), lse.data_ptr(),
        *_tail(q, shape, q_offset, causal, window))
    name = launch_name("flash_attention_fwd", shape[-1])
    backend.check_launch(err, name)
    backend.launches[name] += 1
    return o, lse


def _check_bwd(q, k, v, do, lse, delta):
    b, sq, hq, _ = q.shape
    backend.check(do, "do", q.dtype, q.shape)
    _check_aligned(q, k, v, do)
    backend.check(lse, "lse", torch.float32, (b, hq, sq))
    backend.check(delta, "delta", torch.float32, (b, hq, sq))


def flash_attention_bwd_dkv(q, k, v, do, lse, delta, *, causal: bool = True,
                            window: Optional[int] = None, q_offset: int = 0):
    """The dK/dV sweep.  q, do: (B, Sq, Hq, hd); k, v: (B, Sk, Hkv, hd), CUDA,
    one dtype (f32 or bf16); lse (the forward's) and delta = rowsum(do · o):
    (B, Hq, Sq) f32 → (dk, dv) (B, Sk, Hkv, hd) f32."""
    shape = _check(q, k, v, q_offset, window)
    _check_bwd(q, k, v, do, lse, delta)
    dk = torch.empty(k.shape, dtype=torch.float32, device=k.device)
    dv = torch.empty_like(dk)
    err = _fn("flash_attention_bwd", "fa_bwd_dkv")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), dk.data_ptr(), dv.data_ptr(), *_tail(q, shape, q_offset, causal, window))
    name = launch_name("flash_attention_bwd_dkv", shape[-1])
    backend.check_launch(err, name)
    backend.launches[name] += 1
    return dk, dv


def flash_attention_bwd_dq(q, k, v, do, lse, delta, *, causal: bool = True,
                           window: Optional[int] = None, q_offset: int = 0):
    """The dQ sweep; arguments as :func:`flash_attention_bwd_dkv` → dq
    (B, Sq, Hq, hd) f32."""
    shape = _check(q, k, v, q_offset, window)
    _check_bwd(q, k, v, do, lse, delta)
    dq = torch.empty(q.shape, dtype=torch.float32, device=q.device)
    err = _fn("flash_attention_bwd", "fa_bwd_dq")(
        q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(), lse.data_ptr(),
        delta.data_ptr(), dq.data_ptr(), *_tail(q, shape, q_offset, causal, window))
    name = launch_name("flash_attention_bwd_dq", shape[-1])
    backend.check_launch(err, name)
    backend.launches[name] += 1
    return dq
