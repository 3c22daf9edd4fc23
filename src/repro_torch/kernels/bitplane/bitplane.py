"""ctypes wrappers of the Hopper bit-plane kernels (``csrc/bitplane.cu``).

Each wrapper takes CUDA tensors only, checks device, dtype, shape and
contiguity, allocates its output with ``torch.empty``, launches on
PyTorch's current stream, raises on a nonzero ``cudaGetLastError`` and adds
one to its launch count in :data:`repro_torch.kernels.backend.launches`:

* :func:`pack_bits` — ``bitplane_pack`` (replaces ``pack_bits_2d``);
* :func:`unpack_bits` — ``bitplane_unpack`` (``unpack_bits_2d``);
* :func:`binary_accum` — ``bitplane_binary_accum`` (``binary_accum_2d``).

The kernels read the unpadded buffers and mask the ragged end themselves.
Design, bit-exactness and bound are in the source's header comment.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import backend
from repro_torch.kernels.bitplane import ref

_LIB = "bitplane"
_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_SIGS = {
    "bp_pack": [_P, ctypes.c_int, _I64, ctypes.c_int, _P, _P],
    "bp_unpack": [_P, _I64, ctypes.c_int, _P, ctypes.c_int, _P],
    "bp_binary_accum": [_P, _I64, ctypes.c_int, _P, _P, _I64, _P, _P],
}


def _fn(name: str):
    f = getattr(backend.lib(_LIB), name)
    if f.argtypes is None:
        f.argtypes = _SIGS[name]
        f.restype = ctypes.c_int
    return f


def _width(width: int) -> int:
    if width not in ref.WIDTHS:
        raise ValueError(f"width must be one of {ref.WIDTHS}, got {width}")
    return width


def pack_bits(sym, width: int):
    """(d,) uint8 or int32 CUDA symbols (bool viewed as uint8) → the
    (num_words(d, width),) int32 words."""
    _width(width)
    if sym.dtype == torch.bool:
        sym = sym.view(torch.uint8)
    if sym.dtype not in (torch.uint8, torch.int32):
        raise ValueError(f"sym: expected uint8 or int32 symbols, got {sym.dtype}")
    backend.check(sym, "sym", sym.dtype)
    if sym.dim() != 1 or sym.shape[0] < 1:
        raise ValueError(f"sym: expected a non-empty 1-D tensor, got {tuple(sym.shape)}")
    d = sym.shape[0]
    out = torch.empty(ref.num_words(d, width), dtype=torch.int32, device=sym.device)
    err = _fn("bp_pack")(sym.data_ptr(), sym.element_size(), d, width, out.data_ptr(),
                         backend.stream_ptr(sym.device))
    backend.check_launch(err, "bit-plane pack")
    backend.launches["bitplane_pack"] += 1
    return out


def unpack_bits(words, width: int, d: int):
    """(nw,) int32 CUDA words, nw ≥ num_words(d, width) → (d,) symbols of
    ``ref.symbol_dtype(width)``."""
    _width(width)
    backend.check(words, "words", torch.int32)
    if words.dim() != 1 or d < 1 or words.shape[0] < ref.num_words(d, width):
        raise ValueError(f"words: expected a 1-D tensor of at least "
                         f"{ref.num_words(d, width)} words for d={d}, got {tuple(words.shape)}")
    out = torch.empty(d, dtype=ref.symbol_dtype(width), device=words.device)
    err = _fn("bp_unpack")(words.data_ptr(), d, width, out.data_ptr(), out.element_size(),
                           backend.stream_ptr(words.device))
    backend.check_launch(err, "bit-plane unpack")
    backend.launches["bitplane_unpack"] += 1
    return out


def binary_accum(words, c_lo, c_hi, d: int):
    """(n, nw) int32 CUDA plane windows (rows may be strided, words
    contiguous), (n,) f32 centers → the (d,) f32 peer sum."""
    backend.check(words, "words", torch.int32, contiguous=False)
    if words.dim() != 2 or words.stride(1) != 1 or d < 1:
        raise ValueError("words: expected (n, nw) with contiguous rows and d ≥ 1")
    n, nw = words.shape
    if nw < ref.num_words(d, 1) or n < 1:
        raise ValueError(f"words: need n ≥ 1 rows of ≥ {ref.num_words(d, 1)} words, "
                         f"got {tuple(words.shape)}")
    backend.check(c_lo, "c_lo", torch.float32, (n,))
    backend.check(c_hi, "c_hi", torch.float32, (n,))
    out = torch.empty(d, dtype=torch.float32, device=words.device)
    err = _fn("bp_binary_accum")(words.data_ptr(), words.stride(0), n, c_lo.data_ptr(),
                                 c_hi.data_ptr(), d, out.data_ptr(),
                                 backend.stream_ptr(words.device))
    backend.check_launch(err, "bit-plane binary accumulate")
    backend.launches["bitplane_binary_accum"] += 1
    return out
