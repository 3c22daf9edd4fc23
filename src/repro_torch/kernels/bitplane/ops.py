"""Bit-plane pack / unpack / binary accumulate for any length — port of
``repro.kernels.bitplane.ops``.

Dispatch (:func:`repro_torch.kernels.backend.use_plain`): a CPU tensor takes
the plain version (:mod:`.ref`), a CUDA tensor the Hopper kernel
(:mod:`.bitplane`) or an error.  Both give the same words and symbols, so
wire buffers are portable across devices.  Unlike the reference's wrapper,
nothing is padded to a tile: the kernels mask the ragged end themselves.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import backend
from repro_torch.kernels.bitplane import bitplane as _kernel
from repro_torch.kernels.bitplane import ref as _ref

WIDTHS = _ref.WIDTHS
num_words = _ref.num_words


def pack_bits(vals, width: int):
    """Pack (any-shape) symbols < 2**width — bool, uint8 or int32 (uint32
    bit patterns) — into (ceil(n·width/32),) int32 words, ref.py layout."""
    flat = vals.reshape(-1)
    if backend.use_plain(flat):
        return _ref.pack_bits(flat, width)
    return _kernel.pack_bits(flat.contiguous(), width)


def unpack_bits(words, width: int, d: int):
    """Inverse of :func:`pack_bits`: (nw,) int32 words → (d,) symbols."""
    flat = words.reshape(-1)
    if backend.use_plain(flat):
        return _ref.unpack_bits(flat, width, d)
    return _kernel.unpack_bits(flat.contiguous(), width, d)


def binary_accum(words, c_lo, c_hi, d: int):
    """Fold n peers' (n, nw) 1-bit plane windows and per-peer centers into
    one (d,) f32 peer sum, peers added in ascending order — the fused
    unpack + accumulate of the §13 scatter decode."""
    c_lo = c_lo.to(torch.float32).contiguous()
    c_hi = c_hi.to(torch.float32).contiguous()
    if backend.use_plain(words, c_lo, c_hi):
        return _ref.binary_accum(words, c_lo, c_hi, d)
    return _kernel.binary_accum(words, c_lo, c_hi, d)
