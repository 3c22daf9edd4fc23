"""Plain PyTorch bit-plane pack / unpack / binary accumulate — port of
``repro.kernels.bitplane.ref``.

``pack_bits`` compresses a vector of small unsigned symbols (width w bits
each, w | 32) into 32-bit words, 32/w symbols per word, little-endian
within the word: symbol j lands in word j // (32/w) at bit offset
(j % (32/w))·w.  ``unpack_bits`` is the exact inverse.  The binary (w = 1)
and ternary (w = 2) wire paths of :mod:`repro_torch.core.bitplane` ride
these planes.

Types.  Words are ``torch.int32`` holding the uint32 bit patterns of the
reference (torch has few uint32 kernels); their bytes are the reference's
bytes.  Symbols are ``torch.uint8`` for w ≤ 8 and ``torch.int32`` for
w = 16 (:func:`symbol_dtype`); ``pack_bits`` also takes bool, and int32
symbols as uint32 bit patterns.  Symbols are masked to w bits, as the
reference masks them.  The arithmetic runs in int64 on values in
[0, 2³²) and ends as the same 32 bits.

These are the versions a CPU tensor takes (:mod:`.ops`) and the ones the
CUDA kernels (``csrc/bitplane.cu``) are held against bit for bit.
"""
from __future__ import annotations

import torch

WORD = 32
WIDTHS = (1, 2, 4, 8, 16)
SYMBOL_DTYPES = (torch.bool, torch.uint8, torch.int32)


def num_words(d: int, width: int) -> int:
    """32-bit words needed for d symbols of ``width`` bits."""
    assert width in WIDTHS, width
    per = WORD // width
    return -(-d // per)


def symbol_dtype(width: int) -> torch.dtype:
    """The dtype unpacked symbols come in: uint8 up to 8 bits, else int32."""
    assert width in WIDTHS, width
    return torch.uint8 if width <= 8 else torch.int32


def to_int32(words):
    """int64 values in [0, 2³²) → int32 tensors with the same 32 bits."""
    return torch.where(words >= (1 << 31), words - (1 << 32), words).to(torch.int32)


def pack_bits(vals, width: int):
    """(d,) symbols (bool, uint8 or int32) → (num_words(d, width),) int32 words."""
    assert width in WIDTHS, width
    if vals.dtype not in SYMBOL_DTYPES:
        raise ValueError(f"symbols must be one of {SYMBOL_DTYPES}, got {vals.dtype}")
    per = WORD // width
    v = vals.reshape(-1).to(torch.int64) & ((1 << width) - 1)
    v = torch.nn.functional.pad(v, (0, (-v.shape[0]) % per))
    shifts = torch.arange(per, dtype=torch.int64, device=v.device) * width
    # fields are disjoint, so the sum is a bitwise OR (no carries)
    return to_int32((v.reshape(-1, per) << shifts).sum(-1))


def unpack_bits(words, width: int, d: int):
    """(nw,) int32 words → (d,) symbols of :func:`symbol_dtype`; inverse of
    :func:`pack_bits`."""
    assert width in WIDTHS, width
    per = WORD // width
    shifts = torch.arange(per, dtype=torch.int64, device=words.device) * width
    w = words.reshape(-1)[:num_words(d, width)].to(torch.int64) & 0xFFFFFFFF
    vals = (w[:, None] >> shifts) & ((1 << width) - 1)
    return vals.reshape(-1)[:d].to(symbol_dtype(width))


def binary_accum(words, c_lo, c_hi, d: int):
    """Fold n peers' 1-bit plane windows into one (d,) f32 accumulator.

    ``words`` is (n, nw) int32, each row one peer's plane window covering
    ``d`` symbols; ``c_lo``/``c_hi`` are (n,) f32 per-peer centers.
    Returns ``Σ_i where(bit_ij, c_hi[i], c_lo[i])`` with peers added in
    ascending order into a zero f32 accumulator — the add chain of the
    sequential flat decode, so the shard and flat binary decodes agree bit
    for bit.
    """
    acc = torch.zeros(d, dtype=torch.float32, device=words.device)
    for i in range(words.shape[0]):
        bits = unpack_bits(words[i], 1, d)
        acc = acc + torch.where(bits > 0, c_hi[i], c_lo[i])
    return acc
