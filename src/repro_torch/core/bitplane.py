"""Packed bit-plane wire formats for binary / ternary quantization — port of
``repro.core.bitplane``.

Every buffer is one flat vector of 32-bit words (``torch.int32`` holding
the reference's uint32 bit patterns, so the bytes are the reference's), and
one bucket still costs one collective.

``binary`` (Example 4; 1 bit per coordinate):
  [plane: ceil(d/32) words, bit j of word j//32 at offset j%32 is 1 iff
  Y(j) = X^max ‖ (vmin, vmax) at wire precision r: ceil(2r/32) words].

``ternary`` (Eq. (21); 2 bits per coordinate + pass-through values):
  [plane: ceil(2d/32) words of 2-bit branch symbols (0 → c1, 1 → c2,
  2 → pass-through) ‖ cap pass-through values in support-rank order:
  ceil(cap·r/32) words ‖ (c1, c2): ceil(2r/32) words].

Tail floats ride as f32 bit patterns, or two 16-bit halves per word with
element 2i in the low half.  Pass-through ranks ≥ cap are dropped by the
encoder and decoded as (c1 + c2)/2, symmetrically.  Sampling is
:mod:`repro_torch.core.encoders` (the reference's streams), so pack →
unpack gives the dense encoder's Y_i at f32 wire precision.

The word-aligned shard decode (§13) snaps shard boundaries to whole words
(32 coordinates per word of the 1-bit plane, 16 of the 2-bit plane), so
each shard reads one contiguous word window of every peer's plane.  Peers
fold in ascending order, as in the sequential flat decode, bit for bit.
"""
from __future__ import annotations

import torch

from repro_torch.core import encoders
from repro_torch.core import types as t
from repro_torch.kernels.bernoulli_wire import ref as bw_ref
from repro_torch.kernels.bitplane import ops as bp_ops
from repro_torch.kernels.bitplane.ref import to_int32

WORD = 32
_WIRE_DTYPES = {"bfloat16": torch.bfloat16, "float16": torch.float16,
                "float32": torch.float32}


def torch_dtype(wire_dtype) -> torch.dtype:
    """The torch dtype of a config's wire dtype name."""
    if isinstance(wire_dtype, torch.dtype):
        return wire_dtype
    if wire_dtype not in _WIRE_DTYPES:
        raise ValueError(f"unsupported wire dtype {wire_dtype!r}")
    return _WIRE_DTYPES[wire_dtype]


def wire_bits(wire_dtype) -> int:
    """Bits per wire float (r): 32 for float32, 16 for bfloat16/float16."""
    return torch_dtype(wire_dtype).itemsize * 8


def float_words(count: int, wire_dtype) -> int:
    """32-bit words carrying ``count`` floats at wire precision."""
    return -(-count * wire_bits(wire_dtype) // WORD)


def floats_to_words(v, wire_dtype):
    """(m,) floats → (float_words(m),) int32 words at wire precision: the
    f32 bit patterns, or each value rounded to the 16-bit wire dtype and
    two halves packed per word, element 2i in the low half."""
    v = v.reshape(-1).to(torch.float32)
    dt = torch_dtype(wire_dtype)
    if dt == torch.float32:
        return v.contiguous().view(torch.int32)
    h = v.to(dt).view(torch.int16).to(torch.int64) & 0xFFFF
    h = torch.nn.functional.pad(h, (0, h.shape[0] % 2)).reshape(-1, 2)
    return to_int32(h[:, 0] | (h[:, 1] << 16))


def words_to_floats(w, count: int, wire_dtype):
    """Inverse of :func:`floats_to_words`; returns (count,) f32."""
    w = w.reshape(-1)
    dt = torch_dtype(wire_dtype)
    if dt == torch.float32:
        return w[:count].contiguous().view(torch.float32)
    w = w[:-(-count // 2)].to(torch.int64) & 0xFFFFFFFF
    halves = torch.stack([w & 0xFFFF, w >> 16], dim=-1).reshape(-1)[:count]
    halves = torch.where(halves >= 1 << 15, halves - (1 << 16), halves)
    return halves.to(torch.int16).view(dt).to(torch.float32)


def rank_scatter(values, sent, cap: int):
    """(cap,) f32: ``values[j]`` of each sent coordinate at its support
    rank, ranks ≥ cap dropped, unfilled slots 0 — the capacity-padded value
    segment shared with the Bernoulli §4.4 buffer."""
    return bw_ref.rank_select(values.to(torch.float32), sent, cap)


def topcap_mask(scores, cap: int):
    """(d,) bool membership of the ``cap`` largest of the non-negative f32
    ``scores`` (ties → lowest index): the set ``top_k`` picks.

    The cap-th largest score is found by an MSB-first bisection on the f32
    bit patterns, which order like the values for scores ≥ 0.  The
    reference bisects over all 32 bits of the uint32 pattern; torch has no
    uint32 compare, so the patterns are compared as int32 and the
    bisection starts at bit 30.  That is exact: no score has its sign bit
    set (|v − v̄| is +0.0 or positive), so the reference's step at bit 31
    counts no pattern ≥ 2³¹ and keeps its threshold 0 (for cap ≥ 1), and
    every pattern lies in [0, 2³¹), where the int32 order is the uint32
    order.  (As int32, 1 << 31 is negative: a step there would count every
    score.)  At cap = 0 both pick nothing.  Ties at the threshold go to the
    lowest indices by a cumulative count of the patterns equal to it.
    """
    bits = scores.to(torch.float32).contiguous().view(torch.int32)
    thr = 0
    for b in range(30, -1, -1):
        cand = thr | (1 << b)
        if int(torch.count_nonzero(bits >= cand)) >= cap:
            thr = cand
    above = bits > thr
    need_ties = cap - int(torch.count_nonzero(above))
    is_tie = bits == thr
    tie_rank = torch.cumsum(is_tie, 0, dtype=torch.int32)
    return above | (is_tie & (tie_rank <= need_ties))


# --------------------------------------------------------------------------- #
# Binary: 1-bit plane + (vmin, vmax) tail.
# --------------------------------------------------------------------------- #

def binary_wire_words(d: int, wire_dtype) -> int:
    """Total words of one node's binary wire buffer."""
    return bp_ops.num_words(d, 1) + float_words(2, wire_dtype)


def binary_words(bits, c_lo, c_hi, wire_dtype):
    """THE binary buffer: [packed 1-bit plane ‖ (c_lo, c_hi)]."""
    plane = bp_ops.pack_bits(bits, 1)
    tail = floats_to_words(torch.stack([c_lo, c_hi]), wire_dtype)
    return torch.cat([plane, tail])


def binary_pack(flat, key, wire_dtype):
    """Encode (d,) f32 → (binary_wire_words(d),) int32 wire buffer, the
    stochastic rounding of :func:`encoders.encode_binary`."""
    enc = encoders.encode_binary(key, flat)
    return binary_words(enc.support, enc.extras["vmin"], enc.extras["vmax"], wire_dtype)


def _centers(row, start: int, wire_dtype):
    """The (c_lo, c_hi) tail of one row, from word ``start`` on, as f32."""
    return words_to_floats(row[start:], 2, wire_dtype)


def binary_unpack(buf, d: int, wire_dtype):
    """The dense (d,) f32 Y_i of one node's binary buffer."""
    pw = bp_ops.num_words(d, 1)
    bits = bp_ops.unpack_bits(buf[:pw], 1, d)
    c = _centers(buf, pw, wire_dtype)
    return torch.where(bits > 0, c[1], c[0])


# --------------------------------------------------------------------------- #
# Ternary: 2-bit plane + capacity-padded values + (c1, c2) tail.
# --------------------------------------------------------------------------- #

def ternary_wire_words(d: int, cap: int, wire_dtype) -> int:
    """Total words of one node's ternary wire buffer."""
    return (bp_ops.num_words(d, 2) + float_words(cap, wire_dtype)
            + float_words(2, wire_dtype))


def ternary_words(sym, vbuf, c1, c2, wire_dtype):
    """THE ternary buffer: [2-bit plane ‖ values ‖ (c1, c2)]."""
    plane = bp_ops.pack_bits(sym, 2)
    return torch.cat([plane, floats_to_words(vbuf, wire_dtype),
                      floats_to_words(torch.stack([c1, c2]), wire_dtype)])


def ternary_pack(flat, key, p_pass: float, cap: int, wire_dtype, probs: str = "uniform"):
    """Encode (d,) f32 → (ternary_wire_words(d, cap),) int32 wire buffer:
    the Eq. (21) encoder with c1 = min, c2 = max and the uniform or
    §6-optimal split, its branch symbols on the plane and its pass-through
    values at their support ranks."""
    enc = encoders.encode(key, flat.to(torch.float32),
                          t.EncoderSpec(kind="ternary", fraction=p_pass, probs=probs))
    sym = enc.extras["branch"]
    vbuf = rank_scatter(enc.y, sym == 2, cap)
    return ternary_words(sym, vbuf, enc.extras["c1"], enc.extras["c2"], wire_dtype)


def _ternary_values(sym, prior, vals, c, cap: int):
    """One peer's dense ternary Y over a symbol window whose first
    pass-through has global rank ``prior``."""
    sent = sym == 2
    pos = torch.cumsum(sent, 0, dtype=torch.int32) + (prior - 1)
    valid = sent & (pos < cap)
    v = torch.index_select(vals, 0, pos.clamp(0, cap - 1))
    fallback = 0.5 * (c[0] + c[1])        # symmetric 6σ-overflow substitute
    return torch.where(sym == 0, c[0],
                       torch.where(sym == 1, c[1], torch.where(valid, v, fallback)))


def ternary_unpack(buf, d: int, cap: int, wire_dtype):
    """The dense (d,) f32 Y_i of one node's ternary buffer."""
    pw = bp_ops.num_words(d, 2)
    vw = float_words(cap, wire_dtype)
    sym = bp_ops.unpack_bits(buf[:pw], 2, d)
    vals = words_to_floats(buf[pw:pw + vw], cap, wire_dtype)
    return _ternary_values(sym, 0, vals, _centers(buf, pw + vw, wire_dtype), cap)


# --------------------------------------------------------------------------- #
# Word-aligned shard decode (§13).
# --------------------------------------------------------------------------- #

BINARY_ALIGN = WORD           # 1-bit plane: 32 coordinates per word
TERNARY_ALIGN = WORD // 2     # 2-bit plane: 16 coordinates per word


def _plane_window(plane, nshards: int, ws: int, w0: int):
    """(n, pw) plane words → the (n, ws) word window starting at word w0,
    words past pw zero (the reference pads to nshards·ws words first).

    A window inside the plane is a view of ``plane`` (rows strided, no
    copy); only a window that runs past pw is copied, with its zero tail.
    """
    n, pw = plane.shape
    if w0 + ws <= pw:
        return plane[:, w0:w0 + ws]
    win = torch.zeros((n, ws), dtype=plane.dtype, device=plane.device)
    m = max(0, pw - w0)
    win[:, :m] = plane[:, w0:w0 + m]
    return win


def binary_decode_shard(rows, d: int, wire_dtype, start: int, ds: int, nshards: int):
    """Σ over peers of the binary Y_i on coordinates [start, start + ds),
    zero past d: one fused unpack + select + accumulate over the
    (n, ds/32) word window (``bp_ops.binary_accum``).  ``ds`` is
    32-aligned (``scatter_shard_len(d, nshards, BINARY_ALIGN)``)."""
    pw = bp_ops.num_words(d, 1)
    win = _plane_window(rows[:, :pw], nshards, ds // WORD, start // WORD)
    c = torch.stack([_centers(r, pw, wire_dtype) for r in rows])
    total = bp_ops.binary_accum(win, c[:, 0], c[:, 1], ds)
    total[max(0, d - start):] = 0.0
    return total


def ternary_shard_syms(rows, d: int, start: int, ds: int, nshards: int):
    """Every peer's 2-bit symbols on coordinates [start, start + ds) as
    (n, ds) uint8; symbols past d are 0 (the plane's zero padding).

    This is the unpack (w = 2) of the (n, ds/16) word window read row-major,
    so it runs the unpack kernel once for all peers on the card.  ``ds`` is
    16-aligned (``scatter_shard_len(d, nshards, TERNARY_ALIGN)``).
    """
    n = rows.shape[0]
    pw = bp_ops.num_words(d, 2)
    win = _plane_window(rows[:, :pw], nshards, ds // TERNARY_ALIGN, start // TERNARY_ALIGN)
    return bp_ops.unpack_bits(win.contiguous(), 2, n * ds).reshape(n, ds)


def ternary_decode_shard(rows, syms, prior, d: int, cap: int, wire_dtype, start: int):
    """Σ over peers of the ternary Y_i on this shard's window, zero past d.

    ``syms`` is the (n, ds) window of :func:`ternary_shard_syms`; ``prior``
    (n,) int32 holds each peer's pass-through count before ``start`` (the
    per-shard counts exchange), which offsets the window's ranks to the
    global support ranks of the flat decode.  Peers fold in ascending order.
    """
    n, ds = syms.shape
    pw = bp_ops.num_words(d, 2)
    vw = float_words(cap, wire_dtype)
    acc = torch.zeros(ds, dtype=torch.float32, device=rows.device)
    for i in range(n):
        vals = words_to_floats(rows[i, pw:pw + vw], cap, wire_dtype)
        c = _centers(rows[i], pw + vw, wire_dtype)
        acc = acc + _ternary_values(syms[i], prior[i], vals, c, cap)
    acc[max(0, d - start):] = 0.0
    return acc
