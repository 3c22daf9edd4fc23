"""Robust decode reductions — port of ``repro.core.wire.robust``:
coordinate-wise f-of-n order statistics over the (n, d') stack of per-peer
reconstructions the gather codecs already hold at decode time (the
reference's docs/DESIGN.md §14).  A decode policy or a drop mask costs
nothing on the wire.

  * ``mean``      — the masked ascending-peer average
    ``where(keep_i > 0, acc + Y_i, acc)`` from +0.0, then divided by Σ keep
    (a 0-dim f32 tensor on the data's device): bit for bit a loop over the
    surviving peers only.  ``acc + keep_i·Y_i`` would add a dropped row as
    +0.0, which flips −0.0 and lets NaN and Inf rows through.
  * ``trim(f)``   — per coordinate, drop the f largest and the f smallest of
    the m kept values and average the other m − 2f.
  * ``median``    — the mean of the kept values' two middle ranks.
  * ``mean_trim(f)`` — the midpoint of ranks f and m − 1 − f of the kept
    values.

The order is the reference's sort: XLA's comparator ties +0.0 with −0.0
and every NaN with every other NaN, puts the NaNs after all numbers, and
the sort is stable, so tied values keep peer order.  Here each value maps
to an integer key with the same ties (−0.0 read as +0.0, every NaN one
largest key), with dropped rows placed after all kept ones, and one stable
integer sort orders the peers.  An integer sort has a single stable
answer, so the CPU and the card put the same value at every rank; a float
sort would be free to order ±0.0 or the NaNs its own way.  The mask never
leaves its device: rank windows are compared with the kept count m as a
tensor, and nothing is selected on the host.

Sums run in ascending row order from a +0.0 f32 accumulator, as XLA's
``jnp.sum(axis=0)`` adds the n rows on the CPU.  The reduction works on
column chunks of :data:`CHUNK` coordinates (it is coordinate-wise, so the
chunking changes no bit): at the embed bucket (n = 8, d = 388,956,160) the
whole stack's keys and int64 sort indices would take 37 GB more.

When the reduction is undefined (m = 0, or m ≤ 2f for the trimming
policies) the result is NaN, the 0/0 contract of
:func:`repro_torch.core.collectives.partial_mean`.
"""
from __future__ import annotations

import torch

from repro_torch.core import types as t

# the canonical policy parser lives next to the config field it validates
parse_policy = t.parse_decode_policy

# coordinates a chunk of the reduction
CHUNK = 1 << 24

_F32 = torch.float32
# the largest int32 sort keys: every NaN, and above it every dropped row
_NAN_KEY = (1 << 31) - 2
_DROPPED_KEY = (1 << 31) - 1


def is_mean(cfg: t.CompressionConfig) -> bool:
    """True iff ``cfg`` decodes with the plain averaging decoder."""
    return parse_policy(cfg.decode_policy)[0] == "mean"


def sort_key(v):
    """int32 keys of the f32 values ``v`` whose integer order is XLA's sort
    order: −0.0 ties +0.0, every NaN ties every other NaN above +Inf.  A
    negative value's magnitude bits are flipped, so its key falls as the
    value does."""
    bits = (v + 0.0).view(torch.int32)                      # −0.0 + 0.0 = +0.0
    key = torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits)
    return torch.where(torch.isnan(v), _NAN_KEY, key)


def _sorted_kept(stack, keep):
    """Peer-axis sort of the (n, c) chunk with kept rows first: per
    column, ranks 0..m−1 hold the kept values in order, the dropped rows'
    values follow.  ``keep`` is an (n,) f32 0/1 tensor or None."""
    key = sort_key(stack)
    if keep is not None:
        key = torch.where((keep <= 0)[:, None], _DROPPED_KEY, key)
    idx = torch.sort(key, dim=0, stable=True).indices
    return torch.gather(stack, 0, idx)


def _reduce_chunk(stack, kind: str, f: int, keep, m, nan):
    n = stack.shape[0]
    if kind == "mean":
        acc = torch.zeros(stack.shape[1:], dtype=_F32, device=stack.device)
        for i in range(n):
            acc = acc + stack[i] if keep is None else torch.where(keep[i] > 0, acc + stack[i], acc)
        return acc / m
    s = _sorted_kept(stack, keep)
    if kind == "trim":
        cnt = m - 2.0 * f
        acc = torch.zeros(stack.shape[1:], dtype=_F32, device=stack.device)
        for i in range(n):
            w = (i >= f) & (i < m - f)
            acc = acc + torch.where(w, s[i], 0.0)
        return torch.where(cnt > 0, acc / cnt, nan)
    mi = m.to(torch.int32)
    if kind == "median":
        lo, hi = torch.div(mi - 1, 2, rounding_mode="floor"), torch.div(mi, 2, rounding_mode="floor")
        guard = mi > 0
    else:                               # mean_trim: the extreme survivors' midpoint
        lo, hi = torch.full_like(mi, f), mi - 1 - f
        guard = mi > 2 * f

    def take(r):
        r = torch.clamp(r, 0, n - 1).to(torch.int64).reshape(1, 1).expand(1, s.shape[1])
        return torch.gather(s, 0, r)[0]

    est = 0.5 * (take(lo) + take(hi))
    return torch.where(guard, est, nan)


def reduce_rows(stack, kind: str, f: int, keep=None):
    """One robust reduction over the (n, d') per-peer reconstruction stack:
    the (d',) f32 estimate, NaN where it is undefined.

    ``kind`` and ``f`` come from :func:`parse_policy`; ``keep`` is an
    optional (n,) 0/1 alive mask (1 = keep the peer's row), moved to the
    stack's device if it is not there.
    """
    if kind not in ("mean", "trim", "median", "mean_trim"):
        raise ValueError(f"unknown robust reduction kind {kind!r}")
    stack = stack.to(_F32)
    n, d = stack.shape
    dev = stack.device
    if keep is None:
        m = torch.full((), float(n), dtype=_F32, device=dev)
    else:
        keep = torch.as_tensor(keep).to(device=dev, dtype=_F32)
        m = torch.sum(keep)             # 0/1 values: exact in any order
    nan = torch.full((), float("nan"), dtype=_F32, device=dev)
    out = torch.empty(d, dtype=_F32, device=dev)
    for c0 in range(0, d, CHUNK):
        c1 = min(c0 + CHUNK, d)
        out[c0:c1] = _reduce_chunk(stack[:, c0:c1], kind, f, keep, m, nan)
    return out
