"""Plain PyTorch versions of the §4.4 Bernoulli wire kernels.

The port of ``repro.kernels.bernoulli_wire.ref``.  Two jobs: the path a CPU
tensor takes (:mod:`.ops` dispatches here for CPU tensors), and the
versions the CUDA kernels (``csrc/bernoulli_wire.cu``) are held against
bit for bit.  Every function here runs on any device.

Support semantics (must never drift — peers regenerate them from seeds):
``sent = uniform(key, (d,)) < p`` compared as f32; the j-th sent
coordinate (support rank j) occupies value slot j; ranks ≥ cap are dropped
by both sides symmetrically (≈6σ tail, ``comm_cost.bernoulli_capacity``).

Beyond the reference's functions this module has :class:`Support`, the
count phase of a (shard) decode: per-(peer, 1024-chunk) support counts and
the support bits packed 32 to a word, exactly the layout the CUDA count
kernel writes.  The §12 count exchange sums its counts, and the shard
decode reads its bits — neither needs the (n, ds) bool matrix that the
reference's ``support_shard`` builds.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.kernels.threefry import ref as tf_ref

CHUNK = 1024        # coordinates per count block (the CUDA block)
WORDS = CHUNK // 32  # support words per chunk


class Support(NamedTuple):
    """Count phase of a decode over a window of ds coordinates.

    counts: (n, nchunks) int32 support counts per 1024-coordinate chunk;
    mask: (n, nchunks·32) int32 support bits, word g holding window
    coordinates [32g, 32g + 32) with bit b = coordinate 32g + b.
    """

    counts: torch.Tensor
    mask: torch.Tensor
    ds: int


def num_chunks(ds: int) -> int:
    return -(-ds // CHUNK)


def coefficients(p: float):
    """The f32 scalars of the Eq. (1) rescale ``x·(1/p) − ((1−p)/p)·μ``:
    (p, 1/p, (1−p)/p), each rounded once to f32 on the host — the values
    the reference's encode and kernel multiply by."""
    p32 = np.float32(p)
    return float(p32), float(np.float32(1.0) / p32), float(np.float32((1.0 - p) / p))


def rank_select(values, sent, cap: int):
    """(cap,) f32 with values[j] of each sent coordinate at its support rank;
    ranks ≥ cap dropped, unfilled slots 0.0."""
    pos = torch.cumsum(sent.to(torch.int64), 0) - 1
    keep = sent & (pos < cap)
    out = torch.zeros(cap, dtype=torch.float32, device=values.device)
    out[pos[keep]] = values[keep]
    return out


def encode(flat, key, p: float, cap: int, mu, *, scaled: bool = True):
    """One node's (cap,) Bernoulli value buffer (no μ tail, f32): support
    from the node key, Eq. (1) rescale (or, ``scaled=False``, the raw values
    of the error-feedback twin, −0.0 kept), rank-ordered compaction."""
    d = flat.shape[0]
    p32, inv_p, c = coefficients(p)
    dev = flat.device
    u = tf_ref.uniform(key, d, dev)
    sent = u < torch.tensor(p32, dtype=torch.float32, device=dev)
    if not scaled:
        return rank_select(flat, sent, cap)
    mu = torch.as_tensor(mu, dtype=torch.float32, device=dev)
    vals = (flat * torch.tensor(inv_p, dtype=torch.float32, device=dev)
            - torch.tensor(c, dtype=torch.float32, device=dev) * mu)
    return rank_select(vals, sent, cap)


def decode_one(buf, key, p: float, cap: int, mu, d: int):
    """Reconstruct one peer's dense (d,) Y_i from its (cap,) value buffer."""
    dev = buf.device
    u = tf_ref.uniform(key, d, dev)
    sent = u < torch.tensor(np.float32(p).item(), dtype=torch.float32, device=dev)
    pos = torch.cumsum(sent.to(torch.int64), 0) - 1
    valid = sent & (pos < cap)
    vals = buf[pos.clamp(0, cap - 1)]
    return torch.where(valid, vals, torch.as_tensor(mu, dtype=torch.float32, device=dev))


def decode_sum_sequential(bufs, mus, keys, p: float, cap: int, d: int, acc0: float = 0.0):
    """Peer-sequential Σ_i reconstruction_i from an accumulator of ``acc0``
    (+0.0: the averaging decode) — the accumulation order the decode kernel
    reproduces; caller divides by n.  From −0.0 at n = 1 it equals
    :func:`decode_one` bit for bit (−0 + y = y for every f32 y)."""
    acc = torch.full((d,), acc0, dtype=torch.float32, device=bufs.device)
    for i in range(bufs.shape[0]):
        acc = acc + decode_one(bufs[i], keys[i], p, cap, mus[i], d)
    return acc


def support_shard(keys, p: float, d: int, start: int, ds: int, device=None):
    """(n, ds) bool support slice [start, start + ds) of every peer's (d,)
    draw; lanes past d are False.  One peer at a time, so the int64 cipher
    temporaries are (ds,), not (n, ds)."""
    idx = start + torch.arange(ds, dtype=torch.int64, device=device)
    real = idx < d
    idxc = torch.where(real, idx, torch.zeros_like(idx))
    p32 = torch.tensor(np.float32(p).item(), dtype=torch.float32, device=device)
    keys = torch.as_tensor(keys).reshape(-1, 2)
    return torch.stack([(tf_ref.uniform_at(k, idxc, d) < p32) & real for k in keys])


def pack_bits(sent):
    """(n, 32·m) bool → (n, m) int32 words, bit b of word g = column 32g + b."""
    n, m32 = sent.shape
    shifts = torch.arange(32, dtype=torch.int64, device=sent.device)
    words = (sent.reshape(n, m32 // 32, 32).to(torch.int64) << shifts).sum(-1)
    return torch.where(words >= (1 << 31), words - (1 << 32), words).to(torch.int32)


def unpack_bits(mask):
    """Inverse of :func:`pack_bits`: (n, m) int32 → (n, 32·m) bool."""
    n, m = mask.shape
    shifts = torch.arange(32, dtype=torch.int64, device=mask.device)
    bits = ((mask.to(torch.int64) & 0xFFFFFFFF)[..., None] >> shifts) & 1
    return bits.reshape(n, 32 * m).to(torch.bool)


def support_counts(keys, p: float, d: int, start: int, ds: int, device=None):
    """The count phase over [start, start + ds): a :class:`Support`."""
    sent = support_shard(keys, p, d, start, ds, device)
    n = sent.shape[0]
    nck = num_chunks(ds)
    counts, masks = [], []
    for i in range(n):
        row = torch.zeros(1, nck * CHUNK, dtype=torch.bool, device=sent.device)
        row[0, :ds] = sent[i]
        counts.append(row.reshape(nck, CHUNK).sum(-1, dtype=torch.int32))
        masks.append(pack_bits(row)[0])
    return Support(torch.stack(counts), torch.stack(masks), int(ds))


def decode_sum_shard(bufs, mus, support: Support, prior, cap: int):
    """Σ_i reconstruction_i restricted to the support's window, as (ds,) f32.

    ``prior``: (n,) support counts of each peer strictly before the window.
    Rank = prior + within-window cumsum − 1; ranks ≥ cap and unsent lanes
    (window lanes past d included) fall back to μ_i.  Peers are added in
    ascending order into a zero accumulator.
    """
    acc = torch.zeros(support.ds, dtype=torch.float32, device=bufs.device)
    for i in range(bufs.shape[0]):
        sent = unpack_bits(support.mask[i:i + 1])[0, :support.ds]
        pos = int(prior[i]) + torch.cumsum(sent.to(torch.int64), 0) - 1
        valid = sent & (pos < cap)
        vals = bufs[i][pos.clamp(0, cap - 1)]
        acc = acc + torch.where(valid, vals, mus[i])
    return acc


def decode_sum(bufs, mus, keys, p: float, cap: int, d: int):
    """Σ_i reconstruction_i as (d,) f32: the shard decode of the whole
    vector (start 0, prior 0).  Caller divides by n."""
    sup = support_counts(keys, p, d, 0, d, bufs.device)
    prior = torch.zeros(bufs.shape[0], dtype=torch.int32, device=bufs.device)
    return decode_sum_shard(bufs, mus, sup, prior, cap)
