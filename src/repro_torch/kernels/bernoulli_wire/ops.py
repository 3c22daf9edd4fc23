"""Dispatch for the Bernoulli wire kernels — port of ``repro.kernels
.bernoulli_wire.ops``.

The rule is :func:`repro_torch.kernels.backend.use_plain`: tensors on the
CPU take the plain versions (:mod:`.ref`); tensors on a CUDA device take
the Hopper kernels (:mod:`.kernel`), which raise on what they do not take.
No environment switch and no fallback.  ``p``, ``cap`` and ``d`` are plain
Python values from the compression config.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import backend
from repro_torch.kernels.bernoulli_wire import kernel, ref
from repro_torch.kernels.bernoulli_wire.ref import Support  # noqa: F401  (re-export)


def encode(flat, key, p: float, cap: int, mu, *, scaled: bool = True):
    """(d,) f32 + rank-folded (2,) key → (cap,) f32 wire value buffer: the
    Eq. (1) values, or the raw ones (``scaled=False``, the error-feedback
    twin)."""
    mu = torch.as_tensor(mu, dtype=torch.float32, device=flat.device)
    if backend.use_plain(flat):
        return ref.encode(flat, key, p, cap, mu, scaled=scaled)
    return kernel.encode(flat, key, mu, p=p, cap=cap, scaled=scaled)


def unpack(buf, mu, key, p: float, cap: int, d: int):
    """One peer's dense (d,) reconstruction from its (cap,) value buffer, its
    μ (0-dim) and its rank-folded key, bit for bit (signed zeros included):
    the plain :func:`ref.decode_one` on the CPU, the flat decode kernel at
    n = 1 from a −0.0 accumulator on the card."""
    if backend.use_plain(buf, mu):
        return ref.decode_one(buf, key, p, cap, mu, d)
    return kernel.decode_sum(buf.reshape(1, -1), mu.reshape(1), torch.as_tensor(key).reshape(1, 2),
                             p=p, cap=cap, d=d, acc0=-0.0)


def decode_sum(bufs, mus, keys, p: float, cap: int, d: int):
    """(n, cap) buffers + (n,) μ + (n, 2) keys → Σ_i recon_i as (d,) f32.
    Caller divides by n."""
    if backend.use_plain(bufs, mus):
        return ref.decode_sum(bufs, mus, keys, p, cap, d)
    return kernel.decode_sum(bufs, mus, keys, p=p, cap=cap, d=d)


def support_counts(keys, p: float, d: int, start: int, ds: int, device):
    """Count phase over the window [start, start + ds) of every peer's
    support: per-chunk counts and support bits (:class:`ref.Support`).
    The codec sums the counts for the §12 rank-offset exchange, and the
    shard decode reuses the bits."""
    if torch.device(device).type == "cpu":
        return ref.support_counts(keys, p, d, start, ds, device)
    return kernel.support_counts(keys, p=p, d=d, start=start, ds=ds,
                                 device=device)


def decode_sum_shard(bufs, mus, support: Support, prior, *, cap: int):
    """Shard-restricted Σ_i reconstruction_i as (ds,) f32.  ``prior``: (n,)
    int32 support counts strictly before the window."""
    if backend.use_plain(bufs, mus, prior):
        return ref.decode_sum_shard(bufs, mus, support, prior, cap)
    return kernel.decode_sum_shard(bufs, mus, support, prior, cap=cap)
