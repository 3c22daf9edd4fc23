"""Compressed mean estimation as a collective — port of
``repro.core.collectives`` and of the ``shard_map`` axes it runs inside.

In the reference these functions run inside ``jax.shard_map`` with the
compression axes manual.  Here a communicator stands in for the axes:

* :class:`StackedComm` — n ranks as the rows of a leading dimension on one
  device: the card's counterpart of the reference's fake CPU devices.  It
  runs each rank's pack and each shard's decode in turn; all_gather is the
  stack itself; psum accumulates in f32 in rank order.
* :class:`DistComm` — the same interface over ``torch.distributed`` (one
  rank per process): ``all_gather_into_tensor`` and ``all_reduce``; its
  psum of a buffer narrower than f32 gathers the rows and sums them as
  StackedComm does, so the two give the same bits at every n.

Both count the bytes handed to them, so a run can hold the traffic against
the codecs' ``wire_bits`` / ``scatter_bits`` accounting.

Local data is a stack (L, *shape) with one row per local rank; every entry
point returns the single (*shape) estimate all ranks hold.  Codec state
(:func:`compressed_mean_stateful`, the error-feedback residual) is a stack
of the same layout and stays local.
"""
from __future__ import annotations

import torch

from repro_torch import resolve_device
from repro_torch.core import types as t
from repro_torch.core.wire import base as wire_base
from repro_torch.core.wire import registry


class StackedComm:
    """n ranks stacked on one device; see the module docstring.

    ``bytes_gathered`` / ``bytes_reduced`` count every byte the ranks hand
    to all_gather / psum (all n contributions).
    """

    def __init__(self, n: int, device=None):
        self.size = int(n)
        self.local_ranks = tuple(range(self.size))
        self.device = resolve_device(device)
        self.bytes_gathered = 0
        self.bytes_reduced = 0

    def reset_bytes(self) -> None:
        self.bytes_gathered = 0
        self.bytes_reduced = 0

    def _check(self, local):
        if local.shape[0] != self.size:
            raise ValueError(f"expected {self.size} stacked rank rows, got {local.shape[0]}")

    def all_gather(self, local):
        """(n, ...) rows of all ranks → the same (n, ...) stack."""
        self._check(local)
        self.bytes_gathered += local.numel() * local.element_size()
        return local

    def psum(self, local):
        """Σ over ranks of the (n, ...) rows, accumulated in f32 from 0 in
        rank order."""
        self._check(local)
        self.bytes_reduced += local.numel() * local.element_size()
        return _rank_order_sum(local)


def _rank_order_sum(rows):
    """Σ of the (n, ...) rows in f32, from 0, in rank order."""
    acc = torch.zeros(rows.shape[1:], dtype=torch.float32, device=rows.device)
    for r in range(rows.shape[0]):
        acc += rows[r]
    return acc


class DistComm:
    """One rank per process over ``torch.distributed`` (any backend with
    all_gather_into_tensor and all_reduce: NCCL on cards, gloo on CPUs).

    ``psum`` of a buffer narrower than f32 (the fixed-k wire's bf16)
    gathers every rank's buffer and sums the rows in f32 from 0 in rank
    order, as :meth:`StackedComm.psum` does: the same bits at every n,
    where a bf16 all-reduce rounds each partial sum in the backend's
    order.  Each rank then receives (n − 1)·|buf| against a ring
    all-reduce's 2(n − 1)/n·|buf|.  An f32 buffer (the exact mean, the dense
    simulation) is all-reduced in f32: gathering n full f32 gradients would
    cost n× the memory.  ``bytes_*`` count this rank's contributions, the
    buffer it hands over.
    """

    def __init__(self, group=None, device=None):
        import torch.distributed as dist

        self._dist = dist
        self.group = group
        self.size = dist.get_world_size(group)
        self.rank = dist.get_rank(group)
        self.local_ranks = (self.rank,)
        self.device = resolve_device(device)
        self.bytes_gathered = 0
        self.bytes_reduced = 0

    def reset_bytes(self) -> None:
        self.bytes_gathered = 0
        self.bytes_reduced = 0

    def _gather(self, local):
        if local.shape[0] != 1:
            raise ValueError(f"DistComm holds one rank; got {local.shape[0]} rows")
        local = local.contiguous()
        out = torch.empty((self.size,) + tuple(local.shape[1:]), dtype=local.dtype,
                          device=local.device)
        self._dist.all_gather_into_tensor(out, local, group=self.group)
        return out

    def all_gather(self, local):
        """(1, ...) local row → (n, ...) rows of all ranks in rank order."""
        out = self._gather(local)
        self.bytes_gathered += local.numel() * local.element_size()
        return out

    def psum(self, local):
        if local.shape[0] != 1:
            raise ValueError(f"DistComm holds one rank; got {local.shape[0]} rows")
        self.bytes_reduced += local.numel() * local.element_size()
        if local.element_size() < 4:
            return _rank_order_sum(self._gather(local))
        buf = local[0].clone()
        self._dist.all_reduce(buf, group=self.group)
        return buf.to(torch.float32)


def exact_mean(x, comm):
    """The exact mean over ranks of the (L, *shape) stack (f32 psum / n)."""
    shape, dtype = x.shape[1:], x.dtype
    flat = x.reshape(x.shape[0], -1).to(torch.float32)
    return wire_base.divide(comm.psum(flat), comm.size).reshape(shape).to(dtype)


def _masked_exact_mean(x, drop_mask, comm):
    """The exact mean over the ranks the (n,) ``drop_mask`` keeps: the
    :func:`partial_mean` contract (NaN when none is kept)."""
    keep = wire_base.local_keep(drop_mask, comm, x.device).to(x.dtype)
    xk = x * keep.reshape((-1,) + (1,) * (x.dim() - 1))
    return partial_mean(xk, keep, comm).to(x.dtype)


def _exact(x, comm, drop_mask):
    return exact_mean(x, comm) if drop_mask is None else _masked_exact_mean(x, drop_mask, comm)


def compressed_mean(x, key, cfg: t.CompressionConfig, comm, drop_mask=None):
    """Estimate the mean over the communicator's ranks of the (L, *shape)
    stack ``x`` under the configured protocol; returns (*shape).

    Unbiased for every ported codec: E[result] = the exact mean (Lemmas
    3.1/3.3).  Mode "none" and buckets below ``min_compress_size`` take the
    exact mean.  ``drop_mask`` is an optional (n,) 0/1 alive mask over the
    ranks (1 = keep): dropped peers are left out at decode time and the
    estimate renormalizes over the survivors (NaN when none survives); the
    wire payload is unchanged.
    """
    if drop_mask is not None:
        wire_base.check_ported(cfg)
    if cfg.mode == "none" or x[0].numel() < cfg.min_compress_size:
        return _exact(x, comm, drop_mask)
    return registry.resolve(cfg).mean(x, key, cfg, comm, drop_mask)


def compressed_mean_stateful(x, state, key, cfg: t.CompressionConfig, comm, drop_mask=None):
    """One stateful round of the resolved codec over the (L, *shape) stack
    ``x``: returns ((*shape) estimate, new state).

    ``state`` is the (L, ...) local state of the codec (the error-feedback
    residual, one row per local rank), shaped like ``x`` or flat per row;
    it is threaded flat through the codec, updated in place where it is
    already f32 and contiguous, and returned in its own shape.  Stateless
    codecs, mode "none" and buckets below ``min_compress_size`` pass it
    through untouched.  ``drop_mask`` as in :func:`compressed_mean`; a
    dropped rank's residual is still written and re-enters through its own
    later messages.
    """
    if drop_mask is not None:
        wire_base.check_ported(cfg)
    if cfg.mode == "none" or x[0].numel() < cfg.min_compress_size:
        return _exact(x, comm, drop_mask), state
    codec = registry.resolve(cfg)
    shape, dtype = x.shape[1:], x.dtype
    flat = x.reshape(x.shape[0], -1).to(torch.float32)
    st = state.reshape(state.shape[0], -1).to(torch.float32)
    y, st2 = codec.mean_flat_stateful(flat, st, key, cfg, comm, drop_mask)
    return y.reshape(shape).to(dtype), st2.reshape(state.shape).to(state.dtype)


def partial_mean(x, alive, comm):
    """Straggler-tolerant exact mean over the live ranks only.

    ``alive``: (L,) 0/1 per local rank.  All-dead contract: the survivors'
    mean does not exist and the result is NaN (0/0) by design.
    """
    a = alive.to(torch.float32).reshape((-1,) + (1,) * (x.dim() - 1))
    num = comm.psum(x.to(torch.float32) * a)
    den = comm.psum(alive.to(torch.float32).reshape(-1, 1))
    return num / den.reshape(())
