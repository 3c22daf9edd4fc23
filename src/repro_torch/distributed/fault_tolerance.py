"""Fault tolerance and straggler mitigation — port of
``repro.distributed.fault_tolerance`` (the reference's docs/DESIGN.md §5,
§14).

The aggregation pieces live where they run: the survivors-only exact mean
(:func:`repro_torch.core.collectives.partial_mean`), the robust decode
policies (:mod:`repro_torch.core.wire.robust`) and the decode-time drop
mask of :func:`repro_torch.core.collectives.compressed_mean`.  This module
adds the simulation and forensics half:

  * :class:`FailurePlan` — the deterministic failure schedule, and the
    producer of drop masks;
  * :func:`robust_mean` / :func:`robust_compressed_mean` — one exact or
    compressed round with the plan's mask;
  * :func:`replay_support` — a dropped peer's seed-trick support rebuilt
    from its fold_in chain alone;
  * :func:`corrupt_wire_row` and :class:`ByzantineComm` — one Byzantine
    peer's wire row, and a communicator that delivers it in place of the
    honest one.

The draws follow the reference's Threefry stream in its non-partitionable
layout (:mod:`repro_torch.random`), so a plan drops the same peers here as
there.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch import random as prandom
from repro_torch import resolve_device
from repro_torch.core import comm_cost, rotation
from repro_torch.core import types as t
from repro_torch.core.collectives import compressed_mean, partial_mean
from repro_torch.core.wire import base as wire_base
from repro_torch.core.wire import codecs as wire_codecs
from repro_torch.core.wire import ef as wire_ef
from repro_torch.core.wire import registry as wire_registry
from repro_torch.core.wire import rotated as wire_rotated
from repro_torch.kernels.fixed_k_encode import ops as fk


def survivor_index(u):
    """The never-kill-everyone survivor of a failure draw ``u``: the first
    index attaining max(u), as a 0-dim int64 tensor on u's device.  It is
    also the node the threshold rule ``u >= rate`` kills last, so forcing
    it alive changes nothing until a draw kills everyone."""
    u = torch.as_tensor(u)
    return torch.argmax((u == torch.max(u)).to(torch.uint8))


@dataclasses.dataclass(frozen=True)
class FailurePlan:
    """Deterministic failure schedule: node i is down at step t iff its
    uniform of ``fold_in(PRNGKey(seed), t)`` is below ``rate`` (one node,
    :func:`survivor_index`, always lives)."""
    rate: float = 0.0
    seed: int = 0

    def _draw(self, step: int, n: int, device=None):
        """THE (n,) boolean alive draw every view derives from."""
        key = prandom.fold_in(prandom.PRNGKey(self.seed), step)
        u = prandom.uniform(key, (n,), resolve_device(device))
        alive = u >= torch.tensor(self.rate, dtype=torch.float32, device=u.device)
        return alive | (torch.arange(n, device=u.device) == survivor_index(u))

    def alive_mask(self, step: int, n: int, device=None):
        """The (n,) bool alive mask of ``step``."""
        return self._draw(step, n, device)

    def drop_mask(self, step: int, n: int, device=None):
        """The same draw as an (n,) f32 0/1 mask, the ``drop_mask`` form of
        :func:`compressed_mean` (1 = keep the peer's row)."""
        return self._draw(step, n, device).to(torch.float32)

    def local_alive(self, step: int, comm, device=None, axes=None):
        """The (L,) f32 0/1 entries of the communicator's local rows: over
        ``axes`` (the codec axes: the drop unit is the cross-host peer, each
        row takes its codec rank's entry) when given, else over all ranks."""
        _, n = wire_base.axis_rank_size(comm, axes)
        mask = self.drop_mask(step, n, device)
        return torch.stack([mask[r] for r in wire_base.ranks_over(comm, axes)])


def robust_mean(x, step: int, comm, plan: FailurePlan):
    """The exact mean of the (L, *shape) stack over the ranks the plan left
    alive this step."""
    alive = plan.local_alive(step, comm, x.device)
    return partial_mean(x * alive.reshape((-1,) + (1,) * (x.dim() - 1)), alive, comm)


def robust_compressed_mean(x, key, cfg: t.CompressionConfig, step: int,
                           plan: FailurePlan, comm):
    """One compressed round with the plan's drop mask: the wire runs at full
    strength, the decode leaves out the peers the plan killed this step and
    renormalizes over the survivors, under whatever ``cfg.decode_policy``
    says (trimming applies to the kept rows)."""
    _, n = wire_base.axis_rank_size(comm, cfg.axes)
    return compressed_mean(x, key, cfg, comm, drop_mask=plan.drop_mask(step, n, x.device))


# --------------------------------------------------------------------------- #
# Seed-trick support replay (forensics for dropped peers).
# --------------------------------------------------------------------------- #

@dataclasses.dataclass(frozen=True)
class ReplaySupport:
    """A peer's wire support, rebuilt in the WIRE basis.

    ``dim``     — the basis' length: d, or ``rotation.padded_dim(d)`` for a
                  rotated codec (the support is drawn on rotated coordinates);
    ``support`` — (dim,) bool: the coordinates the encoder sampled;
    ``kept``    — (dim,) bool: those whose values made the buffer (the
                  Bernoulli wire drops support ranks ≥ its capacity);
    ``slot``    — (dim,) int32: the buffer's value slot of each kept
                  coordinate, −1 elsewhere.
    """
    dim: int
    support: torch.Tensor
    kept: torch.Tensor
    slot: torch.Tensor


def _bernoulli_replay(cfg, kenc, dim: int, device) -> ReplaySupport:
    p = float(cfg.encoder.fraction)
    cap = comm_cost.bernoulli_capacity(dim, p)
    sent = prandom.uniform(kenc, (dim,), device) < torch.tensor(p, dtype=torch.float32,
                                                                device=device)
    pos = torch.cumsum(sent.to(torch.int32), 0, dtype=torch.int32) - 1
    kept = sent & (pos < cap)
    slot = torch.where(kept, pos, -1)
    return ReplaySupport(dim=dim, support=sent, kept=kept, slot=slot)


def _fixed_k_replay(cfg, kenc, dim: int, device) -> ReplaySupport:
    nb = fk.num_blocks(dim)
    kb = wire_codecs.fixed_k_blocks(dim, cfg.encoder.fraction)
    ids = fk.sample_blocks(kenc, nb, kb, device)
    hit = torch.zeros(nb, dtype=torch.bool, device=device)
    hit[ids] = True
    # a sampled block's value slots follow its rank among the sorted ids
    rank_of = torch.full((nb,), -1, dtype=torch.int32, device=device)
    rank_of[ids] = torch.arange(kb, dtype=torch.int32, device=device)
    support = hit.repeat_interleave(fk.BLOCK)[:dim]
    off = torch.arange(dim, dtype=torch.int32, device=device) % fk.BLOCK
    slot = torch.where(support, rank_of.repeat_interleave(fk.BLOCK)[:dim] * fk.BLOCK + off, -1)
    return ReplaySupport(dim=dim, support=support, kept=support, slot=slot)


def replay_support(cfg: t.CompressionConfig, key, peer: int, d: int,
                   device=None) -> ReplaySupport:
    """Peer ``peer``'s seed-trick support, rebuilt from the key chain alone
    (the §4.4 seed trick: ``pack`` draws it from ``fold_in(key, peer)``,
    as every surviving peer's ``unpack`` regenerates it), the Bernoulli
    wire's capacity-overflow drops included.

    Error feedback delegates to its inner codec (the twin rides the same
    format and chain); a rotated codec replays the inner support in rotated
    space at ``rotation.padded_dim(d)``; ``fixed_k_shared`` replays the
    shared, unfolded key.  Codecs whose occupancy depends on the data (the
    bit planes, the dense simulation) raise ValueError.
    """
    device = resolve_device(device)
    codec = wire_registry.resolve(cfg)
    dim = d
    while True:
        if isinstance(codec, wire_ef.EFCodec):
            codec = codec.inner
        elif isinstance(codec, wire_rotated.RotatedCodec):
            dim = rotation.padded_dim(dim)
            codec = codec.inner
        else:
            break
    if isinstance(codec, wire_codecs.BernoulliCodec):
        return _bernoulli_replay(cfg, prandom.fold_in(key, peer), dim, device)
    if isinstance(codec, wire_codecs.FixedKSharedCodec):
        return _fixed_k_replay(cfg, key, dim, device)
    if isinstance(codec, wire_codecs.FixedKGatherCodec):
        return _fixed_k_replay(cfg, prandom.fold_in(key, peer), dim, device)
    raise ValueError(f"codec {codec.name!r} has no seed-derivable support to replay "
                     "(data-dependent occupancy: bit-plane and dense wires)")


# --------------------------------------------------------------------------- #
# Adversarial wire rows (the Byzantine test matrix).
# --------------------------------------------------------------------------- #

CORRUPTION_MODES = ("nan", "inf", "sign_flip", "boost")

_SIGN = -(1 << 31)           # the f32 sign bit, as an int32
_QUIET = 1 << 22             # the f32 quiet-NaN bit
_EXP = 0xFF << 23            # the f32 exponent field


def corrupt_wire_row(row, mode: str):
    """One Byzantine peer's wire buffer: ``row`` corrupted, same shape and
    dtype.  "nan" and "inf" flood it, "sign_flip" negates it, "boost"
    scales it by 1000.  Integer plane buffers are corrupted as the f32
    values their words spell, so the corruption travels through the
    unmodified unpack like honest bytes; bf16 and f32 rows go through f32
    and back.

    Every device gives the reference's (x86) bits: the NaN and Inf fills
    are rounded to the row's dtype on the host (a bf16 conversion on the
    device writes its own NaN), and the word arithmetic is spelled out:
    the negation flips the sign bit, 1000·NaN returns that NaN quieted
    (the card would return its canonical NaN, and may negate a NaN as it
    likes), and a denormal is read as a zero of its sign (the reference's
    CPU flushes denormal inputs; the card keeps them).
    """
    if mode not in CORRUPTION_MODES:
        raise ValueError(f"unknown corruption mode {mode!r}; have {CORRUPTION_MODES}")
    fill = {"nan": float("nan"), "inf": float("inf")}.get(mode)
    if row.dtype.is_floating_point:
        if fill is not None:            # the fill value is rounded on the host
            return torch.full_like(row, fill)
        x = row.to(torch.float32)
        return (-x if mode == "sign_flip" else 1000.0 * x).to(row.dtype)
    words = row.view(torch.int32)
    if fill is not None:
        out = torch.full_like(words.view(torch.float32), fill).view(torch.int32)
    elif mode == "sign_flip":
        out = words ^ _SIGN
    else:
        x = words.view(torch.float32)
        out = torch.where(torch.isnan(x), words | _QUIET, (1000.0 * x).view(torch.int32))
        out = torch.where((words & _EXP) == 0, words & _SIGN, out)
    return out.view(row.dtype)


class ByzantineComm:
    """A communicator whose first all_gather — the packed wire rows of a
    round — delivers :func:`corrupt_wire_row` of rank ``rank``'s row to
    every receiver, so the corruption lands between pack and decode.  Every
    other call, and the byte counters, are ``comm``'s own.

    Over a mesh, ``rank`` is a codec rank: the views over the codec axes
    (:meth:`over`) share the one pending corruption, and the inner axes'
    traffic (the pre-reduce, the shard gather) stays honest."""

    def __init__(self, comm, rank: int, mode: str, _pending=None):
        if mode not in CORRUPTION_MODES:
            raise ValueError(f"unknown corruption mode {mode!r}; have {CORRUPTION_MODES}")
        self.comm, self.rank, self.mode = comm, int(rank), mode
        self.size, self.local_ranks = comm.size, comm.local_ranks
        self.axes = getattr(comm, "axes", None)
        self._pending = _pending if _pending is not None else [True]

    def all_gather(self, local):
        out = self.comm.all_gather(local)
        if self._pending[0]:
            self._pending[0] = False
            out = out.clone()
            out[self.rank] = corrupt_wire_row(out[self.rank], self.mode)
        return out

    def psum(self, local):
        return self.comm.psum(local)

    def over(self, axes, inner: bool = False):
        sub = wire_base.view(self.comm, axes, inner)
        if inner:
            return sub
        return ByzantineComm(sub, self.rank, self.mode, self._pending)

    def mean_over(self, x, axes):
        return self.comm.mean_over(x, axes)

    def ranks_over(self, axes):
        return wire_base.ranks_over(self.comm, axes)

    def pick(self, state, axes):
        return self.comm.pick(state, axes)

    def spread(self, rows, state, axes):
        return self.comm.spread(rows, state, axes)
