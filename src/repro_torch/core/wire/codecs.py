"""The wire codecs — port of ``repro.core.wire.codecs``:

* ``fixed_k``        — §4.4 Eq. (9) gather path: block-structured fixed-k
  values + μ tail; supports regenerate from fold_in(key, peer).
* ``fixed_k_shared`` — shared support: one psum of the k-length value
  buffer (reduce kind "psum"); the default train compression.
* ``bernoulli``      — §4.4 Eq. (10) seed trick with capacity-padded value
  buffers and the §12 flat scatter decode.
* ``binary``         — §4.5 Eq. (11) packed 1-bit plane (no seed term: the
  plane travels) with the §13 word-aligned scatter decode.
* ``ternary``        — §7.1 Eq. (21) packed 2-bit plane + capacity-padded
  pass-through values, §13 scatter decode with the pass-through counts
  exchange.
* ``ternary_opt``    — the §6-optimal per-coordinate split on the same wire.
* ``dense``          — dense simulation: encode per node, exact mean of the
  dense f32 encodings (reduce kind "psum"; any encoder).

The PRNG fold_in chains, buffer layouts and op order are the reference's,
so the packed bytes equal the golden wire matrix and the decodes equal the
reference's bit for bit (tests/test_torch_golden_wire.py,
tests/test_torch_collective.py).
"""
from __future__ import annotations

import torch

from repro_torch import random as prandom
from repro_torch.core import bitplane
from repro_torch.core import comm_cost
from repro_torch.core import decoders
from repro_torch.core import encoders
from repro_torch.core import types as t
from repro_torch.core.wire import base
from repro_torch.kernels.bernoulli_wire import ops as bw_ops
from repro_torch.kernels.fixed_k_encode import ops as fk


def _wire_r(cfg: t.CompressionConfig) -> int:
    """r: bits per wire float (16 for bf16, 32 for f32)."""
    return bitplane.wire_bits(cfg.wire_dtype)


def _seed_spec(cfg: t.CompressionConfig) -> t.CommSpec:
    """CommSpec of the §4.4 seed-trick paths at the configured wire dtype."""
    r = _wire_r(cfg)
    return t.CommSpec(protocol="sparse_seed", r_bits=r, rbar_bits=r,
                      rseed_bits=t.DEFAULT_RSEED_BITS)


def _with_tail(vals, mu, cfg):
    """[vals ‖ μ] in the wire dtype, rounding each value once."""
    out = torch.empty(vals.numel() + 1, dtype=bitplane.torch_dtype(cfg.wire_dtype),
                      device=vals.device)
    out[:-1] = vals.reshape(-1)
    out[-1] = mu
    return out


# --------------------------------------------------------------------------- #
# fixed-k (block-structured) — gather + shared-support variants.
# --------------------------------------------------------------------------- #

def fixed_k_blocks(d: int, fraction: float) -> int:
    """kb: number of sampled blocks for a d-vector at the given fraction."""
    nb = fk.num_blocks(d)
    return max(1, min(nb, int(round(fraction * nb))))


def fixed_k_wire_slots(d: int, fraction: float) -> int:
    """Wire-dtype elements of one fixed-k buffer: kb·BLOCK values + μ."""
    return fixed_k_blocks(d, fraction) * fk.BLOCK + 1


def fixed_k_pack(flat, key, cfg, *, scale=None):
    """THE fixed-k wire buffer: [kb·BLOCK values ‖ μ] at the wire dtype.
    ``key`` is the support seed as sampled (the gather codec folds the rank
    in, the shared codec does not).  ``scale=None`` is the unbiased Eq. (4)
    rescale, ``scale=1.0`` the error-feedback twin's raw values (same
    layout: the codecs' unpack and decode take both)."""
    d = flat.shape[0]
    nb = fk.num_blocks(d)
    kb = fixed_k_blocks(d, cfg.encoder.fraction)
    ids = fk.sample_blocks(key, nb, kb, flat.device)
    mu = base.center(flat, cfg.encoder.center)
    vals = fk.fixed_k_encode(flat, ids, mu, scale=scale)
    return _with_tail(vals, mu, cfg)


class FixedKGatherCodec(base.WireCodec):
    """gather_decode fixed-k: independent supports, [values ‖ μ] per node.
    Y = mean μ_i + (1/n) Σ_i scatter(ids_i, vals_i)."""

    name = "fixed_k"
    scatter_supported = True

    def wire_slots(self, d, cfg):
        return fixed_k_wire_slots(d, cfg.encoder.fraction)

    def wire_bits(self, n, d, cfg):
        return float(n * self.wire_slots(d, cfg) * _wire_r(cfg))

    def seed_bits(self, n, cfg):
        return float(n * t.DEFAULT_RSEED_BITS)

    def cost_spec(self, d, cfg):
        k = fixed_k_blocks(d, cfg.encoder.fraction) * fk.BLOCK
        return _seed_spec(cfg), {"k": k}

    def pack(self, flat, key, rank, cfg):
        return fixed_k_pack(flat, prandom.fold_in(key, rank), cfg)

    def unpack(self, row, peer, key, cfg, d):
        # the reference's op chain: the values added onto a zero f32
        # accumulator (so a −0.0 value comes back +0.0), then μ
        row = row.to(torch.float32)
        nb = fk.num_blocks(d)
        kb = fixed_k_blocks(d, cfg.encoder.fraction)
        ids = fk.sample_blocks(prandom.fold_in(key, peer), nb, kb, row.device)
        dense = torch.zeros((nb, fk.BLOCK), dtype=torch.float32, device=row.device)
        dense.index_add_(0, ids, row[:-1].reshape(kb, fk.BLOCK))
        return dense.reshape(-1)[:d] + row[-1]

    def decode_gathered(self, rows, key, cfg, d, n):
        # fused scatter-accumulate: one (nb, BLOCK) accumulator, peers in order
        rows = rows.to(torch.float32)
        nb = fk.num_blocks(d)
        kb = fixed_k_blocks(d, cfg.encoder.fraction)
        all_vals = rows[:, :-1].reshape(n, kb, fk.BLOCK)
        all_mu = rows[:, -1]
        acc = torch.zeros((nb, fk.BLOCK), dtype=torch.float32, device=rows.device)
        for i in range(n):
            ids_i = fk.sample_blocks(prandom.fold_in(key, i), nb, kb, rows.device)
            acc.index_add_(0, ids_i, all_vals[i])
        return (base.divide(acc, n) + decoders.averaging_decoder(all_mu)).reshape(-1)[:d]

    def decode_gathered_shard(self, rows, key, cfg, d, n, shard, nshards):
        # accumulate only the blocks of this shard's ⌈nb/nshards⌉-block
        # window; out-of-window ids land in a dump row that is sliced off,
        # so in-window blocks get the flat decode's adds in the same order.
        rows = rows.to(torch.float32)
        nb = fk.num_blocks(d)
        kb = fixed_k_blocks(d, cfg.encoder.fraction)
        nb_s = -(-nb // nshards)
        all_vals = rows[:, :-1].reshape(n, kb, fk.BLOCK)
        all_mu = rows[:, -1]
        lo = shard * nb_s
        acc = torch.zeros((nb_s + 1, fk.BLOCK), dtype=torch.float32, device=rows.device)
        for i in range(n):
            ids_i = fk.sample_blocks(prandom.fold_in(key, i), nb, kb, rows.device)
            loc = ids_i - lo
            loc = torch.where((loc >= 0) & (loc < nb_s), loc, torch.full_like(loc, nb_s))
            acc.index_add_(0, loc, all_vals[i])
        return (base.divide(acc[:nb_s], n) + decoders.averaging_decoder(all_mu)).reshape(-1)

    def scatter_bits(self, n, d, cfg):
        # flat scatter adds one collective: the decoded f32 shard all_gather
        if not cfg.scatter_decode or cfg.inner_axes:
            return 0.0
        nb_s = -(-fk.num_blocks(d) // n)
        return float(n * nb_s * fk.BLOCK * 32)


class FixedKSharedCodec(base.WireCodec):
    """shared_support fixed-k: one psum of [k wire values ‖ μ] + scatter.
    All nodes draw the same support (``key`` not rank-folded), so the
    averaged values ride a plain psum.  MSE: ``mse.mse_fixed_k_shared``."""

    name = "fixed_k_shared"
    reduce = "psum"

    def wire_slots(self, d, cfg):
        return fixed_k_wire_slots(d, cfg.encoder.fraction)

    def wire_bits(self, n, d, cfg):
        # star-payload convention: n × the reduced buffer
        return float(n * self.wire_slots(d, cfg) * _wire_r(cfg))

    def seed_bits(self, n, cfg):
        return float(n * t.DEFAULT_RSEED_BITS)

    def cost_spec(self, d, cfg):
        k = fixed_k_blocks(d, cfg.encoder.fraction) * fk.BLOCK
        return _seed_spec(cfg), {"k": k}

    def pack(self, flat, key, rank, cfg):
        return fixed_k_pack(flat, key, cfg)

    def decode_reduced(self, wire, key, cfg, d):
        wire = wire.to(torch.float32)
        nb = fk.num_blocks(d)
        kb = fixed_k_blocks(d, cfg.encoder.fraction)
        ids = fk.sample_blocks(key, nb, kb, wire.device)
        gvals = wire[:-1].reshape(-1, fk.BLOCK)
        return fk.fixed_k_decode(gvals, ids, wire[-1], (d,))

    def unpack(self, row, peer, key, cfg, d):
        # shared support: one node's un-reduced buffer decodes like the
        # reduced one, whatever the peer
        return self.decode_reduced(row, key, cfg, d)


# --------------------------------------------------------------------------- #
# Bernoulli (variable-size-support) — the §4.4 seed trick.
# --------------------------------------------------------------------------- #

def bernoulli_wire_slots(d: int, fraction: float) -> int:
    """Wire-dtype elements of one §4.4 Bernoulli buffer: cap values + μ."""
    return comm_cost.bernoulli_capacity(d, float(fraction)) + 1


def bernoulli_pack(flat, key, p: float, cap: int, mu, *, scaled=True):
    """The (cap,) f32 Eq. (1) value buffer: sent coordinates at their
    support rank, overflow ranks dropped (the decoder drops them too).
    ``scaled=False`` ships the raw values (the error-feedback twin); the
    layout is the same, so ``BernoulliCodec.unpack`` decodes both."""
    return bw_ops.encode(flat, key, p, cap, mu, scaled=scaled)


def bernoulli_buffer(flat, key, rank, cfg, *, scaled=True):
    """THE §4.4 Bernoulli wire buffer: [cap value slots ‖ μ] at wire dtype,
    support from fold_in(key, rank); ``scaled`` as in bernoulli_pack."""
    d = flat.shape[0]
    p = float(cfg.encoder.fraction)
    cap = comm_cost.bernoulli_capacity(d, p)
    mu = base.center(flat, cfg.encoder.center)
    buf = bernoulli_pack(flat, prandom.fold_in(key, rank), p, cap, mu, scaled=scaled)
    return _with_tail(buf, mu, cfg)


def _peer_keys(key, n: int):
    return torch.stack([prandom.fold_in(key, i) for i in range(n)])


class BernoulliCodec(base.WireCodec):
    """gather_decode for the uniform-p Bernoulli encoder, real §4.4 wire.
    Each node all_gathers one [cap value slots ‖ μ] buffer; peers regenerate
    the supports from fold_in(key, peer)."""

    name = "bernoulli"
    scatter_supported = True

    def wire_slots(self, d, cfg):
        return bernoulli_wire_slots(d, cfg.encoder.fraction)

    def wire_bits(self, n, d, cfg):
        return float(n * self.wire_slots(d, cfg) * _wire_r(cfg))

    def seed_bits(self, n, cfg):
        return float(n * t.DEFAULT_RSEED_BITS)

    def cost_spec(self, d, cfg):
        cap = comm_cost.bernoulli_capacity(d, float(cfg.encoder.fraction))
        return _seed_spec(cfg), {"cap": cap}

    def pack(self, flat, key, rank, cfg):
        return bernoulli_buffer(flat, key, rank, cfg)

    def unpack(self, row, peer, key, cfg, d):
        # regenerate the peer's support and reconstruct its dense Y_i
        p = float(cfg.encoder.fraction)
        cap = comm_cost.bernoulli_capacity(d, p)
        row = row.to(torch.float32)
        return bw_ops.unpack(row[:-1], row[-1:], prandom.fold_in(key, peer), p, cap, d)

    def decode_gathered(self, rows, key, cfg, d, n):
        # fused regenerate + select + accumulate over all n buffers into one
        # (d,) accumulator — never n dense per-peer reconstructions
        p = float(cfg.encoder.fraction)
        cap = comm_cost.bernoulli_capacity(d, p)
        rows = rows.to(torch.float32)
        total = bw_ops.decode_sum(rows[:, :-1], rows[:, -1].contiguous(),
                                  _peer_keys(key, n), p, cap, d)
        return base.divide(total, n)

    def decode_shards(self, rows, key, cfg, d, n, shards, nshards, comm):
        # §12 reduce-scatter decode over ``nshards`` ⌈d/nshards⌉ windows (n
        # on the flat mesh, n_in under the hierarchical schedule).  Support
        # ranks are global, so each shard needs every peer's support count
        # strictly before its window: the count phase of every local shard
        # runs first, the (nshards, n) table of per-shard counts is
        # all_gathered over the shards' communicator and exclusive-
        # cumsummed, and each shard's decode reuses its count phase's
        # support bits.
        p = float(cfg.encoder.fraction)
        cap = comm_cost.bernoulli_capacity(d, p)
        rows = rows.to(torch.float32)
        bufs, mus = rows[:, :-1], rows[:, -1].contiguous()
        keys = _peer_keys(key, n)
        ds = base.scatter_shard_len(d, nshards)
        sups = [bw_ops.support_counts(keys, p, d, s * ds, ds, rows.device)
                for s in shards]
        counts = torch.stack([s.counts.sum(1, dtype=torch.int32) for s in sups])
        allc = base.gather_nested(counts, comm).reshape(nshards, n)
        prior = torch.cumsum(allc, 0, dtype=torch.int32) - allc
        return torch.stack([
            base.divide(bw_ops.decode_sum_shard(bufs, mus, sup, prior[s].contiguous(),
                                                cap=cap), n)
            for s, sup in zip(shards, sups)])

    def scatter_bits(self, n, d, cfg):
        # flat scatter adds two collectives: the per-shard support counts
        # (n i32 per node) and the decoded f32 shard all_gather
        if not cfg.scatter_decode or cfg.inner_axes:
            return 0.0
        ds = base.scatter_shard_len(d, n)
        return float(n * n * 32 + n * ds * 32)


# --------------------------------------------------------------------------- #
# Binary / ternary packed bit-plane codecs (§4.5 / §7.1).
# --------------------------------------------------------------------------- #

class BinaryCodec(base.WireCodec):
    """gather_decode for binary quantization with the packed 1-bit plane:
    each node all_gathers one [sign plane ‖ vmin, vmax] word buffer."""

    name = "binary"
    scatter_supported = True

    def wire_slots(self, d, cfg):
        return bitplane.binary_wire_words(d, cfg.wire_dtype)

    def wire_bits(self, n, d, cfg):
        return float(n * 32 * self.wire_slots(d, cfg))

    def cost_spec(self, d, cfg):
        return t.CommSpec(protocol="binary", r_bits=_wire_r(cfg)), {"packed": True}

    def pack(self, flat, key, rank, cfg):
        return bitplane.binary_pack(flat, prandom.fold_in(key, rank), cfg.wire_dtype)

    def unpack(self, row, peer, key, cfg, d):
        return bitplane.binary_unpack(row, d, cfg.wire_dtype)

    def scatter_align(self, cfg):
        return bitplane.BINARY_ALIGN

    def decode_gathered_shard(self, rows, key, cfg, d, n, shard, nshards):
        # §13: shards snap to words of the 1-bit plane, and one fused
        # unpack + select + accumulate folds the n peers' word windows
        ds = base.scatter_shard_len(d, nshards, bitplane.BINARY_ALIGN)
        total = bitplane.binary_decode_shard(rows, d, cfg.wire_dtype, shard * ds, ds, nshards)
        return base.divide(total, n)

    def scatter_bits(self, n, d, cfg):
        # flat scatter adds one collective: the decoded f32 shard all_gather
        if not cfg.scatter_decode or cfg.inner_axes:
            return 0.0
        return float(n * base.scatter_shard_len(d, n, bitplane.BINARY_ALIGN) * 32)


class TernaryCodec(base.WireCodec):
    """gather_decode for the ternary encoder (Eq. (21)) with the 2-bit
    plane: [branch plane ‖ cap pass-through value slots ‖ c1, c2] words."""

    name = "ternary"
    scatter_supported = True
    probs = "uniform"

    def _cap(self, d, cfg):
        return comm_cost.bernoulli_capacity(d, float(cfg.encoder.fraction))

    def wire_slots(self, d, cfg):
        return bitplane.ternary_wire_words(d, self._cap(d, cfg), cfg.wire_dtype)

    def wire_bits(self, n, d, cfg):
        return float(n * 32 * self.wire_slots(d, cfg))

    def cost_spec(self, d, cfg):
        return (t.CommSpec(protocol="ternary", r_bits=_wire_r(cfg)),
                {"packed": True, "cap": self._cap(d, cfg)})

    def pack(self, flat, key, rank, cfg):
        d = flat.shape[0]
        return bitplane.ternary_pack(flat, prandom.fold_in(key, rank),
                                     float(cfg.encoder.fraction), self._cap(d, cfg),
                                     cfg.wire_dtype, probs=self.probs)

    def unpack(self, row, peer, key, cfg, d):
        return bitplane.ternary_unpack(row, d, self._cap(d, cfg), cfg.wire_dtype)

    def scatter_align(self, cfg):
        return bitplane.TERNARY_ALIGN

    def decode_shards(self, rows, key, cfg, d, n, shards, nshards, comm):
        # §13 with the §12 count exchange: pass-through slots are addressed
        # by global support rank, so every shard needs each peer's
        # pass-through count before its window.  The symbol windows of all
        # local shards come first, the (nshards, n) table of per-shard counts
        # is all_gathered over the shards' communicator and
        # exclusive-cumsummed, then each shard decodes.
        ds = base.scatter_shard_len(d, nshards, bitplane.TERNARY_ALIGN)
        cap = self._cap(d, cfg)
        syms = [bitplane.ternary_shard_syms(rows, d, s * ds, ds, nshards) for s in shards]
        counts = torch.stack([(sy == 2).sum(1, dtype=torch.int32) for sy in syms])
        allc = base.gather_nested(counts, comm).reshape(nshards, n)
        prior = torch.cumsum(allc, 0, dtype=torch.int32) - allc
        return torch.stack([
            base.divide(bitplane.ternary_decode_shard(rows, sy, prior[s], d, cap,
                                                      cfg.wire_dtype, s * ds), n)
            for s, sy in zip(shards, syms)])

    def scatter_bits(self, n, d, cfg):
        # flat scatter adds two collectives: the per-shard pass-through
        # counts (n i32 per node) and the decoded f32 shard all_gather
        if not cfg.scatter_decode or cfg.inner_axes:
            return 0.0
        ds = base.scatter_shard_len(d, n, bitplane.TERNARY_ALIGN)
        return float(n * n * 32 + n * ds * 32)


class TernaryOptCodec(TernaryCodec):
    """The §6-optimal per-coordinate split (``probs="optimal"``,
    :func:`repro_torch.core.optimal.ternary_optimal_probs`) on the ternary
    wire: the branch choices ride the plane, so decode, capacity and
    accounting are :class:`TernaryCodec`'s."""

    name = "ternary_opt"
    probs = "optimal"


# --------------------------------------------------------------------------- #
# Dense simulation (any encoder).
# --------------------------------------------------------------------------- #

class DenseSimCodec(base.WireCodec):
    """Encode locally, exact mean of the dense encodings (reduce "psum").

    Supports every encoder and is charged naive dense f32 bits.  The wire is
    PINNED to float32 whatever ``cfg.wire_dtype`` says: a narrower psum
    buffer would change the reduce arithmetic.
    """

    name = "dense"
    reduce = "psum"
    WIRE_BITS_PER_SLOT = 32

    def wire_slots(self, d, cfg):
        return d

    def wire_bits(self, n, d, cfg):
        return float(n * d * self.WIRE_BITS_PER_SLOT)

    def cost_spec(self, d, cfg):
        return t.CommSpec(protocol="naive", r_bits=32), {}

    def pack(self, flat, key, rank, cfg):
        kenc = prandom.fold_in(key, rank)
        return encoders.encode(kenc, flat, cfg.encoder).y.to(torch.float32)

    def decode_reduced(self, wire, key, cfg, d):
        return wire

    def unpack(self, row, peer, key, cfg, d):
        return row.to(torch.float32)
