"""WireCodec: the unit of the wire layer — port of ``repro.core.wire.base``.

A codec is one wire format: ``pack`` (one node's buffer), the averaging
decode of the gathered rows (or of the reduced buffer, for "psum" codecs),
``wire_slots`` / ``wire_bits`` accounting and the reduce kind.  The
collective round itself (:meth:`WireCodec.mean_flat`) is the same for every
codec and runs over a communicator instead of ``shard_map`` axes
(:mod:`repro_torch.core.collectives`):

* ``comm.size`` — n, the ranks of the compression axes;
* ``comm.local_ranks`` — the ranks this process holds (all n for
  ``StackedComm``, one for ``DistComm``);
* ``comm.all_gather(local)`` — (L, ...) local rows → (n, ...) in rank order;
* ``comm.psum(local)`` — (L, ...) → the f32 sum over all n ranks;
* with a mesh, ``comm.over(axes)`` — the communicator over a subset of
  its axes, and ``comm.mean_over(x, axes)`` — the exact mean over a subset,
  as the rows of the communicator over the others.

Local data is always a stack with one row per local rank.  Decoded results
are the same on every rank by construction, so a round returns one
estimate, not one per rank.

Ported: the flat round over the compression axes and the §11 two-level
schedule (``cfg.inner_axes``: one exact mean over the inner axes, then the
codec over ``cfg.axes`` at n_eff = n / Π inner sizes, and a scatter decode
sharded over the inner axes), with and without the §12 scatter decode
(§13 word-aligned shards for the packed planes); codec state (the
error-feedback residual, :mod:`.ef`): a state is an (L, *state_shape)
stack, one row per local rank beside ``x``'s rows, threaded through
:meth:`WireCodec.mean_flat_stateful`; and the §14 decode policies and the
decode-time drop mask (:mod:`.robust`).  ``cfg.decode_policy == "mean"``
with no mask keeps each codec's fused decode; a robust policy or a mask
builds the (n, d) stack of per-peer reconstructions (:meth:`decode_rows`)
and reduces it coordinate-wise, in the scatter decode per word-aligned
shard window.  A mask is an (n,) 0/1 tensor over the codec ranks (1 =
keep); the dropped peers' rows still travel, and psum codecs take the
mask-weighted mean of the packed buffers.  Under a hierarchical config the
drop unit is the cross-host peer: the mask has n_eff entries.

Accounting contract: ``comm_cost_bits == wire_bits + seed_bits``.
"""
from __future__ import annotations

from typing import Mapping, Optional, Sequence

import torch

from repro_torch.core import types as t
from repro_torch.core.wire import robust


class NotPortedError(NotImplementedError):
    """A config asks for a part of the reference the port does not have yet;
    the message names the ROADMAP slice that brings it."""


def view(comm, axes, inner: bool = False):
    """The communicator over ``axes`` (``comm.over``); ``inner=True`` counts
    its traffic as inner.  A communicator without a mesh (or without
    ``over``: a test's wrapper) is its own view over any axes."""
    over = getattr(comm, "over", None)
    if over is None:
        if inner:
            raise ValueError("a flat communicator has no inner axes: build it with a mesh")
        return comm
    return over(tuple(axes), inner=inner)


def axis_rank_size(comm, axes=None):
    """The codec ranks this process holds and the node count: over ``axes``
    (the config's compression axes) when given, else over the whole
    communicator."""
    v = comm if axes is None else view(comm, axes)
    return tuple(v.local_ranks), int(v.size)


def ranks_over(comm, axes=None):
    """The rank over ``axes`` of each local row of ``comm`` (its codec rank);
    the local ranks when ``axes`` is None or ``comm`` has no mesh."""
    fn = getattr(comm, "ranks_over", None)
    if axes is None or fn is None:
        return tuple(comm.local_ranks)
    return tuple(fn(tuple(axes)))


def check_mesh(comm, cfg: t.CompressionConfig) -> None:
    """A communicator with a mesh must span ``cfg.inner_axes + cfg.axes``
    exactly; a flat one takes no inner axes."""
    axes = getattr(comm, "axes", None)
    want = tuple(cfg.inner_axes) + tuple(cfg.axes)
    if axes is None:
        if cfg.inner_axes:
            raise ValueError(f"inner_axes={cfg.inner_axes} need a communicator with a mesh "
                             "that names them")
        return
    if set(axes) != set(want) or len(want) != len(set(want)):
        raise ValueError(f"the communicator's axes {axes} are not the config's "
                         f"inner_axes + axes {want}")


def inner_mean(x, cfg: t.CompressionConfig, comm):
    """The (L, d) stack's exact mean over ``cfg.inner_axes``, as the rows of
    the communicator over ``cfg.axes`` (``comm.mean_over``: an f32 sum from
    +0.0 in rank order times f32(1/n_in), the reference's ``pmean`` under
    ``shard_map``); ``x`` itself for a flat config."""
    return comm.mean_over(x, tuple(cfg.inner_axes)) if cfg.inner_axes else x


def scatter_comm(comm, cfg: t.CompressionConfig):
    """The communicator a scatter decode shards over: the inner axes' when
    present (their traffic counted as inner), else the compression axes'."""
    return view(comm, scatter_axes(cfg), inner=bool(cfg.inner_axes))


def divide(x, n: int):
    """``x / n`` as a true f32 division on every device.

    On a CUDA tensor, PyTorch computes ``x / n`` (or ``x /`` a 0-dim CPU
    tensor) as a multiply by the f32 reciprocal, which differs from the
    division unless n is a power of two; the divisor is therefore a 0-dim
    f32 tensor on ``x``'s device.
    """
    return x / torch.full((), float(n), dtype=torch.float32, device=x.device)


def gather_nested(local, comm):
    """all_gather of the local rows over the communicator's ranks."""
    return comm.all_gather(local)


def local_keep(drop_mask, comm, device, axes=None):
    """The (L,) f32 entries of the drop mask for the communicator's local
    rows, each indexed by its rank over ``axes`` (the codec rank; the local
    rank when None), on ``device`` (basic indexing: no index tensor, no
    sync)."""
    m = torch.as_tensor(drop_mask).to(device=device, dtype=torch.float32)
    return torch.stack([m[r] for r in ranks_over(comm, axes)])


def shard_window(stack, start: int, ds: int):
    """Columns [start, start + ds) of the (n, d) stack, zero-padded past d."""
    n, d = stack.shape
    win = stack[:, start:start + ds]
    if win.shape[1] == ds:
        return win
    out = torch.zeros((n, ds), dtype=stack.dtype, device=stack.device)
    out[:, :win.shape[1]] = win
    return out


def scatter_axes(cfg: t.CompressionConfig):
    """The axes a scatter decode shards over: the inner axes when present
    (hierarchical), else the compression axes (flat mesh)."""
    return cfg.inner_axes if cfg.inner_axes else cfg.axes


def scatter_shard_len(d: int, nshards: int, align: int = 1) -> int:
    """Length of one scatter-decode shard: ⌈d/nshards⌉ rounded up to ``align``."""
    ds = -(-d // nshards)
    return -(-ds // align) * align


def scatter_word_align(cfg: t.CompressionConfig) -> int:
    """Shard alignment (coordinates per indivisible wire word) of the codec
    ``cfg`` resolves to: 1 for the linear codecs, 32 for the 1-bit plane, 16
    for the 2-bit plane.  ``scatter_shard_len(d, n, scatter_word_align(cfg))``
    is THE shard split every scatter consumer agrees on."""
    from repro_torch.core.wire import registry
    return registry.resolve(cfg).scatter_align(cfg)


def effective_nodes(cfg: t.CompressionConfig, n: int,
                    mesh_sizes: Optional[Mapping[str, int]] = None) -> int:
    """The codec's effective node count: n for flat configs, the cross-host
    group size n / prod(inner sizes) for hierarchical ones."""
    if not cfg.inner_axes:
        return int(n)
    if mesh_sizes is None:
        raise ValueError(
            f"config has inner_axes={cfg.inner_axes}: accounting needs "
            "mesh_sizes to derive the cross-host group size")
    m = 1
    for ax in cfg.inner_axes:
        if ax not in mesh_sizes:
            raise ValueError(f"inner axis {ax!r} missing from mesh_sizes {mesh_sizes}")
        m *= int(mesh_sizes[ax])
    if m <= 0 or n % m:
        raise ValueError(
            f"world size {n} not divisible by inner-group size {m} "
            f"(inner_axes={cfg.inner_axes}, mesh_sizes={mesh_sizes})")
    return int(n) // m


def tree_sum(x):
    """Σ x in f32 over a fixed pairwise tree: the same adds on every device.

    x is taken as zero-padded to 2^K ≥ d elements; each level adds the upper
    half of its nodes onto the lower half, node i taking node i + 2^(k−1),
    until one node is left.  The padding is never made: a node whose partner
    lies in it passes through, and the first level's unpaired nodes are read
    from x by the second level, not copied.  Every step is one elementwise
    IEEE f32 add, so the CPU and the card give the same bits; ``torch.sum``
    takes another order on each.
    """
    v = x.reshape(-1).to(torch.float32)
    m = v.numel()
    if m <= 1:
        return v.sum()
    h = 1 << ((m - 1).bit_length() - 1)           # 2^(K−1) < m ≤ 2^K
    p = m - h                                     # level 1: nodes [0, p) paired
    lvl = v[:p] + v[h:]                           # ... nodes [p, h) are v[p:h]
    if h == 1:
        return lvl[0]
    h //= 2
    w = torch.empty(h, dtype=torch.float32, device=v.device)
    if p >= h:                                    # level 2 over [lvl | v[p:2h]]
        torch.add(lvl[:p - h], lvl[h:], out=w[:p - h])
        torch.add(lvl[p - h:h], v[p:2 * h], out=w[p - h:])
    else:
        torch.add(lvl, v[h:h + p], out=w[:p])
        torch.add(v[p:h], v[h + p:2 * h], out=w[p:])
    while h > 1:
        h //= 2
        w[:h] += w[h:2 * h]
    return w[0]


def tree_mean(x):
    """The mean of x as :func:`tree_sum` times f32(1/d), as ``jnp.mean``
    scales: the same bits on the CPU and the card.  (``torch.mean`` divides
    on the CPU and multiplies by the reciprocal on the card, after sums in
    different orders.)"""
    inv = torch.full((), 1.0 / x.numel(), dtype=torch.float32, device=x.device)
    return tree_sum(x) * inv


def center(x, policy: str):
    """The node center μ_i used on the wire, as an f32 0-dim tensor; the
    ``mean`` center is :func:`tree_mean`, so a node's wire bytes do not
    depend on the device it packs on."""
    if policy == "zero":
        return torch.zeros((), dtype=torch.float32, device=x.device)
    if policy == "mean":
        return tree_mean(x)
    if policy == "min":
        return torch.min(x).to(torch.float32)
    raise ValueError(f"center policy {policy!r} not supported on the wire "
                     "(optimal centers need the §6 solver — reference path only)")


class WireCodec:
    """One registered wire format; see the module docstring.

    Every parameter comes from the
    :class:`~repro_torch.core.types.CompressionConfig` passed to each call;
    a ``stateful`` codec (error feedback) also threads a local state that
    never travels on the wire.
    """

    name: str = "?"
    reduce: str = "all_gather"          # "all_gather" | "psum"
    scatter_supported: bool = False
    stateful: bool = False

    # ---- wire geometry & accounting -------------------------------------- #

    def wire_slots(self, d: int, cfg: t.CompressionConfig) -> int:
        raise NotImplementedError

    def wire_bits(self, n: int, d: int, cfg: t.CompressionConfig) -> float:
        """Gathered payload bits of one n-node round (star convention)."""
        raise NotImplementedError

    def seed_bits(self, n: int, cfg: t.CompressionConfig) -> float:
        return 0.0

    def scatter_bits(self, n: int, d: int, cfg: t.CompressionConfig) -> float:
        """Extra collective bits of a flat scatter decode (0 otherwise)."""
        return 0.0

    def scatter_align(self, cfg: t.CompressionConfig) -> int:
        """Coordinates per indivisible wire word (shard-split alignment);
        the packed-plane codecs override it (32 or 16)."""
        return 1

    def cost_spec(self, d: int, cfg: t.CompressionConfig):
        raise NotImplementedError

    def comm_cost_bits(self, n: int, d: int, cfg: t.CompressionConfig) -> float:
        """Analytic §4 cost via comm_cost.cost — == wire_bits + seed_bits."""
        from repro_torch.core import comm_cost
        spec, kw = self.cost_spec(d, cfg)
        return comm_cost.cost(spec, n=n, d=d, **kw)

    # ---- per-node wire format -------------------------------------------- #

    def pack(self, flat, key, rank: int, cfg: t.CompressionConfig):
        """Encode one node's (d,) f32 vector into its flat wire buffer."""
        raise NotImplementedError

    def unpack(self, row, peer: int, key, cfg: t.CompressionConfig, d: int):
        """Reconstruct peer ``peer``'s dense (d,) f32 Y_i from its row."""
        raise NotImplementedError

    def decode_gathered(self, rows, key, cfg: t.CompressionConfig, d: int, n: int):
        """Averaging decoder over the gathered (n, slots) rows.

        Default: (1/n) Σ_i unpack(row_i), peers added in ascending order
        into a zero f32 accumulator; codecs with a fused decode override it.
        """
        acc = torch.zeros(d, dtype=torch.float32, device=rows.device)
        for i in range(n):
            acc = acc + self.unpack(rows[i], i, key, cfg, d)
        return divide(acc, n)

    def decode_rows(self, rows, key, cfg: t.CompressionConfig, d: int, n: int):
        """The (n, d) f32 stack of per-peer reconstructions: row i is
        ``unpack(rows[i], i, ...)``, the input of the robust reductions."""
        out = torch.empty((n, d), dtype=torch.float32, device=rows.device)
        for i in range(n):
            out[i] = self.unpack(rows[i], i, key, cfg, d)
        return out

    def decode_rows_shard(self, rows, key, cfg: t.CompressionConfig, d: int,
                          n: int, start: int, ds: int, nshards: int):
        """The (n, ds) window ``decode_rows(...)[:, start:start + ds]``,
        zero-padded past d (``nshards·ds ≥ d``); a bit-plane codec's caller
        passes a word-aligned ``ds``."""
        return shard_window(self.decode_rows(rows, key, cfg, d, n), start, ds)

    def decode_rows_reduce(self, rows, key, cfg: t.CompressionConfig, d: int,
                           n: int, drop_mask=None):
        """The flat decode under ``cfg.decode_policy``: the fused
        :meth:`decode_gathered` for the plain mean without a mask, else
        :func:`robust.reduce_rows` over :meth:`decode_rows` (the masked mean
        renormalizes by the kept count, NaN when none is kept)."""
        kind, f = robust.parse_policy(cfg.decode_policy)
        if kind == "mean" and drop_mask is None:
            return self.decode_gathered(rows, key, cfg, d, n)
        return robust.reduce_rows(self.decode_rows(rows, key, cfg, d, n), kind, f, drop_mask)

    def decode_gathered_shard(self, rows, key, cfg: t.CompressionConfig,
                              d: int, n: int, shard: int, nshards: int):
        """Shard ``shard`` of ``nshards`` of :meth:`decode_gathered`."""
        raise NotImplementedError(f"codec {self.name!r} does not support scatter_decode")

    def decode_shards(self, rows, key, cfg: t.CompressionConfig, d: int,
                      n: int, shards: Sequence[int], nshards: int, comm):
        """The local shards' decodes (of ``nshards``), stacked (L, shard
        length).

        Default: :meth:`decode_gathered_shard` per local shard.  Codecs whose
        shard decode needs a collective of its own (Bernoulli's rank-offset
        count exchange) override this and run it over ``comm``, the
        communicator the shards are spread over (:func:`scatter_comm`).
        """
        return torch.stack([self.decode_gathered_shard(rows, key, cfg, d, n, s, nshards)
                            for s in shards])

    def decode_reduced(self, wire, key, cfg: t.CompressionConfig, d: int):
        """Decode the reduced wire buffer of a "psum" codec."""
        raise NotImplementedError

    # ---- codec state (stateless by default; see wire/ef.py) -------------- #

    def state_shape(self, d: int, cfg: t.CompressionConfig):
        """Shape of one rank's state for a d-vector bucket, or None for a
        stateless codec.  State never travels on the wire."""
        return None

    def init_state(self, d: int, cfg: t.CompressionConfig, local: int = 1, device=None):
        """Zero state for a d-vector bucket: an (local, *state_shape) f32
        stack, one row per local rank (None for a stateless codec)."""
        shp = self.state_shape(d, cfg)
        if shp is None:
            return None
        return torch.zeros((local,) + tuple(shp), dtype=torch.float32, device=device)

    def mean_flat_stateful(self, x, state, key, cfg: t.CompressionConfig, comm,
                           drop_mask=None):
        """One stateful round over the (L, d) stack ``x`` and its (L, ...)
        ``state``: returns (the (d,) estimate, the new state).  A stateless
        codec passes the state through, so every codec is drivable through
        this one entry point.  ``drop_mask`` as in :meth:`mean_flat`.

        Hierarchical configs pre-reduce ``x`` over the inner axes here, once,
        before any codec layer runs, and the codec's state follows the
        cross-host message: the round reads the state row of each codec
        rank's first inner rank (``comm.pick``) and writes the new one to
        every rank of its inner group (``comm.spread``), so the rows of one
        inner group stay bit-equal.  On ``StackedComm`` that is one state
        row per codec rank updated, then copied over its group's other
        rows; on ``DistComm`` every inner rank computes the same row from
        the same inputs."""
        check_mesh(comm, cfg)
        if not cfg.inner_axes or not self.stateful or state is None:
            return self._round_stateful(inner_mean(x, cfg, comm), state, key, cfg, comm,
                                        drop_mask)
        st = comm.pick(state, tuple(cfg.inner_axes))
        y, st = self._round_stateful(inner_mean(x, cfg, comm), st, key, cfg, comm, drop_mask)
        comm.spread(st, state, tuple(cfg.inner_axes))
        return y, state

    def _round_stateful(self, x, state, key, cfg: t.CompressionConfig, comm,
                        drop_mask=None):
        """Stateful companion of :meth:`_round`."""
        return self._round(x, key, cfg, comm, drop_mask), state

    # ---- the collective --------------------------------------------------- #

    def mean_flat(self, x, key, cfg: t.CompressionConfig, comm, drop_mask=None):
        """Estimate the mean over the communicator's ranks of the (L, d) f32
        local stack ``x``; returns the (d,) estimate every rank holds.

        Two-level schedule (DESIGN.md §11): with ``cfg.inner_axes`` the mean
        over the inner axes is exact (:func:`inner_mean`, here, once) and
        the codec round runs only across ``cfg.axes``.  Wrapper codecs
        override :meth:`_round` / :meth:`_round_stateful`, never this.

        ``drop_mask``: an optional 0/1 alive mask over the codec ranks of
        ``cfg.axes`` (1 = keep; n_eff entries under a hierarchical config:
        the drop unit is the cross-host peer).  The dropped peers' buffers
        still travel; the decode leaves them out and renormalizes over the
        kept ones (NaN when none is kept), which equals a decode of the
        survivors' rows alone under their own peer indices.
        """
        check_mesh(comm, cfg)
        return self._round(inner_mean(x, cfg, comm), key, cfg, comm, drop_mask)

    def _round(self, x, key, cfg: t.CompressionConfig, comm, drop_mask=None):
        """One codec round across ``cfg.axes`` (``x`` already inner-reduced:
        one row per local codec rank): pack per codec rank, then
        :meth:`_reduce_decode`."""
        ranks, _ = axis_rank_size(comm, cfg.axes)
        bufs = torch.stack([self.pack(x[i], key, r, cfg) for i, r in enumerate(ranks)])
        return self._reduce_decode(bufs, key, cfg, x.shape[1], comm, drop_mask)

    def _reduce_decode(self, bufs, key, cfg: t.CompressionConfig, d: int, comm,
                       drop_mask=None):
        """The tail of every round over the (L, slots) packed ``bufs``: psum
        (mean of the buffers, rounded once to the wire dtype) and decode the
        reduced buffer, or all_gather and decode the rows.  With a mask the
        psum is the mask-weighted mean Σ keep_i·buf_i / Σ keep_i (the decode
        is affine in the wire values, so leaving out a buffer leaves out its
        message); the buffers are masked at the wire dtype, where × 0 and × 1
        are exact, so the wire keeps its width."""
        if self.reduce == "psum":
            ccomm = view(comm, cfg.axes)
            if drop_mask is None:
                wire = divide(ccomm.psum(bufs), ccomm.size).to(bufs.dtype)
            else:
                keep = local_keep(drop_mask, ccomm, bufs.device)
                num = ccomm.psum(bufs * keep.to(bufs.dtype)[:, None])
                den = ccomm.psum(keep[:, None]).reshape(())
                wire = (num / den).to(bufs.dtype)
            return self.decode_reduced(wire, key, cfg, d)
        return self.gather_decode(bufs, key, cfg, d, comm, drop_mask)

    def gather_decode(self, bufs, key, cfg: t.CompressionConfig, d: int, comm,
                      drop_mask=None):
        """all_gather the packed buffers and decode.

        The gather runs over ``cfg.axes``.  With ``cfg.scatter_decode`` the
        decode is sharded over :func:`scatter_comm`: the inner axes when
        present (hierarchical: each inner rank decodes one ⌈d/n_in⌉ shard
        of the n_eff rows, and the shard gather rides the inner link) or the
        compression axes themselves (flat mesh, §12: ⌈d/n⌉ shards, the
        gather billed by :meth:`scatter_bits`); shards concatenate in shard
        order and pads sit past d, so the result equals the flat decode.  A robust
        policy or a mask reduces the per-peer stack instead: flat through
        :meth:`decode_rows_reduce`, scattered per word-aligned shard window
        of the stack (built once for every local shard: the windows are
        slices of the same rows), which partitions like the mean.
        """
        ccomm = view(comm, cfg.axes)
        n = ccomm.size
        rows = gather_nested(bufs, ccomm).reshape(n, bufs.shape[1])
        if not cfg.scatter_decode:
            return self.decode_rows_reduce(rows, key, cfg, d, n, drop_mask)
        scomm = scatter_comm(comm, cfg)
        shards, nshards = tuple(scomm.local_ranks), scomm.size
        kind, f = robust.parse_policy(cfg.decode_policy)
        if kind == "mean" and drop_mask is None:
            parts = self.decode_shards(rows, key, cfg, d, n, shards, nshards, scomm)
        else:
            ds = scatter_shard_len(d, nshards, self.scatter_align(cfg))
            stack = self.decode_rows(rows, key, cfg, d, n)
            parts = torch.stack([robust.reduce_rows(shard_window(stack, s * ds, ds), kind, f,
                                                    drop_mask) for s in shards])
            del stack
        return gather_nested(parts, scomm).reshape(-1)[:d]

    def mean(self, x, key, cfg: t.CompressionConfig, comm, drop_mask=None):
        """Shape/dtype-preserving wrapper: ``x`` is (L, *shape), the result
        (*shape)."""
        shape, dtype = x.shape[1:], x.dtype
        flat = x.reshape(x.shape[0], -1).to(torch.float32)
        y = self.mean_flat(flat, key, cfg, comm, drop_mask)
        return y.reshape(shape).to(dtype)

    def __repr__(self):
        return f"<WireCodec {self.name} reduce={self.reduce}>"
