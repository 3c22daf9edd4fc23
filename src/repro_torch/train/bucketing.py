"""Gradient bucketing: few flat collectives instead of one per leaf — port
of ``repro.train.bucketing``, both issue schedules.

* :func:`build_plan` (:func:`plan_for_run` for the train step) — a
  static partition of the grad tree (global leaf shapes + sharding specs)
  into fixed-capacity f32 buckets, grouped by sync signature and packed
  first-fit in sorted name order.  Small leaves ride "exact" buckets; a
  leaf larger than the capacity gets its own oversize bucket.  The plan is
  a pure function of its inputs and equals the reference's (ids, kinds,
  slots, offsets, readiness).
* :func:`pack_bucket` / :func:`unpack_bucket` — flatten a bucket's leaves
  into one f32 vector per local rank and scatter a result back.
* :func:`sync_grads_bucketed` — the post-backward schedule: per bucket,
  the exact mean or one compressed-mean round, with the bucket key
  ``fold_in(key, j)`` of its plan position j; with error-feedback state
  (:func:`init_ef_state`) the stateful round of the ``ef_*`` codec.
* :func:`overlap_params` — the backward-pipelined schedule
  (``BucketSpec.overlap``, DESIGN.md §9): per-bucket sync points whose
  backward runs the same round (:func:`_bucket_round`) as soon as the
  bucket's cotangents exist, on a side stream on the card.  Same bits as
  the post-backward schedule: each round depends only on its bucket's
  rows, its key and its own residual, whatever order the buckets finish in.

Gradients are stacks: each leaf is (L, *shape) with one row per local rank
of the communicator (on a mesh, in mesh order), and so is each bucket's
residual, (L, size).  The
synced result holds one (*shape) tensor per leaf, the estimate every rank
holds; a bucket of leaves sharded over some mesh axes (FSDP's shards over
``data`` under a compression over ``pod``: :func:`held_axes`) runs its
round once per coordinate of those axes and gives each leaf as a (K,
*shard) stack of the K coordinates' estimates held here.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Mapping, Optional, Sequence, Tuple

import torch

from repro_torch import random as prandom
from repro_torch.core import collectives as coll
from repro_torch.core import types as t
from repro_torch.core import wire


@dataclasses.dataclass(frozen=True)
class LeafSlot:
    """One leaf's placement inside a bucket (local, per-shard extents)."""

    name: str
    offset: int
    size: int
    shape: Tuple[int, ...]


@dataclasses.dataclass(frozen=True)
class Bucket:
    """A flat f32 aggregation unit: one collective per step.  ``ready`` is
    the backward-order index of its last-produced leaf."""

    bid: str
    kind: str                      # "exact" | "compressed"
    caxes: Tuple[str, ...]
    eaxes: Tuple[str, ...]
    slots: Tuple[LeafSlot, ...]
    size: int
    ready: int = -1


@dataclasses.dataclass(frozen=True)
class BucketPlan:
    buckets: Tuple[Bucket, ...]
    passthrough: Tuple[str, ...]   # leaves whose spec covers every mesh axis

    def schedule(self) -> Tuple[str, ...]:
        """Bucket ids in readiness order (ties broken by bid)."""
        return tuple(b.bid for b in sorted(self.buckets,
                                           key=lambda b: (b.ready, b.bid)))


def leaf_sync_axes(spec, mesh_axes: Sequence[str]) -> Tuple[str, ...]:
    """Mesh axes absent from the leaf's spec — the unreduced X_i axes."""
    present = set()
    for s in spec:
        if s is None:
            continue
        for a in ((s,) if isinstance(s, str) else s):
            present.add(a)
    return tuple(a for a in mesh_axes if a not in present)


def local_shape(shape: Sequence[int], spec,
                mesh_sizes: Mapping[str, int]) -> Tuple[int, ...]:
    """Per-shard extents of a leaf (global ÷ spec axes)."""
    out = []
    for j, dim in enumerate(shape):
        s = spec[j] if j < len(spec) else None
        axes = () if s is None else ((s,) if isinstance(s, str) else tuple(s))
        q = 1
        for a in axes:
            q *= mesh_sizes.get(a, 1)
        if q > 1 and dim % q:
            raise ValueError(f"dim {dim} not divisible by sharding {axes} (= {q})")
        out.append(dim // q if q > 1 else dim)
    return tuple(out)


def _bucket_id(kind: str, caxes, eaxes, idx: int) -> str:
    return (f"{kind}:{'+'.join(caxes) if caxes else '-'}"
            f":{'+'.join(eaxes) if eaxes else '-'}:{idx}")


def build_plan(shapes: Mapping[str, Sequence[int]], specs: Mapping[str, tuple],
               mesh_axes: Sequence[str], mesh_sizes: Mapping[str, int],
               cmp: t.CompressionConfig) -> BucketPlan:
    """Partition a grad tree (global leaf shapes + specs) into buckets; the
    reference's algorithm, step for step."""
    cap = cmp.bucket.capacity
    names = sorted(shapes)
    bwd_index = {name: len(names) - 1 - i for i, name in enumerate(names)}
    open_slots: Dict[tuple, list] = {}
    open_fill: Dict[tuple, int] = {}
    counts: Dict[tuple, int] = {}
    buckets = []
    passthrough = []

    def close(sig):
        slots = open_slots.pop(sig)
        fill = open_fill.pop(sig)
        idx = counts.get(sig, 0)
        counts[sig] = idx + 1
        kind, caxes, eaxes = sig
        ready = max(bwd_index[s.name] for s in slots)
        buckets.append(Bucket(_bucket_id(kind, caxes, eaxes, idx), kind,
                              caxes, eaxes, tuple(slots), fill, ready))

    for name in names:
        shp = shapes[name]
        shp = tuple(shp.shape) if hasattr(shp, "shape") else tuple(shp)
        lshape = local_shape(shp, specs[name], mesh_sizes)
        size = 1
        for d in lshape:
            size *= d
        axes = leaf_sync_axes(specs[name], mesh_axes)
        if not axes:
            passthrough.append(name)
            continue
        caxes = tuple(a for a in axes if a in cmp.axes)
        eaxes = tuple(a for a in axes if a not in cmp.axes)
        compressed = (bool(caxes) and cmp.mode != "none"
                      and size >= cmp.min_compress_size)
        sig = ("compressed", caxes, eaxes) if compressed else ("exact", (), axes)
        fill = open_fill.get(sig, 0)
        if fill and fill + size > cap:
            close(sig)
            fill = 0
        open_slots.setdefault(sig, []).append(LeafSlot(name, fill, size, lshape))
        open_fill[sig] = fill + size

    for sig in list(open_slots):
        close(sig)
    return BucketPlan(tuple(buckets), tuple(passthrough))


def plan_for_run(shapes: Mapping[str, Sequence[int]], specs: Mapping[str, tuple],
                 mesh_axes: Sequence[str], mesh_sizes: Mapping[str, int],
                 cmp: t.CompressionConfig) -> Optional[BucketPlan]:
    """The plan the train step uses, or None when bucketing is disabled."""
    if not cmp.bucket.enabled:
        return None
    return build_plan(shapes, specs, mesh_axes, mesh_sizes, cmp)


def pack_bucket(grads: Mapping[str, torch.Tensor], bucket: Bucket) -> torch.Tensor:
    """The bucket's leaves as one (L, size) f32 stack.  A single-leaf f32
    bucket is a view of its leaf, not a copy."""
    parts = [grads[s.name].reshape(grads[s.name].shape[0], -1).to(torch.float32)
             for s in bucket.slots]
    return parts[0] if len(parts) == 1 else torch.cat(parts, dim=1)


def unpack_bucket(vec: torch.Tensor, bucket: Bucket,
                  like: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """Scatter a (..., size) bucket result back to (..., *leaf shape) and
    the leaves' dtypes."""
    lead = tuple(vec.shape[:-1])
    return {s.name: vec[..., s.offset:s.offset + s.size].reshape(lead + tuple(s.shape))
            .to(like[s.name].dtype) for s in bucket.slots}


def bucket_wire_bits(plan: BucketPlan, cfg: t.CompressionConfig, n: int,
                     mesh_sizes: Optional[Mapping[str, int]] = None) -> Dict[str, float]:
    """Gathered wire bits per compressed bucket and round, keyed by bid —
    ``wire_bits + scatter_bits`` of the resolved codec at the effective node
    count: ``n`` is the world size over the compression axes, and a
    hierarchical config is billed at n / Π inner sizes, which needs
    ``mesh_sizes``.  Only defined for gather_decode wire paths; other modes
    return {} (as the reference)."""
    if cfg.mode != "gather_decode":
        return {}
    n_eff = wire.effective_nodes(cfg, n, mesh_sizes)
    codec = wire.resolve(cfg)
    return {b.bid: float(codec.wire_bits(n_eff, b.size, cfg)
                         + codec.scatter_bits(n_eff, b.size, cfg))
            for b in plan.buckets if b.kind == "compressed"}


def ef_state_shapes(plan: BucketPlan, cfg: t.CompressionConfig,
                    local: int) -> Dict[str, Tuple[int, ...]]:
    """Codec state shapes per compressed bucket, keyed by bucket id: the
    resolved codec's ``state_shape`` behind ``local`` rank rows, (local,
    size) for error feedback.  Empty for stateless configurations."""
    out = {}
    for b in plan.buckets:
        if b.kind != "compressed":
            continue
        lcfg = _bucket_cfg(b, cfg, error_feedback=True)
        shp = wire.resolve(lcfg).state_shape(b.size, lcfg)
        if shp is not None:
            out[b.bid] = (int(local),) + tuple(shp)
    return out


def init_ef_state(plan: BucketPlan, cfg: t.CompressionConfig, local: int,
                  device=None) -> Dict[str, torch.Tensor]:
    """Zero codec state (the error-feedback residuals), one f32 (local,
    size) stack per compressed bucket, shapes from :func:`ef_state_shapes`."""
    return {bid: torch.zeros(shp, dtype=torch.float32, device=device)
            for bid, shp in ef_state_shapes(plan, cfg, local).items()}


def _bucket_cfg(b: Bucket, cmp: t.CompressionConfig, *,
                error_feedback: bool) -> t.CompressionConfig:
    """The per-bucket codec config: compression axes narrowed to the
    bucket's caxes, inner axes to the ones it syncs over."""
    inner = tuple(a for a in b.eaxes if a in cmp.inner_axes)
    return dataclasses.replace(
        cmp, axes=b.caxes, inner_axes=inner,
        scatter_decode=cmp.scatter_decode and (bool(inner) == bool(cmp.inner_axes)),
        error_feedback=error_feedback)


def held_axes(b: Bucket, comm) -> Tuple[str, ...]:
    """The communicator's mesh axes the bucket does not sync over: those its
    leaves are sharded over (FSDP's ``data`` under a compression over
    ``pod``); () on a flat communicator."""
    axes = getattr(comm, "axes", None) or ()
    return tuple(a for a in axes if a not in b.caxes + b.eaxes)


def _bucket_round(grads: Mapping[str, torch.Tensor], b: Bucket, j: int,
                  cmp: t.CompressionConfig, key, comm, ef=None):
    """ONE bucket's sync: pack → (exact mean / codec round) → unpack, with
    the bucket key fold_in(key, j) of its plan position j.  ``ef`` is the
    bucket's (L, size) residual (engages the stateful ``ef_*`` codec) or
    None.  Returns (synced leaf dict, new residual or None).

    A bucket whose leaves are sharded over some of the communicator's axes
    (:func:`held_axes`: an FSDP shard bucket, whose stack rows hold each
    rank's shard of its pod's sum) runs the round once per coordinate of
    those axes on that coordinate's rows (``comm.by_shard``), each with the
    same key, as each ``data`` coordinate's pod group runs it in the
    reference; its residual rows stay each rank's own.  Its leaves come
    back as (K, *shard) stacks, the estimates of the K coordinates held
    here (all of them stacked, this process's one under DistComm).

    On a mesh, the bucket's exact axes that are codec inner axes ride the
    codec round (it pre-reduces them, and its scatter decode shards over
    them); the other exact axes (the ``data`` axis under a compression over
    ``pod`` alone) get their own exact mean first (``comm.mean_over``),
    and the round runs on the communicator over the remaining axes.  The
    residual follows, as in :meth:`~repro_torch.core.wire.base.WireCodec
    .mean_flat_stateful`: one row per group over those axes, written back
    to every rank of the group.  Flat configs take the one-axis path."""
    v = pack_bucket(grads, b)
    held = held_axes(b, comm)
    if not held:
        y, _ = _round(v, b, j, cmp, key, comm, ef)    # the residual in place
        return unpack_bucket(y, b, grads), ef
    groups = comm.by_shard(held)
    out = torch.empty((len(groups), b.size), dtype=torch.float32, device=v.device)
    for k, (rows, sub) in enumerate(groups):
        e = None if ef is None else ef[rows]
        out[k], e = _round(v[rows], b, j, cmp, key, sub, e)
        if ef is not None:
            ef[rows] = e
    return unpack_bucket(out, b, grads), ef


def _round(v, b: Bucket, j: int, cmp: t.CompressionConfig, key, comm, ef):
    """:func:`_bucket_round` on the packed (L, size) rows ``v`` over a
    communicator that spans the bucket's axes: ((size,) estimate, the new
    residual or None; ``ef`` is written in place where it can be)."""
    if b.kind == "exact":
        axes = getattr(comm, "axes", None)
        if axes is not None and set(axes) != set(b.eaxes):
            raise ValueError(f"bucket {b.bid} syncs over {b.eaxes}, not over every axis of "
                             f"the communicator's mesh {axes}")
        return coll.exact_mean(v, comm), ef
    lcfg = _bucket_cfg(b, cmp, error_feedback=ef is not None)
    pre = tuple(a for a in b.eaxes if a not in lcfg.inner_axes)
    sub = comm
    if pre:
        v = comm.mean_over(v, pre)
        sub = comm.over(tuple(a for a in comm.axes if a not in pre))
    kb = prandom.fold_in(key, j)
    if ef is not None:
        st = comm.pick(ef, pre) if pre else ef
        v, st = coll.compressed_mean_stateful(v, st, kb, lcfg, sub)
        if pre:
            comm.spread(st, ef, pre)
            return v, ef
        return v, st
    return coll.compressed_mean(v, kb, lcfg, sub), None


def _timing_event(t: torch.Tensor):
    """A timing CUDA event recorded on the current stream of ``t``'s card,
    or None on the CPU."""
    if not t.is_cuda:
        return None
    ev = torch.cuda.Event(enable_timing=True)
    ev.record(torch.cuda.current_stream(t.device))
    return ev


def sync_grads_bucketed(grads: Mapping[str, torch.Tensor], plan: BucketPlan,
                        cmp: t.CompressionConfig, key, comm,
                        ef_state: Optional[Mapping[str, torch.Tensor]] = None,
                        rounds: Optional["RoundLog"] = None):
    """Bucketed gradient sync (post-backward schedule).

    ``grads`` maps leaf names to (L, *shape) stacks.  Returns (the synced
    (*shape) leaves, the new error-feedback state); the state is None
    exactly when ``ef_state`` is, and passing it engages the ``ef_*`` codec
    (each bucket's residual is updated in place and returned).  Passthrough
    leaves come back as given.  ``rounds``, when given, logs each round
    (:class:`RoundLog`): here in plan order, on the current stream.
    """
    out = {name: grads[name] for name in plan.passthrough}
    new_ef = {} if ef_state is not None else None
    for j, b in enumerate(plan.buckets):
        ef = ef_state[b.bid] if ef_state is not None and b.kind == "compressed" else None
        start = _timing_event(grads[b.slots[0].name]) if rounds is not None else None
        synced, e = _bucket_round(grads, b, j, cmp, key, comm, ef)
        if rounds is not None:
            rounds.add(b.bid, start, _timing_event(grads[b.slots[0].name]))
        if ef is not None:
            new_ef[b.bid] = e
        out.update(synced)
    return out, new_ef


class RoundLog:
    """The bucket rounds of one step in the order they were issued
    (``issued``, bucket ids) and, on the card, a pair of timing events per
    bucket (``events[bid] = (issued, done)``): ``issued`` is recorded once
    the round's inputs are enqueued, ``done`` after its last kernel, on the
    stream the round ran on."""

    def __init__(self):
        self.issued = []
        self.events = {}

    def add(self, bid: str, start, done) -> None:
        self.issued.append(bid)
        if done is not None:
            self.events[bid] = (start, done)


class _SyncPoint(torch.autograd.Function):
    """The identity on one bucket's leaves; its backward receives exactly
    those leaves' cotangents, once all of them are complete, and runs the
    bucket's round (:meth:`OverlapSync._fire`).  It hands no gradient on to
    the leaves: the synced gradient is the round's output."""

    @staticmethod
    def forward(ctx, sync, j, *leaves):
        ctx.sync, ctx.j = sync, j
        return tuple(x.view_as(x) for x in leaves)

    @staticmethod
    def backward(ctx, *cots):
        ctx.sync._fire(ctx.j, cots)
        return (None, None) + (None,) * len(cots)


class OverlapSync:
    """One step's backward-pipelined bucket sync (the reference's
    ``_sync_point`` / ``overlap_params``; DESIGN.md §9).

    ``stacks`` are the step's (L, *shape) f32 gradient stacks, one row per
    local rank of ``comm``; rows other than ``row`` must hold their ranks'
    gradients before the backward that carries the sync points runs.
    :meth:`params` tags the parameters of rank ``row``'s forward: per
    bucket, one sync point over its leaves (passthrough leaves stay
    untagged).  In that rank's backward, once a bucket's last cotangent is
    complete, its sync point writes the cotangents into row ``row`` and runs
    the bucket's round, :func:`_bucket_round` with the plan position j and
    ``fold_in(key, j)``, the post-backward schedule's own code; with
    ``ef_state`` the bucket's residual is updated in place.  Buckets finish
    in the order the backward completes them, not in ``plan.schedule()``
    order (:attr:`rounds` logs it); each round touches only its own leaves
    and its own residual, so the bits are the post-backward schedule's.

    On the card each round runs on ``stream``: it waits on an event the
    compute stream records after the cotangents are written, and its output
    is handed back through :meth:`finish`, never through autograd, so the
    rest of the backward does not queue behind it.  ``record_stream`` keeps
    the allocator from reusing early what the side stream reads (the stacks,
    the residual) and what the compute stream reads of its output.  The
    rounds are launched from the thread that runs the backward, between its
    kernels.

    With ``StackedComm`` every round needs all ranks' rows, so only the last
    local rank's backward (``row`` = L − 1) carries the sync points and can
    hide a round: ranks 0 … L − 2 run forward and backward first.  With
    ``DistComm`` (one rank per process) every process's backward carries
    them and each round is a collective; every process issues the rounds in
    the order its backward completes the buckets, which is the same on every
    rank for the same graph (the tests check :attr:`rounds` across ranks).
    """

    def __init__(self, plan: BucketPlan, cmp: t.CompressionConfig, key, comm,
                 stacks: Mapping[str, torch.Tensor], row: int,
                 ef_state: Optional[Mapping[str, torch.Tensor]] = None, stream=None,
                 absorb: Optional[Callable[[str, torch.Tensor], None]] = None):
        self.plan, self.cmp, self.key, self.comm = plan, cmp, key, comm
        self.stacks, self.row, self.ef_state, self.stream = stacks, row, ef_state, stream
        self.absorb = absorb
        self.synced: Dict[str, torch.Tensor] = {}
        self.rounds = RoundLog()

    def params(self, params: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
        """``params`` with every bucketed leaf replaced by its sync point's
        output (the same values)."""
        tagged = dict(params)
        for j, b in enumerate(self.plan.buckets):
            names = [s.name for s in b.slots]
            tagged.update(zip(names, _SyncPoint.apply(self, j, *(params[k] for k in names))))
        return tagged

    def _fire(self, j: int, cots) -> None:
        b = self.plan.buckets[j]
        for s, g in zip(b.slots, cots):
            if self.absorb is None:
                self.stacks[s.name][self.row].copy_(g)
            else:
                self.absorb(s.name, g)
        ef = (self.ef_state[b.bid]
              if self.ef_state is not None and b.kind == "compressed" else None)
        if self.stream is None:
            synced, _ = _bucket_round(self.stacks, b, j, self.cmp, self.key, self.comm, ef)
            self.rounds.add(b.bid, None, None)
        else:
            compute = torch.cuda.current_stream(self.stream.device)
            ready = _timing_event(self.stacks[b.slots[0].name])
            self.stream.wait_event(ready)
            with torch.cuda.stream(self.stream):
                synced, _ = _bucket_round(self.stacks, b, j, self.cmp, self.key, self.comm, ef)
                done = _timing_event(self.stacks[b.slots[0].name])
            for s in b.slots:
                self.stacks[s.name].record_stream(self.stream)
            if ef is not None:
                ef.record_stream(self.stream)
            for v in synced.values():
                v.record_stream(compute)
            self.rounds.add(b.bid, ready, done)
        self.synced.update(synced)

    def finish(self):
        """(synced leaves, new error-feedback state or None), as
        :func:`sync_grads_bucketed` returns them, once the backward has
        returned; on the card the current stream first waits on every
        bucket's round.  Raises if a bucket's sync point never ran (its
        leaves took no part in the loss)."""
        missing = [b.bid for b in self.plan.buckets if b.bid not in self.rounds.issued]
        if missing:
            raise RuntimeError(f"the sync points of buckets {missing} did not run in the "
                               "backward: their leaves take no part in the loss")
        if self.stream is not None:
            compute = torch.cuda.current_stream(self.stream.device)
            for _, done in self.rounds.events.values():
                compute.wait_event(done)
        out = {name: self.stacks[name] for name in self.plan.passthrough}
        out.update(self.synced)
        new_ef = None
        if self.ef_state is not None:
            new_ef = {b.bid: self.ef_state[b.bid] for b in self.plan.buckets
                      if b.kind == "compressed"}
        return out, new_ef


def overlap_params(params: Mapping[str, torch.Tensor], plan: BucketPlan,
                   cmp: t.CompressionConfig, key, comm, stacks: Mapping[str, torch.Tensor],
                   row: int, ef_state: Optional[Mapping[str, torch.Tensor]] = None,
                   stream=None, absorb: Optional[Callable[[str, torch.Tensor], None]] = None):
    """Wrap the parameter tree with per-bucket sync points (the overlapped
    schedule); returns (tagged params, the :class:`OverlapSync`).

    Differentiating a loss of the tagged params runs each bucket's round
    inside the backward, and ``sync.finish()`` then returns the same synced
    gradients and residuals as :func:`sync_grads_bucketed` over the same
    stacks, bit for bit::

        tagged, sync = bucketing.overlap_params(leaves, plan, cmp, key, comm,
                                                stacks, row, ef_state, stream)
        torch.autograd.grad(loss_fn(tagged), list(leaves.values()), allow_unused=True)
        synced, new_ef = sync.finish()

    The bucketed leaves' own gradients come back as None (the sync points
    hand none on); passthrough leaves' come back as usual and are the
    caller's to write into row ``row``.  ``absorb(name, cotangent)``, when
    given, takes each cotangent in place of the copy into row ``row``
    (the stacked FSDP step adds it into its pod's sum).
    """
    sync = OverlapSync(plan, cmp, key, comm, stacks, row, ef_state, stream, absorb)
    return sync.params(params), sync
