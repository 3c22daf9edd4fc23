"""Gradient bucketing: few flat collectives instead of one per leaf — port
of ``repro.train.bucketing`` (the post-backward schedule).

* :func:`build_plan` (:func:`plan_for_run` for the train step) — a
  static partition of the grad tree (global leaf shapes + sharding specs)
  into fixed-capacity f32 buckets, grouped by sync signature and packed
  first-fit in sorted name order.  Small leaves ride "exact" buckets; a
  leaf larger than the capacity gets its own oversize bucket.  The plan is
  a pure function of its inputs and equals the reference's (ids, kinds,
  slots, offsets, readiness).
* :func:`pack_bucket` / :func:`unpack_bucket` — flatten a bucket's leaves
  into one f32 vector per local rank and scatter a result back.
* :func:`sync_grads_bucketed` — per bucket, the exact mean or one
  compressed-mean round, with the bucket key ``fold_in(key, j)`` of its
  plan position j; with error-feedback state (:func:`init_ef_state`) the
  stateful round of the ``ef_*`` codec.

Gradients are stacks: each leaf is (L, *shape) with one row per local rank
of the communicator (on a mesh, in mesh order), and so is each bucket's
residual, (L, size).  The
synced result holds one (*shape) tensor per leaf, the estimate every rank
holds.  The overlapped schedule comes with a later slice.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Optional, Sequence, Tuple

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
    """Scatter a (size,) bucket result back to leaf shapes and dtypes."""
    return {s.name: vec[s.offset:s.offset + s.size].reshape(s.shape).to(like[s.name].dtype)
            for s in bucket.slots}


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


def _bucket_round(grads: Mapping[str, torch.Tensor], b: Bucket, j: int,
                  cmp: t.CompressionConfig, key, comm, ef=None):
    """ONE bucket's sync: pack → (exact mean / codec round) → unpack, with
    the bucket key fold_in(key, j) of its plan position j.  ``ef`` is the
    bucket's (L, size) residual (engages the stateful ``ef_*`` codec) or
    None.  Returns (synced leaf dict, new residual or None).

    On a mesh, the bucket's exact axes that are codec inner axes ride the
    codec round (it pre-reduces them, and its scatter decode shards over
    them); the other exact axes (the ``data`` axis under a compression over
    ``pod`` alone) get their own exact mean first (``comm.mean_over``),
    and the round runs on the communicator over the remaining axes.  The
    residual follows, as in :meth:`~repro_torch.core.wire.base.WireCodec
    .mean_flat_stateful`: one row per group over those axes, written back
    to every rank of the group.  Flat configs take the one-axis path."""
    v = pack_bucket(grads, b)
    if b.kind == "exact":
        axes = getattr(comm, "axes", None)
        if axes is not None and set(axes) != set(b.eaxes):
            raise ValueError(f"bucket {b.bid} syncs over {b.eaxes}, not over every axis of "
                             f"the communicator's mesh {axes}")
        return unpack_bucket(coll.exact_mean(v, comm), b, grads), ef
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
        return unpack_bucket(v, b, grads), ef
    v = coll.compressed_mean(v, kb, lcfg, sub)
    return unpack_bucket(v, b, grads), None


def sync_grads_bucketed(grads: Mapping[str, torch.Tensor], plan: BucketPlan,
                        cmp: t.CompressionConfig, key, comm,
                        ef_state: Optional[Mapping[str, torch.Tensor]] = None):
    """Bucketed gradient sync (post-backward schedule).

    ``grads`` maps leaf names to (L, *shape) stacks.  Returns (the synced
    (*shape) leaves, the new error-feedback state); the state is None
    exactly when ``ef_state`` is, and passing it engages the ``ef_*`` codec
    (each bucket's residual is updated in place and returned).  Passthrough
    leaves come back as given.
    """
    out = {name: grads[name] for name in plan.passthrough}
    new_ef = {} if ef_state is not None else None
    for j, b in enumerate(plan.buckets):
        ef = ef_state[b.bid] if ef_state is not None and b.kind == "compressed" else None
        synced, e = _bucket_round(grads, b, j, cmp, key, comm, ef)
        if ef is not None:
            new_ef[b.bid] = e
        out.update(synced)
    return out, new_ef
