"""Compressed mean estimation as a collective — port of
``repro.core.collectives`` and of the ``shard_map`` axes it runs inside.

In the reference these functions run inside ``jax.shard_map`` with the
compression axes manual.  Here a communicator stands in for the axes:

* :class:`StackedComm` — n ranks as the rows of a leading dimension on one
  device: the card's counterpart of the reference's fake CPU devices.  It
  runs each rank's pack and each shard's decode in turn; all_gather is the
  stack itself; psum accumulates in f32 in rank order.  With a ``mesh``
  (named axes, pod-major) it acts over any subset of its axes
  (:meth:`StackedComm.over`), which the hierarchical schedule needs: the
  exact mean over the inner axes, the codec over the cross-host axes.
* :class:`DistComm` — the same interface over ``torch.distributed`` (one
  rank per process): ``all_gather_into_tensor``; its psum gathers the rows
  and sums them as StackedComm does, so the two give the same bits at every
  n.

Both count the bytes handed to them, so a run can hold the traffic against
the codecs' ``wire_bits`` / ``scatter_bits`` accounting: the codec axes'
traffic in ``bytes_gathered`` / ``bytes_reduced``, the inner axes' in
``bytes_inner``, FSDP's weight gathers and gradient reduce-scatters
(:meth:`~StackedComm.fsdp_gather`, :meth:`~StackedComm.reduce_scatter`, as
the training step runs them) in ``bytes_fsdp``.

Local data is a stack (L, *shape) with one row per local rank; every entry
point returns the single (*shape) estimate all ranks hold.  Codec state
(:func:`compressed_mean_stateful`, the error-feedback residual) is a stack
of the same layout and stays local.
"""
from __future__ import annotations

import itertools
import math

import torch

from repro_torch import resolve_device
from repro_torch.core import types as t
from repro_torch.core.wire import base as wire_base
from repro_torch.core.wire import registry


def _mesh_pairs(mesh):
    """((name, size), ...) in mesh order from a mapping or a sequence of pairs."""
    pairs = tuple(mesh.items()) if hasattr(mesh, "items") else tuple(mesh)
    out = tuple((str(a), int(s)) for a, s in pairs)
    if not out or len({a for a, _ in out}) != len(out) or min(s for _, s in out) < 1:
        raise ValueError(f"a mesh needs distinct axis names and sizes >= 1, got {mesh}")
    return out


def _rank_over(coords, names, axes):
    """Linear rank over ``axes`` (mesh order) of the rank at ``coords``."""
    r = 0
    for (a, s), c in zip(names, coords):
        if a in axes:
            r = r * s + c
    return r


def _coords(rank, names):
    """Mesh coordinates (pod-major: the last axis varies fastest) of ``rank``."""
    out = []
    for _, s in reversed(names):
        out.append(rank % s)
        rank //= s
    return tuple(reversed(out))


class _Bytes:
    """Byte counters one communicator shares with its views."""

    def __init__(self):
        self.gathered = self.reduced = self.inner = self.fsdp = 0


class _Counted:
    """Byte counters and the mesh bookkeeping of both communicators.

    ``bytes_gathered`` / ``bytes_reduced`` count what is handed to the
    all_gather / psum of the codec axes: the cross-host traffic the
    accounting (``wire_bits + scatter_bits`` at the effective node count)
    bills.  ``bytes_inner`` counts the inner traffic of the hierarchical
    schedule (the pre-reduce, the scatter decode's count exchange and shard
    gather over the inner axes), which the accounting treats as free.
    """

    _bytes: _Bytes
    _inner: bool = False

    @property
    def bytes_gathered(self) -> int:
        return self._bytes.gathered

    @property
    def bytes_reduced(self) -> int:
        return self._bytes.reduced

    @property
    def bytes_inner(self) -> int:
        return self._bytes.inner

    @property
    def bytes_fsdp(self) -> int:
        """The bytes handed to FSDP's per-layer gathers and reduce-scatters
        (:meth:`count_fsdp`): outside the codec axes' accounting."""
        return self._bytes.fsdp

    def count_fsdp(self, nbytes: int) -> None:
        """Count ``nbytes`` as handed to an FSDP gather or reduce-scatter."""
        self._bytes.fsdp += int(nbytes)

    def reset_bytes(self) -> None:
        self._bytes.gathered = self._bytes.reduced = self._bytes.inner = self._bytes.fsdp = 0

    def _count(self, t, reduced: bool) -> None:
        nb = t.numel() * t.element_size()
        if self._inner:
            self._bytes.inner += nb
        elif reduced:
            self._bytes.reduced += nb
        else:
            self._bytes.gathered += nb

    def _sub_axes(self, axes):
        if self.mesh is None:
            raise ValueError("a flat communicator has no named axes: build it with a mesh")
        axes = tuple(axes)
        names = [a for a, _ in self.mesh]
        if any(a not in names for a in axes) or list(axes) != [a for a in names if a in axes]:
            raise ValueError(f"axes {axes} are not a subset of the mesh axes {tuple(names)} "
                             "in mesh order")
        return axes

    def ranks_over(self, axes):
        """The linear rank over ``axes`` (mesh order) of each local row: the
        codec rank of the row under a config whose ``axes`` these are."""
        if self.mesh is None:
            return tuple(self.local_ranks)
        axes = self._sub_axes(axes)
        return tuple(_rank_over(c, self.mesh, axes) for c in self._local_coords)


class StackedComm(_Counted):
    """All ranks of a mesh stacked on one device; see the module docstring.

    ``StackedComm(n)`` is the flat communicator: one axis that stands for
    whatever axes a config names.  ``StackedComm(mesh={"pod": 4, "data":
    2})`` lays the ranks out on named axes in mesh order, pod-major, as the
    reference's ``Mesh(devices.reshape(n // n_in, n_in), ("pod", "data"))``
    does: stacked row r is (pod = r // n_in, data = r % n_in).

    A stacked communicator holds one row for each coordinate of its axes.
    :meth:`over` gives the communicator over a subset of them, whose rows
    stand for all the ranks that share those coordinates (the caller's data
    is replicated over the other axes, as after :meth:`mean_over`); so each
    distinct computation runs once: one pack per codec rank, one shard
    decode per inner shard.  Data that differs over the other axes (FSDP's
    shards over ``data``) takes :meth:`by_shard`: the rows and the view per
    coordinate of those axes.  The byte counters count every contribution
    (all rows) and are shared with the views.
    """

    def __init__(self, n: int = None, device=None, *, mesh=None, _bytes=None, _inner=False):
        if mesh is None:
            self.mesh = None
            self.size = int(n)
        else:
            self.mesh = _mesh_pairs(mesh)
            self.size = math.prod(s for _, s in self.mesh)
            if n is not None and int(n) != self.size:
                raise ValueError(f"n = {n} != the mesh's {self.size} ranks")
            self._local_coords = tuple(_coords(r, self.mesh) for r in range(self.size))
        self.axes = None if self.mesh is None else tuple(a for a, _ in self.mesh)
        self.local_ranks = tuple(range(self.size))
        self.device = resolve_device(device)
        self._bytes = _bytes or _Bytes()
        self._inner = _inner

    def _check(self, local):
        if local.shape[0] != self.size:
            raise ValueError(f"expected {self.size} stacked rank rows, got {local.shape[0]}")

    def all_gather(self, local):
        """(n, ...) rows of all ranks → the same (n, ...) stack."""
        self._check(local)
        self._count(local, reduced=False)
        return local

    def psum(self, local):
        """Σ over ranks of the (n, ...) rows, accumulated in f32 from 0 in
        rank order."""
        self._check(local)
        self._count(local, reduced=True)
        return _rank_order_sum(local)

    def over(self, axes, inner: bool = False):
        """The communicator over ``axes`` (a subset of the mesh axes, in mesh
        order), sharing the byte counters; ``inner=True`` counts its traffic
        as inner.  The flat communicator is its own view over any axes."""
        if self.mesh is None:
            if inner:
                raise ValueError("a flat communicator has no inner axes: build it with a mesh")
            return self
        axes = self._sub_axes(axes)
        if axes == self.axes and inner == self._inner:
            return self
        sizes = dict(self.mesh)
        return StackedComm(device=self.device, mesh=[(a, sizes[a]) for a in axes],
                           _bytes=self._bytes, _inner=inner)

    def _groups(self, axes):
        """(K, M) row indices: row k of the communicator over the other axes,
        and its M ranks over ``axes`` in rank order."""
        axes = self._sub_axes(axes)
        rest = tuple(a for a in self.axes if a not in axes)
        k_of = [_rank_over(c, self.mesh, rest) for c in self._local_coords]
        m_of = [_rank_over(c, self.mesh, axes) for c in self._local_coords]
        m = math.prod(dict(self.mesh)[a] for a in axes)
        idx = [[0] * m for _ in range(self.size // m)]
        for r, (k, j) in enumerate(zip(k_of, m_of)):
            idx[k][j] = r
        return idx

    def by_shard(self, axes):
        """[(rows, sub)] for each coordinate of ``axes`` (mesh order): the
        stack's rows of the ranks at that coordinate, in ``sub``'s rank
        order (a slice: a view), and ``sub``,
        the communicator over the other axes (byte counters shared).  For
        data that differs along ``axes`` (FSDP's shards over ``data``) a
        round over ``sub`` on each coordinate's rows runs the reference's
        round once per coordinate: each ``data`` coordinate's pod group on
        its own shard, with the keys of every other coordinate (the codec
        folds in the rank over its compression axes only)."""
        axes = self._sub_axes(axes)
        rest = tuple(a for a in self.axes if a not in axes)
        sub = self.over(rest)
        return [(_index(rows), sub) for rows in self._groups(rest)]

    def mean_over(self, x, axes):
        """The exact mean over ``axes`` of the (n, ...) rows, as the rows of
        ``over(the other axes)``: per group, an f32 sum from +0.0 over its
        ranks in rank order, times f32(1/m) (:func:`inner_mean_scale`)."""
        if not axes:
            return x
        self._check(x)
        idx = self._groups(axes)
        self._bytes.inner += x.numel() * x.element_size()
        acc = torch.zeros((len(idx),) + tuple(x.shape[1:]), dtype=torch.float32,
                          device=x.device)
        for k, rows in enumerate(idx):
            for r in rows:
                acc[k] += x[r]
        return acc * inner_mean_scale(len(idx[0]), x.device)

    def pick(self, state, axes):
        """The (K, ...) rows of ``state`` at coordinate 0 of ``axes``, as the
        rows of ``over(the other axes)`` (a copy; :meth:`spread` writes it
        back)."""
        idx = self._groups(axes)
        return torch.stack([state[rows[0]] for rows in idx])

    def spread(self, rows, state, axes):
        """Write each of the (K, ...) ``rows`` into every rank of its group
        over ``axes`` in ``state``, in place: the rows of one group end
        bit-equal."""
        for k, group in enumerate(self._groups(axes)):
            for r in group:
                state[r].copy_(rows[k])

    def fsdp_gather(self, rows, dim: int):
        """FSDP's weight gather: the (n, *shard) rows, each rank's shard,
        joined along ``dim`` of the shard into the whole tensor every rank
        holds."""
        self._check(rows)
        return torch.cat(tuple(rows), dim=dim)

    def reduce_scatter(self, rows, dim: int):
        """FSDP's gradient reduce-scatter of bf16 tensors: the (n, *full)
        rows, each rank's whole tensor, summed over the ranks in f32 from
        +0.0 in rank order and rounded once to bf16 (as XLA on the CPU sums
        a bf16 ``psum_scatter``), then cut along ``dim`` of the tensor:
        the (n, *shard) rows, rank r's shard of the sum in row r."""
        self._check(rows)
        total = _rank_order_sum(rows).to(torch.bfloat16)
        return torch.stack(torch.chunk(total, self.size, dim=dim))


def inner_mean_scale(m: int, device):
    """f32(1/m) as a 0-dim tensor on ``device``: the inner mean multiplies
    its rank-order sum by it, as the reference's ``pmean`` over the inner
    axes does under ``shard_map`` (XLA lowers the mean's ``/ m`` to a
    multiply by the f32 reciprocal).  At m = 3 that differs from a true
    division; a tensor multiply gives the same bits on the CPU and the
    card."""
    return torch.full((), 1.0 / m, dtype=torch.float32, device=device)


def _index(rows):
    """Evenly spaced row indices as a slice (a view of the stack)."""
    step = rows[1] - rows[0] if len(rows) > 1 else 1
    if step <= 0 or list(rows) != list(range(rows[0], rows[-1] + 1, step)):
        raise ValueError(f"rows {list(rows)} are not evenly spaced")
    return slice(rows[0], rows[-1] + 1, step)


def _rank_order_sum(rows):
    """Σ of the (n, ...) rows in f32, from 0, in rank order."""
    acc = torch.zeros(rows.shape[1:], dtype=torch.float32, device=rows.device)
    for r in range(rows.shape[0]):
        acc += rows[r]
    return acc


class DistComm(_Counted):
    """One rank per process over ``torch.distributed`` (any backend with
    all_gather_into_tensor: NCCL on cards, gloo on CPUs).

    ``psum`` gathers every rank's buffer and sums the rows in f32 from +0.0
    in rank order, as :meth:`StackedComm.psum` does: the same bits at every
    n, for the fixed-k wire's bf16 (where a bf16 all-reduce rounds each
    partial sum in the backend's order) and for f32 buffers (the exact
    mean, the dense simulation, the f32-wire rounds), where an all-reduce
    adds in the backend's order.  Each rank then receives (n − 1)·|buf|
    against a ring all-reduce's 2(n − 1)/n·|buf|, and holds the n rows at
    once.  ``bytes_*`` count this rank's contributions, the buffer it hands
    over.

    ``mesh`` (as for :class:`StackedComm`) lays the world out on named
    axes, pod-major: process rank r sits at the coordinates StackedComm
    gives row r.  The groups of every proper subset of the axes are made
    with ``torch.distributed.new_group`` in the constructor, which every
    process must therefore call in the same order; ``timeout`` (a
    ``datetime.timedelta``), when given, bounds each of their collectives,
    so a rank that never joins one fails the run instead of hanging it.
    :meth:`mean_over` gathers its group's rows and sums them in rank order,
    so it gives StackedComm's bits at every group size.  FSDP runs its
    gathers, reduce-scatters and :meth:`rank_sum` on the ``data`` group's
    view (``over(("data",))``): on a mesh with a ``pod`` axis the world is
    not the group that holds a leaf's shards.
    """

    def __init__(self, group=None, device=None, *, mesh=None, timeout=None, _view=None):
        import torch.distributed as dist

        self._dist = dist
        self._timeout = timeout
        self.device = resolve_device(device)
        if _view is not None:
            parent, axes, inner = _view
            self.group = parent._subgroups[axes]
            self.mesh = tuple(p for p in parent.mesh if p[0] in axes)
            self.rank = parent.ranks_over(axes)[0]
            self.size = math.prod(s for _, s in self.mesh)
            self._local_coords = (tuple(c for p, c in zip(parent.mesh, parent._local_coords[0])
                                        if p[0] in axes),)
            self._subgroups, self._bytes, self._inner = parent._subgroups, parent._bytes, inner
            self._root = parent._root
        else:
            self.group = group
            self.size = dist.get_world_size(group)
            self.rank = dist.get_rank(group)
            self.mesh = None if mesh is None else _mesh_pairs(mesh)
            self._bytes, self._inner, self._subgroups, self._root = _Bytes(), False, {}, self
            if self.mesh is not None:
                if math.prod(s for _, s in self.mesh) != self.size:
                    raise ValueError(f"mesh {mesh} does not hold the {self.size} ranks")
                self._local_coords = (_coords(self.rank, self.mesh),)
                self._make_groups()
        self.axes = None if self.mesh is None else tuple(a for a, _ in self.mesh)
        self.local_ranks = (self.rank,)

    def _make_groups(self):
        names = tuple(a for a, _ in self.mesh)
        coords = [_coords(r, self.mesh) for r in range(self.size)]
        for k in range(1, len(names)):
            for axes in itertools.combinations(names, k):
                rest = tuple(a for a in names if a not in axes)
                groups = {}
                for r, c in enumerate(coords):
                    groups.setdefault(_rank_over(c, self.mesh, rest), []).append(r)
                for ranks in groups.values():
                    ranks.sort(key=lambda r: _rank_over(coords[r], self.mesh, axes))
                    g = self._dist.new_group(ranks, timeout=self._timeout)
                    if self.rank in ranks:
                        self._subgroups[axes] = g
        self._subgroups[names] = self.group

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
        self._count(local, reduced=False)
        return out

    def psum(self, local):
        if local.shape[0] != 1:
            raise ValueError(f"DistComm holds one rank; got {local.shape[0]} rows")
        self._count(local, reduced=True)
        return _rank_order_sum(self._gather(local))

    def over(self, axes, inner: bool = False):
        """The communicator over ``axes`` (this process's group of them),
        sharing the byte counters; see :meth:`StackedComm.over`."""
        if self.mesh is None:
            if inner:
                raise ValueError("a flat communicator has no inner axes: build it with a mesh")
            return self
        axes = self._sub_axes(axes)
        if axes == self.axes and inner == self._inner:
            return self
        return DistComm(device=self.device, _view=(self._root, axes, inner))

    def by_shard(self, axes):
        """[(rows, sub)] as :meth:`StackedComm.by_shard` gives them: this
        process's one row, at its own coordinate of ``axes``, and its group
        over the other axes."""
        axes = self._sub_axes(axes)
        return [(slice(0, 1), self.over(tuple(a for a in self.axes if a not in axes)))]

    def mean_over(self, x, axes):
        """The exact mean over ``axes`` of the (1, ...) row: the group's rows
        gathered and summed as :meth:`StackedComm.mean_over` sums them."""
        if not axes:
            return x
        sub = self.over(axes, inner=True)
        rows = sub._gather(x)
        self._bytes.inner += x.numel() * x.element_size()
        return (_rank_order_sum(rows) * inner_mean_scale(sub.size, x.device))[None]

    def pick(self, state, axes):
        """This process's state row: every rank of its group holds its own."""
        return state

    def rank_sum(self, x):
        """Σ over all ranks of each rank's f32 ``x`` from +0.0 in rank order
        (the sum :class:`StackedComm`'s rows give), off the byte counters:
        the train step's loss, as the reference's psum over the batch axes."""
        return _rank_order_sum(self._gather(x.reshape((1,) + tuple(x.shape))))

    def barrier(self) -> None:
        self._dist.barrier(group=self.group)

    def fsdp_gather(self, rows, dim: int):
        """FSDP's weight gather: this rank's (1, *shard) row and its peers',
        received whole (``all_gather_into_tensor``) and joined along
        ``dim`` of the shard in rank order: the whole tensor."""
        parts = self._gather(rows)
        if dim == 0:
            return parts.reshape((-1,) + tuple(parts.shape[2:]))
        return torch.cat(tuple(parts), dim=dim)

    def reduce_scatter(self, rows, dim: int):
        """FSDP's gradient reduce-scatter of this rank's (1, *full) bf16 row:
        each peer sends this rank only its shard of its tensor
        (``all_to_all_single``: 1/n of each buffer, where a gather would
        bring every peer's whole one), and the n received shards are summed
        in f32 from +0.0 in rank order and rounded once to bf16, as
        :meth:`StackedComm.reduce_scatter` does.  Returns the (1, *shard)
        row of this rank's shard of the sum."""
        if rows.shape[0] != 1:
            raise ValueError(f"DistComm holds one rank; got {rows.shape[0]} rows")
        x = rows[0]
        send = x.unflatten(dim, (self.size, -1)).movedim(dim, 0).contiguous()
        recv = torch.empty_like(send)
        self._dist.all_to_all_single(recv, send, group=self.group)
        return _rank_order_sum(recv).to(torch.bfloat16)[None]

    def spread(self, rows, state, axes):
        if rows is not state:
            state.copy_(rows)


def exact_mean(x, comm):
    """The exact mean over all of the communicator's ranks of the (L, *shape)
    stack (f32 psum / n): over ``cfg.inner_axes + cfg.axes`` for the
    communicator a round runs on."""
    shape, dtype = x.shape[1:], x.dtype
    flat = x.reshape(x.shape[0], -1).to(torch.float32)
    return wire_base.divide(comm.psum(flat), comm.size).reshape(shape).to(dtype)


def _masked_exact_mean(x, drop_mask, comm, cfg):
    """The exact mean over the ranks the drop mask keeps: the
    :func:`partial_mean` contract (NaN when none is kept).  The mask has an
    entry per codec rank over ``cfg.axes`` (the drop unit is the cross-host
    peer): each row takes its codec rank's entry, and the partial mean runs
    over all of the communicator's ranks."""
    keep = wire_base.local_keep(drop_mask, comm, x.device, cfg.axes).to(x.dtype)
    xk = x * keep.reshape((-1,) + (1,) * (x.dim() - 1))
    return partial_mean(xk, keep, comm).to(x.dtype)


def _exact(x, comm, cfg, drop_mask):
    if drop_mask is None:
        return exact_mean(x, comm)
    return _masked_exact_mean(x, drop_mask, comm, cfg)


def compressed_mean(x, key, cfg: t.CompressionConfig, comm, drop_mask=None):
    """Estimate the mean over the communicator's ranks of the (L, *shape)
    stack ``x`` under the configured protocol; returns (*shape).

    A communicator with a mesh must span ``cfg.inner_axes + cfg.axes``; a
    hierarchical config first takes the exact mean over its inner axes and
    runs the codec over ``cfg.axes`` only (DESIGN.md §11,
    :meth:`~repro_torch.core.wire.base.WireCodec.mean_flat`).

    Unbiased for every ported codec: E[result] = the exact mean (Lemmas
    3.1/3.3).  Mode "none" and buckets below ``min_compress_size`` take the
    exact mean.  ``drop_mask`` is an optional 0/1 alive mask over the codec
    ranks of ``cfg.axes`` (1 = keep): dropped peers are left out at decode
    time and the estimate renormalizes over the survivors (NaN when none
    survives); the wire payload is unchanged.
    """
    wire_base.check_mesh(comm, cfg)
    if cfg.mode == "none" or x[0].numel() < cfg.min_compress_size:
        return _exact(x, comm, cfg, drop_mask)
    return registry.resolve(cfg).mean(x, key, cfg, comm, drop_mask)


def compressed_mean_stateful(x, state, key, cfg: t.CompressionConfig, comm, drop_mask=None):
    """One stateful round of the resolved codec over the (L, *shape) stack
    ``x``: returns ((*shape) estimate, new state).

    ``state`` is the (L, ...) local state of the codec (the error-feedback
    residual, one row per local rank), shaped like ``x`` or flat per row;
    it is threaded flat through the codec, updated in place where it is
    already f32 and contiguous, and returned in its own shape.  Under a
    hierarchical config the rows of one inner group end bit-equal
    (:meth:`~repro_torch.core.wire.base.WireCodec.mean_flat_stateful`).
    Stateless codecs, mode "none" and buckets below ``min_compress_size``
    pass it through untouched.  ``drop_mask`` as in
    :func:`compressed_mean`; a dropped rank's residual is still written and
    re-enters through its own later messages.
    """
    wire_base.check_mesh(comm, cfg)
    if cfg.mode == "none" or x[0].numel() < cfg.min_compress_size:
        return _exact(x, comm, cfg, drop_mask), state
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
