"""Data-parallel train step — port of ``repro.train.train_step``: the n
ranks stacked on one device, or one rank per process.

The reference runs the step per device inside ``shard_map``.  Here the
ranks of the mesh (the ``data`` axis, or ``(pod, data)`` with the
multi-pod compression over ``pod``) are the local ranks of a communicator:
with :class:`StackedComm` (the default) all n run one after another on one
device, in mesh order; with :class:`DistComm` each process holds one.  Each
rank's forward and backward run on its own slice of the global batch (the
rows the reference's ``P(("pod", "data"))`` batch sharding gives it)
against the same replicated parameters, and its f32 gradients go into its
row of an (L, *shape) stack per leaf, L the local rank count.  Each rank's
loss is its local CE sum over the *global* token count
(``model.train_loss``), so the synced mean is 1/n of the global batch's
gradient, as in the reference; the step's loss is the f32 sum over ranks
from 0 in rank order, as ``psum`` over the batch axis gives it.

Then the gradient sync (DESIGN.md §4): bucketed when
``cmp.bucket.enabled``, else the per-leaf :func:`sync_grads`, with the key
``fold_in(PRNGKey(base_seed), step)``; the global gradient norm; AdamW.
With ``cmp.error_feedback`` the sync is the stateful ``ef_*`` round and the
step threads the residuals: per bucket an (L, size) stack
(:func:`repro_torch.train.bucketing.init_ef_state`), per leaf an (L,
*shape) one, each row one rank's own residual, updated in place.

Issue schedule, by the reference's rule (:func:`overlap_enabled`):
bucketed sync, ``cmp.bucket.overlap`` and one microbatch select the
backward-pipelined schedule (:func:`repro_torch.train.bucketing
.overlap_params`): the last local rank's backward carries one sync point
per bucket, each running the bucket's round (on a side stream on the card)
once its cotangents are complete.  Otherwise the post-backward schedule
(:func:`repro_torch.train.bucketing.sync_grads_bucketed` after the
backward).  The two give the same bits.  ``microbatches > 1`` accumulates
each rank's microbatch gradients in f32, then syncs once.

FSDP (``run.fsdp``, ZeRO-3 over ``data``; the reference's ``gather_fsdp``
and the ``psum_scatter`` its autodiff makes of it).  The leaves whose spec
names ``data`` get no (L, *shape) stack and no sync: their gradient is the
*sum* over the ranks, not the mean (the transpose of the gather sums every
rank's cotangent, and the loss already divides by the global token count).
Each microbatch's rank gradients, each an f32 copy of a bf16 cotangent, are
summed in f32 from +0.0 in rank order and rounded once to bf16, as XLA sums
a bf16 ``psum_scatter``; the rounded sums accumulate in f32 over the
microbatches.  With :class:`DistComm` each process holds only its rank's
shards (``init_fn`` draws each whole leaf, keeps the slice and frees the
rest, leaf by leaf): every layer gathers its bf16 weights and its backward
reduce-scatters their cotangents
(:func:`repro_torch.models.common.gather_fsdp`); stacked, every rank holds
the whole leaf, the "gather" is the cast, and the step sums the ranks.
The loops run microbatches outside ranks, so a microbatch's rank sum is
complete before the next; each rank's rows keep their bits.  The grad norm
sums each FSDP leaf's squares per shard in rank order
(:func:`repro_torch.optim.optimizers.global_norm`), so stacked and
distributed steps give the same bits; AdamW then updates the parameters
and moments in place.  Tensor parallelism raises :class:`NotPortedError`.

FSDP on a (pod, data) mesh (the reference's multi-pod run of an FSDP arch,
the compression over ``pod``): the gathers, reduce-scatters and the norm's
sum run over each pod's ``data`` group, and the FSDP leaves are synced too:
each rank's row of such a leaf's stack is its shard of its pod's sum (the
reduce-scatter over ``data``), and each bucket of them runs its round over
``pod`` once per data coordinate, on that coordinate's shards, with the
same key (:func:`repro_torch.train.bucketing._bucket_round`); the mean
over pod of the pods' sums is n_data × the other leaves' scale.  Stacked,
each pod's data ranks are summed apart, in place into that pod's block of
the (n, *shard) stack (:func:`_pod_sum`: from +0.0 in data order, rounded
once to bf16 after the pod's last data rank), so the stack's rows are the
sums' shards and no second copy is made; under DistComm the data group's
reduce-scatter gives the rank its row.  The backward-pipelined schedule
applies as on one axis: the last local rank's sync points add its
cotangents into the last pod's sum before their rounds (every other pod is
complete by then), so ``overlap_enabled`` and the reported schedule read as
without FSDP, and the two schedules give the same bits.  The synced FSDP
leaves come back in the parameters' layout: whole (stacked) or this
process's shard.  The per-leaf sync (bucketing off) raises there.
"""
from __future__ import annotations

import dataclasses
import logging
import math
from typing import Callable, Dict, Mapping, Optional, Tuple

import torch

from repro_torch import random as prandom
from repro_torch import convert, resolve_device
from repro_torch.configs.base import ArchConfig, RunConfig, ShapeSpec
from repro_torch.configs.registry import param_shapes
from repro_torch.core import collectives as coll
from repro_torch.core import types as core_types
from repro_torch.core.wire.base import NotPortedError
from repro_torch.models import model as model_lib
from repro_torch.models import transformer as tfm
from repro_torch.optim import optimizers as opt_lib
from repro_torch.train import bucketing

log = logging.getLogger("repro_torch.train_step")

def resolve_mesh(n: Optional[int] = None,
                 mesh: Optional[Mapping[str, int]] = None) -> Dict[str, int]:
    """The mesh as {axis: size} in mesh order: ``mesh``, or the flat
    shorthand ``{"data": n}``."""
    if (n is None) == (mesh is None):
        raise ValueError("give either n (the flat data axis) or mesh")
    return {"data": int(n)} if mesh is None else {str(a): int(s) for a, s in dict(mesh).items()}


def grad_sync_plan(run: RunConfig, shapes, specs, mesh_sizes: Mapping[str, int]):
    """The BucketPlan the train step syncs with (None = per-leaf path)."""
    return bucketing.plan_for_run(shapes, specs, tuple(mesh_sizes), mesh_sizes, run.compression)


def overlap_enabled(plan, run: RunConfig) -> bool:
    """THE eligibility rule for the backward-pipelined issue schedule, the
    reference's: bucketed sync, the overlap knob and a single backward
    (accumulated microbatches sync once, after the last)."""
    return (plan is not None and run.compression.bucket.overlap
            and run.microbatches == 1)


def batch_axes_for(cfg: ArchConfig, run: RunConfig, shape: ShapeSpec,
                   mesh_sizes: Mapping[str, int]) -> Tuple[str, ...]:
    """Largest prefix of candidate axes whose product divides global_batch."""
    if run.model_parallel:
        cands = [a for a in ("pod", "data") if a in mesh_sizes]
    else:
        cands = [a for a in ("data", "model") if a in mesh_sizes]
    chosen = []
    prod = 1
    for a in cands:
        if shape.global_batch % (prod * mesh_sizes[a]) == 0:
            chosen.append(a)
            prod *= mesh_sizes[a]
    return tuple(chosen)


def _exact_leaf(g, eaxes, caxes, comm):
    """The reference's exact sync of a leaf: the mean over ``eaxes``, then
    over ``caxes`` (one mean over the whole mesh when either is empty)."""
    if eaxes and caxes:
        return coll.exact_mean(comm.mean_over(g, eaxes), comm.over(caxes))
    return coll.exact_mean(g, comm)


def sync_grads(grads, specs, mesh_axes, cmp: core_types.CompressionConfig, key, comm,
               ef_state=None):
    """Per-leaf sync of (n, *shape) stacks (the ``bucket.enabled = False``
    path), the reference's rule: a leaf's sync axes split into the
    compression axes it spans (caxes) and the others (eaxes); the eaxes get
    an exact mean, then the leaf in sorted-name position i takes one
    compressed-mean round over caxes with key ``fold_in(key, i)`` when its
    per-rank size reaches ``min_compress_size`` (the stateful ``ef_*`` round
    on its (n, *shape) residual when ``ef_state`` is given), else the exact
    mean over caxes.  As in the reference, a hierarchical config's inner
    axes among the eaxes are averaged before the round and again inside it
    (``comm.mean_over``, then the round's inner mean): over an inner group
    of 2 that is the same bits, over 3 it is not always.  Returns (the
    synced (*shape) leaves, the new error-feedback state, None exactly when
    ``ef_state`` is, with every leaf's state: an uncompressed leaf's passes
    through); a leaf whose spec covers every mesh axis comes back as
    given."""
    out = {}
    new_ef = {} if ef_state is not None else None
    for i, (name, g) in enumerate(sorted(grads.items())):
        axes = bucketing.leaf_sync_axes(specs[name], mesh_axes)
        st = ef_state[name] if ef_state is not None else None
        caxes = tuple(a for a in axes if a in cmp.axes)
        eaxes = tuple(a for a in axes if a not in cmp.axes)
        if not (caxes and cmp.mode != "none" and g[0].numel() >= cmp.min_compress_size):
            out[name] = _exact_leaf(g, eaxes, caxes, comm) if axes else g
            if ef_state is not None:
                new_ef[name] = st
            continue
        kleaf = prandom.fold_in(key, i)
        lcfg = dataclasses.replace(cmp, axes=caxes, error_feedback=ef_state is not None)
        pre = tuple(a for a in eaxes if a not in lcfg.inner_axes)
        again = tuple(a for a in eaxes if a in lcfg.inner_axes)
        sub = comm
        if eaxes:
            sub = comm.over(tuple(a for a in comm.axes if a not in pre))
            rows = comm.mean_over(g, eaxes)
            if again:
                g = torch.empty((len(sub.local_ranks),) + tuple(rows.shape[1:]),
                                dtype=rows.dtype, device=rows.device)
                sub.spread(rows, g, again)
            else:
                g = rows
            del rows
        if ef_state is None:
            out[name] = coll.compressed_mean(g, kleaf, lcfg, sub)
            continue
        stp = comm.pick(st, pre) if pre else st
        out[name], stp = coll.compressed_mean_stateful(g, stp, kleaf, lcfg, sub)
        if pre:
            comm.spread(stp, st, pre)
        new_ef[name] = st
    return out, new_ef


def fsdp_leaf_dims(specs: Mapping[str, tuple], axis: str = "data") -> Dict[str, int]:
    """The FSDP leaves of a spec tree: name → the dim of the whole leaf its
    rank shards split (the dim whose spec entry is ``axis``)."""
    return {k: tuple(v).index(axis) for k, v in specs.items() if axis in tuple(v)}


def _timing_event(dev):
    """A timing CUDA event recorded on the current stream, or None on the CPU."""
    if torch.device(dev).type != "cuda":
        return None
    ev = torch.cuda.Event(enable_timing=True)
    ev.record()
    return ev


def _pod_sum(stack, g, r: int, n_data: int, dim: int, comm) -> None:
    """Rank ``r``'s gradient ``g`` of a whole FSDP leaf (split along ``dim``)
    into its pod's sum, in place: the pod's (n_data, *shard) block of the
    (n, *shard) f32 ``stack`` holds shard e of the sum in row e (the rows
    the reference's reduce-scatter over ``data`` gives the pod's ranks).
    Summed from +0.0 in data order and rounded once to bf16 after the pod's
    last data rank, as XLA sums a bf16 ``psum_scatter``; the bytes a
    reduce-scatter would be handed (the rank's bf16 cotangent) are
    counted."""
    comm.count_fsdp(g.numel() * 2)
    p, d = divmod(r, n_data)
    rows = stack[p * n_data:(p + 1) * n_data]
    g = g.unflatten(dim, (n_data, -1)).movedim(dim, 0)
    if d == 0:
        torch.add(g, 0.0, out=rows)
    else:
        rows.add_(g)
    if d == n_data - 1:
        rows.copy_(rows.to(torch.bfloat16))


def _add_rank(acc, k, g, dist: bool, comm) -> None:
    """One rank's gradient ``g`` of FSDP leaf ``k`` into this microbatch's
    rank sum ``acc``.  Under DistComm the backward's reduce-scatter has
    summed it already (this rank's shard, f32 of bf16); stacked, the f32
    sum over the ranks runs here, in place, from +0.0 in rank order, and the
    bytes a reduce-scatter would be handed (the rank's bf16 cotangent) are
    counted."""
    if dist:
        acc[k] = g
        return
    comm.count_fsdp(g.numel() * 2)
    if k in acc:
        acc[k].add_(g)
    else:
        acc[k] = g.add_(0.0)


def _rows(batch: Dict[str, torch.Tensor], part: int, parts: int) -> Dict[str, torch.Tensor]:
    """Part ``part`` of ``parts`` equal slices of every leaf's rows."""
    rows = next(iter(batch.values())).shape[0] // parts
    return {k: v[part * rows:(part + 1) * rows] for k, v in batch.items()}


def comm_mesh(comm) -> Dict[str, int]:
    """A communicator's mesh as {axis: size}: its named axes, or the flat
    ``{"data": size}``."""
    return dict(comm.mesh) if comm.mesh is not None else {"data": comm.size}


def build_train_step(cfg: ArchConfig, run: RunConfig, shape: ShapeSpec, n: Optional[int] = None,
                     opt_cfg: Optional[opt_lib.AdamWConfig] = None, base_seed: int = 0,
                     device=None, on_phase: Optional[Callable[..., None]] = None,
                     *, mesh: Optional[Mapping[str, int]] = None, comm=None):
    """Returns (step_fn, init_fn, plan) on ``device`` (the card unless given).

    ``mesh`` maps axis names to sizes in mesh order, pod-major (``{"pod":
    2, "data": 4}``); ``n`` is the flat shorthand ``{"data": n}``.  Every
    mesh axis must carry the batch (``batch_axes_for``): rank r takes slice
    r of the global batch, as the reference's ``P(("pod", "data"))`` batch
    sharding gives it.  ``comm`` is the communicator: None stacks the ranks
    on ``device`` (:class:`StackedComm`, L = n rows); a :class:`DistComm`
    makes the step hold its one rank (L = 1), the mesh being the
    communicator's (``n`` and ``mesh``, if given, must match it).

    ``step_fn(params, opt_state, ef_state, batch, step) -> (params,
    opt_state, ef_state, metrics)`` (under FSDP the update is in place: the
    returned parameters and moments are the given tensors) with metrics
    ``loss``, ``grad_norm`` and ``lr`` (f32 device scalars), and for a config with an MoE
    sub-config (the MoE and hybrid families) ``aux``, the
    layers' summed aux loss averaged over ranks and microbatches (the
    loss holds it over the layer count, per rank and microbatch); ``batch``
    is the global batch
    (``SyntheticLM.batch``).  ``init_fn(seed) -> (params, opt_state,
    ef_state)``: with error feedback the zero residuals, (L, size) per
    compressed bucket (bucketed) or (L, *shape) per leaf, else ``{}``.
    ``plan`` is the BucketPlan the step syncs with (None = per-leaf path).

    ``on_phase(name, **state)``, when given, is called as a step starts
    (``"start"``, with ``step``) and after each of its phases:
    ``"backward"`` once the last backward kernel is enqueued (``grads``:
    the (L, *shape) stacks and the FSDP leaves' rank sums; under the
    overlapped schedule the rounds are enqueued by then too;
    ``reduce_events``: on the card, the (start, end) timing events around
    each stretch of the stacked ranks' FSDP rank sum and its rounding,
    within the backward phase, the last rank's adds into the last pod's
    sum that its sync points make included; none under DistComm, whose
    reduce-scatters run inside the backward), ``"sync"`` once the current stream waits on
    every round (``grads``, ``synced``, ``key``, the communicator ``comm``,
    the new ``ef_state``, ``schedule`` — ``"backward-pipelined"`` or
    ``"post-backward"`` — and ``rounds``, the
    :class:`~repro_torch.train.bucketing.RoundLog` of a bucketed sync, else
    None) and ``"update"`` (``params``, ``opt_state``) — for diagnostics
    and timing; the step does not depend on it.
    """
    dev = resolve_device(device)
    tfm.check_family(cfg)
    use_ef = run.compression.error_feedback
    opt_cfg = opt_cfg or opt_lib.AdamWConfig()
    if comm is None:
        msizes = resolve_mesh(n, mesh)
        comm = coll.StackedComm(device=dev, mesh=msizes)
    else:
        msizes = comm_mesh(comm)
        if (n, mesh) != (None, None) and resolve_mesh(n, mesh) != msizes:
            raise ValueError(f"the communicator's mesh {msizes} is not {resolve_mesh(n, mesh)}")
    n = math.prod(msizes.values())
    local = tuple(comm.local_ranks)
    rows = len(local)
    dist = isinstance(comm, coll.DistComm)
    mesh_axes = tuple(msizes)
    if run.fsdp and tuple(a for a in mesh_axes if a != "model") not in (("data",),
                                                                       ("pod", "data")):
        raise NotPortedError(f"FSDP on the mesh {msizes} is not ported: the port shards over "
                             "data, on a (data) or (pod, data) mesh")
    # FSDP's gathers, reduce-scatters and norm run over the data group; a pod
    # axis makes each FSDP leaf a stack of shards synced over pod
    dcomm = comm.over(("data",)) if dist else None
    pods = run.fsdp and "pod" in msizes
    n_data = msizes["data"]
    ctx = model_lib.make_ctx(cfg, run, msizes, comm=dcomm if run.fsdp else None)
    shapes, specs = param_shapes(cfg, fsdp="data" if run.fsdp else None)
    fsdp_dims = fsdp_leaf_dims(specs)
    # the leaves whose rank gradients the step sums, not written to rows
    summed = () if pods and dist else tuple(sorted(fsdp_dims))
    # each rank's row of a leaf's stack: its shard of an FSDP leaf with a pod axis
    row_shapes = {k: (bucketing.local_shape(shapes[k], specs[k], msizes) if pods
                      and k in fsdp_dims else tuple(shapes[k])) for k in shapes}
    if batch_axes_for(cfg, run, shape, msizes) != mesh_axes:
        raise NotPortedError(f"a global batch of {shape.global_batch} does not split over "
                             f"the mesh {msizes}: replicated batches are not ported")
    if (shape.global_batch // n) % run.microbatches:
        raise ValueError(f"{shape.global_batch // n} rows per rank do not split into "
                         f"{run.microbatches} microbatches")
    global_tokens = float(shape.global_batch * shape.seq_len)
    plan = grad_sync_plan(run, shapes, specs, msizes)
    if pods and plan is None:
        raise NotPortedError("FSDP on a mesh with a pod axis syncs through the bucketed sync: "
                             "the per-leaf sync (bucket.enabled = False) is not ported for it")
    use_overlap = overlap_enabled(plan, run)
    schedule = "backward-pipelined" if use_overlap else "post-backward"
    if plan is not None:
        n_cmp = sum(1 for b in plan.buckets if b.kind == "compressed")
        log.info("grad sync: %d buckets (%d compressed), schedule=%s, overlap=%s",
                 len(plan.buckets), n_cmp, plan.schedule(), schedule)
    # the overlapped rounds' stream on the card
    side = torch.cuda.Stream(device=dev) if use_overlap and dev.type == "cuda" else None
    key0 = prandom.PRNGKey(base_seed)
    names = sorted(shapes)
    notify = on_phase or (lambda name, **state: None)
    mbs = run.microbatches

    def step_fn(params, opt_state, ef_state, batch, step):
        notify("start", step=int(step))
        key = prandom.fold_in(key0, int(step))
        leaves = {k: params[k].detach().requires_grad_() for k in names}
        # the sync's input: an (L, *shape) f32 stack per leaf, one row a local
        # rank; on a data-only mesh each FSDP leaf's gradient summed over the
        # ranks (local shards under DistComm), with a pod axis a stack of each
        # rank's shard of its pod's sum
        grads = {k: torch.empty((rows,) + row_shapes[k], dtype=torch.float32, device=dev)
                 for k in names if k not in fsdp_dims or pods}
        reduce_events = []
        absorb = None
        if pods and summed:
            def absorb(k, g):
                # the last stacked rank's cotangent, taken by its sync point
                if k in summed:
                    start = _timing_event(dev)
                    _pod_sum(grads[k], g, local[-1], n_data, fsdp_dims[k], comm)
                    reduce_events.append((start, _timing_event(dev)))
                else:
                    grads[k][rows - 1].copy_(g)
        ef_in = ef_state if use_ef else None
        sync = None
        losses = [[] for _ in local]
        auxes = [[] for _ in local]
        for mb in range(mbs):
            acc = {}           # this microbatch's FSDP gradients, summed over the ranks
            if pods and summed:
                acc = grads if mb == 0 else {k: torch.empty_like(grads[k]) for k in summed}
            for i, r in enumerate(local):
                mb_batch = _rows(_rows(batch, r, n), mb, mbs)
                tagged = leaves
                if use_overlap and i == rows - 1:
                    tagged, sync = bucketing.overlap_params(leaves, plan, run.compression, key,
                                                            comm, grads, i, ef_in, side,
                                                            absorb)
                loss, lm = model_lib.train_loss(ctx, tagged, cfg, run, mb_batch, global_tokens)
                auxes[i].append(lm["aux"].detach())
                losses[i].append(loss.detach())
                got = list(torch.autograd.grad(loss, [leaves[k] for k in names],
                                               allow_unused=sync is not None))
                del loss, lm, tagged
                for j, k in enumerate(names):
                    # None: bucketed, its sync point took the cotangent
                    if k in summed or got[j] is None:
                        continue
                    if mb == 0:
                        grads[k][i].copy_(got[j])
                    else:
                        grads[k][i].add_(got[j])
                    got[j] = None
                start = _timing_event(dev)
                for j, k in enumerate(names):
                    if k not in summed or got[j] is None:
                        continue
                    if pods:
                        _pod_sum(acc[k], got[j], r, n_data, fsdp_dims[k], comm)
                    else:
                        _add_rank(acc, k, got[j], dist, comm)
                    got[j] = None
                if summed and not dist:
                    reduce_events.append((start, _timing_event(dev)))
                del got
            if pods:
                if mb:
                    for k, a in acc.items():
                        grads[k].add_(a)
                del acc
                continue
            start = _timing_event(dev)
            for k, a in acc.items():
                # the reference's psum_scatter rounds its f32 rank sum once to
                # bf16; the microbatches accumulate the rounded sums in f32
                if not dist:
                    a.copy_(a.to(torch.bfloat16))
                if mb == 0:
                    grads[k] = a
                else:
                    grads[k].add_(a)
            if acc and not dist:
                reduce_events.append((start, _timing_event(dev)))
            del acc
        loss_all = torch.zeros((), dtype=torch.float32, device=dev)
        aux_all = torch.zeros((), dtype=torch.float32, device=dev)
        for i in range(rows):
            loss_r = torch.zeros((), dtype=torch.float32, device=dev)
            for mb in range(mbs):
                loss_r = loss_r + losses[i][mb]
                aux_all = aux_all + auxes[i][mb]
            loss_all = loss_all + loss_r
        notify("backward", grads=grads, reduce_events=reduce_events)
        rounds = None
        if sync is not None:
            synced, new_ef = sync.finish()
            rounds = sync.rounds
            del sync
        elif plan is not None:
            rounds = bucketing.RoundLog()
            synced, new_ef = bucketing.sync_grads_bucketed(grads, plan, run.compression, key,
                                                           comm, ef_in, rounds)
        else:
            synced, new_ef = sync_grads(grads, specs, mesh_axes, run.compression, key, comm,
                                        ef_in)
        if use_ef:
            ef_state = new_ef
        if pods:
            # each FSDP leaf's (K, *shard) estimates → the parameter's layout:
            # this process's shard, or the whole leaf from its n_data shards
            for k in fsdp_dims:
                est = synced.pop(k)
                synced[k] = est[0] if dist else convert.fsdp_unshard(est.unbind(0), specs[k])
                del est
        notify("sync", grads=grads, synced=synced, key=key, comm=comm, ef_state=ef_state,
               schedule=schedule, rounds=rounds)
        del grads
        gnorm = opt_lib.global_norm(synced, fsdp_dims, shards=1 if dist else n_data,
                                    rank_sum=dcomm.rank_sum if dist else None)
        params, opt_state = opt_lib.adamw_update(opt_cfg, synced, opt_state, params,
                                                 grad_norm=gnorm, in_place=run.fsdp)
        notify("update", params=params, opt_state=opt_state)
        if dist:
            loss_all = comm.rank_sum(loss_all)
        metrics = {"loss": loss_all, "grad_norm": gnorm,
                   "lr": opt_lib.lr_at(opt_cfg, opt_state.step - 1)}
        if cfg.moe is not None:
            if dist:
                aux_all = comm.rank_sum(aux_all)
            metrics["aux"] = aux_all / torch.tensor(float(n * mbs),
                                                    dtype=torch.float32, device=dev)
        return params, opt_state, ef_state, metrics

    def init_fn(seed: int):
        keep = None
        if fsdp_dims and dist:
            def keep(name, x):
                if name not in fsdp_dims:
                    return x
                return convert.fsdp_shard(x, specs[name], dcomm.rank, n_data).clone()
        params = model_lib.init(seed, cfg, device=dev, keep=keep)
        if use_ef and plan is not None:
            ef_state = bucketing.init_ef_state(plan, run.compression, rows, dev)
        elif use_ef:
            ef_state = {k: torch.zeros((rows,) + tuple(v.shape), dtype=torch.float32, device=dev)
                        for k, v in params.items()}
        else:
            ef_state = {}
        return params, opt_lib.adamw_init(params), ef_state

    return step_fn, init_fn, plan
