"""Trainer: the step loop with checkpoint and restart — port of
``repro.train.trainer``.

The reference's fault-tolerance contract:

* every ``ckpt_every`` steps the parameters, the optimizer state and the
  step are saved with an atomic commit, the file write overlapping the next
  steps (:class:`~repro_torch.checkpoint.checkpointing.AsyncCheckpointer`);
* on (re)start the trainer resumes from the newest committed checkpoint;
  batches come from :class:`~repro_torch.data.pipeline.SyntheticLM`, a pure
  function of (seed, step), and the sync keys from the step, so the stream
  realigns exactly;
* a checkpoint restores at any rank count and on any mesh: its leaves are
  whole (under FSDP with one rank per process every rank first gathers its
  shards over its data group), and a process that holds FSDP shards
  restores the slices of its data coordinate;
* with one rank per process (``comm``, a :class:`DistComm`) rank 0 writes
  the checkpoints, every rank waits at a barrier after the last save, and
  every rank restores from the same directory.

As in the reference, the error-feedback residuals are not saved: a
restarted run starts them at ``init_fn``'s zeros.
"""
from __future__ import annotations

import dataclasses
import logging
import time
from typing import Callable, Mapping, Optional

from repro_torch import convert, resolve_device
from repro_torch.checkpoint import checkpointing as ckpt
from repro_torch.configs.base import ArchConfig, RunConfig, ShapeSpec
from repro_torch.configs.registry import param_shapes
from repro_torch.core.collectives import DistComm
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.optim.optimizers import AdamWConfig
from repro_torch.train import train_step as ts

log = logging.getLogger("repro_torch.trainer")


@dataclasses.dataclass
class TrainerConfig:
    steps: int = 100
    ckpt_dir: Optional[str] = None      # save there, and resume from its newest step
    ckpt_every: int = 50
    keep_last: int = 3
    log_every: int = 10
    seed: int = 0


class Trainer:
    """The ranks of ``mesh`` (axis → size in mesh order, pod-major), or
    ``n`` data-parallel ranks (the flat shorthand ``{"data": n}``), stacked
    on ``device`` (the card unless given); or, with ``comm`` a
    :class:`DistComm`, this process's one rank of the communicator's mesh.
    ``on_phase`` as in
    :func:`~repro_torch.train.train_step.build_train_step`; :attr:`overlap`
    says whether the step runs the backward-pipelined schedule."""

    def __init__(self, cfg: ArchConfig, run: RunConfig, shape: ShapeSpec,
                 tcfg: TrainerConfig, n: Optional[int] = None,
                 opt_cfg: Optional[AdamWConfig] = None, device=None,
                 on_phase: Optional[Callable[..., None]] = None, *,
                 mesh: Optional[Mapping[str, int]] = None, comm=None):
        self.cfg, self.run, self.shape, self.tcfg = cfg, run, shape, tcfg
        self.device = resolve_device(device)
        # sync_plan is THE grad-sync plan the step executes (None = per-leaf)
        self.step_fn, self.init_fn, self.sync_plan = ts.build_train_step(
            cfg, run, shape, n, opt_cfg, base_seed=tcfg.seed, device=self.device,
            on_phase=on_phase, mesh=mesh, comm=comm)
        self.overlap = ts.overlap_enabled(self.sync_plan, run)
        self.mesh = ts.resolve_mesh(n, mesh) if comm is None else ts.comm_mesh(comm)
        self.dist = comm if isinstance(comm, DistComm) else None
        self.writes = self.dist is None or self.dist.rank == 0
        self.specs = param_shapes(cfg, fsdp="data" if run.fsdp else None)[1]
        # the FSDP leaves (name → the dim their shards split); a process of a
        # DistComm holds only its rank's shards of them
        self.fsdp_dims = ts.fsdp_leaf_dims(self.specs)
        self.sharded = bool(self.fsdp_dims) and self.dist is not None
        # the group that holds an FSDP leaf's shards: the data axis
        self.data_comm = self.dist.over(("data",)) if self.sharded else None
        self.data = SyntheticLM(cfg, shape, seed=tcfg.seed)
        # every save of fit() goes through it: ckpt.history times each one
        self.ckpt = ckpt.AsyncCheckpointer()
        self.metrics_history = []
        # the error-feedback state after fit(): per compressed bucket (or
        # leaf) the (n, size) residuals; examples read their norms here
        self.ef_state = None

    def init_or_restore(self):
        """(start step, params, opt_state, ef_state): freshly drawn, then the
        parameters and optimizer state of the newest checkpoint under
        ``ckpt_dir`` when there is one; the error-feedback state stays
        ``init_fn``'s zeros, as in the reference."""
        params, opt_state, ef = self.init_fn(self.tcfg.seed)
        start = 0
        last = ckpt.latest_step(self.tcfg.ckpt_dir) if self.tcfg.ckpt_dir else None
        if last is not None:
            template = opt_state._replace(m={}, v={})   # the drawn state is freed first
            del params, opt_state
            shard = None
            if self.sharded:
                def shard(name, arr):
                    if name not in self.fsdp_dims:
                        return arr
                    return convert.fsdp_shard(arr, self.specs[name], self.data_comm.rank,
                                              self.data_comm.size)
            start, params, opt_state, _ = ckpt.restore(self.tcfg.ckpt_dir, self.specs, template,
                                                       device=self.device, shard=shard)
            log.info("restored checkpoint at step %d", start)
        return start, params, opt_state, ef

    def fit(self):
        """Run from the start step (0, or the restored one) to ``tcfg.steps``;
        returns (params, opt_state, metrics_history) and keeps the last
        error-feedback state in :attr:`ef_state`.  A step's metrics are
        logged (as floats, with ``step`` and ``sec``) at the start step and
        every ``log_every`` steps.  With ``ckpt_dir``, the state after every
        ``ckpt_every`` steps is saved asynchronously, and after the last save
        has landed the state at ``tcfg.steps`` synchronously: through the same
        checkpointer, waited for (a second save when ``steps`` is a multiple
        of ``ckpt_every``, as in the reference)."""
        start, params, opt_state, ef = self.init_or_restore()
        t0 = time.time()
        for step in range(start, self.tcfg.steps):
            batch = self.data.batch(step, self.device)
            params, opt_state, ef, metrics = self.step_fn(params, opt_state, ef, batch, step)
            if (step + 1) % self.tcfg.log_every == 0 or step == start:
                m = {k: float(v) for k, v in metrics.items()}
                m["step"] = step
                m["sec"] = time.time() - t0
                self.metrics_history.append(m)
                log.info("step %d loss %.4f gnorm %.3f", step, m["loss"], m["grad_norm"])
            if self.tcfg.ckpt_dir and (step + 1) % self.tcfg.ckpt_every == 0:
                self._save(step + 1, params, opt_state)
        self.ckpt.wait()
        self.ef_state = ef
        if self.tcfg.ckpt_dir:
            self._save(self.tcfg.steps, params, opt_state)
            self.ckpt.wait()
        if self.dist is not None and self.tcfg.ckpt_dir:
            self.dist.barrier()
        return params, opt_state, self.metrics_history

    def whole(self, params, opt_state):
        """(params, opt_state) with every leaf whole: as given, or, where this
        process holds FSDP shards, each FSDP leaf and its moments gathered
        from every rank of its data group (a collective: every rank calls
        it; every pod's group holds the same leaves)."""
        if not self.sharded:
            return params, opt_state

        def join(tree):
            return {k: (self.data_comm.fsdp_gather(v[None], self.fsdp_dims[k])
                        if k in self.fsdp_dims else v) for k, v in tree.items()}

        return join(params), opt_state._replace(m=join(opt_state.m), v=join(opt_state.v))

    def _save(self, step: int, params, opt_state) -> None:
        """Save the state after ``step`` steps through the checkpointer, whole,
        on the writing rank; a step that updates in place (FSDP's) waits
        for the device → host copies before it runs."""
        params, opt_state = self.whole(params, opt_state)
        if self.writes:
            self.ckpt.save(self.tcfg.ckpt_dir, step, params, opt_state, self.specs,
                           extra={"arch": self.cfg.name}, keep_last=self.tcfg.keep_last)
            if self.run.fsdp:
                self.ckpt.fence()
