"""Trainer: the step loop — port of ``repro.train.trainer`` without
checkpointing.

Batches come from :class:`~repro_torch.data.pipeline.SyntheticLM`, a pure
function of (seed, step), as in the reference.  Checkpoint and restart
(``ckpt_dir``) raise :class:`NotPortedError`.
"""
from __future__ import annotations

import dataclasses
import logging
import time
from typing import Callable, Mapping, Optional

from repro_torch import resolve_device
from repro_torch.configs.base import ArchConfig, RunConfig, ShapeSpec
from repro_torch.core.wire.base import NotPortedError
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.optim.optimizers import AdamWConfig
from repro_torch.train import train_step as ts

log = logging.getLogger("repro_torch.trainer")


@dataclasses.dataclass
class TrainerConfig:
    steps: int = 100
    ckpt_dir: Optional[str] = None      # raises: checkpointing is not ported
    log_every: int = 10
    seed: int = 0


class Trainer:
    """The ranks of ``mesh`` (axis → size in mesh order, pod-major), or
    ``n`` data-parallel ranks (the flat shorthand ``{"data": n}``), stacked
    on ``device`` (the card unless given); ``on_phase`` as in
    :func:`~repro_torch.train.train_step.build_train_step`."""

    def __init__(self, cfg: ArchConfig, run: RunConfig, shape: ShapeSpec,
                 tcfg: TrainerConfig, n: Optional[int] = None,
                 opt_cfg: Optional[AdamWConfig] = None, device=None,
                 on_phase: Optional[Callable[..., None]] = None, *,
                 mesh: Optional[Mapping[str, int]] = None):
        if tcfg.ckpt_dir is not None:
            raise NotPortedError("checkpointing (TrainerConfig.ckpt_dir) is not ported yet "
                                 "(ROADMAP.md, queue 1)")
        self.cfg, self.run, self.shape, self.tcfg = cfg, run, shape, tcfg
        self.device = resolve_device(device)
        # sync_plan is THE grad-sync plan the step executes (None = per-leaf)
        self.step_fn, self.init_fn, self.sync_plan = ts.build_train_step(
            cfg, run, shape, n, opt_cfg, base_seed=tcfg.seed, device=self.device,
            on_phase=on_phase, mesh=mesh)
        self.mesh = ts.resolve_mesh(n, mesh)
        self.data = SyntheticLM(cfg, shape, seed=tcfg.seed)
        self.metrics_history = []
        # the error-feedback state after fit(): per compressed bucket (or
        # leaf) the (n, size) residuals; examples read their norms here
        self.ef_state = None

    def fit(self):
        """Run ``tcfg.steps`` steps from freshly drawn parameters; returns
        (params, opt_state, metrics_history) and keeps the last
        error-feedback state in :attr:`ef_state`.  A step's metrics are
        logged (as floats, with ``step`` and ``sec``) at the first step and
        every ``log_every`` steps."""
        params, opt_state, ef = self.init_fn(self.tcfg.seed)
        t0 = time.time()
        for step in range(self.tcfg.steps):
            batch = self.data.batch(step, self.device)
            params, opt_state, ef, metrics = self.step_fn(params, opt_state, ef, batch, step)
            if (step + 1) % self.tcfg.log_every == 0 or step == 0:
                m = {k: float(v) for k, v in metrics.items()}
                m["step"] = step
                m["sec"] = time.time() - t0
                self.metrics_history.append(m)
                log.info("step %d loss %.4f gnorm %.3f", step, m["loss"], m["grad_norm"])
        self.ef_state = ef
        return params, opt_state, self.metrics_history
