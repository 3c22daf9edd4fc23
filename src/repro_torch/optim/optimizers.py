"""AdamW over parameter dicts — port of ``repro.optim.optimizers`` (AdamW).

States hold one f32 tensor per leaf with the leaf's shape.  Master weights
are the f32 parameters themselves (layers are cast to the compute dtype at
use).  The schedule and the bias corrections are computed in f32 tensors on
the parameters' device, as the reference computes them in f32 arrays (not
in Python doubles, which would move the last bits of every update); the
scalar divisions are by device tensors, true divisions as in the reference.
The update is out of place: it returns new parameter and state dicts.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, NamedTuple

import torch


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    warmup_steps: int = 100
    total_steps: int = 10000
    min_lr_ratio: float = 0.1
    grad_clip: float = 1.0


class AdamWState(NamedTuple):
    step: torch.Tensor                 # () int32
    m: Dict[str, torch.Tensor]
    v: Dict[str, torch.Tensor]


def _f32(x: float, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(x, dtype=torch.float32, device=like.device)


def lr_at(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    """Linear warm-up, then cosine decay to ``min_lr_ratio``; f32 () on
    ``step``'s device."""
    step = step.to(torch.float32)
    warm = torch.clamp((step + 1) / _f32(max(1, cfg.warmup_steps), step), max=1.0)
    prog = torch.clamp((step - cfg.warmup_steps)
                       / _f32(max(1, cfg.total_steps - cfg.warmup_steps), step), 0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(_f32(math.pi, step) * prog))
    return cfg.lr * warm * (cfg.min_lr_ratio + (1 - cfg.min_lr_ratio) * cos)


def adamw_init(params: Dict[str, torch.Tensor]) -> AdamWState:
    some = next(iter(params.values()))
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=some.device),
                      m={k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                         for k, p in params.items()},
                      v={k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                         for k, p in params.items()})


def global_norm(tree: Dict[str, torch.Tensor]) -> torch.Tensor:
    """L2 norm over the leaves: f32 sums of squares added in sorted name
    order, then the square root."""
    ss = None
    for name in sorted(tree):
        term = torch.sum(torch.square(tree[name].to(torch.float32)))
        ss = term if ss is None else ss + term
    return torch.sqrt(ss)


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, grads: Dict[str, torch.Tensor], state: AdamWState,
                 params: Dict[str, torch.Tensor], grad_norm=None):
    """One AdamW step; returns (new params, new state).  Weight decay hits
    every leaf with ``ndim >= 2`` (the stacked (L, d) norm scales too, as in
    the reference); the gradient is clipped to ``grad_clip`` by
    ``grad_norm`` when given."""
    step = state.step + 1
    lr = lr_at(cfg, state.step)
    one = torch.ones((), dtype=torch.float32, device=state.step.device)
    if grad_norm is not None and cfg.grad_clip > 0:
        scale = torch.minimum(one, _f32(cfg.grad_clip, one) / (grad_norm + 1e-9))
    else:
        scale = one
    b1c = 1 - _f32(cfg.b1, one) ** step.to(torch.float32)
    b2c = 1 - _f32(cfg.b2, one) ** step.to(torch.float32)
    new_p, new_m, new_v = {}, {}, {}
    for name, g in grads.items():
        p, m, v = params[name], state.m[name], state.v[name]
        g = g.to(torch.float32) * scale
        m2 = cfg.b1 * m + (1 - cfg.b1) * g
        v2 = cfg.b2 * v + (1 - cfg.b2) * g * g
        delta = (m2 / b1c) / (torch.sqrt(v2 / b2c) + cfg.eps)
        if p.dim() >= 2:        # decay matrices only (and the stacked norm scales)
            delta = delta + cfg.weight_decay * p.to(torch.float32)
        new_p[name] = (p.to(torch.float32) - lr * delta).to(p.dtype)
        new_m[name], new_v[name] = m2, v2
    return new_p, AdamWState(step=step, m=new_m, v=new_v)
