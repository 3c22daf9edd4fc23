"""AdamW over parameter dicts — port of ``repro.optim.optimizers`` (AdamW).

States hold one f32 tensor per leaf with the leaf's shape.  Master weights
are the f32 parameters themselves (layers are cast to the compute dtype at
use).  The schedule and the bias corrections are computed in f32 tensors on
the parameters' device, as the reference computes them in f32 arrays (not
in Python doubles, which would move the last bits of every update); the
scalar divisions are by device tensors, true divisions as in the reference.
The update returns new parameter and state dicts, or (the FSDP step's)
writes the new values in place.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Mapping, NamedTuple, Optional

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


def _sum_sq(t: torch.Tensor) -> torch.Tensor:
    return torch.sum(torch.square(t.to(torch.float32).contiguous()))


def global_norm(tree: Dict[str, torch.Tensor], fsdp_dims: Optional[Mapping[str, int]] = None,
                shards: int = 1, rank_sum: Optional[Callable] = None) -> torch.Tensor:
    """L2 norm over the leaves: f32 sums of squares added in sorted name
    order, then the square root.

    An FSDP leaf (``fsdp_dims``: its name → the dim its rank shards split)
    adds the sum over the ranks, in rank order from +0.0, of each rank's
    shard's sum of squares, as the reference psums each leaf's squares over
    the axes in its spec.  ``tree`` holds it whole, cut here into
    ``shards`` rank shards (the ranks stacked on one device), or one rank's
    shard with ``rank_sum`` the sum over the ranks
    (:meth:`~repro_torch.core.collectives.DistComm.rank_sum`): the same
    bits either way."""
    fsdp_dims = fsdp_dims or {}
    names = sorted(tree)
    sharded = [k for k in names if k in fsdp_dims]
    per_leaf = {}
    if sharded:
        rows = torch.stack([torch.stack([_sum_sq(c) for c in torch.chunk(tree[k], shards,
                                                                           fsdp_dims[k])])
                            for k in sharded], dim=1)               # (shards, leaves)
        tot = torch.zeros(len(sharded), dtype=torch.float32, device=rows.device)
        for r in range(shards):
            tot = tot + rows[r]
        if rank_sum is not None:
            tot = rank_sum(tot)
        per_leaf = dict(zip(sharded, tot.unbind()))
    ss = None
    for name in names:
        term = per_leaf[name] if name in per_leaf else _sum_sq(tree[name])
        ss = term if ss is None else ss + term
    return torch.sqrt(ss)


# elements of a leaf updated at once in place: the update's temporaries stay
# a few times 256 MB however large the leaf
_CHUNK = 1 << 26


def _adamw_leaf(cfg: AdamWConfig, g, p, m, v, scale, lr, b1c, b2c, decay: bool):
    """(new p, new m, new v) of one leaf or a slice of it, elementwise."""
    g = g.to(torch.float32) * scale
    m2 = cfg.b1 * m + (1 - cfg.b1) * g
    v2 = cfg.b2 * v + (1 - cfg.b2) * g * g
    delta = (m2 / b1c) / (torch.sqrt(v2 / b2c) + cfg.eps)
    if decay:               # decay matrices only (and the stacked norm scales)
        delta = delta + cfg.weight_decay * p.to(torch.float32)
    return (p.to(torch.float32) - lr * delta).to(p.dtype), m2, v2


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, grads: Dict[str, torch.Tensor], state: AdamWState,
                 params: Dict[str, torch.Tensor], grad_norm=None, in_place: bool = False):
    """One AdamW step; returns (new params, new state).  Weight decay hits
    every leaf with ``ndim >= 2`` (the stacked (L, d) norm scales too, as in
    the reference); the gradient is clipped to ``grad_clip`` by
    ``grad_norm`` when given.  With ``in_place`` the new values overwrite
    ``params``, ``state.m`` and ``state.v`` (the FSDP step's: its state
    fills the card and has no room for a second copy), ``_CHUNK`` elements
    at a time (elementwise: the same bits as whole); else they are new
    tensors."""
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
        decay = p.dim() >= 2
        if not in_place:
            new_p[name], new_m[name], new_v[name] = _adamw_leaf(cfg, g, p, m, v, scale, lr,
                                                                b1c, b2c, decay)
            continue
        flat = [t.reshape(-1) for t in (g, p, m, v)]
        if any(t.data_ptr() != u.data_ptr() for t, u in zip((p, m, v), flat[1:])):
            raise ValueError(f"{name}: parameters and optimizer state must be contiguous")
        for a in range(0, p.numel(), _CHUNK):
            gc, pc, mc, vc = (t[a:a + _CHUNK] for t in flat)
            for out, new in zip((pc, mc, vc),
                                _adamw_leaf(cfg, gc, pc, mc, vc, scale, lr, b1c, b2c, decay)):
                out.copy_(new)
        new_p[name], new_m[name], new_v[name] = p, m, v
    return new_p, AdamWState(step=step, m=new_m, v=new_v)
