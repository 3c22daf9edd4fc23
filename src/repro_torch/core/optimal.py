"""§6-optimal parameters — the part of ``repro.core.optimal`` the wire path
needs: the per-coordinate ternary split of the ``ternary_opt`` codec.

The §6 Bernoulli optimizers (``optimal_probs``, ``alternating_minimization``)
belong to the single-host math and come with ROADMAP slice 7.
"""
from __future__ import annotations

import torch


def _f32(v, device):
    return torch.as_tensor(v, dtype=torch.float32, device=device)


def ternary_optimal_probs(x, q, c1=None, c2=None):
    """§6-optimal per-coordinate (p1, p2) for the ternary encoder (§7.1).

    At fixed pass mass q and centers c1 = min x, c2 = max x the variance of
    coordinate j is convex in s_j = p1_j·c1 + p2_j·c2, minimized at
    s*_j = x_j − q·(c1 + c2)/2 clamped to [(1 − q)c1, (1 − q)c2]; then
    p1 = ((1 − q)c2 − s)/(c2 − c1) and p2 = (1 − q) − p1.  A constant
    vector puts all branch mass on c1.  Returns (p1, p2) shaped like ``x``;
    each expression is one f32 operation, as in the reference.
    """
    x = x.to(torch.float32)
    q = _f32(q, x.device)
    c1 = torch.amin(x) if c1 is None else _f32(c1, x.device)
    c2 = torch.amax(x) if c2 is None else _f32(c2, x.device)
    keep = 1.0 - q
    s = torch.clamp(x - q * (c1 + c2) / 2, keep * c1, keep * c2)
    span = c2 - c1
    one = torch.ones((), dtype=torch.float32, device=x.device)
    p1 = torch.where(span > 0, (keep * c2 - s) / torch.where(span > 0, span, one), keep)
    p1 = p1.expand(x.shape)
    return p1, keep - p1
