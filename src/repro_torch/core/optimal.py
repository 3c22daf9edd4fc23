"""§6-optimal protocol parameters — port of ``repro.core.optimal``.

Problem (14): minimize Σ_ij (1/p_ij − 1)(X_i(j) − μ_i)² subject to the
budget Σ_ij p_ij ≤ B and 0 < p_ij ≤ 1, jointly over probabilities and
centers.  It is biconvex; §6 alternates (:func:`alternating_minimization`)
between the closed-form centers of Eq. (16) and the water-filled
probabilities p_ij = min(1, a_ij/θ), a_ij = |X_i(j) − μ_i|, with θ the root
of Σ min(1, a/θ) = B found by bisection (:func:`optimal_probs`).  The
ternary codec's per-coordinate split (:func:`ternary_optimal_probs`) rides
the wire path.

The bisection runs in f32, as the reference runs without x64, one 0-dim
tensor operation per reference operation and no host synchronization.  Its
sums add in another order than XLA's, so θ — and the probabilities — agree
with the reference to a few ulps, not bit for bit
(tests/test_torch_protocol.py states the tolerance).
"""
from __future__ import annotations

import torch

from repro_torch.core import centers as centers_lib
from repro_torch.core import mse as mse_lib


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


def optimal_probs(xs, mus, B, iters: int = 64):
    """Water-filled optimal probabilities for fixed centers (§6.1).

    xs: (n, d); mus: (n,); B: the budget on Σ_ij p_ij.  Returns (n, d)
    probabilities p = min(1, a/θ), 0 where a_ij = 0 (Remark 1: never sent,
    no error), with Σ p ≤ B, tight unless B ≥ |S| (then p = 1 on S).
    """
    f32 = torch.float32
    a = torch.abs(xs - mus[:, None]).to(f32)
    S = torch.sum(a > 0).to(f32)
    B = torch.minimum(_f32(B, a.device), S)
    one = torch.ones((), dtype=f32, device=a.device)
    # θ bracket: at θ → 0+, Σ min(1, a/θ) → |S| ≥ B; at θ = Σa/B,
    # Σ min(1, a/θ) ≤ Σ a/θ = B
    lo = _f32(1e-30, a.device)
    hi = torch.maximum(torch.sum(a) / torch.clamp_min(B, 1e-30), lo * 2)
    for _ in range(iters):
        mid = 0.5 * (lo + hi)
        sent = torch.sum(torch.minimum(one, a / mid))
        # sent falls as θ grows: above the budget θ must grow
        lo, hi = torch.where(sent > B, mid, lo), torch.where(sent > B, hi, mid)
    theta = 0.5 * (lo + hi)
    p = torch.minimum(one, a / theta)
    p = torch.where(a > 0, p, torch.zeros_like(p))
    return p.to(xs.dtype)


def optimal_probs_per_node(xs, mus, budgets):
    """Remark 5: per-node budgets B_1..B_n, each node solving its own §6.1
    problem (the reference's ``vmap`` over nodes, as a loop).
    budgets: (n,) bounds on Σ_j p_ij."""
    budgets = torch.as_tensor(budgets, dtype=torch.float32)
    return torch.stack([optimal_probs(xs[i:i + 1], mus[i:i + 1], budgets[i])[0]
                        for i in range(xs.shape[0])])


def alternating_minimization(xs, B, iters: int = 20, init_center: str = "mean"):
    """§6 alternating scheme for the joint (p, μ) problem (14).

    Each step solves the probabilities at the current centers, then the
    Eq. (16) centers at those probabilities, and records the Lemma 3.2 MSE.
    Returns (probs (n, d), mus (n,), mse_trace (iters,)); the trace does not
    increase (each step solves its subproblem exactly).
    """
    mus = centers_lib.compute_centers(xs, init_center)
    probs = torch.zeros_like(xs)
    trace = []
    for _ in range(iters):
        probs = optimal_probs(xs, mus, B)
        mus = centers_lib.optimal_centers(xs, probs)
        trace.append(mse_lib.mse_bernoulli(xs, probs, mus))
    return probs, mus, torch.stack(trace)
