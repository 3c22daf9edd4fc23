"""Node-center (μ_i) policies — port of ``repro.core.centers``.

* ``zero``    — μ_i = 0;
* ``mean``    — μ_i = (1/d) Σ_j X_i(j);
* ``min``     — μ_i = min_j X_i(j) (Example 4);
* ``optimal`` — Eq. (16): the weighted mean with w_ij = 1/p_ij − 1.

``min`` is exact in both frameworks; ``mean`` and ``optimal`` sum in
another order than jnp and can differ from the reference in the last bits
(tests/test_torch_encoders.py states the tolerance).
"""
from __future__ import annotations

import torch


def compute_centers(x, policy: str, probs=None):
    """μ with shape x.shape[:-1] (one scalar per node row of x)."""
    if policy == "zero":
        return torch.zeros(x.shape[:-1], dtype=x.dtype, device=x.device)
    if policy == "mean":
        return torch.mean(x, dim=-1)
    if policy == "min":
        return torch.amin(x, dim=-1)
    if policy == "optimal":
        if probs is None:
            raise ValueError("optimal centers need probabilities (Eq. 16)")
        return optimal_centers(x, probs)
    raise ValueError(f"unknown center policy {policy!r}")


def optimal_centers(x, probs):
    """Eq. (16): μ_i = Σ_j w_ij X_i(j) / Σ_j w_ij, w_ij = 1/p_ij − 1.

    p = 1 coordinates get zero weight; a node whose weights all vanish
    falls back to the plain mean.
    """
    p = torch.clamp(probs, 1e-12, 1.0)
    w = 1.0 / p - 1.0
    wsum = torch.sum(w, dim=-1)
    one = torch.ones((), dtype=wsum.dtype, device=wsum.device)
    mu = torch.sum(w * x, dim=-1) / torch.where(wsum > 0, wsum, one)
    return torch.where(wsum > 0, mu, torch.mean(x, dim=-1))
