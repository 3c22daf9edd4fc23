"""Closed-form MSE of the encoding protocols — the parts of
``repro.core.mse`` the ported codecs need: Lemma 3.2 at uniform p, and the
shared-support fixed-k form.

Conventions: xs is (n, d); mus (n,).  The sums run one node row at a time,
so a full-width bucket needs one (d,) temporary, not an (n, d) one.
"""
from __future__ import annotations

import torch


def mse_bernoulli(xs, p: float, mus):
    """Lemma 3.2 at uniform probabilities p:
    MSE = (1/n²) Σ_ij (1/p − 1)(X_i(j) − μ_i)²."""
    n = xs.shape[0]
    total = sum(torch.sum((xs[i] - mus[i]) ** 2) for i in range(n))
    return (1.0 / p - 1.0) * total / n ** 2


def mse_fixed_k_shared(xs, k, mus):
    """Shared-support fixed-k:  ((d−k)/k) · Σ_j ((1/n) Σ_i (X_i(j) − μ_i))².

    All nodes draw the same support, so the errors couple through the
    common indicator and the node-mean deviation enters squared.
    """
    n, d = xs.shape
    mean_dev = torch.zeros(d, dtype=xs.dtype, device=xs.device)
    for i in range(n):
        mean_dev += xs[i] - mus[i]
    mean_dev /= n
    return (d - k) / k * torch.sum(mean_dev ** 2)
