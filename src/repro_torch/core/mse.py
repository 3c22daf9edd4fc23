"""Closed-form MSE of the encoding protocols — the parts of
``repro.core.mse`` the ported codecs need: Lemma 3.2 at uniform p, Lemma
3.4 and the shared-support fixed-k form, Example 4 (binary) with its
bound, the corrected Lemma 7.2 (ternary), and the §7.2 rotation's
composition rule.

Conventions: xs is (n, d); mus (n,).  The sums run one node row at a time,
so a full-width bucket needs one (d,) temporary, not an (n, d) one.
"""
from __future__ import annotations

import torch

from repro_torch.core import rotation


def mse_bernoulli(xs, p: float, mus):
    """Lemma 3.2 at uniform probabilities p:
    MSE = (1/n²) Σ_ij (1/p − 1)(X_i(j) − μ_i)²."""
    n = xs.shape[0]
    total = sum(torch.sum((xs[i] - mus[i]) ** 2) for i in range(n))
    return (1.0 / p - 1.0) * total / n ** 2


def mse_fixed_k(xs, k, mus):
    """Lemma 3.4:  MSE = (1/n²) Σ_ij ((d−k)/k)(X_i(j) − μ_i)²."""
    n, d = xs.shape
    total = sum(torch.sum((xs[i] - mus[i]) ** 2) for i in range(n))
    return (d - k) / k * total / n ** 2


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


def mse_binary(xs):
    """Example 4:  (1/n²) Σ_ij (X^max_i − X_i(j))(X_i(j) − X^min_i)."""
    n = xs.shape[0]
    total = sum(torch.sum((torch.amax(x) - x) * (x - torch.amin(x))) for x in xs)
    return total / n ** 2


def mse_binary_bound(xs):
    """Example 4 / [10, Thm 1] bound:  d/(2n) · (1/n) Σ_i ||X_i||²."""
    n, d = xs.shape
    return d / (2 * n) * (sum(torch.sum(x * x) for x in xs) / n)


def mse_ternary(xs, p1, p2, c1s, c2s):
    """Eq. (21), corrected Lemma 7.2: per coordinate
    p1(X−c1)² + p2(X−c2)² + (p1(X−c1) + p2(X−c2))² / (1−p1−p2), summed and
    divided by n².  ``p1``/``p2`` are scalars, (d,) or (n, d)."""
    n = xs.shape[0]
    total = 0.0
    for i in range(n):
        a = torch.as_tensor(p1, dtype=xs.dtype, device=xs.device)
        b = torch.as_tensor(p2, dtype=xs.dtype, device=xs.device)
        a = a[i] if a.dim() == 2 else a
        b = b[i] if b.dim() == 2 else b
        d1 = xs[i] - c1s[i]
        d2 = xs[i] - c2s[i]
        rest = 1.0 - a - b
        restsafe = torch.where(rest > 0, rest, torch.ones_like(rest))
        total = total + torch.sum(a * d1 ** 2 + b * d2 ** 2 + (a * d1 + b * d2) ** 2 / restsafe)
    return total / n ** 2


# --- §7.2: random-rotation pre-processing -------------------------------- #

def mse_rotated(xs, krot, base_mse_fn):
    """§7.2 composition rule: the rotated protocol's MSE conditional on Q.

    With a shared orthogonal Q (seed ``krot``), E‖Qᵀz̄ − X̄‖² = E‖z̄ − QX̄‖²:
    the base protocol's closed form at the rotated data.  At a
    non-power-of-two d the rotated basis has padded_dim(d) coordinates and
    truncation makes it an upper bound; at power-of-two d it is exact.
    ``base_mse_fn`` maps the rotated (n, dp) stack to the base closed form.
    """
    return base_mse_fn(rotation.rotate(krot, xs))


def mse_rotated_binary(xs, krot):
    """Rotated binary quantization (§7.2 ∘ Example 4): Example 4 at QX."""
    return mse_rotated(xs, krot, mse_binary)


def mse_rotated_fixed_k(xs, k, krot):
    """Rotated fixed-k (§7.2 ∘ Lemma 3.4): Lemma 3.4 at QX, with the
    rotated-basis dimension dp = padded_dim(d) in its (dp − k)/k factor and
    each rank's center the mean of its rotated vector."""
    zs = rotation.rotate(krot, xs)
    return mse_fixed_k(zs, k, torch.mean(zs, dim=-1))
