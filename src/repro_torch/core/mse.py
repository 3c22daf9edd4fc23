"""Closed-form MSE of the encoding protocols — port of ``repro.core.mse``:
Lemma 3.2 (Bernoulli, at a uniform p or per-coordinate probabilities with
the Remark 1 semantics), Lemma 3.4 and the shared-support fixed-k form,
Example 4 (binary) with its bound, the corrected Lemma 7.2 (ternary), the
§7.2 rotation's composition rule, and the Theorem 6.1 forms with R and the
heterogeneity term, and the §14 bounds of the trimmed decode.

Conventions: xs is (n, d); mus (n,).  The sums run one node row at a time,
so a full-width bucket needs one (d,) temporary, not an (n, d) one.
"""
from __future__ import annotations

import torch

from repro_torch.core import rotation


def r_factor(xs, mus):
    """R = (1/n) Σ_i ‖X_i − μ_i·1‖²  (§5.2 / Thm 6.1)."""
    n = xs.shape[0]
    return sum(torch.sum((xs[i] - mus[i]) ** 2) for i in range(n)) / n


def mse_bernoulli(xs, probs, mus):
    """Lemma 3.2:  MSE = (1/n²) Σ_ij (1/p_ij − 1)(X_i(j) − μ_i)².

    ``probs`` is a scalar p, (d,) or (n, d).  p_ij = 0 contributes 0 where
    X_i(j) = μ_i and ∞ elsewhere (Remark 1: the optimal solutions of §6.1
    assign p = 0 only where X_i(j) = μ_i).
    """
    n = xs.shape[0]
    p = torch.as_tensor(probs, dtype=xs.dtype).to(xs.device)
    total = 0.0
    for i in range(n):
        dev2 = (xs[i] - mus[i]) ** 2
        pi = p[i] if p.dim() == 2 else p
        if pi.dim() == 0 and bool(pi > 0):      # one factor, no (d,) temporaries
            total = total + (1.0 / pi - 1.0) * torch.sum(dev2)
            continue
        psafe = torch.where(pi > 0, pi, torch.ones_like(pi))
        never = torch.where(dev2 > 0, torch.full_like(dev2, float("inf")), torch.zeros_like(dev2))
        total = total + torch.sum(torch.where(pi > 0, (1.0 / psafe - 1.0) * dev2, never))
    return total / n ** 2


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


# --- Theorem 6.1 --------------------------------------------------------- #

def heterogeneity(xs):
    """Σ_i ‖X_i − X̄‖², the data-dispersion term."""
    xbar = torch.mean(xs, dim=0)
    return sum(torch.sum((x - xbar) ** 2) for x in xs)


# --- §14: the robust (trimmed) decode ----------------------------------- #

def mse_trimmed(base_mse, xs, f: int):
    """Clean-regime bound on the trim(f) decoder's MSE (the reference's
    docs/DESIGN.md §14): m = n − 2f kept rows a coordinate, Cauchy–Schwarz
    over the ≤ n active terms gives

        MSE_trim ≤ (n²·MSE_mean + Σ_i ‖X_i − X̄‖²) / (n − 2f),

    valid for any rule keeping n − 2f rows a coordinate.  ``f = 0`` returns
    ``base_mse`` itself: trim(0) is the averaging decoder."""
    n = xs.shape[0]
    if f == 0:
        return base_mse
    if n <= 2 * f:
        raise ValueError(f"trim({f}) undefined for n={n}: needs n > 2f")
    return (n * n * base_mse + heterogeneity(xs)) / (n - 2 * f)


def mse_trimmed_bernoulli(xs, probs, mus, f: int):
    """:func:`mse_trimmed` over the Lemma 3.2 Bernoulli closed form."""
    return mse_trimmed(mse_bernoulli(xs, probs, mus), xs, f)


def mse_trimmed_binary(xs, f: int):
    """:func:`mse_trimmed` over the Example 4 binary closed form."""
    return mse_trimmed(mse_binary(xs), xs, f)


def thm61_bounds(xs, mus, B):
    """MSE bounds of the optimal protocol under budget B (Thm 6.1, Eq. 19):
    (1/B − 1)·R/n ≤ MSE* ≤ (|S|/B − 1)·R/n, S = {(i, j): X_i(j) ≠ μ_i}."""
    n = xs.shape[0]
    R = r_factor(xs, mus)
    S = sum(torch.sum(xs[i] != mus[i]) for i in range(n))
    return (1.0 / B - 1.0) * R / n, (S / B - 1.0) * R / n


def thm61_exact_low_budget(xs, mus, B):
    """Eq. (20): the exact optimal MSE W²/(n²B) − R/n when
    B ≤ Σ a_ij / max a_ij, with a_ij = |X_i(j) − μ_i| and W = Σ a_ij."""
    n = xs.shape[0]
    W = sum(torch.sum(torch.abs(xs[i] - mus[i])) for i in range(n))
    return W ** 2 / (n ** 2 * B) - r_factor(xs, mus) / n
