"""The paper's randomized, unbiased encoders (§3, §5, §7.1) — port of
``repro.core.encoders``.

Every encoder maps one (d,) vector x to a random (d,) vector y (the Y_i of
the paper) with E[y] = x, plus what travels on the wire (support, centers,
branch symbols).  The uniform draws are the reference's ``jax.random``
streams, bit for bit (:mod:`repro_torch.random`), and every expression is
one PyTorch op per reference op, so nothing is fused into an FMA: the
binary support, the ternary branches and values equal the reference's
(tests/test_torch_encoders.py).

Scalars stay 0-dim tensors where the reference broadcasts a scalar to
(d,), which gives the same f32 results without the (d,) copies.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch import random as prandom
from repro_torch.core import centers as centers_lib
from repro_torch.core import optimal as optimal_lib
from repro_torch.core import types as t
from repro_torch.kernels.fixed_k_encode import ref as fk_ref


class Encoded(NamedTuple):
    """One encoded vector: ``y`` the dense (d,) message, ``mu`` the node
    center, ``support`` (d,) bool where y ≠ μ, ``nsent`` |S_i| (int32),
    ``extras`` the protocol's wire payloads (binary vmin/vmax, ternary
    c1/c2/branch)."""

    y: torch.Tensor
    mu: torch.Tensor
    support: torch.Tensor
    nsent: torch.Tensor
    extras: dict


def _f32(v, device):
    return torch.as_tensor(v, dtype=torch.float32, device=device)


def _count(mask):
    return torch.sum(mask, dtype=torch.int32)


def encode_bernoulli(key, x, probs, mu) -> Encoded:
    """Eq. (1): Y(j) = X(j)/p_j − (1−p_j)/p_j · μ with prob p_j, else μ.
    ``probs`` is a scalar or (d,); p_j = 0 is never sent (Remark 1)."""
    probs = _f32(probs, x.device)
    mu = _f32(mu, x.device)
    u = prandom.uniform(key, x.shape, x.device)
    sent = u < probs
    psafe = torch.where(probs > 0, probs, torch.ones_like(probs))
    scaled = x / psafe - (1.0 - psafe) / psafe * mu
    y = torch.where(sent, scaled, mu)
    return Encoded(y=y, mu=mu, support=sent, nsent=_count(sent), extras={})


def sample_support(key, d: int, k: int, device=None):
    """A uniform k-subset of {0..d-1} (Gumbel top-k, ties to the lower
    index), sorted (k,) int64 — the D_i of Eq. (4)."""
    return fk_ref.sample_blocks(key, d, k, device)


def encode_fixed_k(key, x, k: int, mu) -> Encoded:
    """Eq. (4): Y(j) = d·X(j)/k − (d−k)/k · μ on a uniform k-subset, else μ."""
    d = x.shape[-1]
    mu = _f32(mu, x.device)
    idx = sample_support(key, d, k, x.device)
    support = torch.zeros(d, dtype=torch.bool, device=x.device)
    support[idx] = True
    scaled = _f32(d / k, x.device) * x - _f32((d - k) / k, x.device) * mu
    y = torch.where(support, scaled, mu)
    return Encoded(y=y, mu=mu, support=support,
                   nsent=torch.tensor(k, dtype=torch.int32), extras={"indices": idx})


def encode_binary(key, x) -> Encoded:
    """Example 4: Y(j) = X^max w.p. (X(j) − X^min)/Δ, else X^min."""
    vmin = torch.amin(x)
    vmax = torch.amax(x)
    delta = vmax - vmin
    one = torch.ones_like(delta)
    p = torch.where(delta > 0, (x - vmin) / torch.where(delta > 0, delta, one),
                    torch.zeros_like(delta))
    u = prandom.uniform(key, x.shape, x.device)
    take_max = u < p
    y = torch.where(take_max, vmax, vmin)
    return Encoded(y=y, mu=vmin, support=take_max,
                   nsent=torch.tensor(x.shape[-1], dtype=torch.int32),
                   extras={"vmin": vmin, "vmax": vmax})


def encode_ternary(key, x, p1, p2, c1, c2) -> Encoded:
    """Eq. (21): Y(j) = c1 w.p. p1_j, c2 w.p. p2_j, else the pass-through
    (X(j) − p1_j·c1 − p2_j·c2)/(1 − p1_j − p2_j).

    ``extras["branch"]`` is the uint8 branch symbol (0 → c1, 1 → c2, 2 →
    pass-through) the packed 2-bit plane ships.
    """
    dev = x.device
    p1, p2, c1, c2 = (_f32(v, dev) for v in (p1, p2, c1, c2))
    rest = 1.0 - p1 - p2
    restsafe = torch.where(rest > 0, rest, torch.ones_like(rest))
    y_rest = (x - p1 * c1 - p2 * c2) / restsafe
    u = prandom.uniform(key, x.shape, dev)
    low = u < p1
    mid = u < p1 + p2
    y = torch.where(low, c1, torch.where(mid, c2, y_rest))
    sent = ~mid
    branch = torch.full(x.shape, 2, dtype=torch.uint8, device=dev)
    branch.masked_fill_(mid, 1).masked_fill_(low, 0)
    return Encoded(y=y, mu=c1, support=sent, nsent=_count(sent),
                   extras={"c1": c1, "c2": c2, "branch": branch})


def encode_identity(x) -> Encoded:
    """Example 1: the lossless identity encoder."""
    return Encoded(y=x, mu=torch.zeros((), dtype=x.dtype, device=x.device),
                   support=torch.ones(x.shape, dtype=torch.bool, device=x.device),
                   nsent=torch.tensor(x.shape[-1], dtype=torch.int32), extras={})


def encode(key, x, spec: t.EncoderSpec, probs=None, mu=None) -> Encoded:
    """Encode one vector according to ``spec``; ``probs``/``mu`` override
    the spec's policies when given."""
    d = x.shape[-1]
    if spec.kind == "identity":
        return encode_identity(x)
    if spec.kind == "binary":
        return encode_binary(key, x)
    if mu is None:
        if spec.center == "optimal" and probs is None and spec.probs == "uniform":
            p0 = torch.full(x.shape, spec.fraction, dtype=x.dtype, device=x.device)
            mu = centers_lib.compute_centers(x, "optimal", p0)
        elif spec.center == "optimal" and probs is not None:
            mu = centers_lib.compute_centers(x, "optimal", probs)
        else:
            policy = spec.center if spec.center != "optimal" else "mean"
            mu = centers_lib.compute_centers(x, policy)
    if spec.kind == "fixed_k":
        return encode_fixed_k(key, x, t.fixed_k_from_fraction(d, spec.fraction), mu)
    if spec.kind == "bernoulli":
        return encode_bernoulli(key, x, spec.fraction if probs is None else probs, mu)
    if spec.kind == "ternary":
        # c1/c2 bracket the data; the pass mass is `fraction` under either
        # split (uniform mid-split or the §6-optimal per-coordinate one)
        c1 = torch.amin(x)
        c2 = torch.amax(x)
        if spec.probs == "optimal":
            p1, p2 = optimal_lib.ternary_optimal_probs(x, spec.fraction, c1, c2)
            return encode_ternary(key, x, p1, p2, c1, c2)
        half = (1.0 - spec.fraction) / 2.0
        return encode_ternary(key, x, half, half, c1, c2)
    raise ValueError(f"unhandled encoder kind {spec.kind!r}")


def encode_batch(key, xs, spec: t.EncoderSpec, probs=None, mus=None) -> Encoded:
    """Independently encode the rows of (n, d) ``xs``, row i with
    ``fold_in(key, i)``; fields gain a leading node axis."""
    rows = [encode(prandom.fold_in(key, i), xs[i], spec,
                   probs=None if probs is None else probs[i],
                   mu=None if mus is None else mus[i])
            for i in range(xs.shape[0])]
    extras = {k: torch.stack([r.extras[k] for r in rows]) for k in rows[0].extras}
    return Encoded(*(torch.stack([getattr(r, f) for r in rows])
                     for f in ("y", "mu", "support", "nsent")), extras)
