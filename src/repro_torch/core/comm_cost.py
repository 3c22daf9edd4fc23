"""Communication-cost models β (§4) — the parts of ``repro.core.comm_cost``
that the ported codecs need.  All costs are in bits for the full n-node
round.
"""
from __future__ import annotations

import math

from repro_torch.core.types import CommSpec


def cost_sparse_seed_fixed_k(n: int, k: int, spec: CommSpec) -> float:
    """§4.4 Eq. (9) (fixed-size support):  C = n(r̄ + r̄_s) + n·k·r."""
    return float(n * (spec.rbar_bits + spec.rseed_bits) + n * k * spec.r_bits)


def bernoulli_capacity(d: int, p: float, slack_sigmas: float = 6.0) -> int:
    """Wire-buffer slots for the seed-trick Bernoulli protocol:
    cap = min(d, ⌈p·d + slack·σ⌉) with σ = √(d·p(1−p)); the overflow tail
    (≈1e-9 at 6σ) is dropped by encoder and decoder symmetrically."""
    if not (0.0 < p <= 1.0):
        raise ValueError(f"p must be in (0, 1], got {p}")
    sigma = math.sqrt(max(d * p * (1.0 - p), 0.0))
    cap = int(math.ceil(p * d + slack_sigmas * sigma))
    return max(1, min(d, cap))


def cost_sparse_seed_capacity(n: int, cap: int, spec: CommSpec) -> float:
    """§4.4 with capacity padding:  C = n·(r̄ + r̄_s) + n·cap·r."""
    return float(n * (spec.rbar_bits + spec.rseed_bits) + n * cap * spec.r_bits)


def cost(spec: CommSpec, *, n: int, d: int, k=None, cap=None) -> float:
    """The §4.4 seed-trick cost of the ported codecs: with ``cap`` the
    capacity-padded Bernoulli realization, with ``k`` fixed-k Eq. (9).
    The other protocols arrive with their codecs."""
    if spec.protocol == "sparse_seed" and cap is not None:
        return cost_sparse_seed_capacity(n, cap, spec)
    if spec.protocol == "sparse_seed" and k is not None:
        return cost_sparse_seed_fixed_k(n, k, spec)
    raise NotImplementedError(
        f"cost model {spec.protocol!r} (k={k}, cap={cap}) is not ported yet: it "
        "comes with its codec's slice (ROADMAP.md, queue 1)")
