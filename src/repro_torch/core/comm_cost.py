"""Communication-cost models β (§4) — the parts of ``repro.core.comm_cost``
that the ported codecs need: naive f32, the §4.4 seed trick, and the §4.5 /
§7.1 binary and ternary planes as word-padded wire buffers.  All costs are in
bits for the full n-node round.
"""
from __future__ import annotations

import math

from repro_torch.core.types import CommSpec


def cost_naive(n: int, d: int, spec: CommSpec) -> float:
    """§4.1:  C = n·d·r."""
    return float(n * d * spec.r_bits)


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


def _pad_words(bits: float) -> float:
    """Round a bit count up to whole 32-bit wire words."""
    return 32.0 * math.ceil(bits / 32.0)


def cost_binary_packed(n: int, d: int, spec: CommSpec) -> float:
    """Eq. (11) as packed words: C = n·(32·⌈d/32⌉ + 32·⌈2r/32⌉)."""
    return float(n * (_pad_words(d) + _pad_words(2 * spec.r_bits)))


def cost_ternary_packed(n: int, d: int, cap: int, spec: CommSpec) -> float:
    """Eq. (21) as a packed 2-bit plane + capacity-padded values:
    C = n·(32·⌈2d/32⌉ + 32·⌈cap·r/32⌉ + 32·⌈2r/32⌉)."""
    return float(n * (_pad_words(2 * d) + _pad_words(cap * spec.r_bits)
                      + _pad_words(2 * spec.r_bits)))


def cost(spec: CommSpec, *, n: int, d: int, k=None, cap=None, packed: bool = False) -> float:
    """Dispatch on ``spec.protocol`` over the cost models of the ported
    codecs: naive; the §4.4 seed trick with ``cap`` (capacity-padded
    Bernoulli) or ``k`` (fixed-k Eq. (9)); the word-padded binary and
    ternary planes (``packed``; ternary needs ``cap``).  The ideal §4.5 /
    §7.1 forms and the varying-length and sparse models arrive with
    slice 7."""
    if spec.protocol == "naive":
        return cost_naive(n, d, spec)
    if spec.protocol == "sparse_seed" and cap is not None:
        return cost_sparse_seed_capacity(n, cap, spec)
    if spec.protocol == "sparse_seed" and k is not None:
        return cost_sparse_seed_fixed_k(n, k, spec)
    if spec.protocol == "binary" and packed:
        return cost_binary_packed(n, d, spec)
    if spec.protocol == "ternary" and packed and cap is not None:
        return cost_ternary_packed(n, d, cap, spec)
    raise NotImplementedError(
        f"cost model {spec.protocol!r} (k={k}, cap={cap}, packed={packed}) is "
        "not ported yet: it comes with its codec's slice (ROADMAP.md, queue 1)")
