"""Communication-cost models β (§4) — port of ``repro.core.comm_cost``.

* analytic expected costs C_{α,β} as closed forms in the protocol
  parameters (§4.1–§4.5, §7.1), the quantities of the paper's Table 1,
  dispatched by :func:`cost`, and the word-padded and capacity-padded wire
  realizations the codecs ship; :func:`cost_config` charges what the
  registry's codec for a config ships;
* the realized cost of one sampled round, :func:`measure_bits`.

All costs are in bits for the full n-node round.
"""
from __future__ import annotations

import math

import torch

from repro_torch.core.types import CommSpec


def ceil_log2(d: int) -> int:
    return max(1, math.ceil(math.log2(d)))


# --- analytic expected costs (§4) ---------------------------------------- #

def cost_naive(n: int, d: int, spec: CommSpec) -> float:
    """§4.1:  C = n·d·r."""
    return float(n * d * spec.r_bits)


def cost_varying_length(probs, spec: CommSpec) -> float:
    """§4.2:  C = n·r̄ + Σ_ij (1 + r·p_ij).   probs: (n, d)."""
    n = probs.shape[0]
    return float(n * spec.rbar_bits + torch.sum(1.0 + spec.r_bits * probs))


def cost_sparse(probs, spec: CommSpec, d: int) -> float:
    """§4.3 Eq. (8):  C = n·r̄ + (⌈log d⌉ + r)·Σ_ij p_ij."""
    n = probs.shape[0]
    return float(n * spec.rbar_bits + (ceil_log2(d) + spec.r_bits) * torch.sum(probs))


def cost_sparse_seed_fixed_k(n: int, k: int, spec: CommSpec) -> float:
    """§4.4 Eq. (9) (fixed-size support):  C = n(r̄ + r̄_s) + n·k·r."""
    return float(n * (spec.rbar_bits + spec.rseed_bits) + n * k * spec.r_bits)


def cost_sparse_seed_uniform_p(n: int, d: int, p: float, spec: CommSpec) -> float:
    """§4.4 Eq. (10) (uniform-p variable support):  C = n(r̄ + r̄_s) + n·d·p·r."""
    return float(n * (spec.rbar_bits + spec.rseed_bits) + n * d * p * spec.r_bits)


def cost_binary(n: int, d: int, spec: CommSpec) -> float:
    """§4.5 Eq. (11):  C = 2·n·r + n·d   (two scalars + 1 bit a coordinate)."""
    return float(n * 2 * spec.r_bits + n * d)


def cost_ternary(n: int, d: int, p_pass: float, spec: CommSpec) -> float:
    """§7.1 analogue of Eq. (11):  C = 2·n·r + 2·n·d + n·d·p_pass·r — two
    centers, a 2-bit branch index a coordinate and the expected p_pass·d
    pass-through values of Eq. (21)."""
    return float(n * 2 * spec.r_bits + n * 2 * d + n * d * p_pass * spec.r_bits)


# --- §4.4 and the planes as static wire buffers --------------------------- #

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


def cost(spec: CommSpec, *, n: int, d: int, probs=None, k=None, p=None, cap=None,
         packed: bool = False) -> float:
    """Dispatch on ``spec.protocol`` to the per-protocol models.

    ``packed=True`` selects the word-padded planes (ternary needs ``cap``),
    the ideal §4.5 / §7.1 forms otherwise.  For ``sparse_seed``, ``cap``
    selects the capacity-padded realization, ``k`` the fixed-k Eq. (9) and
    ``p`` the uniform-p Eq. (10); ``varying`` and ``sparse`` need ``probs``.
    """
    if spec.protocol == "naive":
        return cost_naive(n, d, spec)
    if spec.protocol == "varying":
        return cost_varying_length(_need(probs, "probs", spec), spec)
    if spec.protocol == "sparse":
        return cost_sparse(_need(probs, "probs", spec), spec, d)
    if spec.protocol == "sparse_seed":
        if cap is not None:
            return cost_sparse_seed_capacity(n, cap, spec)
        if k is not None:
            return cost_sparse_seed_fixed_k(n, k, spec)
        return cost_sparse_seed_uniform_p(n, d, _need(p, "p", spec), spec)
    if spec.protocol == "binary":
        return cost_binary_packed(n, d, spec) if packed else cost_binary(n, d, spec)
    if spec.protocol == "ternary":
        if packed:
            return cost_ternary_packed(n, d, _need(cap, "cap", spec), spec)
        return cost_ternary(n, d, _need(p, "p", spec), spec)
    raise ValueError(spec.protocol)


def _need(v, name: str, spec: CommSpec):
    if v is None:
        raise ValueError(f"the {spec.protocol!r} cost model needs {name}")
    return v


def cost_config(cfg, *, n: int, d: int, mesh_sizes=None) -> float:
    """Analytic cost of the wire codec the registry resolves for ``cfg``: its
    payload, seed bits and flat scatter-decode bits,
    ``codec.comm_cost_bits + codec.scatter_bits`` at the effective node
    count.  ``n`` is the world size over all compression axes; a
    hierarchical config (``cfg.inner_axes``) is billed at the cross-host
    group size :func:`~repro_torch.core.wire.base.effective_nodes`, which
    needs ``mesh_sizes`` (axis name → size); its shard gather and count
    exchange ride the inner axes and are not billed (DESIGN.md §11)."""
    from repro_torch.core import wire  # local import: wire consumes this module
    n_eff = wire.effective_nodes(cfg, n, mesh_sizes)
    codec = wire.resolve(cfg)
    return float(codec.comm_cost_bits(n_eff, d, cfg) + codec.scatter_bits(n_eff, d, cfg))


# --- realized cost of one encoded round ----------------------------------- #

def measure_bits(encoded, spec: CommSpec, d: int) -> float:
    """Bits one sampled round uses under ``spec``; ``encoded`` is a batched
    :class:`~repro_torch.core.encoders.Encoded` (leading node axis).  Its
    expectation over the encoder's randomness is :func:`cost`."""
    n = encoded.y.shape[0]
    nsent = int(torch.sum(encoded.nsent))
    if spec.protocol == "naive":
        return float(n * d * spec.r_bits)
    if spec.protocol == "varying":
        return float(n * spec.rbar_bits + n * d + spec.r_bits * nsent)
    if spec.protocol == "sparse":
        return float(n * spec.rbar_bits + (ceil_log2(d) + spec.r_bits) * nsent)
    if spec.protocol == "sparse_seed":
        return float(n * (spec.rbar_bits + spec.rseed_bits) + spec.r_bits * nsent)
    if spec.protocol == "binary":
        return float(n * 2 * spec.r_bits + n * d)
    if spec.protocol == "ternary":
        # 2 centers, the 2-bit plane and r bits a realized pass-through value
        return float(n * 2 * spec.r_bits + n * 2 * d + spec.r_bits * nsent)
    raise ValueError(spec.protocol)
