"""The single-host (α, β, γ) stack — port of ``repro.core.protocol``.

:class:`MeanEstimator` bundles an encoder spec (α, §3), a communication-cost
model (β, §4) and the averaging decoder (γ, §2), and gives what the paper
analyses: an unbiased estimate Y of X = mean(X_i), its realized and expected
cost in bits, and its closed-form MSE.  :func:`empirical_mse` is the
Monte-Carlo MSE of Def. 2.2.  Everything runs on the device of the data.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch import random as prandom
from repro_torch.core import centers as centers_lib
from repro_torch.core import comm_cost, decoders, encoders
from repro_torch.core import mse as mse_lib
from repro_torch.core import optimal as optimal_lib
from repro_torch.core import rotation as rotation_lib
from repro_torch.core import types as t


@dataclasses.dataclass
class EstimateReport:
    estimate: torch.Tensor       # (d,) the decoded Y
    bits: float                  # realized communication cost (this round)
    expected_bits: float         # analytic C_{α,β}
    expected_mse: float          # closed-form MSE at the given X (not rotated)
    nsent_total: int             # Σ_i |S_i|


class MeanEstimator:
    """(α, β, γ) with α from §3, β from §4 and γ the averaging decoder."""

    def __init__(self, enc: t.EncoderSpec = t.EncoderSpec(),
                 comm: t.CommSpec = t.CommSpec(), budget: Optional[float] = None):
        """``budget`` (B of §6) bounds Σ_ij p_ij when enc.probs == "optimal"."""
        self.enc = enc
        self.comm = comm
        self.budget = budget
        if enc.probs == "optimal" and comm.protocol == "sparse_seed":
            # §4.4: the seed trick needs identically distributed supports;
            # per-coordinate probabilities must send their indices (§4.3)
            raise ValueError("optimal probabilities require the 'sparse' "
                             "communication protocol (§4.3), not sparse_seed")

    # -- parameter selection (§6) ---------------------------------------- #
    def parameters_for(self, xs):
        """(probs or None, mus) per the spec's policies."""
        n, d = xs.shape
        if self.enc.kind in ("identity", "binary"):
            return None, None
        if self.enc.probs == "optimal":
            B = self.budget if self.budget is not None else self.enc.fraction * n * d
            if self.enc.center == "optimal":
                probs, mus, _ = optimal_lib.alternating_minimization(xs, B)
            else:
                mus = centers_lib.compute_centers(xs, self.enc.center)
                probs = optimal_lib.optimal_probs(xs, mus, B)
            return probs, mus
        if self.enc.center == "optimal":
            p0 = torch.full(xs.shape, self.enc.fraction, dtype=xs.dtype, device=xs.device)
            return None, centers_lib.optimal_centers(xs, p0)
        return None, centers_lib.compute_centers(xs, self.enc.center)

    # -- one estimation round --------------------------------------------- #
    def round(self, key, xs):
        """encode → decode on (n, d) ``xs``: (the estimate, the encoded data
        ``work`` (rotated by the shared Q of §7.2 if the spec says so), its
        probabilities and centers, the batched encoding)."""
        kq, kenc = prandom.split(key)
        work = rotation_lib.rotate(kq, xs) if self.enc.rotation else xs
        probs, mus = self.parameters_for(work)
        encd = encoders.encode_batch(kenc, work, self.enc, probs=probs, mus=mus)
        y = decoders.averaging_decoder(encd.y)
        if self.enc.rotation:
            y = rotation_lib.unrotate(kq, y, xs.shape[1])
        return y, work, probs, mus, encd

    def estimate(self, key, xs) -> EstimateReport:
        """encode → (bit-accounted) communicate → decode on (n, d) ``xs``."""
        y, work, probs, mus, encd = self.round(key, xs)
        return EstimateReport(
            estimate=y,
            bits=comm_cost.measure_bits(encd, self.comm, work.shape[1]),
            expected_bits=self.expected_bits(work, probs),
            expected_mse=float(self.expected_mse(work, probs, mus)),
            nsent_total=int(torch.sum(encd.nsent)),
        )

    def expected_bits(self, xs, probs=None) -> float:
        n, d = xs.shape
        if self.enc.kind == "identity":
            return comm_cost.cost_naive(n, d, self.comm)
        if self.enc.kind == "binary":
            return comm_cost.cost_binary(n, d, self.comm)
        if self.enc.kind == "fixed_k":
            k = t.fixed_k_from_fraction(d, self.enc.fraction)
            return comm_cost.cost(self.comm, n=n, d=d, k=k)
        if probs is None:
            probs = torch.full(xs.shape, self.enc.fraction, dtype=xs.dtype, device=xs.device)
        return comm_cost.cost(self.comm, n=n, d=d, probs=probs, p=float(self.enc.fraction))

    def expected_mse(self, xs, probs=None, mus=None):
        n, d = xs.shape
        if self.enc.kind == "identity":
            return torch.zeros((), device=xs.device)
        if self.enc.kind == "binary":
            return mse_lib.mse_binary(xs)
        if mus is None:
            _, mus = self.parameters_for(xs)
        if self.enc.kind == "fixed_k":
            return mse_lib.mse_fixed_k(xs, t.fixed_k_from_fraction(d, self.enc.fraction), mus)
        if self.enc.kind == "bernoulli":
            return mse_lib.mse_bernoulli(xs, self.enc.fraction if probs is None else probs, mus)
        if self.enc.kind == "ternary":
            half = (1.0 - self.enc.fraction) / 2.0
            return mse_lib.mse_ternary(xs, half, half, torch.amin(xs, dim=-1),
                                       torch.amax(xs, dim=-1))
        raise ValueError(self.enc.kind)


def empirical_mse(key, xs, estimator: MeanEstimator, trials: int = 256):
    """Monte-Carlo MSE of the estimator (the Def. 2.2 expectation): the mean
    over ``split(key, trials)`` of one round's squared error against the
    true mean, without the bit accounting."""
    x_true = decoders.averaging_decoder(xs)
    total = 0.0
    for k in prandom.split(key, trials):
        y = estimator.round(k, xs)[0]
        total = total + torch.sum((y - x_true) ** 2)
    return total / trials
