"""Federated-style mean estimation with stragglers and per-node budgets —
port of ``examples/federated_mean.py``, the paper's §1 setting end to end.

    PYTHONPATH=src python -m repro_torch.examples.federated_mean [--device cpu]

n nodes of different scales (non-iid); §6 optimal probabilities under a 5%
budget; one Bernoulli round and its squared error; the same round with a
quarter of the nodes dropped and the live nodes reweighted (unbiased for
their mean); and an elastic fixed-k round on half the nodes.  Runs on the
CUDA card unless ``--device cpu`` is given.
"""
from __future__ import annotations

import argparse

import torch

from repro_torch import random as prandom
from repro_torch import resolve_device
from repro_torch.core import decoders, encoders, mse, optimal
from repro_torch.core.protocol import MeanEstimator
from repro_torch.core.types import CommSpec, EncoderSpec

N, D = 32, 1024
FRACTION = 0.05      # the budget: Σp ≤ 5% of the n·d coordinates
DROP = 0.25          # the straggler share


def make_data(n: int, d: int, device, seed: int = 0):
    """(n, d) seeded Gaussian rows at log-normal scales (σ = 0.5)."""
    gen = torch.Generator(device=device).manual_seed(seed)
    scales = torch.exp(torch.randn(n, 1, generator=gen, device=device) * 0.5)
    return torch.randn(n, d, generator=gen, device=device) * scales


def straggler_round(xs, key):
    """The example's three rounds on ``xs``; returns their numbers."""
    n, d = xs.shape
    x_true = decoders.averaging_decoder(xs)

    # per-node centers, §6 probabilities under the budget
    mus = torch.mean(xs, dim=-1)
    budget = FRACTION * n * d
    p = optimal.optimal_probs(xs, mus, budget)
    out = {"n": n, "d": d, "budget": budget, "sum_p": float(torch.sum(p)),
           "mse_closed": float(mse.mse_bernoulli(xs, p, mus))}

    # one communication round
    enc = encoders.encode_batch(prandom.fold_in(key, 2), xs,
                                EncoderSpec(kind="bernoulli", probs="optimal", fraction=FRACTION),
                                probs=p, mus=mus)
    est = decoders.averaging_decoder(enc.y)
    out["err"] = float(torch.sum((est - x_true) ** 2))

    # stragglers: drop a share of the nodes and reweight the live ones
    alive = prandom.uniform(prandom.fold_in(key, 3), (n,), xs.device) > DROP
    est_partial = decoders.weighted_partial_decoder(enc.y, alive)
    live_true = torch.sum(xs * alive[:, None], dim=0) / torch.sum(alive)
    out["alive"] = int(torch.sum(alive))
    out["err_partial"] = float(torch.sum((est_partial - live_true) ** 2))
    out["mse_closed_partial"] = float(mse.mse_bernoulli(xs[alive], p[alive], mus[alive]))

    # elasticity: the decoder is n-agnostic
    half = MeanEstimator(EncoderSpec(kind="fixed_k", fraction=FRACTION), CommSpec("sparse_seed"))
    rep = half.estimate(prandom.fold_in(key, 4), xs[: n // 2])
    out.update(elastic_bits=rep.bits, elastic_expected_bits=rep.expected_bits,
               elastic_mse_closed=rep.expected_mse)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None, help="cpu, or cuda (the default)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    r = straggler_round(make_data(N, D, dev), prandom.PRNGKey(0))
    print(f"budget Σp = {r['sum_p']:.0f} of {N * D} coordinates ({FRACTION:.0%}); "
          f"closed-form MSE = {r['mse_closed']:.4f}")
    print(f"one-round squared error: {r['err']:.4f}")
    print(f"straggler round ({r['alive']}/{N} alive): error vs live-mean "
          f"{r['err_partial']:.4f} (still unbiased)")
    print(f"elastic round with n/2 nodes: bits={r['elastic_bits']:.0f} "
          f"mse_closed={r['elastic_mse_closed']:.4f} (MSE ∝ 1/n: double of full-n)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
