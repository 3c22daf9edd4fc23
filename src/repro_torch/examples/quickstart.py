"""Quickstart: randomized distributed mean estimation — port of
``examples/quickstart.py``.

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cpu]

Estimates the mean of n seeded Gaussian vectors under seven protocols and
prints the accuracy-vs-bits trade-off (the paper's core object): each
protocol's expected bits, bits a coordinate, closed-form MSE and
Monte-Carlo MSE.  Runs on the CUDA card unless ``--device cpu`` is given.
"""
from __future__ import annotations

import argparse
import math

import torch

from repro_torch import random as prandom
from repro_torch import resolve_device
from repro_torch.core.protocol import MeanEstimator, empirical_mse
from repro_torch.core.types import CommSpec, EncoderSpec

N, D = 16, 512
TRIALS = 200


def configs():
    """The seven (name, encoder, protocol) of the reference's quickstart, with
    its fractions as numbers (1/ln 512, 1/16, 1/512) whatever the d."""
    return [
        ("full (Ex. 5)", EncoderSpec(kind="identity"), CommSpec("naive")),
        ("log-MSE p=1/log d (Ex. 6)",
         EncoderSpec(kind="bernoulli", fraction=1 / math.log(D)), CommSpec("sparse_seed")),
        ("1-bit/coord p=1/r (Ex. 7)",
         EncoderSpec(kind="bernoulli", fraction=1 / 16), CommSpec("sparse_seed")),
        ("below-1-bit p=1/d (Ex. 9)",
         EncoderSpec(kind="bernoulli", fraction=1 / D), CommSpec("sparse_seed")),
        ("binary quantization (Ex. 4)", EncoderSpec(kind="binary"), CommSpec("binary")),
        ("fixed-k k=d/16 (Eq. 4)",
         EncoderSpec(kind="fixed_k", fraction=1 / 16), CommSpec("sparse_seed")),
        ("optimal p, B=d (Thm 6.1)",
         EncoderSpec(kind="bernoulli", fraction=1 / 16, probs="optimal"), CommSpec("sparse")),
    ]


def run(xs, trials: int = TRIALS):
    """One row a protocol on the (n, d) ``xs`` with the budget B = d: the
    report of one round (key 1) and the Monte-Carlo MSE (key 2)."""
    n, d = xs.shape
    out = []
    for name, enc, comm in configs():
        est = MeanEstimator(enc, comm, budget=float(d))
        rep = est.estimate(prandom.PRNGKey(1), xs)
        emp = float(empirical_mse(prandom.PRNGKey(2), xs, est, trials=trials))
        out.append({"protocol": name, "bits": rep.expected_bits, "measured_bits": rep.bits,
                    "bits_per_coord": rep.expected_bits / (n * d),
                    "mse_closed": rep.expected_mse, "mse_emp": emp})
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None, help="cpu, or cuda (the default)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    xs = torch.randn(N, D, generator=torch.Generator(device=dev).manual_seed(0), device=dev)
    print(f"estimating the mean of {N} vectors in R^{D} on {dev}\n")
    print(f"{'protocol':32s} {'bits':>10s} {'bits/coord':>10s} "
          f"{'MSE (closed)':>12s} {'MSE (emp)':>10s}")
    for r in run(xs):
        print(f"{r['protocol']:32s} {r['bits']:10.0f} {r['bits_per_coord']:10.3f} "
              f"{r['mse_closed']:12.4f} {r['mse_emp']:10.4f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
