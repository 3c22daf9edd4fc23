"""Decoding protocols γ (§2) — port of ``repro.core.decoders``.

The averaging decoder of Example 2 and its straggler-tolerant form.  Both
divide (or multiply by a reciprocal) with the divisor as a tensor on the
data's device, so the card computes what the CPU computes.
"""
from __future__ import annotations

import torch


def averaging_decoder(ys):
    """γ(Y_1..Y_n) = (1/n) Σ Y_i  (Example 2).  ys: (n, ...) → (...).

    The reference's ``jnp.mean(ys, axis=0)``: the rows added in order (XLA's
    CPU reduce over up to 32 rows), then multiplied by the f32 reciprocal of
    n (XLA's rewrite of a division by a constant); the same operations on
    every device.  The wire codecs average their peers' centers with it.
    """
    n = ys.shape[0]
    acc = ys[0]
    for i in range(1, n):
        acc = acc + ys[i]
    inv = float(torch.reciprocal(torch.tensor(float(n), dtype=torch.float32)))
    return acc * torch.full((), inv, dtype=acc.dtype, device=acc.device)


def weighted_partial_decoder(ys, alive):
    """Straggler-tolerant decode: the average over the live rows only.

    Unbiased for the mean of the live nodes' vectors (the averaging decoder
    is n-agnostic).  ``alive``: (n,) bool or 0/1 mask.
    """
    w = alive.to(ys.dtype)
    denom = torch.clamp_min(torch.sum(w), 1.0)
    return torch.einsum("n,nd->d", w, ys) / denom
