"""Plain PyTorch block-structured fixed-k encoder (Eq. (4)) — port of
``repro.kernels.fixed_k_encode.ref``.

The support is kb tile-aligned blocks of BLOCK = 1024 contiguous
coordinates, sampled uniformly without replacement from the d/BLOCK blocks
(Gumbel top-k), so every coordinate has inclusion probability k/d and the
Lemma 3.4 closed form holds unchanged.

encode: gather the selected blocks as v = (d/k)·(x − μ); decode: scatter
back and add μ.
"""
from __future__ import annotations

import torch

from repro_torch import random as prandom

BLOCK = 1024


def sample_blocks(key, num_blocks: int, kb: int, device=None):
    """Uniform kb-subset of block ids (Gumbel top-k), sorted, as int64.

    ``lax.top_k`` puts the lower index first among equal values; a stable
    descending sort does the same.  g = −log(−log u) takes two logs, and
    ``log`` differs by an ulp between libraries, so the port's Gumbel values
    differ from JAX's by at most 2⁻²³·(1 + max(1, |g|)).  Uniform draws lie
    on a 2⁻²³ grid, so adjacent draws are 2⁻²³/(u·(−log u)) apart in g.
    The kb-th largest value sits near u = 1 − kb/num_blocks; where the gap
    there exceeds both draws' errors, 2·2⁻²³·(1 + max(1, |g|)), the two
    orderings — and the ids — agree.  That holds for a boundary above
    u ≈ 0.72, i.e. kb/num_blocks below 0.28: at the shipped 1/16 the gap is
    16.5·2⁻²³ against 7.5·2⁻²³; near g = 0 (u ≈ 1/e) it is 2.7·2⁻²³
    against 4·2⁻²³ (tests/test_torch_threefry.py, tests/test_torch_fixed_k.py).
    """
    g = prandom.gumbel(key, (num_blocks,), device)
    order = torch.sort(g, descending=True, stable=True).indices[:kb]
    return torch.sort(order).values


def fixed_k_encode(x, block_ids, mu, scale=None):
    """x: flat (d,) with d % BLOCK == 0 → wire values (kb, BLOCK).

    ``scale`` defaults to the unbiased d/k; every product and difference is
    one f32 operation, as in the kernel.
    """
    d = x.shape[0]
    kb = block_ids.shape[0]
    if scale is None:
        scale = d / (kb * BLOCK)
    blocks = x.reshape(-1, BLOCK)[block_ids]
    s = torch.tensor(scale, dtype=torch.float32, device=x.device)
    return s * (blocks - torch.as_tensor(mu, dtype=torch.float32, device=x.device))


def fixed_k_decode(values, block_ids, mu, d: int):
    """Reconstruct dense Y_i = μ + scatter(values).  values: (kb, BLOCK)."""
    out = torch.zeros((d // BLOCK, BLOCK), dtype=values.dtype, device=values.device)
    out[block_ids] = values
    return (out + torch.as_tensor(mu, dtype=values.dtype, device=values.device)).reshape(d)
