"""Block-structured fixed-k encode/decode for flat vectors — port of
``repro.kernels.fixed_k_encode.ops``.

k is expressed in blocks (kb) of BLOCK coordinates; a flat input whose
length is not a BLOCK multiple is treated as zero-padded (padding joins the
population like real coordinates and is sliced away after decode).

Dispatch (:func:`repro_torch.kernels.backend.use_plain`): a CPU tensor takes
the plain gather, a CUDA tensor the Hopper gather kernel.  Block sampling
(Gumbel, top-k, sort) and the decode scatter are plain PyTorch on every
device, as the reference leaves them to XLA outside any Pallas kernel.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import backend
from repro_torch.kernels.fixed_k_encode import fixed_k_encode as _kernel
from repro_torch.kernels.fixed_k_encode import ref as _ref
from repro_torch.kernels.fixed_k_encode.ref import sample_blocks  # noqa: F401  (re-export)

BLOCK = _ref.BLOCK


def num_blocks(n: int) -> int:
    return (n + BLOCK - 1) // BLOCK


def fixed_k_encode(x, block_ids, mu, *, scale=None):
    """Gather-encode: wire values scale·(x[S] − μ) as (kb, BLOCK) f32.

    ``scale=None`` is the unbiased d/k rescale of Eq. (4), with d the
    BLOCK-padded length.
    """
    flat = x.reshape(-1).to(torch.float32)
    n = flat.shape[0]
    d = num_blocks(n) * BLOCK
    k = block_ids.shape[0] * BLOCK
    if scale is None:
        scale = d / k
    mu = torch.as_tensor(mu, dtype=torch.float32, device=flat.device)
    if backend.use_plain(flat):
        padded = torch.nn.functional.pad(flat, (0, d - n))
        return _ref.fixed_k_encode(padded, block_ids, mu, scale)
    return _kernel.fixed_k_gather(flat, block_ids, scale, mu)


def fixed_k_decode(values, block_ids, mu, shape, dtype=torch.float32):
    """Scatter-decode dense Y_i and restore the original shape."""
    n = 1
    for s in shape:
        n *= s
    d = num_blocks(n) * BLOCK
    y = _ref.fixed_k_decode(values, block_ids, mu, d)
    return y[:n].reshape(shape).to(dtype)
