"""Plain PyTorch dense Bernoulli encoder (Eq. (1), uniform p) — port of
``repro.kernels.bernoulli_encode.ref``.

Y(j) = X(j)/p − (1−p)/p·μ where u_j < p, else μ, with
u_j = ``uniform_hash(seed, j)`` over the global flat index j, cast back to
x's dtype.  Every operation is one f32 operation in the reference's order;
p and μ are 0-dim f32 tensors on x's device, so the division is a true
division on the card too.  ``csrc/bernoulli_encode.cu`` computes the same
bits.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import prng


def bernoulli_encode(x, p, mu, seed: int):
    """x: any shape, float32 or bfloat16 → the dense Eq. (1) encoding in
    x's dtype and shape; the coordinate index is global over the flattened
    input."""
    flat = x.reshape(-1)
    idx = torch.arange(flat.shape[0], dtype=torch.int64, device=x.device)
    u = prng.uniform_hash(seed, idx)
    p32 = torch.as_tensor(p, dtype=torch.float32).to(x.device)
    mu32 = torch.as_tensor(mu, dtype=torch.float32).to(x.device)
    sent = u < p32
    y = torch.where(sent, flat.to(torch.float32) / p32 - (1.0 - p32) / p32 * mu32, mu32)
    return y.to(x.dtype).reshape(x.shape)
