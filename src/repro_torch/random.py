"""The ``jax.random`` calls the wire path and the single-host stack make,
bit-exact, in PyTorch.

Keys are raw Threefry key data: an int64 tensor of shape (2,) on the CPU
holding two uint32 words, the same words ``jax.random.key_data`` returns for
a JAX key (:func:`repro_torch.convert.key_to_torch` carries one across).
Every stream follows JAX's non-partitionable Threefry layout
(:mod:`repro_torch.kernels.threefry.ref`), which the golden wire bytes pin.
These are not ``torch.Generator`` streams: peers regenerate each other's
supports from the key alone.
"""
from __future__ import annotations

import math

import torch

from repro_torch.kernels.threefry import ref as tf

_MASK = 0xFFFFFFFF
# float32 finfo.tiny, the lower bound jax.random.gumbel draws its uniform at
_F32_TINY = torch.finfo(torch.float32).tiny


def PRNGKey(seed: int) -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` key data for a 32-bit seed: [0, seed]."""
    seed = int(seed)
    if not -(1 << 31) <= seed < (1 << 31):
        raise OverflowError(f"seed {seed} does not fit in int32")
    return torch.tensor([0, seed & _MASK], dtype=torch.int64)


def fold_in(key, data: int) -> torch.Tensor:
    """``jax.random.fold_in(key, data)``: Threefry of the counter (0, data)."""
    k0, k1 = (int(w) & _MASK for w in torch.as_tensor(key).reshape(2))
    o0, o1 = tf.threefry2x32(k0, k1, 0, int(data) & _MASK)
    return torch.tensor([o0, o1], dtype=torch.int64)


def split(key, num: int = 2) -> torch.Tensor:
    """``jax.random.split(key, num)`` key data, (num, 2): the Threefry bits
    of the counter ``arange(2·num)`` (the non-partitionable layout), two
    words a key."""
    return tf.random_bits(key, 2 * num).reshape(num, 2)


def uniform(key, shape, device=None) -> torch.Tensor:
    """``jax.random.uniform(key, shape, float32)`` in [0, 1)."""
    shape = (shape,) if isinstance(shape, int) else tuple(shape)
    size = math.prod(shape)
    return tf.uniform(key, size, device).reshape(shape)


def rademacher(key, shape, device=None) -> torch.Tensor:
    """``jax.random.rademacher(key, shape, float32)``: ±1 with equal odds.

    JAX draws ``bernoulli(key, 0.5, shape)`` — ``uniform(key, shape) < 0.5``
    — and maps True to 1, False to −1.
    """
    u = uniform(key, shape, device)
    one = torch.ones((), dtype=torch.float32, device=u.device)
    return torch.where(u < 0.5, one, -one)


def gumbel(key, shape, device=None) -> torch.Tensor:
    """``jax.random.gumbel(key, shape, float32)`` (its default "low" mode).

    JAX draws ``u = max(tiny, f·(1 − tiny) + tiny)`` with f the mantissa
    fill of the bits (no clamp at 0) and returns ``−log(−log u)``; in f32
    ``1 − tiny`` rounds to 1, so u = f for f > 0 and u = tiny for f = 0.
    """
    shape = (shape,) if isinstance(shape, int) else tuple(shape)
    size = math.prod(shape)
    bits = tf.random_bits(key, size, device)
    fbits = ((bits >> 9) | 0x3F800000).to(torch.int32)
    f = fbits.view(torch.float32) - torch.tensor(1.0, dtype=torch.float32,
                                                 device=bits.device)
    u = torch.clamp_min(f + _F32_TINY, _F32_TINY)
    return (-torch.log(-torch.log(u))).reshape(shape)
