"""Bit-exact PyTorch Threefry-2x32 — the port of ``repro.kernels.threefry.ref``.

The §4.4 seed-trick wire paths draw their supports from JAX's Threefry
stream, and peers regenerate each other's supports from the key alone, so
the port must reproduce that stream bit for bit (the golden wire bytes in
tests/golden/golden_wire.npz pin it).  ``torch.Generator`` would not do.

The layout is the one ``repro.kernels.threefry.ref`` encodes — JAX's
*non-partitionable* Threefry (``jax.threefry_partitionable(False)``): for a
(d,) draw the counter ``arange(d)`` is zero-padded to 2·⌈d/2⌉ and split in
halves, so lane j < half comes from cipher word x0 of the pair
(j, half + j) and lane j ≥ half from x1 of (j − half, j).

PyTorch on the CPU has no uint32 add, shift or compare, so the words live
in int64 tensors (or Python ints) holding values in [0, 2³²) and every
add and shift is masked with ``& 0xFFFFFFFF``.  The same code runs on a
CUDA tensor; the kernels' device function is ``csrc/threefry.cuh``.
"""
from __future__ import annotations

import torch

_MASK = 0xFFFFFFFF
_PARITY = 0x1BD11BDA
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _rotl(x, r: int):
    return ((x << r) & _MASK) | (x >> (32 - r))


def threefry2x32(k0, k1, x0, x1):
    """The 20-round Threefry-2x32 block cipher on uint32 words held in int64.

    Arguments are Python ints or int64 tensors with values in [0, 2³²),
    broadcastable against each other.  Returns the two output words.
    """
    ks = (k0, k1, k0 ^ k1 ^ _PARITY)
    x0 = (x0 + ks[0]) & _MASK
    x1 = (x1 + ks[1]) & _MASK
    for group in range(5):
        for r in _ROTATIONS[group % 2]:
            x0 = (x0 + x1) & _MASK
            x1 = _rotl(x1, r)
            x1 = x1 ^ x0
        x0 = (x0 + ks[(group + 1) % 3]) & _MASK
        x1 = (x1 + ks[(group + 2) % 3] + (group + 1)) & _MASK
    return x0, x1


def counter_words(idx, d: int):
    """The (x0, x1) counter words feeding coordinate ``idx`` of a (d,) draw.

    ``idx``: int64 tensor of flat coordinate indices < d.  Returns
    ``(pair, c1, lo)``: the cipher input words and whether the lane takes
    output word x0 (lo) or x1.
    """
    half = (d + 1) // 2
    lo = idx < half
    pair = torch.where(lo, idx, idx - half)
    c1 = pair + half
    c1 = torch.where(c1 < d, c1, torch.zeros_like(c1))  # odd-d zero pad
    return pair, c1, lo


def _key_words(key):
    key = torch.as_tensor(key).reshape(2)
    return int(key[0]) & _MASK, int(key[1]) & _MASK


def random_bits(key, d: int, device=None):
    """Bit-exact ``jax.random.bits(key, (d,), uint32)`` (non-partitionable),
    as int64 values in [0, 2³²)."""
    k0, k1 = _key_words(key)
    half = (d + 1) // 2
    cnt = torch.zeros(2 * half, dtype=torch.int64, device=device)
    cnt[:d] = torch.arange(d, dtype=torch.int64, device=device)
    o0, o1 = threefry2x32(k0, k1, cnt[:half], cnt[half:])
    return torch.cat([o0, o1])[:d]


def bits_to_uniform(bits):
    """uint32 bits (int64) → U[0, 1) float32 exactly as jax.random.uniform:
    fill the f32 mantissa (value in [1, 2)), subtract 1, clamp at 0."""
    fbits = ((bits >> 9) | 0x3F800000).to(torch.int32)
    u = fbits.view(torch.float32) - torch.tensor(1.0, dtype=torch.float32,
                                                 device=bits.device)
    return torch.clamp_min(u, 0.0)


# cipher pairs one pass of :func:`uniform` draws
UNIFORM_CHUNK = 1 << 24


def uniform(key, d: int, device=None):
    """Bit-exact ``jax.random.uniform(key, (d,), float32)``: the lanes of
    :func:`random_bits` through :func:`bits_to_uniform`, drawn
    ``UNIFORM_CHUNK`` cipher pairs at a time into the (d,) f32 result, so
    the int64 temporaries of a large draw stay a few hundred MB (a whole
    draw at once holds about eight (d/2,) int64 tensors)."""
    k0, k1 = _key_words(key)
    half = (d + 1) // 2
    out = torch.empty(d, dtype=torch.float32, device=device)
    for s in range(0, half, UNIFORM_CHUNK):
        e = min(s + UNIFORM_CHUNK, half)
        pair = torch.arange(s, e, dtype=torch.int64, device=device)
        hi = max(0, min(e, d - half) - s)     # pairs whose x1 lane is a coordinate < d
        c1 = pair + half
        c1[hi:] = 0                           # odd-d zero pad
        o0, o1 = threefry2x32(k0, k1, pair, c1)
        out[s:e] = bits_to_uniform(o0)
        out[half + s:half + s + hi] = bits_to_uniform(o1[:hi])
    return out


def uniform_at(key, idx, d: int):
    """``uniform(key, d)[idx]`` without the (d,) draw: only the cipher pairs
    feeding the lanes ``idx`` (any int tensor of indices < d) are evaluated.

    ``key`` is one (2,) key, or an (n, 2) stack of keys, in which case
    ``idx`` broadcasts against a leading peer dimension and the result is
    (n, *idx.shape).
    """
    key = torch.as_tensor(key).to(torch.int64)
    idx = idx.to(torch.int64)
    c0, c1, lo = counter_words(idx, d)
    if key.dim() == 2:
        k = key.to(idx.device)
        k0 = k[:, 0].reshape((-1,) + (1,) * idx.dim()) & _MASK
        k1 = k[:, 1].reshape((-1,) + (1,) * idx.dim()) & _MASK
    else:
        k0, k1 = _key_words(key)
    o0, o1 = threefry2x32(k0, k1, c0, c1)
    return bits_to_uniform(torch.where(lo, o0, o1))
