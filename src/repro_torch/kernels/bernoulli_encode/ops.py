"""The dense Bernoulli encoder over any shape — port of
``repro.kernels.bernoulli_encode.ops``.

Dispatch (:func:`repro_torch.kernels.backend.use_plain`): a CPU tensor takes
the plain version (:mod:`.ref`), a CUDA tensor the Hopper kernel
(:mod:`.bernoulli_encode`) or an error; both give the same bits.  The
reference pads the flat input to (R, 128) tiles for its TPU kernel and
slices the padding away; the counter is the global index either way, so
neither version here pads.
"""
from __future__ import annotations

from repro_torch.kernels import backend
from repro_torch.kernels.bernoulli_encode import bernoulli_encode as _kernel
from repro_torch.kernels.bernoulli_encode import ref as _ref


def bernoulli_encode(x, p: float, mu: float, seed: int):
    """Dense Eq. (1) encoding of any-shape float32 or bfloat16 ``x`` with
    uniform probability ``p`` in (0, 1], node center ``mu`` and a uint32
    ``seed``; returns x's shape and dtype."""
    if backend.use_plain(x):
        return _ref.bernoulli_encode(x, p, mu, seed)
    return _kernel.encode(x.reshape(-1).contiguous(), float(p), float(mu), seed).reshape(x.shape)
