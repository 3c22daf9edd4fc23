"""The Walsh–Hadamard transform along the last axis — port of
``repro.kernels.hadamard.ops``.

Dispatch (:func:`repro_torch.kernels.backend.use_plain`): a CPU tensor takes
the plain butterfly (:mod:`.ref`), a CUDA tensor the Hopper kernel
(:mod:`.hadamard`) or an error.  Both give the reference's CPU bits.
Vectors longer than :data:`MAX_D` are the caller's to chunk
(:func:`repro_torch.core.rotation._chunked_fwht`: a block-diagonal rotation).
"""
from __future__ import annotations

from repro_torch.kernels import backend
from repro_torch.kernels.hadamard import hadamard as _kernel
from repro_torch.kernels.hadamard import ref as _ref

MAX_D = _kernel.MAX_D


def fwht(x):
    """Unnormalised WHT along the last axis.  x: (..., d), d = 2^m ≤ MAX_D."""
    d = x.shape[-1]
    if d < 1 or d & (d - 1):
        raise ValueError(f"fwht needs a power-of-two length, got {d}")
    if d > MAX_D:
        raise ValueError(f"fwht supports d ≤ {MAX_D}; chunk the input "
                         "(repro_torch.core.rotation does)")
    if backend.use_plain(x):
        return _ref.fwht(x)
    return _kernel.fwht(x.reshape(-1, d).contiguous()).reshape(x.shape)
