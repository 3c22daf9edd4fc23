"""Flash attention in the model's layout — port of
``repro.kernels.flash_attention.ops`` (forward only: the backward kernels
come with the training step).

Dispatch (:func:`repro_torch.kernels.backend.use_plain`): CPU tensors take
the plain blockwise version (:mod:`.ref`) at the caller's block sizes; CUDA
tensors take the Hopper kernel (:mod:`.kernel`, its own 64 × 64 tiles) or
an error.  The reference falls back off the TPU to the model's chunked XLA
path instead; both are the same online softmax.
"""
from __future__ import annotations

from typing import Optional

from repro_torch.kernels import backend
from repro_torch.kernels.flash_attention import kernel as _kernel
from repro_torch.kernels.flash_attention import ref as _ref


def flash_attention(q, k, v, *, causal: bool = True, window: Optional[int] = None,
                    q_offset: int = 0, block_q: int = 512, block_k: int = 512):
    """q: (B, Sq, Hq, hd); k, v: (B, Sk, Hkv, hd) → (B, Sq, Hq, hd)."""
    if backend.use_plain(q, k, v):
        o, _ = _ref.flash_attention_fwd(q, k, v, causal=causal, window=window,
                                        q_offset=q_offset, block_q=block_q, block_k=block_k)
    else:
        o, _ = _kernel.flash_attention_fwd(q.contiguous(), k.contiguous(), v.contiguous(),
                                           causal=causal, window=window, q_offset=q_offset)
    return o
