"""Flash attention in the model's layout, differentiable — port of
``repro.kernels.flash_attention.ops`` (its ``jax.custom_vjp`` becomes a
``torch.autograd.Function``).

Forward: the forward kernel, saving q, k, v, o and lse.  Backward, as the
reference's ``_flash_bwd``: ``delta = sum(do · o, -1)`` in f32 over the
returned o (bf16 at bf16 compute, not the f32 accumulator), then the dK/dV
and dQ sweeps, whose f32 results are cast to the inputs' dtypes.  A call
that needs no gradient runs the forward alone, as the serving path does.

Dispatch (:func:`repro_torch.kernels.backend.use_plain`): CPU tensors take
the plain blockwise versions (:mod:`.ref`) at the caller's block sizes; CUDA
tensors take the Hopper kernels (:mod:`.kernel`, their own tiles) or an
error.  The reference falls back off the TPU to the model's chunked
XLA path instead; both are the same online softmax.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import backend
from repro_torch.kernels.flash_attention import kernel as _kernel
from repro_torch.kernels.flash_attention import ref as _ref


def _forward(q, k, v, mask: dict, blocks: dict):
    if backend.use_plain(q, k, v):
        return _ref.flash_attention_fwd(q, k, v, **mask, **blocks)
    return _kernel.flash_attention_fwd(q.contiguous(), k.contiguous(), v.contiguous(), **mask)


class _FlashAttention(torch.autograd.Function):

    @staticmethod
    def forward(ctx, q, k, v, mask: dict, blocks: dict):
        o, lse = _forward(q, k, v, mask, blocks)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.mask, ctx.blocks = mask, blocks
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        delta = torch.sum(do.float() * o.float(), dim=-1).transpose(1, 2).contiguous()
        if backend.use_plain(q, k, v, do):
            dq, dk, dv = _ref.flash_attention_bwd(q, k, v, do, lse, delta, **ctx.mask,
                                                  **ctx.blocks)
        else:
            q, k, v, do = (t.contiguous() for t in (q, k, v, do))
            dk, dv = _kernel.flash_attention_bwd_dkv(q, k, v, do, lse, delta, **ctx.mask)
            dq = _kernel.flash_attention_bwd_dq(q, k, v, do, lse, delta, **ctx.mask)
        return dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype), None, None


def flash_attention(q, k, v, *, causal: bool = True, window: Optional[int] = None,
                    q_offset: int = 0, block_q: int = 512, block_k: int = 512):
    """q: (B, Sq, Hq, hd); k, v: (B, Sk, Hkv, hd) → (B, Sq, Hq, hd).

    Differentiable: the backward recomputes the scores tile by tile from
    the saved o and lse (the two sweeps); nothing of size S² is kept."""
    mask = dict(causal=causal, window=window, q_offset=q_offset)
    blocks = dict(block_q=block_q, block_k=block_k)
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        return _FlashAttention.apply(q, k, v, mask, blocks)
    return _forward(q, k, v, mask, blocks)[0]
