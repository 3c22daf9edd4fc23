"""GQA attention with qk-norm, sliding windows, the chunked (memory-bounded)
online softmax and KV-cache decode — port of ``repro.models.attention`` at
``tp = 1``.

Where the reference asks XLA for f32 results from low-precision inputs
(``preferred_element_type=jnp.float32``), the port multiplies the inputs
cast to f32: a bf16 × bf16 product is exact in f32, so this is the same
f32-accumulated product.  Plain einsums in the compute dtype stay in it, as
in the reference.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.models import common

NEG_INF = -1e30


@dataclasses.dataclass(frozen=True)
class AttnDims:
    """Attention dimensions (derived from config + ctx.tp)."""
    q_heads: int          # global, padded to a multiple of tp
    kv_heads: int         # global
    head_dim: int
    q_local: int
    kv_local: int
    kv_replicated: bool   # kv weights replicated over the model axis


def attn_dims(num_heads: int, num_kv_heads: int, head_dim: int, tp: int) -> AttnDims:
    qp = common.ceil_to(num_heads, tp)
    kv_rep = num_kv_heads < tp
    return AttnDims(
        q_heads=qp, kv_heads=num_kv_heads, head_dim=head_dim,
        q_local=qp // tp,
        kv_local=num_kv_heads if kv_rep else num_kv_heads // tp,
        kv_replicated=kv_rep)


def init_attention(pb: common.ParamBuilder, prefix: str, layers: int, d_model: int,
                   dims: AttnDims, qk_norm: bool) -> None:
    """Stacked (over ``layers``) attention params, the reference's names,
    shapes and scales."""
    scale = d_model ** -0.5
    pb.add(f"{prefix}.wq", (layers, d_model, dims.q_heads, dims.head_dim), scale=scale)
    pb.add(f"{prefix}.wk", (layers, d_model, dims.kv_heads, dims.head_dim), scale=scale)
    pb.add(f"{prefix}.wv", (layers, d_model, dims.kv_heads, dims.head_dim), scale=scale)
    pb.add(f"{prefix}.wo", (layers, dims.q_heads, dims.head_dim, d_model),
           scale=(dims.q_heads * dims.head_dim) ** -0.5)
    if qk_norm:
        pb.ones(f"{prefix}.q_norm", (layers, dims.head_dim))
        pb.ones(f"{prefix}.k_norm", (layers, dims.head_dim))


def project_qkv(ctx, p, x, dims: AttnDims, qk_norm: bool, positions,
                rope_theta: Optional[float]):
    """x: (B, S, D) → q (B, S, Hq, hd), k / v (B, S, Hkv, hd)."""
    cd = ctx.compute_dtype
    q = torch.einsum("bsd,dhk->bshk", x, p["wq"].to(cd))
    k = torch.einsum("bsd,dhk->bshk", x, p["wk"].to(cd))
    v = torch.einsum("bsd,dhk->bshk", x, p["wv"].to(cd))
    if qk_norm:
        q = common.rms_norm(q, p["q_norm"])
        k = common.rms_norm(k, p["k_norm"])
    if rope_theta is not None:
        q = common.apply_rope(q, positions, rope_theta)
        k = common.apply_rope(k, positions, rope_theta)
    return q, k, v


def chunked_attention(q, k, v, *, causal: bool, window: Optional[int] = None,
                      q_offset: int = 0, chunk_q: int = 1024, chunk_k: int = 1024):
    """Online-softmax attention over (chunk_q, chunk_k) chunks, every chunk
    visited (the reference's ``attn_impl="xla"`` path).

    q: (B, Sq, Hq, hd); k, v: (B, Sk, Hkv, hd) with Hq % Hkv == 0 →
    (B, Sq, Hq, hd).  f32 scores and sums, p rounded to v's dtype.
    """
    b, sq, hq, hd = q.shape
    _, sk, hkv, _ = k.shape
    g = hq // hkv
    chunk_q, chunk_k = min(chunk_q, sq), min(chunk_k, sk)
    if sq % chunk_q or sk % chunk_k:
        raise ValueError(f"Sq={sq}, Sk={sk} must be multiples of the chunks {chunk_q}, {chunk_k}")
    scale = hd ** -0.5
    qr = q.reshape(b, sq, hkv, g, hd)
    out = torch.empty(b, sq, hkv, g, hd, dtype=q.dtype, device=q.device)
    pos = torch.arange(max(sq + q_offset, sk), device=q.device)
    for qi in range(sq // chunk_q):
        qc = qr[:, qi * chunk_q:(qi + 1) * chunk_q].float()
        q_pos = pos[q_offset + qi * chunk_q:q_offset + (qi + 1) * chunk_q]
        m = torch.full((b, hkv, g, chunk_q), NEG_INF, dtype=torch.float32, device=q.device)
        l = torch.zeros_like(m)
        acc = torch.zeros(b, hkv, g, chunk_q, hd, dtype=torch.float32, device=q.device)
        for ki in range(sk // chunk_k):
            kc = k[:, ki * chunk_k:(ki + 1) * chunk_k]
            vc = v[:, ki * chunk_k:(ki + 1) * chunk_k]
            k_pos = pos[ki * chunk_k:(ki + 1) * chunk_k]
            s = torch.einsum("bqhgd,bkhd->bhgqk", qc, kc.float()) * scale
            mask = torch.ones(chunk_q, chunk_k, dtype=torch.bool, device=q.device)
            if causal:
                mask &= q_pos[:, None] >= k_pos[None, :]
            if window is not None:
                mask &= k_pos[None, :] > q_pos[:, None] - window
            s = torch.where(mask, s, NEG_INF)
            m_new = torch.maximum(m, s.amax(-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(-1)
            pv = torch.einsum("bhgqk,bkhd->bhgqd", p.to(vc.dtype).float(), vc.float())
            acc = acc * corr[..., None] + pv
            m = m_new
        o = acc / torch.clamp(l, min=1e-30)[..., None]                # (b, hkv, g, cq, hd)
        out[:, qi * chunk_q:(qi + 1) * chunk_q] = o.permute(0, 3, 1, 2, 4).to(q.dtype)
    return out.reshape(b, sq, hq, hd)


def decode_attention(q, k_cache, v_cache, pos: int, *, window: Optional[int] = None):
    """Single-token attention against a cache, plain torch (the reference
    computes it outside any Pallas kernel).

    q: (B, 1, Hq, hd); caches: (B, Smax, Hkv, hd); ``pos``: the number of
    valid cache entries.  Returns (B, 1, Hq, hd) in q's dtype.
    """
    b, _, hq, hd = q.shape
    _, smax, hkv, _ = k_cache.shape
    g = hq // hkv
    qr = q.reshape(b, hkv, g, hd).float()
    s = torch.einsum("bhgd,bkhd->bhgk", qr, k_cache.float()) * hd ** -0.5
    k_pos = torch.arange(smax, device=q.device)
    mask = k_pos < pos
    if window is not None:
        mask &= k_pos > pos - 1 - window
    s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhgk,bkhd->bhgd", p.to(v_cache.dtype).float(), v_cache.float())
    return out.reshape(b, 1, hq, hd).to(q.dtype)


def output_proj(ctx, p, attn_out):
    """(B, S, Hq, hd) → (B, S, D)."""
    return torch.einsum("bshk,hkd->bsd", attn_out, p["wo"].to(ctx.compute_dtype))
