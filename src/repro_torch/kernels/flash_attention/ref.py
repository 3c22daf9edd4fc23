"""Plain PyTorch flash attention — port of ``repro.kernels.flash_attention``'s
oracle (``ref.attention``) and of its Pallas forward's body
(``flash_attention.py:50``) as a blockwise version.

* :func:`attention` — full-softmax GQA attention with causal / sliding
  window masks, the oracle;
* :func:`flash_attention_fwd` — the online softmax over (block_q, block_k)
  blocks, step for step as the Pallas body: f32 scores times the f32 scale,
  the finite ``-1e30`` sentinel, blocks that ``_block_live`` calls dead
  skipped, p rounded to v's dtype before P·V with f32 sums, and
  ``o = acc / max(l, 1e-30)``, ``lse = m + log(max(l, 1e-30))``.

Both take the model's layout, q (B, Sq, Hq, hd) and k, v (B, Sk, Hkv, hd);
the reference's Pallas forward takes (B, H, S, hd).  ``lse`` is
(B, Hq, Sq) f32 as there.  The blockwise version is what a CPU tensor takes
(:mod:`.ops`) and what the CUDA kernel (``csrc/flash_attention.cu``) is
held against.
"""
from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30


def _scale(hd: int, device) -> torch.Tensor:
    """hd^-0.5 rounded once to f32, the constant the kernel multiplies by."""
    return torch.tensor(hd ** -0.5, dtype=torch.float32, device=device)


def _mask(q_pos, k_pos, causal: bool, window: Optional[int]):
    mask = torch.ones(q_pos.shape[0], k_pos.shape[0], dtype=torch.bool, device=q_pos.device)
    if causal:
        mask &= q_pos[:, None] >= k_pos[None, :]
    if window is not None:
        mask &= k_pos[None, :] > q_pos[:, None] - window
    return mask


def _block_live(q_start, k_start, bq, bk, causal, window) -> bool:
    run = True
    if causal:
        run = q_start + bq - 1 >= k_start
    if window is not None:
        run = run and k_start + bk - 1 > q_start - window
    return run


def attention(q, k, v, *, causal: bool = True, window: Optional[int] = None,
              q_offset: int = 0):
    """q: (B, Sq, Hq, hd); k, v: (B, Sk, Hkv, hd), Hq % Hkv == 0 →
    (B, Sq, Hq, hd) in q's dtype.  f32 softmax."""
    b, sq, hq, hd = q.shape
    _, sk, hkv, _ = k.shape
    g = hq // hkv
    qr = q.reshape(b, sq, hkv, g, hd).float()
    s = torch.einsum("bqhgd,bkhd->bhgqk", qr, k.float()) * _scale(hd, q.device)
    pos = torch.arange(max(sq + q_offset, sk), device=q.device)
    mask = _mask(pos[q_offset:q_offset + sq], pos[:sk], causal, window)
    s = torch.where(mask, s, NEG_INF)
    p = torch.exp(s - s.amax(-1, keepdim=True))
    p = p / p.sum(-1, keepdim=True)
    o = torch.einsum("bhgqk,bkhd->bhgqd", p, v.float())
    return o.permute(0, 3, 1, 2, 4).reshape(b, sq, hq, hd).to(q.dtype)


def flash_attention_fwd(q, k, v, *, causal: bool = True, window: Optional[int] = None,
                        q_offset: int = 0, block_q: int = 512, block_k: int = 512):
    """q: (B, Sq, Hq, hd); k, v: (B, Sk, Hkv, hd) → (o (B, Sq, Hq, hd) in q's
    dtype, lse (B, Hq, Sq) f32).  Sq % min(block_q, Sq) == 0 and
    Sk % min(block_k, Sk) == 0, as the Pallas kernel requires."""
    b, sq, hq, hd = q.shape
    _, sk, hkv, _ = k.shape
    g = hq // hkv
    bq, bk = min(block_q, sq), min(block_k, sk)
    if sq % bq or sk % bk:
        raise ValueError(f"Sq={sq}, Sk={sk} must be multiples of the blocks {bq}, {bk}")
    scale = _scale(hd, q.device)
    qh = q.reshape(b, sq, hkv, g, hd).permute(0, 2, 3, 1, 4)    # (b, hkv, g, sq, hd)
    kh = k.permute(0, 2, 1, 3)[:, :, None]                      # (b, hkv, 1, sk, hd)
    vh = v.permute(0, 2, 1, 3)[:, :, None]
    o = torch.empty(b, hkv, g, sq, hd, dtype=q.dtype, device=q.device)
    lse = torch.empty(b, hkv, g, sq, dtype=torch.float32, device=q.device)
    pos = torch.arange(max(sq + q_offset, sk), device=q.device)
    for qi in range(sq // bq):
        q_start = q_offset + qi * bq
        qb = qh[..., qi * bq:(qi + 1) * bq, :].float()
        m = torch.full(qb.shape[:-1], NEG_INF, dtype=torch.float32, device=q.device)
        l = torch.zeros_like(m)
        acc = torch.zeros(qb.shape, dtype=torch.float32, device=q.device)
        for ki in range(sk // bk):
            k_start = ki * bk
            if not _block_live(q_start, k_start, bq, bk, causal, window):
                continue
            kb = kh[..., k_start:k_start + bk, :].float()
            vb = vh[..., k_start:k_start + bk, :]
            s = torch.matmul(qb, kb.transpose(-1, -2)) * scale
            mask = _mask(pos[q_start:q_start + bq], pos[k_start:k_start + bk], causal, window)
            s = torch.where(mask, s, NEG_INF)
            m_new = torch.maximum(m, s.amax(-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(-1)
            m = m_new
            pv = torch.matmul(p.to(v.dtype).float(), vb.float())
            acc = acc * corr[..., None] + pv
        l = torch.clamp(l, min=1e-30)
        o[..., qi * bq:(qi + 1) * bq, :] = (acc / l[..., None]).to(q.dtype)
        lse[..., qi * bq:(qi + 1) * bq] = m + torch.log(l)
    return o.permute(0, 3, 1, 2, 4).reshape(b, sq, hq, hd), lse.reshape(b, hq, sq)
