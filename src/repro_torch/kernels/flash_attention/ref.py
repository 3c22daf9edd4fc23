"""Plain PyTorch flash attention — port of ``repro.kernels.flash_attention``'s
oracle (``ref.attention``) and of its Pallas kernels' bodies (forward
``flash_attention.py:50``, backward sweeps ``:162`` and ``:207``) as
blockwise versions.

* :func:`attention` — full-softmax GQA attention with causal / sliding
  window masks, the oracle;
* :func:`flash_attention_fwd` — the online softmax over (block_q, block_k)
  blocks, step for step as the Pallas body: f32 scores times the f32 scale,
  the finite ``-1e30`` sentinel, blocks that ``_block_live`` calls dead
  skipped, p rounded to v's dtype before P·V with f32 sums, and
  ``o = acc / max(l, 1e-30)``, ``lse = m + log(max(l, 1e-30))``;
* :func:`flash_attention_bwd` — the two backward sweeps, step for step as
  ``_bwd_dkv_kernel`` and ``_bwd_dq_kernel``: f32 casts of q, k, v and do,
  ``p = exp(s - lse)`` left unrounded (the forward rounds it, the backward
  does not), ``ds = p * (dp - delta)``, each block's ``dsᵀ·q``, ``pᵀ·do``
  and ``ds·k`` added to its f32 sum in the reference's grid order, dk and
  dq blocks times the scale before they are added.

Both take the model's layout, q (B, Sq, Hq, hd) and k, v (B, Sk, Hkv, hd);
the reference's Pallas forward takes (B, H, S, hd).  ``lse`` is
(B, Hq, Sq) f32 as there, and so is the backward's ``delta``.  The
blockwise versions are what a CPU tensor takes (:mod:`.ops`) and what the
CUDA kernels (``csrc/flash_attention.cu``, ``csrc/flash_attention_bwd.cu``)
are held against.
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
    bq, bk = _blocks(sq, sk, block_q, block_k)
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


def _blocks(sq: int, sk: int, block_q: int, block_k: int):
    bq, bk = min(block_q, sq), min(block_k, sk)
    if sq % bq or sk % bk:
        raise ValueError(f"Sq={sq}, Sk={sk} must be multiples of the blocks {bq}, {bk}")
    return bq, bk


class _Sweep:
    """The inputs of both backward sweeps in the reference's grouped layout,
    and the (p, ds) of one block pair."""

    def __init__(self, q, k, v, do, lse, delta, causal, window, q_offset, block_q, block_k):
        b, sq, hq, hd = q.shape
        _, sk, hkv, _ = k.shape
        g = hq // hkv
        self.shape = (b, sq, sk, hq, hkv, hd, g)
        self.bq, self.bk = _blocks(sq, sk, block_q, block_k)
        self.mask_args = (causal, window)
        self.q_offset = q_offset
        self.scale = _scale(hd, q.device)

        def heads(x):                          # (b, s, hkv*g, hd) → (b, hkv, g, s, hd)
            return x.reshape(b, x.shape[1], hkv, g, hd).permute(0, 2, 3, 1, 4).float()

        self.qh, self.doh = heads(q), heads(do)
        self.kh = k.permute(0, 2, 1, 3).float()             # (b, hkv, sk, hd)
        self.vh = v.permute(0, 2, 1, 3).float()
        self.lse = lse.reshape(b, hkv, g, sq)
        self.delta = delta.reshape(b, hkv, g, sq)
        self.pos = torch.arange(max(sq + q_offset, sk), device=q.device)

    def live(self, qi: int, ki: int) -> bool:
        return _block_live(self.q_offset + qi * self.bq, ki * self.bk, self.bq, self.bk,
                           *self.mask_args)

    def block(self, gi, qi: int, ki: int):
        """(q, do, k, p, ds) of q block qi of group member gi against key
        block ki, (b, hkv[, g], rows, ·) f32; gi None takes every member."""
        bq, bk = self.bq, self.bk
        q_start, k_start = self.q_offset + qi * bq, ki * bk
        sel = slice(None) if gi is None else gi
        rows = slice(qi * bq, (qi + 1) * bq)
        qb, dob = self.qh[:, :, sel, rows], self.doh[:, :, sel, rows]
        kb = self.kh[:, :, k_start:k_start + bk]
        vb = self.vh[:, :, k_start:k_start + bk]
        if gi is None:
            kb, vb = kb[:, :, None], vb[:, :, None]
        s = torch.matmul(qb, kb.transpose(-1, -2)) * self.scale
        mask = _mask(self.pos[q_start:q_start + bq], self.pos[k_start:k_start + bk],
                     *self.mask_args)
        s = torch.where(mask, s, NEG_INF)
        p = torch.exp(s - self.lse[:, :, sel, rows, None])
        dp = torch.matmul(dob, vb.transpose(-1, -2))
        ds = p * (dp - self.delta[:, :, sel, rows, None])
        return qb, dob, kb, p, ds


def flash_attention_bwd_dkv(q, k, v, do, lse, delta, *, causal: bool = True,
                            window: Optional[int] = None, q_offset: int = 0,
                            block_q: int = 512, block_k: int = 512):
    """Sweep 1 (``_bwd_dkv_kernel``): for each key block, the g q heads of
    its kv head and then their q blocks, as the reference's innermost grid
    index ``jq = g_idx * nq + q_block``.  Arguments as
    :func:`flash_attention_bwd` → (dk, dv) (B, Sk, Hkv, hd) f32."""
    sw = _Sweep(q, k, v, do, lse, delta, causal, window, q_offset, block_q, block_k)
    b, sq, sk, _, hkv, hd, g = sw.shape
    dk = torch.zeros(b, hkv, sk, hd, dtype=torch.float32, device=q.device)
    dv = torch.zeros_like(dk)
    for ki in range(sk // sw.bk):
        keys = slice(ki * sw.bk, (ki + 1) * sw.bk)
        for gi in range(g):
            for qi in range(sq // sw.bq):
                if not sw.live(qi, ki):
                    continue
                qb, dob, _, p, ds = sw.block(gi, qi, ki)
                dv[:, :, keys] += torch.matmul(p.transpose(-1, -2), dob)
                dk[:, :, keys] += torch.matmul(ds.transpose(-1, -2), qb) * sw.scale
    return dk.permute(0, 2, 1, 3), dv.permute(0, 2, 1, 3)


def flash_attention_bwd_dq(q, k, v, do, lse, delta, *, causal: bool = True,
                           window: Optional[int] = None, q_offset: int = 0,
                           block_q: int = 512, block_k: int = 512):
    """Sweep 2 (``_bwd_dq_kernel``): for each q block, its live key blocks
    in order.  Arguments as :func:`flash_attention_bwd` → dq
    (B, Sq, Hq, hd) f32."""
    sw = _Sweep(q, k, v, do, lse, delta, causal, window, q_offset, block_q, block_k)
    b, sq, sk, hq, hkv, hd, g = sw.shape
    dq = torch.zeros(b, hkv, g, sq, hd, dtype=torch.float32, device=q.device)
    for qi in range(sq // sw.bq):
        for ki in range(sk // sw.bk):
            if not sw.live(qi, ki):
                continue
            _, _, kb, _, ds = sw.block(None, qi, ki)
            dq[:, :, :, qi * sw.bq:(qi + 1) * sw.bq] += torch.matmul(ds, kb) * sw.scale
    return dq.permute(0, 3, 1, 2, 4).reshape(b, sq, hq, hd)


def flash_attention_bwd(q, k, v, do, lse, delta, *, causal: bool = True,
                        window: Optional[int] = None, q_offset: int = 0,
                        block_q: int = 512, block_k: int = 512):
    """q, do: (B, Sq, Hq, hd); k, v: (B, Sk, Hkv, hd); lse, delta: (B, Hq, Sq)
    f32 → (dq (B, Sq, Hq, hd), dk, dv (B, Sk, Hkv, hd)), all f32.  Block
    sizes as :func:`flash_attention_fwd`; dead blocks (``_block_live``) are
    skipped in both sweeps."""
    kw = dict(causal=causal, window=window, q_offset=q_offset, block_q=block_q,
              block_k=block_k)
    dk, dv = flash_attention_bwd_dkv(q, k, v, do, lse, delta, **kw)
    return flash_attention_bwd_dq(q, k, v, do, lse, delta, **kw), dk, dv
