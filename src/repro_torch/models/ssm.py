"""Mamba-2 (SSD, state-space duality) layers at ``tp = 1`` — port of
``repro.models.ssm``: the chunked scan of training and prefill, and the
one-token decode recurrence.

Per head, with state S_t ∈ R^{p×n}:

    S_t = a_t·S_{t−1} + Δ_t·X_t ⊗ B_t,      a_t = exp(Δ_t·A) ∈ (0, 1]
    y_t = S_t·C_t + D·x_t

Chunked over chunks of Q tokens (cum_t = Σ_{v≤t} log a_v):

    intra:  y_t += Σ_{u≤t} e^{cum_t−cum_u}·Δ_u·(C_t·B_u)·X_u
    inter:  y_t += e^{cum_t}·S_init·C_t
    carry:  S' = e^{cum_Q}·S_init + Σ_u e^{cum_Q−cum_u}·Δ_u·X_u ⊗ B_u

The formulas and dtypes are the reference's: decay math in f32 log space,
the mask applied before the ``exp`` (above the diagonal ``cum_t − cum_u``
is positive and its ``exp`` would overflow), B, C and X in f32 inside the
scan, Y cast back to X's dtype.  Where the reference scans chunk by chunk,
:func:`ssd_chunked` computes every chunk's intra-chunk terms and state
contribution at once and runs only the carry S' = e^{total}·S +
contribution in a loop, in the reference's order; the inter-chunk term
follows from each chunk's entering state.  Only the order of the f32 sums
inside the products differs.  The f32 products run in full f32 on the card
(TF32 off, :func:`~repro_torch.models.common.check_no_tf32`).
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.models import common

NEG_INF = -1e30


@dataclasses.dataclass(frozen=True)
class SSMCfg:
    """The reference's ``SSMCfg``, field for field."""

    d_state: int = 128
    head_dim: int = 64
    expand: int = 2
    n_groups: int = 1          # B/C groups; shared B/C (n_groups = 1), the
    conv_width: int = 4        # mamba2-130m setting
    chunk: int = 256

    def d_inner(self, d_model: int) -> int:
        return self.expand * d_model

    def nheads(self, d_model: int) -> int:
        return self.d_inner(d_model) // self.head_dim


def init_ssm(pb: common.ParamBuilder, prefix: str, layers: int, d_model: int,
             cfg: SSMCfg) -> None:
    """The reference's leaves, in its order and at its scales."""
    din = cfg.d_inner(d_model)
    nh = cfg.nheads(d_model)
    gn = cfg.n_groups * cfg.d_state
    pb.add(f"{prefix}.w_z", (layers, d_model, din))
    pb.add(f"{prefix}.w_x", (layers, d_model, din))
    pb.add(f"{prefix}.w_B", (layers, d_model, gn))
    pb.add(f"{prefix}.w_C", (layers, d_model, gn))
    pb.add(f"{prefix}.w_dt", (layers, d_model, nh))
    pb.add(f"{prefix}.conv_x", (layers, cfg.conv_width, din), scale=cfg.conv_width ** -0.5)
    pb.add(f"{prefix}.conv_B", (layers, cfg.conv_width, gn), scale=cfg.conv_width ** -0.5)
    pb.add(f"{prefix}.conv_C", (layers, cfg.conv_width, gn), scale=cfg.conv_width ** -0.5)
    pb.add(f"{prefix}.A_log", (layers, nh), scale=1.0)
    pb.add(f"{prefix}.D", (layers, nh), scale=1.0)
    pb.add(f"{prefix}.dt_bias", (layers, nh), scale=1.0)
    pb.ones(f"{prefix}.norm", (layers, din))
    pb.add(f"{prefix}.w_out", (layers, din, d_model), scale=din ** -0.5)


def _silu(x):
    return x * torch.sigmoid(x)        # jax.nn.silu is x * sigmoid(x)


def _causal_conv(x, w, state: Optional[torch.Tensor] = None):
    """Depthwise causal conv, then silu.  x: (B, S, C); w: (W, C).

    The W products are summed from 0 in x's dtype, rounding after each
    multiply and add, as the reference's Python ``sum``.  Returns (y,
    new_state): new_state holds the last W−1 *inputs* (the decode's
    window), in x's dtype (a bf16 state is promoted to it)."""
    bw = w.shape[0]
    pad = (state.to(x.dtype) if state is not None
           else torch.zeros((x.shape[0], bw - 1, x.shape[2]), dtype=x.dtype, device=x.device))
    xp = torch.cat([pad, x], dim=1)
    s = x.shape[1]
    y = 0
    for i in range(bw):
        y = y + xp[:, i:i + s] * w[i][None, None, :].to(x.dtype)
    return _silu(y), xp[:, -(bw - 1):]


def ssd_chunked(X, B, C, dt, log_a, cfg: SSMCfg, init_state=None):
    """Chunked SSD scan.

    X: (b, s, h, p); B, C: (b, s, n) f32, shared across heads; dt, log_a:
    (b, s, h) f32.  Returns (Y (b, s, h, p) in X's dtype, final state (b, h,
    p, n) f32).  ``s`` must be a multiple of ``q = min(cfg.chunk, s)``, as
    the reference asserts: a prompt is never padded, which would change
    the carried state."""
    b, s, h, hd = X.shape
    n = B.shape[-1]
    q = min(cfg.chunk, s)
    if s % q:
        raise ValueError(f"a sequence of {s} tokens is not a multiple of the SSD chunk {q}")
    nc = s // q
    common.check_no_tf32(B, "the SSD scan's f32 products")
    dev = X.device

    xf = X.float().reshape(b, nc, q, h, hd)
    Bc = B.reshape(b, nc, q, n)
    Cc = C.reshape(b, nc, q, n)
    dtc = dt.reshape(b, nc, q, h)
    cum = torch.cumsum(log_a.reshape(b, nc, q, h), dim=2)   # ≤ 0, non-increasing
    total = cum[:, :, -1]                                    # (b, nc, h)

    # intra-chunk masked quadratic form, every chunk at once, heads before (t, u)
    mask = torch.ones((q, q), dtype=torch.bool, device=dev).tril()      # t ≥ u
    cumh = cum.transpose(2, 3)                               # (b, nc, h, q)
    ldiff = torch.where(mask, cumh[..., :, None] - cumh[..., None, :], NEG_INF)
    scores = torch.matmul(Cc, Bc.transpose(-1, -2))          # (b, nc, t, u)
    m = scores[:, :, None] * torch.exp(ldiff) * dtc.transpose(2, 3)[:, :, :, None, :]
    y_intra = torch.matmul(m, xf.permute(0, 1, 3, 2, 4))     # (b, nc, h, t, p)

    # each chunk's own contribution to the state it hands on
    wgt = torch.exp(total[:, :, None, :] - cum) * dtc        # (b, nc, q, h)
    contrib = torch.einsum("bcuhp,bcun->bchpn", xf * wgt[..., None], Bc)

    # the carry, chunk by chunk in the reference's order
    state = (init_state if init_state is not None
             else torch.zeros((b, h, hd, n), dtype=torch.float32, device=dev))
    decay = torch.exp(total)
    entering = []
    for c in range(nc):
        entering.append(state)
        state = decay[:, c, :, None, None] * state + contrib[:, c]
    s_in = torch.stack(entering, dim=1)                      # (b, nc, h, p, n)

    # inter-chunk: the state entering each chunk
    y_inter = torch.einsum("bctn,bchpn->bcthp", Cc, s_in) * torch.exp(cum)[..., None]
    Y = (y_intra.permute(0, 1, 3, 2, 4) + y_inter).to(X.dtype)
    return Y.reshape(b, s, h, hd), state


def ssd_decode_step(state, x, B, C, dt, log_a):
    """One-token recurrence.  state: (b, h, p, n) f32; x: (b, h, p); B, C:
    (b, n); dt, log_a: (b, h) f32.  Returns (y (b, h, p) in x's dtype, the
    new state f32)."""
    xf = x.float()
    common.check_no_tf32(xf, "the SSD decode's f32 products")
    a = torch.exp(log_a)
    upd = (xf * dt[:, :, None])[..., None] * B.float()[:, None, None, :]
    s_new = a[:, :, None, None] * state + upd
    y = torch.einsum("bhpn,bn->bhp", s_new, C.float())
    return y.to(x.dtype), s_new


def _split_proj(ctx: common.ShardCtx, p, x_full):
    """The input projections shared by prefill, training and decode."""
    cd = ctx.compute_dtype
    return tuple(x_full @ p[k].to(cd) for k in ("w_z", "w_x", "w_B", "w_C", "w_dt"))


def _dt_log_a(p, dt_raw):
    """dt = softplus(dt_raw + dt_bias) and log a = dt·A, A = −exp(A_log),
    in f32."""
    dt = torch.nn.functional.softplus(dt_raw.float() + p["dt_bias"].float())
    a = -torch.exp(p["A_log"].float())
    return dt, dt * a


def _gate_out(ctx: common.ShardCtx, p, Y, X, z):
    """Y + D·X in X's dtype, the silu(z) gate, RMSNorm, the out projection."""
    Y = Y + X * p["D"].to(X.dtype)[..., :, None]
    y = Y.reshape(Y.shape[:-2] + (-1,))
    y = common.rms_norm(y * _silu(z.float()).to(y.dtype), p["norm"])
    return y @ p["w_out"].to(ctx.compute_dtype)


def mamba_block(ctx: common.ShardCtx, p, x_seq, cfg: SSMCfg, conv_state=None,
                ssm_state=None, return_state: bool = False):
    """The Mamba-2 block on a sequence (training or prefill).  x_seq: (B, S,
    D).  Returns out (B, S, D) [, (conv windows {"x", "B", "C"}, final
    state)]."""
    b, s, d = x_seq.shape
    nh = cfg.nheads(d)
    z, xin, braw, craw, dt_raw = _split_proj(ctx, p, x_seq)
    cs = conv_state or {}
    xin, cs_x = _causal_conv(xin, p["conv_x"], cs.get("x"))
    braw, cs_b = _causal_conv(braw, p["conv_B"], cs.get("B"))
    craw, cs_c = _causal_conv(craw, p["conv_C"], cs.get("C"))
    X = xin.reshape(b, s, nh, cfg.head_dim)
    dt, log_a = _dt_log_a(p, dt_raw)
    Y, final = ssd_chunked(X, braw.float(), craw.float(), dt, log_a, cfg, init_state=ssm_state)
    out = _gate_out(ctx, p, Y, X, z)
    if return_state:
        return out, ({"x": cs_x, "B": cs_b, "C": cs_c}, final)
    return out


def mamba_decode(ctx: common.ShardCtx, p, x_tok, cfg: SSMCfg, conv_state, ssm_state):
    """One-token decode.  x_tok: (B, 1, D); conv_state: {"x", "B", "C"} of
    (B, W−1, C) windows; ssm_state: (B, h, p, n) f32.  Returns (out (B, 1,
    D), (new windows, new state))."""
    b, _, d = x_tok.shape
    nh = cfg.nheads(d)
    z, xin, braw, craw, dt_raw = _split_proj(ctx, p, x_tok)
    xin, cs_x = _causal_conv(xin, p["conv_x"], conv_state["x"])
    braw, cs_b = _causal_conv(braw, p["conv_B"], conv_state["B"])
    craw, cs_c = _causal_conv(craw, p["conv_C"], conv_state["C"])
    X = xin.reshape(b, nh, cfg.head_dim)
    dt, log_a = _dt_log_a(p, dt_raw[:, 0])
    y, s_new = ssd_decode_step(ssm_state, X, braw[:, 0], craw[:, 0], dt, log_a)
    out = _gate_out(ctx, p, y, X, z[:, 0]).reshape(b, 1, d)
    return out, ({"x": cs_x, "B": cs_b, "C": cs_c}, s_new)
