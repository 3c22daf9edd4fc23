"""The gated SiLU MLP (llama family) — port of ``repro.models.mlp`` at
``tp = 1``.  Its three products are plain ``torch.einsum`` in the compute
dtype, as the reference leaves them to XLA outside any kernel."""
from __future__ import annotations

import torch

from repro_torch.models import common


def init_mlp(pb: common.ParamBuilder, prefix: str, layers: int, d_model: int,
             d_ff: int) -> None:
    pb.add(f"{prefix}.w_up", (layers, d_model, d_ff))
    pb.add(f"{prefix}.w_gate", (layers, d_model, d_ff))
    pb.add(f"{prefix}.w_down", (layers, d_ff, d_model), scale=d_ff ** -0.5)


def mlp(ctx: common.ShardCtx, p, x):
    """x: (B, S, D) → (B, S, D); silu(x W_gate) · (x W_up) W_down."""
    cd = ctx.compute_dtype
    up = torch.einsum("bsd,df->bsf", x, p["w_up"].to(cd))
    gate = torch.einsum("bsd,df->bsf", x, p["w_gate"].to(cd))
    h = gate * torch.sigmoid(gate) * up        # jax.nn.silu is x * sigmoid(x)
    return torch.einsum("bsf,fd->bsd", h, p["w_down"].to(cd))
