"""Dense MLP blocks — port of ``repro.models.mlp`` at ``tp = 1``: the gated
SiLU MLP (llama family) and the GELU MLP (whisper).  Their products are
plain ``torch.einsum`` in the compute dtype, as the reference leaves them
to XLA outside any kernel."""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models import common


def init_mlp(pb: common.ParamBuilder, prefix: str, layers: int, d_model: int,
             d_ff: int, gated: bool = True) -> None:
    pb.add(f"{prefix}.w_up", (layers, d_model, d_ff))
    if gated:
        pb.add(f"{prefix}.w_gate", (layers, d_model, d_ff))
    pb.add(f"{prefix}.w_down", (layers, d_ff, d_model), scale=d_ff ** -0.5)


def mlp(ctx: common.ShardCtx, p, x, gated: bool = True):
    """x: (B, S, D) → (B, S, D): silu(x W_gate) · (x W_up) W_down, or with
    ``gated=False`` gelu(x W_up) W_down in the tanh form, which is
    ``jax.nn.gelu``'s default (torch's default is the erf form)."""
    cd = ctx.compute_dtype
    up = torch.einsum("bsd,df->bsf", x, p["w_up"].to(cd))
    if gated:
        gate = torch.einsum("bsd,df->bsf", x, p["w_gate"].to(cd))
        h = gate * torch.sigmoid(gate) * up    # jax.nn.silu is x * sigmoid(x)
    else:
        h = F.gelu(up, approximate="tanh")
    return torch.einsum("bsf,fd->bsd", h, p["w_down"].to(cd))
