"""Shared model substrate — port of ``repro.models.common``: the shard
context, the seeded parameter initializer, RMSNorm, RoPE and the
sinusoidal positions.

The reference writes every layer per shard inside ``shard_map`` with
Megatron-style collectives over its ``model`` axis; at ``tp = 1`` those
collectives are identities (and its sequence sharding is off).  The port
runs on one device with no mesh, so :class:`ShardCtx` takes ``tp = 1``
only and the layers call no collective; tensor parallelism raises
:class:`~repro_torch.core.wire.base.NotPortedError` (FSDP does in
:func:`repro_torch.convert.run_config`).
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Dict, Sequence

import torch

from repro_torch.core.wire.base import NotPortedError


@dataclasses.dataclass(frozen=True)
class ShardCtx:
    """Static context threaded through all layers: one device, no mesh.

    ``compute_dtype``: the dtype of activations and matmul inputs (the
    reference casts every layer's weights to it before use).
    """

    tp: int = 1
    compute_dtype: torch.dtype = torch.bfloat16

    def __post_init__(self):
        if self.tp != 1:
            raise NotPortedError(
                f"tensor parallelism (tp={self.tp}) is not ported yet: it arrives with "
                "the full-depth training slice if its multi-card step needs it "
                "(ROADMAP.md, queue 1)")


def ceil_to(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


class ParamBuilder:
    """Accumulates a flat parameter dict with seeded normal init.

    Draws with one explicit ``torch.Generator`` (its device is the
    parameters' device), leaf by leaf in the order the reference adds them,
    at the reference's scales (``ParamBuilder.add``): ``shape[0] ** -0.5``
    by default for matrices, 0.02 for vectors, ones for norms.  The values
    are not the reference's (another generator); names, shapes, f32 dtype
    and scales are.
    """

    def __init__(self, generator: torch.Generator):
        self.gen = generator
        self.params: Dict[str, torch.Tensor] = {}

    def add(self, name: str, shape: Sequence[int], scale=None) -> None:
        if scale is None:
            scale = shape[0] ** -0.5 if len(shape) > 1 else 0.02
        x = torch.randn(tuple(shape), generator=self.gen, device=self.gen.device)
        self.params[name] = x.mul_(scale)

    def ones(self, name: str, shape: Sequence[int]) -> None:
        self.params[name] = torch.ones(tuple(shape), device=self.gen.device)


def check_no_tf32(t, what: str) -> None:
    """An f32 product (the LM head, the MoE router) must run in full f32 on
    the card, as the reference's f32 products do: TF32 off."""
    if t.is_cuda and torch.backends.cuda.matmul.allow_tf32:
        raise RuntimeError(f"torch.backends.cuda.matmul.allow_tf32 is set: {what} would round "
                           "its inputs to TF32")


def rms_norm(x, scale, eps: float = 1e-6):
    """RMSNorm in f32, cast back to the input dtype."""
    xf = x.float()
    var = torch.mean(xf * xf, dim=-1, keepdim=True)
    y = xf * torch.rsqrt(var + eps)
    return (y * scale.float()).to(x.dtype)


def rope_frequencies(head_dim: int, theta: float, device=None):
    """(head_dim / 2,) f32 inverse frequencies θ^(−2i/hd), bit-equal to the
    reference's table: the f32 exponents (a true division, on the CPU) are
    raised from θ rounded to f32 in f64, and the power rounded once, as
    XLA's correctly rounded f32 ``pow`` gives it (torch's f32 ``pow`` is an
    ulp off at some exponents, which the angle multiplies by the
    position).  One table a (head_dim, θ, device), made once: a copy to
    the card at every call would wait for the card."""
    return _rope_table(head_dim, float(theta), str(torch.device(device or "cpu")))


@functools.lru_cache(maxsize=None)
def _rope_table(head_dim: int, theta: float, device: str):
    expo = -torch.arange(0, head_dim, 2, dtype=torch.float32) / head_dim
    base = float(torch.tensor(theta, dtype=torch.float32))
    return (base ** expo.double()).float().to(device)


def apply_rope(x, positions, theta: float = 1e4):
    """x: (B, S, H, hd); positions: (S,) or (B, S)."""
    hd = x.shape[-1]
    freqs = rope_frequencies(hd, theta, x.device)           # (hd/2,)
    ang = positions.float()[..., None] * freqs              # (S | B S, hd/2)
    ang = ang[None, :, None, :] if positions.dim() == 1 else ang[:, :, None, :]
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def sinusoidal_positions(length: int, d_model: int, offset: int = 0, device=None):
    """(length, d_model) f32 absolute positions ``offset`` … ``offset +
    length − 1``: sines of the angles pos · 10⁴^(−2i/d) in the first half,
    cosines in the second (the reference's order).  The f32 exponents'
    power is taken in f64 and rounded once, as XLA's correctly rounded f32
    ``pow`` gives it (torch's f32 ``pow`` is an ulp off at some exponents,
    which the angle multiplies by the position)."""
    pos = torch.arange(length, dtype=torch.float32, device=device) + offset
    expo = -torch.arange(0, d_model, 2, dtype=torch.float32, device=device) / d_model
    inv = (1e4 ** expo.double()).float()
    ang = pos[:, None] * inv[None, :]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)
