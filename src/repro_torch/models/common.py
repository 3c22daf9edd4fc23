"""Shared model substrate — port of ``repro.models.common``: the shard
context, the per-layer FSDP gather, the seeded parameter initializer,
RMSNorm, RoPE and the sinusoidal positions.

The reference writes every layer per shard inside ``shard_map`` with
Megatron-style collectives over its ``model`` axis; at ``tp = 1`` those
collectives are identities (and its sequence sharding is off).  The port
takes ``tp = 1`` only and the layers call no collective over a model axis;
tensor parallelism raises :class:`~repro_torch.core.wire.base.NotPortedError`.
FSDP (ZeRO-3 over ``data``) gathers each layer's sharded leaves
(:func:`gather_fsdp`) where a process holds only its rank's shards.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Callable, Dict, Mapping, Optional, Sequence

import torch

from repro_torch.core.wire.base import NotPortedError


@dataclasses.dataclass(frozen=True)
class ShardCtx:
    """Static context threaded through all layers.

    ``compute_dtype``: the dtype of activations and matmul inputs (the
    reference casts every layer's weights to it before use).  ``fsdp``:
    leaves whose spec names ``fsdp_axis`` are sharded over it (ZeRO-3).
    ``comm``: the communicator over that axis when this process holds only
    its own rank's shards (a ``DistComm``), so each layer gathers them;
    None where every leaf is whole here (the ranks stacked on one device,
    serving), and the gather is the cast.
    """

    tp: int = 1
    compute_dtype: torch.dtype = torch.bfloat16
    fsdp: bool = False
    fsdp_axis: str = "data"
    comm: Any = dataclasses.field(default=None, compare=False)

    def __post_init__(self):
        if self.tp != 1:
            raise NotPortedError(
                f"tensor parallelism (tp={self.tp}) is not ported yet: it arrives with "
                "tensor-parallel serving (ROADMAP.md, queue 1)")


class _GatherFSDP(torch.autograd.Function):
    """One FSDP leaf of one layer: the forward casts this rank's f32 shard
    to the compute dtype and gathers the whole tensor (bf16 on the wire,
    not the f32 master); the backward reduce-scatters the bf16 cotangent
    (an f32 sum over the ranks in rank order, rounded once) and casts this
    rank's shard to f32: the transpose of the reference's gather."""

    @staticmethod
    def forward(ctx, w, dim: int, comm, dtype):
        ctx.dim, ctx.comm = dim, comm
        shard = w.to(dtype)[None]
        comm.count_fsdp(shard.numel() * shard.element_size())
        return comm.fsdp_gather(shard, dim)

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous()[None]
        ctx.comm.count_fsdp(g.numel() * g.element_size())
        return ctx.comm.reduce_scatter(g, ctx.dim)[0].to(torch.float32), None, None, None


def gather_fsdp(layer: Mapping[str, torch.Tensor], specs: Mapping[str, Optional[tuple]],
                ctx: ShardCtx) -> Dict[str, torch.Tensor]:
    """One layer's leaves in the compute dtype, the FSDP-sharded ones
    gathered whole (``repro.models.common.gather_fsdp``).  ``specs`` gives
    each leaf's per-layer spec (the stack dim stripped); a leaf whose spec
    names ``ctx.fsdp_axis`` is gathered along that dim under FSDP when
    ``ctx.comm`` is set, and only cast where the leaf is whole."""
    out = {}
    for k, w in layer.items():
        spec = specs.get(k)
        if ctx.fsdp and ctx.comm is not None and spec is not None and ctx.fsdp_axis in spec:
            out[k] = _GatherFSDP.apply(w, spec.index(ctx.fsdp_axis), ctx.comm,
                                       ctx.compute_dtype)
        else:
            out[k] = w.to(ctx.compute_dtype)
    return out


def ceil_to(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


class ParamBuilder:
    """Accumulates a flat parameter dict with seeded normal init.

    Draws with one explicit ``torch.Generator`` (its device is the
    parameters' device), leaf by leaf in the order the reference adds them,
    at the reference's scales (``ParamBuilder.add``): ``shape[0] ** -0.5``
    by default for matrices, 0.02 for vectors, ones for norms.  The values
    are not the reference's (another generator); names, shapes, f32 dtype
    and scales are.  ``keep(name, leaf)``, when given, takes what this
    process keeps of each whole leaf as it is drawn (a rank's FSDP shard),
    so the rest is freed before the next leaf is drawn; the draws do not
    depend on it.
    """

    def __init__(self, generator: torch.Generator,
                 keep: Optional[Callable[[str, torch.Tensor], torch.Tensor]] = None):
        self.gen = generator
        self.keep = keep or (lambda name, x: x)
        self.params: Dict[str, torch.Tensor] = {}

    def add(self, name: str, shape: Sequence[int], scale=None) -> None:
        if scale is None:
            scale = shape[0] ** -0.5 if len(shape) > 1 else 0.02
        x = torch.randn(tuple(shape), generator=self.gen, device=self.gen.device)
        self.params[name] = self.keep(name, x.mul_(scale))

    def ones(self, name: str, shape: Sequence[int]) -> None:
        self.params[name] = self.keep(name, torch.ones(tuple(shape), device=self.gen.device))


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
