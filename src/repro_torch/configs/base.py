"""Architecture configuration schema — port of ``repro.configs.base``'s
:class:`ArchConfig`.

Field for field the reference's dataclass; the MoE and SSM sub-configs are
kept as opaque values until their model families are ported.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                       # dense | moe | ssm | hybrid | encdec | vlm
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: Optional[int] = None    # default d_model // num_heads
    qk_norm: bool = False
    window: Optional[int] = None      # sliding-window attention width
    rope_theta: float = 1e4
    tie_embeddings: bool = False
    moe: Optional[Any] = None
    ssm: Optional[Any] = None
    attn_every: Optional[int] = None
    attn_offset: int = 0
    encoder_layers: int = 0
    encoder_seq: int = 0
    num_patches: int = 0
    sub_quadratic: bool = False

    @property
    def hd(self) -> int:
        return self.head_dim or self.d_model // self.num_heads

    def vocab_padded(self, tp: int) -> int:
        return -(-self.vocab_size // tp) * tp
