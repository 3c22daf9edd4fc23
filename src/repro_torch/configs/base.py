"""Architecture, shape and run configuration schema — port of
``repro.configs.base``.

:class:`ArchConfig` and :class:`ShapeSpec` are field for field the
reference's dataclasses (the MoE and SSM sub-configs kept as opaque values
until their model families are ported).  :class:`RunConfig` has only the
fields the serving path reads.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str              # "train" | "prefill" | "decode"
    seq_len: int
    global_batch: int


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


@dataclasses.dataclass(frozen=True)
class RunConfig:
    """The reference's execution tunables that the serving path reads.

    ``attn_impl``: "flash" runs the flash-attention forward (the Hopper
    kernel on a CUDA tensor, its plain blockwise version on a CPU one);
    "xla" the model's chunked online softmax
    (:func:`repro_torch.models.attention.chunked_attention`), the
    reference's name for it.  ``attn_chunk_q`` / ``attn_chunk_k`` are the
    chunk sizes of that path and the block sizes of the plain flash version
    (the kernel tiles by 64).  ``compute_dtype`` names the torch dtype of
    activations and matmul inputs.  ``remat`` has no effect when serving.
    """
    attn_chunk_q: int = 1024
    attn_chunk_k: int = 1024
    remat: bool = True
    attn_impl: str = "flash"
    compute_dtype: str = "bfloat16"
