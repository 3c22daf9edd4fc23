"""Architecture, shape and run configuration schema — port of
``repro.configs.base``.

:class:`ArchConfig` and :class:`ShapeSpec` are field for field the
reference's dataclasses (the MoE and SSM sub-configs are the port's
:class:`~repro_torch.models.moe.MoECfg` and
:class:`~repro_torch.models.ssm.SSMCfg`).  :class:`RunConfig` has the fields
the serving path and the training step read, with the reference's defaults.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

from repro_torch.core import types as core_types
from repro_torch.models.moe import MoECfg
from repro_torch.models.ssm import SSMCfg


@dataclasses.dataclass(frozen=True)
class ShapeSpec:
    name: str
    kind: str              # "train" | "prefill" | "decode"
    seq_len: int
    global_batch: int


SHAPES = {
    "train_4k": ShapeSpec("train_4k", "train", 4096, 256),
    "prefill_32k": ShapeSpec("prefill_32k", "prefill", 32768, 32),
    "decode_32k": ShapeSpec("decode_32k", "decode", 32768, 128),
    "long_500k": ShapeSpec("long_500k", "decode", 524288, 1),
}


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
    moe: Optional[MoECfg] = None
    ssm: Optional[SSMCfg] = None
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
    """The reference's execution tunables (``repro.configs.base.RunConfig``).

    ``attn_impl``: "flash" runs the flash-attention forward (the Hopper
    kernel on a CUDA tensor, its plain blockwise version on a CPU one);
    "xla" the model's chunked online softmax
    (:func:`repro_torch.models.attention.chunked_attention`), the
    reference's name for it.  ``attn_chunk_q`` / ``attn_chunk_k`` are the
    chunk sizes of that path and the block sizes of the plain flash version
    (the kernel tiles by 64).  ``compute_dtype`` names the torch dtype of
    activations and matmul inputs.  ``remat`` recomputes each layer's
    forward in the backward (``torch.utils.checkpoint``), ``remat_attention``
    the attention call's; neither has an effect without a gradient.
    ``microbatches`` splits each rank's batch for f32 gradient accumulation;
    ``compression`` configures the gradient sync.  ``fsdp`` shards every
    leaf whose spec names ``data`` over the data axis (ZeRO-3): each layer
    gathers its bf16 weights and reduce-scatters their gradients
    (:func:`repro_torch.models.common.gather_fsdp`, the train step).
    ``model_parallel`` acts only with a model axis above 1, which raises
    (:func:`repro_torch.models.model.make_ctx`).
    ``seq_shard`` (the reference's sequence-parallel residual stream) is
    read only at tp > 1, which raises: it is carried so every field of the
    reference's ``RunConfig`` has its place.
    """
    microbatches: int = 1
    fsdp: bool = False
    model_parallel: bool = True
    seq_shard: bool = True
    attn_chunk_q: int = 1024
    attn_chunk_k: int = 1024
    remat: bool = True
    remat_attention: bool = False
    attn_impl: str = "flash"
    compression: core_types.CompressionConfig = dataclasses.field(
        default_factory=lambda: core_types.CompressionConfig(mode="none"))
    compute_dtype: str = "bfloat16"

    def __post_init__(self):
        if self.microbatches < 1:
            raise ValueError(f"microbatches must be >= 1, got {self.microbatches}")
