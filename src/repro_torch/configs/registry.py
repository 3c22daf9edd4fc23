"""Architecture registry, compression presets, smoke configs and parameter
shapes — the parts of ``repro.configs.registry`` the port needs.

``COMPRESSION_PRESETS`` is the reference's table, all 14 entries, so a
preset name means the same config on both sides; the registry
(:func:`repro_torch.core.wire.resolve`) says which of them the port can run;
the ``hier_*`` presets run unflattened on a ``(pod, data)`` mesh.
:func:`get_run_config` is the reference's run configuration.
:func:`param_shapes` gives the dense, MoE and SSM families' leaf names,
global shapes and sharding specs exactly as
``repro.models.transformer.init_lm`` with ``init_attention`` /
``init_mlp`` / ``init_moe`` / ``init_ssm`` builds them.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

from repro_torch.configs import mamba2_130m, olmoe_1b_7b, qwen2_moe_a2_7b, qwen3_4b
from repro_torch.configs.base import SHAPES, ArchConfig, RunConfig
from repro_torch.core import types as core_types
from repro_torch.core.wire.base import NotPortedError
from repro_torch.models.moe import MoECfg
from repro_torch.models.ssm import SSMCfg

_ARCHS = {m.CONFIG.name: m.CONFIG
          for m in (qwen3_4b, qwen2_moe_a2_7b, olmoe_1b_7b, mamba2_130m)}


def list_archs():
    return sorted(_ARCHS)


def get_config(name: str) -> ArchConfig:
    if name not in _ARCHS:
        raise KeyError(f"unknown arch {name!r}; have {list_archs()}")
    return _ARCHS[name]


_E = core_types.EncoderSpec
_C = core_types.CompressionConfig

# default compression for train shapes: fixed-k at k/d = 1/r = 1/16 with
# shared support (Example 7), across the pod axis.
_TRAIN_COMPRESSION = _C(encoder=_E(kind="fixed_k", fraction=1.0 / 16, center="mean"),
                        mode="shared_support", axes=("pod",))

COMPRESSION_PRESETS: Dict[str, core_types.CompressionConfig] = {
    "fixed_k_1bit": _TRAIN_COMPRESSION,
    "bernoulli_seed_1bit": _C(
        encoder=_E(kind="bernoulli", fraction=1.0 / 16, center="mean"),
        mode="gather_decode", axes=("pod",), scatter_decode=True),
    "binary_packed": _C(
        encoder=_E(kind="binary", center="min"),
        mode="gather_decode", axes=("pod",), scatter_decode=True),
    "ternary_packed": _C(
        encoder=_E(kind="ternary", fraction=1.0 / 16, center="min"),
        mode="gather_decode", axes=("pod",), scatter_decode=True),
    "rotated_binary": _C(
        encoder=_E(kind="binary", center="min", rotation=True),
        mode="gather_decode", axes=("pod",)),
    "rotated_fixed_k": _C(
        encoder=_E(kind="fixed_k", fraction=1.0 / 16, center="mean", rotation=True),
        mode="gather_decode", axes=("pod",)),
    "ternary_opt": _C(
        encoder=_E(kind="ternary", fraction=1.0 / 16, probs="optimal", center="min"),
        mode="gather_decode", axes=("pod",)),
    "ef_fixed_k": _C(
        encoder=_E(kind="fixed_k", fraction=1.0 / 16, center="mean"),
        mode="gather_decode", axes=("pod",), error_feedback=True),
    "ef_bernoulli": _C(
        encoder=_E(kind="bernoulli", fraction=1.0 / 16, center="mean"),
        mode="gather_decode", axes=("pod",), error_feedback=True,
        scatter_decode=True),
    "ef_binary": _C(
        encoder=_E(kind="binary", center="min"),
        mode="gather_decode", axes=("pod",), error_feedback=True,
        scatter_decode=True),
    "ef_ternary": _C(
        encoder=_E(kind="ternary", fraction=1.0 / 16, center="min"),
        mode="gather_decode", axes=("pod",), error_feedback=True,
        scatter_decode=True),
    "ef_rotated_binary": _C(
        encoder=_E(kind="binary", center="min", rotation=True),
        mode="gather_decode", axes=("pod",), error_feedback=True,
        scatter_decode=True),
    "hier_fixed_k": _C(
        encoder=_E(kind="fixed_k", fraction=1.0 / 16, center="mean"),
        mode="gather_decode", axes=("pod",), inner_axes=("data",),
        scatter_decode=True),
    "hier_bernoulli": _C(
        encoder=_E(kind="bernoulli", fraction=1.0 / 16, center="mean"),
        mode="gather_decode", axes=("pod",), inner_axes=("data",),
        scatter_decode=True),
}


def compression_preset(name: str,
                       axes: Optional[Tuple[str, ...]] = None
                       ) -> core_types.CompressionConfig:
    """Resolve a named preset, optionally re-pointing its mesh axes; inner
    axes that collide with the new axes are dropped (a hierarchical preset
    on a single-axis mesh becomes its flat codec, scatter decode kept)."""
    if name not in COMPRESSION_PRESETS:
        raise KeyError(f"unknown compression preset {name!r}; "
                       f"have {sorted(COMPRESSION_PRESETS)}")
    cfg = COMPRESSION_PRESETS[name]
    if axes is None:
        return cfg
    inner = tuple(a for a in cfg.inner_axes if a not in axes)
    return dataclasses.replace(cfg, axes=axes, inner_axes=inner)


def robust_preset(name: str, policy: str,
                  axes: Optional[Tuple[str, ...]] = None) -> core_types.CompressionConfig:
    """A named preset with the decode policy ``policy`` ("trim(1)",
    "median", "mean_trim(1)", "mean").  The wire is the base preset's byte
    for byte: only the decode-time reduction changes.  Deliberately not a
    new preset: the preset dict is the golden wire matrix's universe.
    ``wire.resolve`` rejects a robust policy on the psum presets."""
    return dataclasses.replace(compression_preset(name, axes), decode_policy=policy)


# the reference's microbatch counts for train shapes (dry-run memory sizing)
_TRAIN_MICROBATCHES = {"qwen3-4b": 4, "qwen2-moe-a2.7b": 4, "olmoe-1b-7b": 2,
                       "mamba2-130m": 1}
# the reference's FSDP set among the port's archs (> 8B parameters)
_BIG = {"qwen2-moe-a2.7b"}


def get_run_config(arch: str, shape: str, *, multi_pod: bool = False,
                   compression=None) -> RunConfig:
    """The reference's run configuration for (arch, shape), field for field
    (``repro.configs.registry.get_run_config``).

    A train shape compresses by default with ``fixed_k_1bit`` (Example 7)
    over ``("pod",)`` when ``multi_pod``, exactly averaged inside each pod
    by the train step (the ``data`` axis is not a compression axis), else
    over ``("data",)``; a preset name is re-pointed the same way
    (:func:`compression_preset`).  mamba2-130m runs without a model axis
    (``model_parallel`` and ``seq_shard`` False: the reference folds the
    model axis into data parallelism).  FSDP (the reference's ≥ 30B set)
    raises in ``RunConfig``, as do the shapes and families the port
    lacks."""
    cfg = get_config(arch)
    kind = SHAPES[shape].kind
    if isinstance(compression, str):
        compression = compression_preset(compression,
                                          axes=("pod",) if multi_pod else ("data",))
    mb = _TRAIN_MICROBATCHES.get(arch, 2) if kind == "train" else 1
    if compression is None:
        if kind == "train":
            compression = dataclasses.replace(
                _TRAIN_COMPRESSION, axes=("pod",) if multi_pod else ("data",))
        else:
            compression = core_types.CompressionConfig(mode="none")
    chunk_q = chunk_k = 1024
    if SHAPES[shape].seq_len >= 32768 and kind != "decode":
        chunk_q, chunk_k = 1024, 2048
    sharded = cfg.name != "mamba2-130m"
    return RunConfig(microbatches=mb, fsdp=cfg.name in _BIG, model_parallel=sharded,
                     seq_shard=sharded,
                     attn_chunk_q=chunk_q, attn_chunk_k=chunk_k, remat=(kind == "train"),
                     compression=compression)


def smoke_config(name: str) -> ArchConfig:
    """The reference's reduced smoke variant (``repro.configs.registry
    .smoke_config``): same family and topology, tiny dims; an MoE config
    gets 4 experts, top-2, expert ff 64, and 2 shared of ff 64 where the
    full config has shared experts; an SSM config ``SSMCfg(d_state=16,
    head_dim=16, expand=2, conv_width=4, chunk=16)``.  Dense, MoE and SSM
    families only; the others arrive with their model families."""
    cfg = get_config(name)
    if cfg.family not in ("dense", "moe", "ssm"):
        raise NotPortedError(
            f"the {cfg.family!r} family is not ported yet (ROADMAP.md, queue 1)")
    moe = None
    if cfg.moe is not None:
        moe = MoECfg(num_experts=4, top_k=2, d_ff_expert=64,
                     num_shared=(2 if cfg.moe.num_shared else 0),
                     d_ff_shared=(64 if cfg.moe.num_shared else 0),
                     every_n=cfg.moe.every_n)
    ssm = None
    if cfg.ssm is not None:
        ssm = SSMCfg(d_state=16, head_dim=16, expand=2, conv_width=4, chunk=16)
    return ArchConfig(
        name=cfg.name + "-smoke", family=cfg.family,
        num_layers=2, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
        d_ff=128, vocab_size=512, qk_norm=cfg.qk_norm,
        window=16 if cfg.window else None, rope_theta=cfg.rope_theta,
        tie_embeddings=cfg.tie_embeddings, moe=moe, ssm=ssm,
        sub_quadratic=cfg.sub_quadratic)


def _ceil_to(a: int, b: int) -> int:
    return -(-a // b) * b


def _ssm_shapes(add, cfg: ArchConfig, tp: int, fsdp) -> None:
    """The ``layers.ssm`` leaves of ``repro.models.ssm.init_ssm``, in its
    order."""
    s, d, L = cfg.ssm, cfg.d_model, cfg.num_layers
    m = "model" if tp > 1 else None
    din, nh, gn, w = s.d_inner(d), s.nheads(d), s.n_groups * s.d_state, s.conv_width
    for name, shape, spec in (
            ("w_z", (d, din), (fsdp, m)), ("w_x", (d, din), (fsdp, m)),
            ("w_B", (d, gn), (fsdp, None)), ("w_C", (d, gn), (fsdp, None)),
            ("w_dt", (d, nh), (fsdp, m)), ("conv_x", (w, din), (None, m)),
            ("conv_B", (w, gn), (None, None)), ("conv_C", (w, gn), (None, None)),
            ("A_log", (nh,), (m,)), ("D", (nh,), (m,)), ("dt_bias", (nh,), (m,)),
            ("norm", (din,), (m,)), ("w_out", (din, d), (m, fsdp))):
        add(f"layers.ssm.{name}", (L,) + shape, (None,) + spec)


def param_shapes(cfg: ArchConfig, tp: int = 1, fsdp: Optional[str] = None):
    """(shapes, specs): the global shape and sharding spec of every leaf of
    a dense-, MoE- or SSM-family model, named and built as ``init_lm``
    builds them (``tp`` the model-axis size, ``fsdp`` the FSDP axis or
    None)."""
    if cfg.family not in ("dense", "vlm", "moe", "ssm"):
        raise NotPortedError(
            f"parameter shapes of the {cfg.family!r} family are not ported "
            "yet: they arrive with the models slice (ROADMAP.md, queue 1)")
    shapes: Dict[str, Tuple[int, ...]] = {}
    specs: Dict[str, tuple] = {}

    def add(name, shape, spec):
        shapes[name] = tuple(shape)
        specs[name] = tuple(spec)

    d, L, hd = cfg.d_model, cfg.num_layers, cfg.hd
    vshard = "model" if tp > 1 else None
    add("embed", (cfg.vocab_padded(tp), d), (vshard, None))
    if not cfg.tie_embeddings:
        add("lm_head", (cfg.vocab_padded(tp), d), (vshard, None))
    add("final_norm", (d,), (None,))
    if cfg.family == "ssm":
        _ssm_shapes(add, cfg, tp, fsdp)
        add("layers.norm1", (L, d), (None, None))
        return shapes, specs

    q_heads = _ceil_to(cfg.num_heads, tp)
    kv_spec = None if cfg.num_kv_heads < tp else "model"
    add("layers.attn.wq", (L, d, q_heads, hd), (None, fsdp, "model", None))
    add("layers.attn.wk", (L, d, cfg.num_kv_heads, hd), (None, fsdp, kv_spec, None))
    add("layers.attn.wv", (L, d, cfg.num_kv_heads, hd), (None, fsdp, kv_spec, None))
    add("layers.attn.wo", (L, q_heads, hd, d), (None, "model", None, fsdp))
    if cfg.qk_norm:
        add("layers.attn.q_norm", (L, hd), (None, None))
        add("layers.attn.k_norm", (L, hd), (None, None))
    if cfg.family == "moe":
        m, ep = cfg.moe, cfg.moe.padded(tp)
        add("layers.moe.router", (L, d, ep), (None, None, None))
        add("layers.moe.w_up", (L, ep, d, m.d_ff_expert), (None, "model", fsdp, None))
        add("layers.moe.w_gate", (L, ep, d, m.d_ff_expert), (None, "model", fsdp, None))
        add("layers.moe.w_down", (L, ep, m.d_ff_expert, d), (None, "model", None, fsdp))
        ffn = [("layers.moe.shared", m.d_ff_shared)] if m.num_shared else []
    else:
        ffn = [("layers.mlp", cfg.d_ff)]
    for prefix, f in ffn:
        add(f"{prefix}.w_up", (L, d, f), (None, fsdp, "model"))
        add(f"{prefix}.w_gate", (L, d, f), (None, fsdp, "model"))
        add(f"{prefix}.w_down", (L, f, d), (None, "model", fsdp))
    add("layers.norm1", (L, d), (None, None))
    add("layers.norm2", (L, d), (None, None))
    if cfg.family == "vlm":
        add("patch_proj", (d, d), (None, None))
    return shapes, specs
