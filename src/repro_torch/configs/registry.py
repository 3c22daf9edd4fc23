"""Architecture registry, compression presets, smoke configs and parameter
shapes — the parts of ``repro.configs.registry`` the port needs.

``COMPRESSION_PRESETS`` is the reference's table, all 14 entries, so a
preset name means the same config on both sides; the registry
(:func:`repro_torch.core.wire.resolve`) says which of them the port can run;
the ``hier_*`` presets run unflattened on a ``(pod, data)`` mesh.
:func:`get_run_config` is the reference's run configuration.
:func:`param_shapes` gives the dense, VLM, MoE, SSM, hybrid and
encoder–decoder families' leaf names, global shapes and sharding specs
exactly as ``repro.models.transformer.init_lm`` (or
``repro.models.encdec.init_encdec``) with ``init_attention`` /
``init_mlp`` / ``init_moe`` / ``init_ssm`` builds them.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

from repro_torch.configs import (h2o_danube3_4b, jamba_v01_52b, llava_next_34b, mamba2_130m,
                                 minitron_4b, mistral_large_123b, olmoe_1b_7b, qwen2_moe_a2_7b,
                                 qwen3_4b, whisper_medium)
from repro_torch.configs.base import SHAPES, ArchConfig, RunConfig
from repro_torch.core import types as core_types
from repro_torch.core.wire.base import NotPortedError
from repro_torch.models.moe import MoECfg
from repro_torch.models.ssm import SSMCfg

_ARCHS = {m.CONFIG.name: m.CONFIG
          for m in (qwen3_4b, h2o_danube3_4b, minitron_4b, mistral_large_123b,
                    qwen2_moe_a2_7b, olmoe_1b_7b, mamba2_130m, jamba_v01_52b,
                    whisper_medium, llava_next_34b)}


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
_TRAIN_MICROBATCHES = {"mistral-large-123b": 16, "llava-next-34b": 8, "jamba-v0.1-52b": 8,
                       "qwen3-4b": 4, "h2o-danube-3-4b": 4, "minitron-4b": 4,
                       "qwen2-moe-a2.7b": 4, "olmoe-1b-7b": 2, "whisper-medium": 1,
                       "mamba2-130m": 1}
# the reference's FSDP set (> 8B parameters)
_BIG = {"mistral-large-123b", "jamba-v0.1-52b", "llava-next-34b", "qwen2-moe-a2.7b"}


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
    model axis into data parallelism).  The reference's set of archs above
    8B parameters (``_BIG``) trains with FSDP over ``data``: ``fsdp=True``,
    as the reference sets it; with ``multi_pod`` its FSDP leaves' shards
    take the compressed mean over ``pod`` (exact inside each pod)."""
    return _run_config(arch, shape, fsdp=get_config(arch).name in _BIG, multi_pod=multi_pod,
                       compression=compression)


def _run_config(arch: str, shape: str, *, fsdp: bool, multi_pod: bool = False,
                compression=None) -> RunConfig:
    """:func:`get_run_config` with FSDP on or off as ``fsdp`` says.  Off, it
    is a cut of an arch of the FSDP set: every rank holds every parameter
    whole, and the gradients take the exact or compressed mean."""
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
    return RunConfig(microbatches=mb, fsdp=fsdp, model_parallel=sharded, seq_shard=sharded,
                     attn_chunk_q=chunk_q, attn_chunk_k=chunk_k, remat=(kind == "train"),
                     compression=compression)


def smoke_config(name: str) -> ArchConfig:
    """The reference's reduced smoke variant (``repro.configs.registry
    .smoke_config``): same family and topology, tiny dims; an MoE config
    gets 4 experts, top-2, expert ff 64, and 2 shared of ff 64 where the
    full config has shared experts; an SSM config ``SSMCfg(d_state=16,
    head_dim=16, expand=2, conv_width=4, chunk=16)``; a hybrid config one
    period of 4 layers (``attn_every`` 4, attention at position 1) with
    both; an encoder–decoder config 2 encoder layers and 24 frames; a VLM
    config 8 patches."""
    cfg = get_config(name)
    if cfg.family not in ("dense", "vlm", "moe", "ssm", "hybrid", "encdec"):
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
    hybrid, encdec = cfg.family == "hybrid", cfg.family == "encdec"
    return ArchConfig(
        name=cfg.name + "-smoke", family=cfg.family,
        num_layers=4 if hybrid else 2, d_model=64, num_heads=4, num_kv_heads=2, head_dim=16,
        d_ff=128, vocab_size=512, qk_norm=cfg.qk_norm,
        window=16 if cfg.window else None, rope_theta=cfg.rope_theta,
        tie_embeddings=cfg.tie_embeddings, moe=moe, ssm=ssm,
        attn_every=4 if hybrid else None, attn_offset=1 if hybrid else 0,
        encoder_layers=2 if encdec else 0, encoder_seq=24 if encdec else 0,
        num_patches=8 if cfg.family == "vlm" else 0, sub_quadratic=cfg.sub_quadratic)


def _ceil_to(a: int, b: int) -> int:
    return -(-a // b) * b


def _ssm_shapes(add, prefix: str, n: int, cfg: ArchConfig, tp: int, fsdp) -> None:
    """The ``n`` stacked leaves of ``repro.models.ssm.init_ssm`` under
    ``prefix``, in its order."""
    s, d = cfg.ssm, cfg.d_model
    m = "model" if tp > 1 else None
    din, nh, gn, w = s.d_inner(d), s.nheads(d), s.n_groups * s.d_state, s.conv_width
    for name, shape, spec in (
            ("w_z", (d, din), (fsdp, m)), ("w_x", (d, din), (fsdp, m)),
            ("w_B", (d, gn), (fsdp, None)), ("w_C", (d, gn), (fsdp, None)),
            ("w_dt", (d, nh), (fsdp, m)), ("conv_x", (w, din), (None, m)),
            ("conv_B", (w, gn), (None, None)), ("conv_C", (w, gn), (None, None)),
            ("A_log", (nh,), (m,)), ("D", (nh,), (m,)), ("dt_bias", (nh,), (m,)),
            ("norm", (din,), (m,)), ("w_out", (din, d), (m, fsdp))):
        add(f"{prefix}.{name}", (n,) + shape, (None,) + spec)


def _attn_shapes(add, prefix: str, n: int, cfg: ArchConfig, tp: int, fsdp) -> None:
    """``repro.models.attention.init_attention``'s ``n`` stacked leaves."""
    d, hd = cfg.d_model, cfg.hd
    q_heads = _ceil_to(cfg.num_heads, tp)
    kv_spec = None if cfg.num_kv_heads < tp else "model"
    add(f"{prefix}.wq", (n, d, q_heads, hd), (None, fsdp, "model", None))
    add(f"{prefix}.wk", (n, d, cfg.num_kv_heads, hd), (None, fsdp, kv_spec, None))
    add(f"{prefix}.wv", (n, d, cfg.num_kv_heads, hd), (None, fsdp, kv_spec, None))
    add(f"{prefix}.wo", (n, q_heads, hd, d), (None, "model", None, fsdp))
    if cfg.qk_norm:
        add(f"{prefix}.q_norm", (n, hd), (None, None))
        add(f"{prefix}.k_norm", (n, hd), (None, None))


def _mlp_shapes(add, prefix: str, n: int, d: int, f: int, fsdp, gated: bool = True) -> None:
    """``repro.models.mlp.init_mlp``'s ``n`` stacked leaves (``w_gate``
    only when ``gated``)."""
    add(f"{prefix}.w_up", (n, d, f), (None, fsdp, "model"))
    if gated:
        add(f"{prefix}.w_gate", (n, d, f), (None, fsdp, "model"))
    add(f"{prefix}.w_down", (n, f, d), (None, "model", fsdp))


def _moe_shapes(add, prefix: str, n: int, cfg: ArchConfig, tp: int, fsdp) -> None:
    """``repro.models.moe.init_moe``'s ``n`` stacked leaves, the shared
    experts' MLP last."""
    d, m = cfg.d_model, cfg.moe
    ep = m.padded(tp)
    add(f"{prefix}.router", (n, d, ep), (None, None, None))
    add(f"{prefix}.w_up", (n, ep, d, m.d_ff_expert), (None, "model", fsdp, None))
    add(f"{prefix}.w_gate", (n, ep, d, m.d_ff_expert), (None, "model", fsdp, None))
    add(f"{prefix}.w_down", (n, ep, m.d_ff_expert, d), (None, "model", None, fsdp))
    if m.num_shared:
        _mlp_shapes(add, f"{prefix}.shared", n, d, m.d_ff_shared, fsdp)


def hybrid_layout(cfg: ArchConfig):
    """The hybrid family's period: (period length, number of periods, Mamba
    mixers a period, MoE FFNs a period, the positions whose FFN is the MoE
    block).  Attention sits at ``attn_offset``, a mixer at every other
    position; the FFN at position i is the MoE block where ``i % every_n ==
    1 % every_n`` (``repro.models.transformer._forward_hybrid``), else the
    gated MLP."""
    per = cfg.attn_every
    if not per or cfg.num_layers % per or not 0 <= cfg.attn_offset < per:
        raise ValueError(f"{cfg.name}: {cfg.num_layers} layers do not split into periods of "
                         f"{per} with attention at {cfg.attn_offset}")
    every = cfg.moe.every_n
    n_moe = per // every
    moe_at = tuple(i for i in range(per) if n_moe > 0 and i % every == 1 % every)
    if len(moe_at) != n_moe:
        raise ValueError(f"{cfg.name}: {len(moe_at)} MoE positions in a period of {per}, "
                         f"not {n_moe}")
    return per, cfg.num_layers // per, per - 1, n_moe, moe_at


def param_shapes(cfg: ArchConfig, tp: int = 1, fsdp: Optional[str] = None):
    """(shapes, specs): the global shape and sharding spec of every leaf of
    a dense-, VLM-, MoE-, SSM-, hybrid- or encoder–decoder-family model, named
    and built as ``init_lm`` (``init_encdec``) builds them (``tp`` the
    model-axis size, ``fsdp`` the FSDP axis or None).  The hybrid's
    ``periods.*`` leaves stack each sublayer kind over all periods:
    attention (periods), Mamba mixers (periods × (period − 1)), MoE and MLP
    FFNs (periods × their count a period), both norms (layers).  The
    encoder–decoder's ``enc.*`` leaves stack over the encoder layers, its
    ``dec.*`` leaves (self-attention, cross-attention ``dec.xattn``, the
    GELU MLP, three norms) over the decoder layers."""
    if cfg.family not in ("dense", "vlm", "moe", "ssm", "hybrid", "encdec"):
        raise NotPortedError(
            f"parameter shapes of the {cfg.family!r} family are not ported "
            "yet: they arrive with the models slice (ROADMAP.md, queue 1)")
    shapes: Dict[str, Tuple[int, ...]] = {}
    specs: Dict[str, tuple] = {}

    def add(name, shape, spec):
        shapes[name] = tuple(shape)
        specs[name] = tuple(spec)

    d, L = cfg.d_model, cfg.num_layers
    vshard = "model" if tp > 1 else None
    add("embed", (cfg.vocab_padded(tp), d), (vshard, None))
    if not cfg.tie_embeddings:
        add("lm_head", (cfg.vocab_padded(tp), d), (vshard, None))
    add("final_norm", (d,), (None,))
    if cfg.family == "encdec":
        le = cfg.encoder_layers
        add("enc_final_norm", (d,), (None,))
        _attn_shapes(add, "enc.attn", le, cfg, tp, fsdp)
        _mlp_shapes(add, "enc.mlp", le, d, cfg.d_ff, fsdp, gated=False)
        add("enc.norm1", (le, d), (None, None))
        add("enc.norm2", (le, d), (None, None))
        _attn_shapes(add, "dec.attn", L, cfg, tp, fsdp)
        _attn_shapes(add, "dec.xattn", L, cfg, tp, fsdp)
        _mlp_shapes(add, "dec.mlp", L, d, cfg.d_ff, fsdp, gated=False)
        for i in (1, 2, 3):
            add(f"dec.norm{i}", (L, d), (None, None))
        return shapes, specs
    if cfg.family == "ssm":
        _ssm_shapes(add, "layers.ssm", L, cfg, tp, fsdp)
        add("layers.norm1", (L, d), (None, None))
        return shapes, specs
    if cfg.family == "hybrid":
        per, np_, nm, n_moe, _ = hybrid_layout(cfg)
        _attn_shapes(add, "periods.attn", np_, cfg, tp, fsdp)
        _ssm_shapes(add, "periods.ssm", np_ * nm, cfg, tp, fsdp)
        _moe_shapes(add, "periods.moe", np_ * n_moe, cfg, tp, fsdp)
        _mlp_shapes(add, "periods.mlp", np_ * (per - n_moe), d, cfg.d_ff, fsdp)
        add("periods.norm1", (L, d), (None, None))
        add("periods.norm2", (L, d), (None, None))
        return shapes, specs

    _attn_shapes(add, "layers.attn", L, cfg, tp, fsdp)
    if cfg.family == "moe":
        _moe_shapes(add, "layers.moe", L, cfg, tp, fsdp)
    else:
        _mlp_shapes(add, "layers.mlp", L, d, cfg.d_ff, fsdp)
    add("layers.norm1", (L, d), (None, None))
    add("layers.norm2", (L, d), (None, None))
    if cfg.family == "vlm":
        add("patch_proj", (d, d), (None, None))
    return shapes, specs
