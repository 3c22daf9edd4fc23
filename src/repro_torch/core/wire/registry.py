"""The wire-codec registry — port of ``repro.core.wire.registry``.

Every consumer of "what does this config put on the wire" (the collective,
the bit accounting, the bucket plan) resolves a codec here.  ``gather_kind``
is the reference's rule verbatim.  The port has every base codec:
``fixed_k``, ``fixed_k_shared``, ``bernoulli``, ``binary``, ``ternary``,
``ternary_opt`` and ``dense``, and the §7.2 rotation wrapper
(:class:`~.rotated.RotatedCodec`, registered as ``rotated_binary`` and
``rotated_fixed_k``, built on the fly around any other codec), and error
feedback (:class:`~.ef.EFCodec`, outermost: EF∘rotation, so the residual
stays in model coordinates; the reference's six ``ef_*`` compositions are
registered, any other is built on the fly).  It never falls back to
another codec.
"""
from __future__ import annotations

from typing import Dict, List

from repro_torch.core import types as t
from repro_torch.core.wire import base, codecs, ef, rotated

_CODECS: Dict[str, base.WireCodec] = {}


def register(codec: base.WireCodec) -> base.WireCodec:
    """Register a codec instance under its ``name`` (last write wins)."""
    _CODECS[codec.name] = codec
    return codec


def get(name: str) -> base.WireCodec:
    if name not in _CODECS:
        raise KeyError(f"unknown wire codec {name!r}; have {names()}")
    return _CODECS[name]


def names() -> List[str]:
    return sorted(_CODECS)


register(codecs.FixedKGatherCodec())
register(codecs.FixedKSharedCodec())
register(codecs.BernoulliCodec())
register(codecs.BinaryCodec())
register(codecs.TernaryCodec())
register(codecs.TernaryOptCodec())
register(codecs.DenseSimCodec())
# the shipped rotations get stable names; resolve() builds any other on the fly
register(rotated.RotatedCodec(get("binary")))
register(rotated.RotatedCodec(get("fixed_k")))
# the shipped error-feedback compositions (resolve() builds any other)
for _name in ("fixed_k", "fixed_k_shared", "bernoulli", "binary", "ternary", "rotated_binary"):
    register(ef.EFCodec(get(_name)))


def gather_kind(cfg: t.CompressionConfig) -> str:
    """The base wire format gather_decode mode uses for ``cfg``: one of
    "fixed_k" | "bernoulli" | "binary" | "ternary" | "ternary_opt" | "dense"
    (the reference's rule)."""
    e = cfg.encoder
    if e.kind == "fixed_k":
        return "fixed_k"
    if (e.kind == "bernoulli" and e.probs == "uniform"
            and e.center in ("zero", "mean", "min")):
        return "bernoulli"
    if e.kind == "binary":
        return "binary"
    if e.kind == "ternary" and e.probs == "uniform":
        return "ternary"
    if e.kind == "ternary" and e.probs == "optimal":
        return "ternary_opt"
    return "dense"


def resolve(cfg: t.CompressionConfig) -> base.WireCodec:
    """The codec ``compressed_mean`` executes for ``cfg``.

    Composition order: base codec → §7.2 rotation (``cfg.encoder.rotation``)
    → error feedback (``cfg.error_feedback``).  Raises ValueError for modes
    without a wire codec and for the reference's invalid combinations
    (scatter decode on a codec that cannot shard, a robust policy on a psum
    codec).
    """
    if cfg.mode == "shared_support":
        codec = get("fixed_k_shared")
    elif cfg.mode == "dense_sim":
        codec = get("dense")
    elif cfg.mode == "gather_decode":
        codec = get(gather_kind(cfg))
    else:
        raise ValueError(cfg.mode)
    if cfg.encoder.rotation:
        codec = _CODECS.get("rotated_" + codec.name) or rotated.RotatedCodec(codec)
    if cfg.error_feedback:
        codec = _CODECS.get("ef_" + codec.name) or ef.EFCodec(codec)
    if cfg.scatter_decode and not codec.scatter_supported:
        raise ValueError(
            f"scatter_decode requires a linear gather decode; codec "
            f"{codec.name!r} does not partition coordinate-wise")
    kind, _ = t.parse_decode_policy(cfg.decode_policy)
    if codec.reduce == "psum" and kind != "mean":
        raise ValueError(
            f"decode_policy {cfg.decode_policy!r} needs per-peer wire rows "
            f"(gather reduce); codec {codec.name!r} reduces by psum")
    return codec
