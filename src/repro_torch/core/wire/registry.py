"""The wire-codec registry — port of ``repro.core.wire.registry``.

Every consumer of "what does this config put on the wire" (the collective,
the bit accounting, the bucket plan) resolves a codec here.  ``gather_kind``
is the reference's rule verbatim.  The port has every base codec:
``fixed_k``, ``fixed_k_shared``, ``bernoulli``, ``binary``, ``ternary``,
``ternary_opt`` and ``dense``, and the §7.2 rotation wrapper
(:class:`~.rotated.RotatedCodec`, registered as ``rotated_binary`` and
``rotated_fixed_k``, built on the fly around any other codec); a config
that asks for error feedback raises :class:`~.base.NotPortedError` naming
the slice that brings it.  It never falls back to another codec.
"""
from __future__ import annotations

from typing import Dict, List

from repro_torch.core import types as t
from repro_torch.core.wire import base, codecs, rotated

_CODECS: Dict[str, base.WireCodec] = {}

# the work of ROADMAP.md queue 1 that brings each codec not ported yet
PENDING = {
    "error_feedback": "the error-feedback slice",
}


def register(codec: base.WireCodec) -> base.WireCodec:
    """Register a codec instance under its ``name`` (last write wins)."""
    _CODECS[codec.name] = codec
    return codec


def _pending(name: str) -> base.NotPortedError:
    return base.NotPortedError(
        f"wire codec {name!r} is not ported yet: it arrives with "
        f"{PENDING[name]} (ROADMAP.md, queue 1)")


def get(name: str) -> base.WireCodec:
    if name in PENDING:
        raise _pending(name)
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
    → error feedback (not ported).  Raises NotPortedError for wrappers the
    port does not have, ValueError for modes without a wire codec and for
    the reference's invalid combinations (scatter decode on a codec that
    cannot shard, a robust policy on a psum codec).
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
        raise _pending("error_feedback")
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
