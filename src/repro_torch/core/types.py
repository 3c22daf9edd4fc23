"""Configuration types — the port's own copy of ``repro.core.types``.

Plain frozen dataclasses, copied field for field (names, defaults and
validation) so that a config built on one side converts to the other
(:mod:`repro_torch.convert`).  Kept as a copy because importing the
reference's module pulls in JAX.

Vocabulary (Konečný & Richtárik, 2016): the *encoder* α is the per-node
randomized transform (§3), the *communication protocol* β the bit-level wire
format (§4), and the *decoder* γ the averaging estimate (§2).
"""
from __future__ import annotations

import dataclasses
import re
from typing import Tuple

# Bits for one float on the wire ("r"); bf16 is the default wire dtype.
DEFAULT_R_BITS = 16
# Bits to send one node center mu_i ("r bar").
DEFAULT_RBAR_BITS = 16
# Bits for a random seed identifying a sampled support set ("r bar_s", §4.4).
DEFAULT_RSEED_BITS = 32

ENCODERS = ("identity", "bernoulli", "fixed_k", "binary", "ternary")
CENTERS = ("zero", "mean", "min", "optimal")
PROBS = ("uniform", "optimal")
MODES = ("none", "gather_decode", "shared_support", "dense_sim")

# Decode-side aggregation policies: "mean" is the paper's averaging decoder;
# "trim(f)" / "mean_trim(f)" carry an integer trim count in the string.
DECODE_POLICIES = ("mean", "median", "trim", "mean_trim")
_POLICY_RE = re.compile(r"(trim|mean_trim)\((\d+)\)")


def parse_decode_policy(policy: str) -> Tuple[str, int]:
    """``cfg.decode_policy`` string → ``(kind, f)``.

    ``"trim(0)"`` normalizes to ``("mean", 0)``: a trimmed mean that trims
    nothing is the mean.  ``"mean_trim(0)"`` does not (it is the midpoint).
    """
    m = _POLICY_RE.fullmatch(policy.strip())
    if m:
        kind, f = m.group(1), int(m.group(2))
        if kind == "trim" and f == 0:
            return "mean", 0
        return kind, f
    if policy in ("mean", "median"):
        return policy, 0
    raise ValueError(
        f"unknown decode_policy {policy!r}; want 'mean', 'median', "
        "'trim(f)' or 'mean_trim(f)' with integer f >= 0")


@dataclasses.dataclass(frozen=True)
class EncoderSpec:
    """Parameters of the encoding protocol α (§3).

    kind: ``identity`` | ``bernoulli`` (Eq. (1)) | ``fixed_k`` (Eq. (4)) |
    ``binary`` (Example 4) | ``ternary`` (Eq. (21)).  ``fraction`` is p for
    uniform Bernoulli and k/d for fixed-k.  ``center`` is the μ_i policy,
    ``rotation`` the §7.2 randomized Hadamard pre-rotation.
    """

    kind: str = "fixed_k"
    fraction: float = 1.0 / DEFAULT_R_BITS
    probs: str = "uniform"
    center: str = "mean"
    rotation: bool = False

    def __post_init__(self):
        if self.kind not in ENCODERS:
            raise ValueError(f"unknown encoder kind {self.kind!r}; want one of {ENCODERS}")
        if self.probs not in PROBS:
            raise ValueError(f"unknown probs policy {self.probs!r}")
        if self.center not in CENTERS:
            raise ValueError(f"unknown center policy {self.center!r}")
        if not (0.0 < self.fraction <= 1.0):
            raise ValueError(f"fraction must be in (0, 1], got {self.fraction}")


@dataclasses.dataclass(frozen=True)
class CommSpec:
    """Parameters of the communication protocol β (§4): which bit-cost model
    (``naive`` | ``varying`` | ``sparse`` | ``sparse_seed`` | ``binary`` |
    ``ternary``) and its bit widths."""

    protocol: str = "sparse_seed"
    r_bits: int = DEFAULT_R_BITS
    rbar_bits: int = DEFAULT_RBAR_BITS
    rseed_bits: int = DEFAULT_RSEED_BITS

    def __post_init__(self):
        if self.protocol not in ("naive", "varying", "sparse", "sparse_seed",
                                 "binary", "ternary"):
            raise ValueError(f"unknown communication protocol {self.protocol!r}")


@dataclasses.dataclass(frozen=True)
class BucketSpec:
    """Gradient-bucketing knobs (:mod:`repro_torch.train.bucketing`).

    ``capacity`` is the max f32 elements per bucket; a leaf larger than it
    gets a dedicated oversize bucket.  ``overlap`` selects the overlapped
    issue schedule, which the port does not have yet (post-backward only).
    """

    enabled: bool = True
    capacity: int = 1 << 22
    overlap: bool = True

    def __post_init__(self):
        if self.capacity <= 0:
            raise ValueError(f"bucket capacity must be positive, got {self.capacity}")


@dataclasses.dataclass(frozen=True)
class CompressionConfig:
    """End-to-end configuration for compressed gradient aggregation.

    ``mode``: ``none`` (exact mean), ``gather_decode`` (star protocol:
    all_gather the compressed messages, decode locally), ``shared_support``
    (one fixed-k support for all nodes; the collective is a psum of the
    value buffer) or ``dense_sim``.  ``axes`` are the mesh axes the mean is
    taken over, ``inner_axes`` the exact inner level of the hierarchical
    schedule, ``scatter_decode`` the reduce-scatter decode (§12).
    """

    encoder: EncoderSpec = dataclasses.field(default_factory=EncoderSpec)
    mode: str = "none"
    axes: Tuple[str, ...] = ("data",)
    inner_axes: Tuple[str, ...] = ()
    scatter_decode: bool = False
    error_feedback: bool = False
    decode_policy: str = "mean"
    wire_dtype: str = "bfloat16"
    bucket: BucketSpec = dataclasses.field(default_factory=BucketSpec)
    # Leaves smaller than this many elements are aggregated exactly.
    min_compress_size: int = 65536

    def __post_init__(self):
        if self.mode not in MODES:
            raise ValueError(f"unknown mode {self.mode!r}; want one of {MODES}")
        if self.mode == "shared_support" and self.encoder.kind not in ("fixed_k", "identity"):
            raise ValueError("shared_support mode requires the fixed_k encoder")
        overlap = set(self.inner_axes) & set(self.axes)
        if overlap:
            raise ValueError(
                f"inner_axes and axes must be disjoint; both contain "
                f"{sorted(overlap)}")
        parse_decode_policy(self.decode_policy)  # raises on bad strings


def fixed_k_from_fraction(d: int, fraction: float) -> int:
    """k = |S_i| for the fixed-size-support encoder, from a target fraction."""
    return max(1, min(d, int(round(fraction * d))))
