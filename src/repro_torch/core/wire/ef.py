"""Error feedback as a composable wire layer — port of ``repro.core.wire.ef``.

:class:`EFCodec` wraps any registered codec the way
:class:`~repro_torch.core.wire.rotated.RotatedCodec` wraps the §7.2
rotation.  For each local rank i of the round:

    v_i   = x_i + e_i                       (residual-corrected input)
    wire  = twin_pack(v_i)                  (the inner codec's EXACT format)
    est   = inner.decode(collective(wire))  (= mean_i m_i over the ranks)
    e_i'  = v_i − inner.unpack(own wire)    (local; never transmitted)

so the estimates telescope, Σ_t est_t = Σ_t x̄_t + ē_0 − ē_T, and the wire
payload is byte for byte the un-wrapped codec's.

Every inner codec gets a *contractive twin*: a message in the same wire
format (same buffer layout and slots, decoded by the inner codec's own
``unpack``) whose values are damped, because the unbiased encoders are
expansions at aggressive budgets and diverge under error feedback:

* ``fixed_k`` / ``fixed_k_shared`` / ``bernoulli`` — the scale-1
  sparsifier: raw values on the sampled support, μ elsewhere (kernel 4 at
  scale 1; kernel 1's unscaled encode);
* ``binary`` — Seide et al.'s 1-bit compressor: threshold at mean(v), the
  two cluster means in the tail slots;
* ``ternary`` / ``ternary_opt`` — the ``cap`` largest |v − v̄| pass through
  exactly, the rest 2-means like binary;
* ``dense`` — the same rules applied densely, by encoder kind;
* ``rotated_*`` — rotate, then the twin of the rotated codec's inner; the
  residual stays in model space (EF∘rotation, built by ``registry.resolve``).

The residual absorbs all local reconstruction error (wire-dtype rounding and
capacity drops included), being v minus the reconstruction of the bytes
shipped: bit for bit the inner ``unpack`` of them (:func:`twin_recon`; for
the plane codecs it comes from the twin's own mask and centers through
:func:`_wire_round`, and the rotated recursion unrotates once).

Sums.  The 2-means' three sums, the ternary twin's mean and every center μ
are the port's fixed-order :func:`~.base.tree_sum` / :func:`~.base.tree_mean`,
divided by 0-dim f32 tensors on the data's device, and the cluster counts are
exact integers rounded once to f32; so a round's estimate and residuals are
the same bits on the CPU and on the card.  The reference's ``jnp.sum`` adds
in another order and differs from these sums in its last bits (its counts
agree below 2²⁴); the bf16 wire absorbs that on the golden input, as it does
for μ, and the f32 dense twins carry it (tests/test_torch_ef_wire.py states
the tolerance).

State layout: the port's stacked one, an (L, d) residual beside ``x``'s
(L, d) rows.  A round writes each rank's new residual into its own row of
the state (``state[i] = v − recon``) and returns that same tensor: no
second (n, d) stack is made.  Under the hierarchical schedule the round
receives the inner-reduced vector (one row per codec rank), so the residual
tracks the cross-host message, the only lossy step; the state keeps one row
per local rank, and :meth:`~.base.WireCodec.mean_flat_stateful` reads and
writes it so that the rows of one inner group stay bit-equal (the stacked
communicator updates one row per codec rank and copies it over the group).

Accounting delegates verbatim (wire_slots / wire_bits / seed_bits /
cost_spec / scatter_bits), so ``comm_cost_bits == wire_bits + seed_bits``
holds for every wrapped codec.
"""
from __future__ import annotations

import torch

from repro_torch import random as prandom
from repro_torch.core import bitplane
from repro_torch.core import encoders
from repro_torch.core import rotation
from repro_torch.core.wire import base, codecs, rotated

_F32 = torch.float32


# --------------------------------------------------------------------------- #
# Contractive twin messages, one per inner wire format.  Every helper emits
# a buffer in the inner codec's exact layout; the inner ``unpack`` decodes it.
# --------------------------------------------------------------------------- #

def _count(mask):
    """|mask| as an f32 0-dim tensor: the exact count, rounded once."""
    return torch.count_nonzero(mask).to(_F32)


def _two_means(v, select=None):
    """One deterministic 2-means step: threshold at the (selected) mean.

    Returns (c_lo, c_hi, hi_mask).  ``select`` restricts the clustering to
    a subset (the ternary twin's non-pass coordinates); excluded coordinates
    get an arbitrary side of the threshold and are overwritten by the
    caller.  Cluster means minimize the within-cluster SS, so
    ‖v − m‖ ≤ ‖v − v̄1‖ on ``select``.
    """
    one = torch.ones((), dtype=_F32, device=v.device)
    if select is None:
        cnt = torch.maximum(torch.full((), float(v.numel()), dtype=_F32, device=v.device), one)
        thr = base.tree_sum(v) / cnt
        hi = v >= thr
        lo = ~hi
    else:
        cnt = torch.maximum(_count(select), one)
        thr = base.tree_sum(torch.where(select, v, 0.0)) / cnt
        hi_all = v >= thr
        hi = select & hi_all
        lo = select & ~hi_all
    n_hi, n_lo = _count(hi), _count(lo)
    c_hi = torch.where(n_hi > 0, base.tree_sum(torch.where(hi, v, 0.0))
                       / torch.maximum(n_hi, one), thr)
    c_lo = torch.where(n_lo > 0, base.tree_sum(torch.where(lo, v, 0.0))
                       / torch.maximum(n_lo, one), thr)
    return c_lo, c_hi, (hi if select is None else hi_all)


def _fixed_k_twin(flat, key, rank, cfg, shared: bool):
    """Scale-1 fixed-k: [v − μ on support ‖ μ] — unpack gives v / μ."""
    kids = key if shared else prandom.fold_in(key, rank)
    return codecs.fixed_k_pack(flat, kids, cfg, scale=1.0)


def _bernoulli_twin(flat, key, rank, cfg):
    """Scale-1 Bernoulli: raw values at their support-rank slots + μ tail."""
    return codecs.bernoulli_buffer(flat, key, rank, cfg, scaled=False)


def _wire_round(x, wire_dtype):
    """The value a float takes after the floats_to_words → words_to_floats
    wire round trip: itself at r = 32, rounded through the wire dtype at
    r = 16."""
    x = x.to(_F32)
    if bitplane.wire_bits(wire_dtype) == 32:
        return x
    return x.to(bitplane.torch_dtype(wire_dtype)).to(_F32)


def _binary_twin(flat, cfg):
    """Seide 1-bit: mean-threshold plane + the two cluster means as tail.
    Returns (buf, recon), recon bit for bit ``binary_unpack(buf)``."""
    c_lo, c_hi, hi = _two_means(flat)
    buf = bitplane.binary_words(hi, c_lo, c_hi, cfg.wire_dtype)
    recon = torch.where(hi, _wire_round(c_hi, cfg.wire_dtype),
                        _wire_round(c_lo, cfg.wire_dtype))
    return buf, recon


def _ternary_twin(flat, cap, cfg):
    """Deterministic ternary: the top-cap |v − v̄| pass through exactly, the
    rest 2-means; the value segment is filled to capacity, never overflows.
    Returns (buf, recon), recon bit for bit ``ternary_unpack(buf)``."""
    d = flat.shape[0]
    cap = min(cap, d)
    passm = bitplane.topcap_mask(torch.abs(flat - base.tree_mean(flat)), cap)
    c_lo, c_hi, hi = _two_means(flat, select=~passm)
    sym = hi.to(torch.uint8).masked_fill_(passm, 2)
    vbuf = bitplane.rank_scatter(flat, passm, cap)
    wd = cfg.wire_dtype
    buf = bitplane.ternary_words(sym, vbuf, c_lo, c_hi, wd)
    recon = torch.where(passm, _wire_round(flat, wd),
                        torch.where(hi, _wire_round(c_hi, wd), _wire_round(c_lo, wd)))
    return buf, recon


def _dense_twin(flat, key, rank, cfg):
    """Dense contractive message, dispatched on the encoder kind."""
    kind = cfg.encoder.kind
    if kind == "identity":
        return flat.to(_F32)
    if kind == "binary":
        c_lo, c_hi, hi = _two_means(flat)
        return torch.where(hi, c_hi, c_lo).to(_F32)
    if kind == "ternary":
        d = flat.shape[0]
        k = max(1, min(d, int(round(float(cfg.encoder.fraction) * d))))
        # the set top_k(|v − v̄|, k) picks (ties to the lowest index)
        passm = bitplane.topcap_mask(torch.abs(flat - base.tree_mean(flat)), k)
        c_lo, c_hi, hi = _two_means(flat, select=~passm)
        return torch.where(passm, flat, torch.where(hi, c_hi, c_lo)).to(_F32)
    # Eq. (1) family (bernoulli / fixed_k, any probs policy): raw values on
    # the sampled support, the center elsewhere (the wire's μ for the
    # zero / mean / min policies, the same bits on every device)
    enc = encoders.encode(prandom.fold_in(key, rank), flat, cfg.encoder,
                          mu=_wire_center(flat, cfg))
    return torch.where(enc.support, flat, enc.mu).to(_F32)


def _wire_center(flat, cfg):
    """μ as :func:`base.center` gives it where the policy has a wire form,
    else None (the encoder computes its §6 center)."""
    if cfg.encoder.center in ("zero", "mean", "min"):
        return base.center(flat, cfg.encoder.center)
    return None


def _twin_pack(codec, flat, key, rank, cfg):
    """The contractive message for ``codec``, in its exact wire format.

    A codec may define ``ef_twin_pack(flat, key, rank, cfg)`` (and
    ``ef_residual_bound``) to declare its own twin; that hook is checked
    first.
    """
    hook = getattr(codec, "ef_twin_pack", None)
    if hook is not None:
        return hook(flat, key, rank, cfg)
    if isinstance(codec, rotated.RotatedCodec):
        z = rotation.rotate(rotation.rotation_key(key), flat)
        return _twin_pack(codec.inner, z, key, rank, cfg)
    if isinstance(codec, codecs.FixedKGatherCodec):
        return _fixed_k_twin(flat, key, rank, cfg, shared=False)
    if isinstance(codec, codecs.FixedKSharedCodec):
        return _fixed_k_twin(flat, key, rank, cfg, shared=True)
    if isinstance(codec, codecs.BernoulliCodec):
        return _bernoulli_twin(flat, key, rank, cfg)
    if isinstance(codec, codecs.TernaryCodec):  # incl. TernaryOptCodec
        return _ternary_twin(flat, codec._cap(flat.shape[0], cfg), cfg)[0]
    if isinstance(codec, codecs.BinaryCodec):
        return _binary_twin(flat, cfg)[0]
    if isinstance(codec, codecs.DenseSimCodec):
        return _dense_twin(flat, key, rank, cfg)
    raise ValueError(
        f"error feedback has no contractive twin for codec {codec.name!r}; "
        "define ef_twin_pack/ef_residual_bound on the codec or leave "
        "error_feedback off for it")


def _twin_pack_recon(codec, flat, key, rank, cfg):
    """(wire buffer, local reconstruction) of the contractive twin; the
    reconstruction is bit for bit ``codec.unpack(buf, rank, key, cfg, d)``.

    The plane codecs derive it from the twin's own mask and centers, the
    rotated wrapper recurses in rotated space with one inverse FWHT at the
    end, and every other codec packs, then unpacks.
    """
    hook = getattr(codec, "ef_twin_pack", None)
    if hook is not None:
        buf = hook(flat, key, rank, cfg)
        return buf, codec.unpack(buf, rank, key, cfg, flat.shape[0])
    if isinstance(codec, rotated.RotatedCodec):
        krot = rotation.rotation_key(key)
        z = rotation.rotate(krot, flat)
        buf, rz = _twin_pack_recon(codec.inner, z, key, rank, cfg)
        return buf, rotation.unrotate(krot, rz, flat.shape[0])
    if isinstance(codec, codecs.TernaryCodec):  # incl. TernaryOptCodec
        return _ternary_twin(flat, codec._cap(flat.shape[0], cfg), cfg)
    if isinstance(codec, codecs.BinaryCodec):
        return _binary_twin(flat, cfg)
    buf = _twin_pack(codec, flat, key, rank, cfg)
    return buf, codec.unpack(buf, rank, key, cfg, flat.shape[0])


def twin_recon_fused(codec) -> bool:
    """True iff the twin of inner ``codec`` derives its reconstruction from
    encode-side intermediates (no plane unpack round trip)."""
    if isinstance(codec, rotated.RotatedCodec):
        return twin_recon_fused(codec.inner)
    return isinstance(codec, (codecs.BinaryCodec, codecs.TernaryCodec))


def twin_recon(codec, flat, key, rank, cfg):
    """The residual's reconstruction m(v) for inner ``codec``: bit for bit
    ``codec.unpack`` of the shipped twin buffer, collective-free."""
    return _twin_pack_recon(codec, flat, key, rank, cfg)[1]


def _twin_bound(codec, flat, key, cfg):
    """Deterministic bound on ‖v − m(v)‖ for the twin message of ``codec``
    (f32 wire)."""
    hook = getattr(codec, "ef_residual_bound", None)
    if hook is not None:
        return hook(flat, key, cfg)
    if isinstance(codec, rotated.RotatedCodec):
        z = rotation.rotate(rotation.rotation_key(key), flat)
        return _twin_bound(codec.inner, z, key, cfg)
    if isinstance(codec, (codecs.FixedKGatherCodec, codecs.FixedKSharedCodec,
                          codecs.BernoulliCodec)):
        mu = base.center(flat, cfg.encoder.center)
        return torch.linalg.vector_norm(flat - mu)
    if isinstance(codec, codecs.DenseSimCodec) and cfg.encoder.kind in ("bernoulli", "fixed_k"):
        enc = encoders.encode(prandom.fold_in(key, 0), flat, cfg.encoder,
                              mu=_wire_center(flat, cfg))
        return torch.linalg.vector_norm(flat - enc.mu)
    if isinstance(codec, codecs.DenseSimCodec) and cfg.encoder.kind == "identity":
        return torch.zeros((), dtype=_F32, device=flat.device)
    # binary / ternary twins: within-cluster SS ≤ SS around the mean
    return torch.linalg.vector_norm(flat - base.tree_mean(flat))


# --------------------------------------------------------------------------- #
# The wrapper codec.
# --------------------------------------------------------------------------- #

class EFCodec(base.WireCodec):
    """Error feedback composed over any inner codec (residual state local)."""

    stateful = True

    def __init__(self, inner: base.WireCodec):
        if inner.stateful:
            raise ValueError(f"error feedback does not nest over a stateful codec ({inner.name})")
        self.inner = inner
        self.name = "ef_" + inner.name
        self.reduce = inner.reduce
        self.scatter_supported = inner.scatter_supported

    # ---- geometry & accounting: delegated verbatim ------------------------ #

    def wire_slots(self, d, cfg):
        return self.inner.wire_slots(d, cfg)

    def wire_bits(self, n, d, cfg):
        return self.inner.wire_bits(n, d, cfg)

    def seed_bits(self, n, cfg):
        return self.inner.seed_bits(n, cfg)

    def cost_spec(self, d, cfg):
        return self.inner.cost_spec(d, cfg)

    def comm_cost_bits(self, n, d, cfg):
        return self.inner.comm_cost_bits(n, d, cfg)

    def scatter_bits(self, n, d, cfg):
        return self.inner.scatter_bits(n, d, cfg)

    def scatter_align(self, cfg):
        return self.inner.scatter_align(cfg)

    # ---- wire format: twin pack, inner decode ----------------------------- #

    def pack(self, flat, key, rank, cfg):
        """The contractive twin of the inner codec's message for ``flat``
        (the residual-corrected v; the residual is added in the round)."""
        return _twin_pack(self.inner, flat, key, rank, cfg)

    def unpack(self, row, peer, key, cfg, d):
        return self.inner.unpack(row, peer, key, cfg, d)

    def decode_gathered(self, rows, key, cfg, d, n):
        return self.inner.decode_gathered(rows, key, cfg, d, n)

    def decode_gathered_shard(self, rows, key, cfg, d, n, shard, nshards):
        return self.inner.decode_gathered_shard(rows, key, cfg, d, n, shard, nshards)

    def decode_reduced(self, wire, key, cfg, d):
        return self.inner.decode_reduced(wire, key, cfg, d)

    def gather_decode(self, bufs, key, cfg, d, comm, drop_mask=None):
        # whole delegation: a rotated inner owns its scatter decomposition
        # (shards in rotated space at the padded length).  Robust policies
        # and masks delegate the same way; a dropped rank's residual stays
        # local and re-enters through its own later messages.
        return self.inner.gather_decode(bufs, key, cfg, d, comm, drop_mask)

    def decode_rows_reduce(self, rows, key, cfg, d, n, drop_mask=None):
        return self.inner.decode_rows_reduce(rows, key, cfg, d, n, drop_mask)

    # ---- the stateful round ----------------------------------------------- #

    def state_shape(self, d, cfg):
        return (d,)

    def residual_bound(self, flat, key, cfg):
        """Deterministic bound on one zero-residual step's new residual:
        ‖flat − m(flat)‖ ≤ the inner twin's worst-case per-step error (f32
        wire; a narrower wire adds its rounding)."""
        return _twin_bound(self.inner, flat, key, cfg)

    def _round_stateful(self, x, state, key, cfg, comm, drop_mask=None):
        """One EF round over the (L, d) stack ``x`` and its (L, d) residual
        ``state``: (estimate, state), each row of ``state`` overwritten in
        place by that rank's new residual.  ``state=None`` is the zero
        residual (v = x + 0, as the reference adds its zeros), with nothing
        written back.  ``drop_mask`` reaches the decode (the masked psum of
        a psum inner); every rank's residual is written, dropped or not."""
        ranks, _ = base.axis_rank_size(comm, cfg.axes)
        bufs = []
        for i, r in enumerate(ranks):
            v = x[i] + (state[i] if state is not None else 0.0)
            buf, recon = _twin_pack_recon(self.inner, v, key, r, cfg)
            if state is not None:
                torch.sub(v, recon, out=state[i])
            bufs.append(buf)
            del v, recon
        return (self._reduce_decode(torch.stack(bufs), key, cfg, x.shape[1], comm, drop_mask),
                state)

    def _round(self, x, key, cfg, comm, drop_mask=None):
        """Stateless round: zero residual, nothing kept; for payload and
        accounting measurements of ``compressed_mean``.  Training threads
        real residuals through ``compressed_mean_stateful``."""
        return self._round_stateful(x, None, key, cfg, comm, drop_mask)[0]
