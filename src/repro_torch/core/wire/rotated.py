"""Composable §7.2 pre-transform: the seeded per-bucket Hadamard rotation —
port of ``repro.core.wire.rotated``.

:class:`RotatedCodec` wraps a registered codec: each rank's bucket vector
is rotated by Q = (1/√c)HD before the inner codec packs it, and the
averaging decode is unrotated once at the end — valid because averaging
commutes with the linear, orthogonal Q, so conditional on the seed the
composed MSE is the inner closed form at the rotated data
(:func:`repro_torch.core.mse.mse_rotated`).

The wire overhead is the seed only: Q comes from ``rotation_key(key)``,
which every rank already holds, so the gathered payload is exactly the
inner codec's buffer at ``rotation.padded_dim(d)``; the analytic §4 cost
adds one r̄_s seed term per node.

The round is :meth:`WireCodec._round` unchanged: it packs through
:meth:`RotatedCodec.pack` (rotate, then the inner pack — the fused kernel
pair for an inner ``binary``) and decodes through :meth:`gather_decode` or
:meth:`decode_reduced` (the inner decode at the padded length, the scatter
decode's shards included, then one unrotate), which is the reference's
rotated ``_round`` op for op.  Under the hierarchical schedule the in-pod
pre-reduce runs once, in :meth:`WireCodec.mean_flat`, before any rotation:
the packs rotate the codec ranks' in-pod means, and the scatter decode
shards the rotated estimate at the padded length over the inner axes (the
reference delegates to its inner ``_round`` for the same effect; here the
pack keeps the fused rotate-and-encode kernels).  Codec state is forwarded
in the rotated basis (:meth:`RotatedCodec._round_stateful`); the production error
feedback wraps the rotation instead (EF∘rotation, :mod:`.ef`), keeping its
residual in model coordinates.  Robust decode policies and drop masks
(:mod:`.robust`) reduce in ROTATED space at the padded length, where the
rotation has spread any coordinate-aligned outlier, and one unrotate maps
the robust estimate back.
"""
from __future__ import annotations

from repro_torch.core import rotation
from repro_torch.core import types as t
from repro_torch.core.wire import base
from repro_torch.kernels.rotated_encode import ops as ro_ops


class RotatedCodec(base.WireCodec):
    """The inner codec applied in the rotated basis z = Qx (§7.2)."""

    def __init__(self, inner: base.WireCodec):
        if isinstance(inner, RotatedCodec):
            raise ValueError("rotation pre-transform does not nest")
        self.inner = inner
        self.name = "rotated_" + inner.name
        self.reduce = inner.reduce
        # the rotated decode partitions iff the inner one does (the unrotate
        # runs on the reassembled estimate, outside the shards)
        self.scatter_supported = inner.scatter_supported
        self.stateful = inner.stateful

    # ---- geometry & accounting: the inner codec at padded_dim(d) ---------- #

    def wire_slots(self, d, cfg):
        return self.inner.wire_slots(rotation.padded_dim(d), cfg)

    def wire_bits(self, n, d, cfg):
        # the gathered payload IS the inner buffer at dp: the rotation ships nothing
        return self.inner.wire_bits(n, rotation.padded_dim(d), cfg)

    def seed_bits(self, n, cfg):
        return self.inner.seed_bits(n, cfg) + float(n * t.DEFAULT_RSEED_BITS)

    def cost_spec(self, d, cfg):
        return self.inner.cost_spec(rotation.padded_dim(d), cfg)

    def scatter_bits(self, n, d, cfg):
        # a scatter decode shards the ROTATED estimate
        return self.inner.scatter_bits(n, rotation.padded_dim(d), cfg)

    def scatter_align(self, cfg):
        return self.inner.scatter_align(cfg)

    def comm_cost_bits(self, n, d, cfg):
        # inner analytic cost at the rotated length + the rotation seed
        return (self.inner.comm_cost_bits(n, rotation.padded_dim(d), cfg)
                + float(n * t.DEFAULT_RSEED_BITS))

    # ---- wire format: rotate before pack, unrotate after decode ----------- #

    def pack(self, flat, key, rank, cfg):
        if self.inner.name == "binary":
            # the fused rotate + encode kernels on the card, the chain below
            # on the CPU (repro_torch.kernels.rotated_encode)
            return ro_ops.pack_binary(flat, key, rank, cfg.wire_dtype)
        z = rotation.rotate(rotation.rotation_key(key), flat)
        return self.inner.pack(z, key, rank, cfg)

    def unpack(self, row, peer, key, cfg, d):
        z = self.inner.unpack(row, peer, key, cfg, rotation.padded_dim(d))
        return rotation.unrotate(rotation.rotation_key(key), z, d)

    def decode_gathered(self, rows, key, cfg, d, n):
        # unrotate once, after the averaging decode (linearity of Q)
        zbar = self.inner.decode_gathered(rows, key, cfg, rotation.padded_dim(d), n)
        return rotation.unrotate(rotation.rotation_key(key), zbar, d)

    def gather_decode(self, bufs, key, cfg, d, comm, drop_mask=None):
        # the scatter decode runs in ROTATED space: the unrotated estimate is
        # not coordinate-partitionable, so shard decode, reassembling
        # all_gather and truncation run inside the inner codec at dp, and the
        # single inverse rotation follows; robust policies and masks ride the
        # same delegation
        zbar = self.inner.gather_decode(bufs, key, cfg, rotation.padded_dim(d), comm,
                                        drop_mask)
        return rotation.unrotate(rotation.rotation_key(key), zbar, d)

    def decode_rows_reduce(self, rows, key, cfg, d, n, drop_mask=None):
        # the collective-free policy decode, in rotated space at dp
        zbar = self.inner.decode_rows_reduce(rows, key, cfg, rotation.padded_dim(d), n,
                                             drop_mask)
        return rotation.unrotate(rotation.rotation_key(key), zbar, d)

    def decode_reduced(self, wire, key, cfg, d):
        zbar = self.inner.decode_reduced(wire, key, cfg, rotation.padded_dim(d))
        return rotation.unrotate(rotation.rotation_key(key), zbar, d)

    # ---- codec state: forwarded in the rotated basis ---------------------- #

    def state_shape(self, d, cfg):
        return self.inner.state_shape(rotation.padded_dim(d), cfg)

    def _round_stateful(self, x, state, key, cfg, comm, drop_mask=None):
        # the state lives in the (per-step reseeded) rotated basis; the inner
        # round at dp shards the ROTATED estimate when scatter decode is on,
        # and one unrotate follows (the reference's rotated._round_stateful)
        d = x.shape[1]
        krot = rotation.rotation_key(key)
        zbar, new_state = self.inner._round_stateful(rotation.rotate(krot, x), state, key,
                                                     cfg, comm, drop_mask)
        return rotation.unrotate(krot, zbar, d), new_state
