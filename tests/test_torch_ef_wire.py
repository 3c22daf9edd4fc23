"""The port's error feedback on the wire (``core/wire/ef.py``) against the
JAX package's ``repro.core.wire.ef``, op by op, inside
``jax.threefry_partitionable(False)``:

* ``core/bitplane.py::topcap_mask`` — ties at the threshold, cap = 1 and
  cap = d, scores whose bit patterns use bit 30 (≥ 2.0);
* kernel 1's plain unscaled encode against ``ref.encode(scaled=False)``,
  −0.0 entries with μ < 0 (its bytes keep the sign: bf16 0x8000);
* each contractive twin's wire bytes and reconstruction against
  ``ef._twin_pack_recon`` for every inner codec (fixed_k, fixed_k_shared,
  bernoulli, binary, ternary, ternary_opt, dense identity / binary /
  ternary / Eq. (1), rotated_binary, rotated_fixed_k), at the bf16 and the
  f32 wire; the reconstruction equals the port's own ``unpack`` of the
  bytes, signed zeros included;
* T = 3 rounds of the five ``ef_*`` presets and ``fixed_k_1bit`` + EF,
  estimates and residuals, against the reference's per-rank twin round
  simulated without a mesh, both started from the same nonzero residuals
  (``convert.ef_state``);
* ``residual_bound`` as a hypothesis property, and the registry rules.

Sums.  Inputs on a 2⁻⁶ grid make every partial sum exact, so the port's
fixed-order ``tree_sum`` and ``jnp.sum`` agree and everything is bit-equal.
On Gaussian inputs the sums round differently in their last bits: the bf16
wire absorbs that (bytes, recon and trajectories stay bit-equal), the f32
dense twins carry it — held there to 4 f32 ulps of the data's scale
(``DENSE_ATOL``: a center off by a few ulps of a sum moves each value it
sets by as much, and nothing else moves).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings, strategies as st

from repro.configs.registry import compression_preset as jpreset
from repro.core import bitplane as jbitplane
from repro.core import types as jtypes
from repro.core import wire as jwire
from repro.core.wire import ef as jef
from repro.kernels.bernoulli_wire import ref as jbw_ref
from repro_torch import convert
from repro_torch import random as R
from repro_torch.core import bitplane as tbitplane
from repro_torch.core import collectives as tcoll
from repro_torch.core import wire as twire
from repro_torch.core.error_feedback import compressed_mean_ef
from repro_torch.core.wire import ef as tef
from repro_torch.kernels.bernoulli_wire import ref as tbw_ref

# one intra-op thread: beside other test workers on a loaded machine, torch's
# thread pool stalls for tens of seconds
torch.set_num_threads(1)

D = 20_011
KEY_SEED = 99
T = 3
DENSE_ATOL = 4 * 2.0 ** -23 * 8      # 4 ulps at the inputs' scale (|x| < 8)
ROTATED_ATOL = 1e-6


def _cfg(kind, *, mode="gather_decode", center="min", probs="uniform", rotation=False,
         frac=0.125, wire="bfloat16", ef=False, scatter=False):
    return jtypes.CompressionConfig(
        encoder=jtypes.EncoderSpec(kind=kind, fraction=frac, center=center,
                                   rotation=rotation, probs=probs),
        mode=mode, axes=("data",), wire_dtype=wire, min_compress_size=1,
        error_feedback=ef, scatter_decode=scatter)


INNER = {
    "fixed_k": dict(kind="fixed_k", center="mean"),
    "fixed_k_shared": dict(kind="fixed_k", center="mean", mode="shared_support"),
    "bernoulli": dict(kind="bernoulli", center="mean"),
    "binary": dict(kind="binary"),
    "ternary": dict(kind="ternary"),
    "ternary_opt": dict(kind="ternary", probs="optimal"),
    "dense_identity": dict(kind="identity", mode="dense_sim"),
    "dense_binary": dict(kind="binary", mode="dense_sim"),
    "dense_ternary": dict(kind="ternary", mode="dense_sim"),
    "dense_bernoulli": dict(kind="bernoulli", center="mean", mode="dense_sim"),
    "rotated_binary": dict(kind="binary", rotation=True),
    "rotated_fixed_k": dict(kind="fixed_k", center="mean", rotation=True),
}


def _x(d, seed, data):
    """(d,) f32 with −0.0 entries and exact ties: on a 2⁻⁶ grid (every sum
    exact) or Gaussian."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal(d).astype(np.float32) * 0.5 + 0.01
    if data == "grid":
        x = (np.round(x * 64) / 64).astype(np.float32)
    x[::97] = -0.0
    x[5::101] = x[min(3, d - 1)]
    return x


def _bytes(buf):
    if isinstance(buf, torch.Tensor):
        return buf.contiguous().view(torch.uint8).numpy()
    return np.asarray(buf).view(np.uint8)


def _bits(x):
    return np.asarray(x, np.float32).view(np.uint32)


def _jkey(seed=KEY_SEED):
    return jax.random.PRNGKey(seed)


def _tkey(jkey):
    return convert.key_to_torch(jax.random.key_data(jkey))


# ------------------------------------------------------------ topcap_mask

@pytest.mark.parametrize("case", ("random", "ties", "cap1", "capd", "bit30", "zeros"))
def test_topcap_mask_matches_reference(case):
    rng = np.random.default_rng(7)
    d = 4099
    scores = np.abs(rng.standard_normal(d)).astype(np.float32)
    cap = 300
    if case == "ties":          # a run of equal scores straddles the threshold
        scores = np.round(scores * 4) / 4
        cap = int(np.sum(scores > np.sort(scores)[-cap])) + 5
    elif case == "cap1":
        cap = 1
    elif case == "capd":
        cap = d
    elif case == "bit30":       # patterns ≥ 0x40000000: scores ≥ 2.0
        scores = scores * 1e6 + 2.0
        scores[::7] = 3.0e38
    elif case == "zeros":       # +0.0 everywhere but a few
        scores = np.zeros(d, np.float32)
        scores[::400] = 1.0
    got = tbitplane.topcap_mask(torch.from_numpy(scores.astype(np.float32)), cap).numpy()
    want = np.asarray(jbitplane.topcap_mask(jnp.asarray(scores, jnp.float32), cap))
    np.testing.assert_array_equal(got, want)
    assert got.sum() == min(cap, d)


# ------------------------------------------------ kernel 1's unscaled encode

@pytest.mark.parametrize("d,p,cap", [(4099, 1 / 16, None), (20_011, 0.3, None),
                                     (20_011, 1 / 16, 200), (2, 0.5, None)])
def test_unscaled_plain_encode_matches_reference(d, p, cap):
    from repro.core import comm_cost as jcc
    cap = jcc.bernoulli_capacity(d, p) if cap is None else cap
    x = _x(d, d, "gauss")
    x[1::3] = -0.0                           # many −0.0, some surely sent
    mu = np.float32(-0.25)                   # μ < 0: 0·μ would be −0.0
    with jax.threefry_partitionable(False):
        jk = jax.random.fold_in(_jkey(), 3)
        want = np.asarray(jbw_ref.encode(jnp.asarray(x), jk, p, cap, jnp.float32(mu),
                                         scaled=False))
        got = tbw_ref.encode(torch.from_numpy(x), _tkey(jk), p, cap, torch.tensor(mu),
                             scaled=False).numpy()
    np.testing.assert_array_equal(_bits(got), _bits(want))
    assert (_bits(got) == 0x80000000).any() or d < 10
    buf = torch.from_numpy(got).to(torch.bfloat16)
    assert (buf.view(torch.int16) == -32768).any() or d < 10     # bf16 0x8000 shipped


# --------------------------------------------------- twins, bytes and recon

def _twin_pair(name, x, wire, rank=1):
    jcfg = _cfg(**INNER[name], wire=wire)
    tcfg = convert.compression_config(jcfg)
    with jax.threefry_partitionable(False):
        jcodec = jwire.resolve(jcfg)
        jbuf, jrec = jef._twin_pack_recon(jcodec, jnp.asarray(x), _jkey(), rank, jcfg)
        jbuf, jrec = np.asarray(jbuf), np.asarray(jrec)
    tcodec = twire.resolve(tcfg)
    assert tcodec.name == jcodec.name
    tbuf, trec = tef._twin_pack_recon(tcodec, torch.from_numpy(x), R.PRNGKey(KEY_SEED), rank,
                                      tcfg)
    return (jbuf, jrec), (tbuf, trec), tcodec, tcfg


def _check_twin(name, wire, data):
    x = _x(D, 11 if data == "grid" else 12, data)
    (jbuf, jrec), (tbuf, trec), codec, cfg = _twin_pair(name, x, wire)
    if name.startswith("rotated"):
        # the rotated twins center the rotated vector, whose mean is a
        # cancellation near 0 (|z̄| ≈ 1e-9 here): tree_mean and jnp.mean
        # differ there by ≈ 1e-9 absolute, which no wire dtype absorbs.  The
        # bytes decode (by the port's unpack) to values within ROTATED_ATOL.
        raw = torch.from_numpy(np.array(jbuf).view(np.int16 if jbuf.itemsize == 2 else np.int32))
        want = codec.unpack(raw.view(tbuf.dtype), 1, R.PRNGKey(KEY_SEED), cfg, D)
        got = codec.unpack(tbuf, 1, R.PRNGKey(KEY_SEED), cfg, D)
        np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=ROTATED_ATOL)
        np.testing.assert_allclose(trec.numpy(), jrec, rtol=0, atol=ROTATED_ATOL)
    elif name.startswith("dense") and data == "gauss":
        # the f32 dense wire carries the sums' last bits
        np.testing.assert_allclose(tbuf.numpy(), jbuf, rtol=0, atol=DENSE_ATOL)
        np.testing.assert_allclose(trec.numpy(), jrec, rtol=0, atol=DENSE_ATOL)
    else:
        np.testing.assert_array_equal(_bytes(tbuf), _bytes(jbuf))
        np.testing.assert_array_equal(_bits(trec.numpy()), _bits(jrec))


@pytest.mark.parametrize("wire", ("bfloat16", "float32"))
@pytest.mark.parametrize("name", sorted(INNER))
def test_twin_bytes_and_recon_match_reference_on_grid(name, wire):
    _check_twin(name, wire, "grid")


@pytest.mark.parametrize("name", sorted(INNER))
def test_twin_bytes_and_recon_match_reference_gauss(name):
    _check_twin(name, "bfloat16", "gauss")


@pytest.mark.parametrize("wire", ("bfloat16", "float32"))
@pytest.mark.parametrize("name", sorted(INNER))
def test_twin_recon_equals_unpack(name, wire):
    """The fused reconstructions (binary, ternary, rotated) and the unpack
    ones are the inner codec's ``unpack`` of the shipped bytes, bit for
    bit, −0.0 included."""
    x = _x(D, 13, "gauss")
    tcfg = convert.compression_config(_cfg(**INNER[name], wire=wire))
    codec = twire.resolve(tcfg)
    key = R.PRNGKey(KEY_SEED)
    buf, recon = tef._twin_pack_recon(codec, torch.from_numpy(x), key, 2, tcfg)
    assert torch.equal(buf.view(torch.uint8), tef._twin_pack(codec, torch.from_numpy(x), key,
                                                             2, tcfg).view(torch.uint8))
    want = codec.unpack(buf, 2, key, tcfg, D)
    np.testing.assert_array_equal(_bits(recon.numpy()), _bits(want.numpy()))
    assert tef.twin_recon_fused(codec) == (name in ("binary", "ternary", "ternary_opt",
                                                    "rotated_binary"))


def test_bernoulli_unpack_keeps_negative_zero():
    """A sent −0.0 comes back −0.0 (the reference's where), and its residual
    v − recon is +0.0 as in the reference."""
    x = np.full(4096, -0.0, np.float32)
    x[::2] = 0.5
    tcfg = convert.compression_config(_cfg(**INNER["bernoulli"]))
    codec = twire.resolve(tcfg)
    _, recon = tef._twin_pack_recon(codec, torch.from_numpy(x), R.PRNGKey(3), 0, tcfg)
    sent_negzero = (_bits(recon.numpy()) == 0x80000000) & (_bits(x) == 0x80000000)
    assert sent_negzero.any()
    res = (torch.from_numpy(x) - recon).numpy()
    assert (_bits(res)[sent_negzero] == 0).all()


# -------------------------------------------------------------- T rounds

def _preset(name):
    base = name.split("+")[0]
    return dataclasses.replace(jpreset(base, axes=("data",)), min_compress_size=1,
                               error_feedback=True)


# the five ef_* presets and the training default, fixed_k_1bit + EF
PRESETS = {name: _preset(name) for name in ("ef_fixed_k", "ef_bernoulli", "ef_binary",
                                            "ef_ternary", "ef_rotated_binary",
                                            "fixed_k_1bit+ef")}


def reference_ef_round(jcfg, v, e, key):
    """The reference's EF round without a mesh over the (n, d) rows ``v``
    and residuals ``e``, per rank: v + e, the twin's (bytes, recon) by
    ``ef._twin_pack_recon``, e' = v + e − recon; then the rank-order f32
    mean of the buffers rounded once to the wire dtype and
    ``decode_reduced`` (psum), or ``decode_gathered`` of the stacked rows
    (its scatter decode equals it).  Returns (estimate, new residuals)."""
    inner = jwire.resolve(jcfg).inner
    n, d = v.shape
    bufs, new_e = [], []
    for i in range(n):
        vi = jnp.asarray(v[i]) + jnp.asarray(e[i])
        buf, recon = jef._twin_pack_recon(inner, vi, key, i, jcfg)
        bufs.append(buf)
        new_e.append(np.asarray(vi - recon))
    if inner.reduce == "psum":
        acc = jnp.zeros(bufs[0].shape, jnp.float32)
        for b in bufs:
            acc = acc + b.astype(jnp.float32)
        est = inner.decode_reduced((acc / n).astype(bufs[0].dtype), key, jcfg, d)
    else:
        est = inner.decode_gathered(jnp.stack(bufs), key, jcfg, d, n)
    return np.asarray(est), np.stack(new_e)


def reference_ef_rounds(jcfg, xs, e0, seed):
    """T reference rounds from the residuals ``e0``, with keys
    fold_in(PRNGKey(seed), t): the T estimates and residual stacks."""
    e, ests, ress = e0, [], []
    for t in range(xs.shape[0]):
        key = jax.random.fold_in(jax.random.PRNGKey(seed), t)
        est, e = reference_ef_round(jcfg, xs[t], e, key)
        ests.append(est)
        ress.append(e)
    return ests, ress


def _trajectory_inputs(n, d, data):
    rng = np.random.default_rng(n * 7 + 1)
    xs = rng.standard_normal((T, n, d)).astype(np.float32) * 0.5
    xs += (np.arange(n, dtype=np.float32)[None, :, None] - n / 2) / 64
    e0 = rng.standard_normal((n, d)).astype(np.float32) * 0.05
    if data == "grid":
        xs, e0 = np.round(xs * 64) / 64, np.round(e0 * 64) / 64
    xs[:, :, ::89] = -0.0
    return xs.astype(np.float32), e0.astype(np.float32)


@pytest.mark.parametrize("n", (3, 4))
@pytest.mark.parametrize("name", sorted(PRESETS))
def test_ef_trajectory_matches_reference(name, n):
    jcfg = PRESETS[name]
    xs, e0 = _trajectory_inputs(n, D, "gauss")
    with jax.threefry_partitionable(False):
        want_est, want_res = reference_ef_rounds(jcfg, xs, e0, KEY_SEED)
    cfg = convert.compression_config(jcfg)
    assert twire.resolve(cfg).name == jwire.resolve(jcfg).name
    state = convert.ef_state({"bucket": list(e0)})["bucket"]
    assert state.shape == (n, D)
    comm = tcoll.StackedComm(n, "cpu")
    for t in range(T):
        key = R.fold_in(R.PRNGKey(KEY_SEED), t)
        est, new_state = tcoll.compressed_mean_stateful(torch.from_numpy(xs[t]), state, key,
                                                        cfg, comm)
        assert new_state.data_ptr() == state.data_ptr()      # written in place
        np.testing.assert_array_equal(_bits(est.numpy()), _bits(want_est[t]), err_msg=f"t={t}")
        np.testing.assert_array_equal(_bits(state.numpy()), _bits(want_res[t]),
                                      err_msg=f"t={t}")


@pytest.mark.parametrize("name", sorted(PRESETS))
def test_ef_telescopes_and_ships_the_inner_bytes(name):
    """Σ_t est_t = Σ_t x̄_t + ē_0 − ē_T up to f32 rounding, the bytes handed
    to the communicator are the inner codec's accounting, and the stateless
    round is the zero-residual stateful one."""
    n = 4
    cfg = convert.compression_config(PRESETS[name])
    codec = twire.resolve(cfg)
    xs, e0 = _trajectory_inputs(n, D, "gauss")
    state = torch.from_numpy(e0.copy())
    comm = tcoll.StackedComm(n, "cpu")
    est_sum = torch.zeros(D, dtype=torch.float64)
    for t in range(T):
        comm.reset_bytes()
        key = R.fold_in(R.PRNGKey(KEY_SEED), t)
        est, state = compressed_mean_ef(torch.from_numpy(xs[t]), state, key, cfg, comm)
        est_sum += est.double()
        got = comm.bytes_reduced if codec.reduce == "psum" else comm.bytes_gathered
        assert got * 8 == (codec.inner.wire_bits(n, D, cfg)
                           + codec.inner.scatter_bits(n, D, cfg))
    lhs = est_sum
    rhs = (torch.from_numpy(xs).double().mean(1).sum(0) + torch.from_numpy(e0).double().mean(0)
           - state.double().mean(0))
    rel = float(torch.linalg.vector_norm(lhs - rhs) / torch.linalg.vector_norm(rhs))
    # gather codecs: every estimate is the mean of the rows whose
    # reconstructions the residuals subtract, so only f32 rounding remains;
    # a psum codec also rounds the reduced buffer to bf16 once a round (2⁻⁹
    # relative at most), which no residual sees
    assert rel <= (2.0 ** -8 if codec.reduce == "psum" else 1e-6), rel
    print(f"{name}: telescoping rel {rel:.3g}")
    zero = tcoll.compressed_mean_stateful(torch.from_numpy(xs[0]), torch.zeros(n, D),
                                          R.PRNGKey(1), cfg, comm)[0]
    stateless = tcoll.compressed_mean(torch.from_numpy(xs[0]), R.PRNGKey(1), cfg, comm)
    np.testing.assert_array_equal(_bits(stateless.numpy()), _bits(zero.numpy()))


# ------------------------------------------------------- residual bound, registry

EF_CODECS = {
    "ef_fixed_k": _cfg("fixed_k", wire="float32", ef=True),
    "ef_fixed_k_shared": _cfg("fixed_k", mode="shared_support", wire="float32", ef=True),
    "ef_bernoulli": _cfg("bernoulli", center="mean", wire="float32", ef=True),
    "ef_binary": _cfg("binary", wire="float32", ef=True),
    "ef_ternary": _cfg("ternary", wire="float32", ef=True),
    "ef_rotated_binary": _cfg("binary", rotation=True, wire="float32", ef=True),
    "ef_dense": _cfg("bernoulli", center="mean", probs="optimal", wire="float32", ef=True),
}


@pytest.mark.parametrize("name", sorted(EF_CODECS))
def test_residual_bound_property(name):
    cfg = convert.compression_config(EF_CODECS[name])
    codec = twire.resolve(cfg)
    assert codec.name == name and codec.stateful

    @settings(max_examples=10, deadline=None)
    @given(seed=st.integers(0, 2**31 - 1), d=st.integers(33, 1500),
           scale=st.floats(1e-3, 1e3), spike=st.floats(0.0, 50.0))
    def prop(seed, d, scale, spike):
        rng = np.random.default_rng(seed)
        v = torch.from_numpy((rng.standard_normal(d) * scale).astype(np.float32))
        v[0] += spike * scale                       # anisotropy stresses the quantizers
        key = R.PRNGKey(seed)
        recon = codec.unpack(codec.pack(v, key, 0, cfg), 0, key, cfg, d)
        res = float(torch.linalg.vector_norm(v - recon))
        bound = float(codec.residual_bound(v, key, cfg))
        assert res <= bound * (1 + 1e-5) + 1e-5 * scale, (name, d, res, bound)

    prop()


@pytest.mark.parametrize("name", sorted(EF_CODECS))
def test_residual_bound_matches_reference(name):
    jcfg = EF_CODECS[name]
    cfg = convert.compression_config(jcfg)
    x = _x(3001, 5, "gauss")
    with jax.threefry_partitionable(False):
        want = float(jwire.resolve(jcfg).residual_bound(jnp.asarray(x), _jkey(), jcfg))
    got = float(twire.resolve(cfg).residual_bound(torch.from_numpy(x), R.PRNGKey(KEY_SEED),
                                                  cfg))
    assert got == pytest.approx(want, rel=1e-5)


def test_registry_builds_ef_outermost_and_accounts_as_the_inner_codec():
    names = set(twire.names())
    assert {"ef_fixed_k", "ef_fixed_k_shared", "ef_bernoulli", "ef_binary", "ef_ternary",
            "ef_rotated_binary"} <= names
    cfg = convert.compression_config(_cfg("fixed_k", center="mean", rotation=True, ef=True))
    codec = twire.resolve(cfg)
    assert codec.name == "ef_rotated_fixed_k" and codec.inner.name == "rotated_fixed_k"
    assert codec.state_shape(D, cfg) == (D,)
    assert codec.init_state(D, cfg, 3).shape == (3, D)
    for n in (2, 8):
        assert codec.wire_bits(n, D, cfg) == codec.inner.wire_bits(n, D, cfg)
        assert codec.comm_cost_bits(n, D, cfg) == pytest.approx(
            codec.wire_bits(n, D, cfg) + codec.seed_bits(n, cfg), rel=1e-12)
    with pytest.raises(ValueError, match="does not nest"):
        tef.EFCodec(codec)
    with pytest.raises(ValueError, match="does not nest"):
        tef.EFCodec(twire.rotated.RotatedCodec(twire.get("ef_binary")))
    plain = twire.resolve(convert.compression_config(_cfg("binary")))
    assert plain.state_shape(D, cfg) is None and plain.init_state(D, cfg) is None
    # a robust policy (a later slice's, once refused): the over-trimmed n = 2
    # round is NaN everywhere, as the reference's; at n = 3 the twins'
    # estimate equals the reference's decode of its twin rows under trim(1)
    # (the rotated twins' mean center: ROTATED_ATOL)
    rcfg = dataclasses.replace(cfg, decode_policy="trim(1)")
    est, _ = codec.mean_flat_stateful(torch.zeros(2, 8), torch.zeros(2, 8), R.PRNGKey(0),
                                      rcfg, tcoll.StackedComm(2, "cpu"))
    assert est.shape == (8,) and torch.isnan(est).all()
    jcfg = dataclasses.replace(_cfg("fixed_k", center="mean", rotation=True, ef=True),
                               decode_policy="trim(1)")
    xs = np.stack([_x(D, s, "grid") for s in range(3)])
    with jax.threefry_partitionable(False):
        jc = jwire.resolve(jcfg)
        rows = jnp.stack([jc.pack(jnp.asarray(xs[i]), _jkey(), i, jcfg) for i in range(3)])
        want = np.asarray(jc.decode_rows_reduce(rows, _jkey(), jcfg, D, 3))
    est, _ = codec.mean_flat_stateful(torch.from_numpy(xs), torch.zeros(3, D),
                                      R.PRNGKey(KEY_SEED), rcfg, tcoll.StackedComm(3, "cpu"))
    np.testing.assert_allclose(est.numpy(), want, rtol=0, atol=ROTATED_ATOL)


def test_ef_twin_extension_hook():
    """A codec outside ``ef.py`` composes with error feedback by declaring
    its own twin (``ef_twin_pack`` / ``ef_residual_bound``); a codec without
    one fails loudly."""

    class IdentityCodec(twire.WireCodec):
        name = "identity_psum"
        reduce = "psum"

        def pack(self, flat, key, rank, cfg):
            return flat

        def unpack(self, row, peer, key, cfg, d):
            return row

        def decode_reduced(self, w, key, cfg, d):
            return w

        def ef_twin_pack(self, flat, key, rank, cfg):
            return flat                   # lossless: the twin is the message

        def ef_residual_bound(self, flat, key, cfg):
            return torch.zeros(())

    cfg = convert.compression_config(_cfg("identity", mode="dense_sim"))
    efc = tef.EFCodec(IdentityCodec())
    x = torch.arange(8.0).reshape(1, 8) + torch.tensor([[0.0], [1.0]])
    state = torch.ones(2, 8)
    est, state = efc.mean_flat_stateful(x, state, R.PRNGKey(0), cfg, tcoll.StackedComm(2, "cpu"))
    assert torch.equal(est, x.mean(0) + 1) and not state.any()
    assert float(efc.residual_bound(x[0], R.PRNGKey(0), cfg)) == 0.0

    class OpaqueCodec(IdentityCodec):
        name = "opaque"
        ef_twin_pack = None

    with pytest.raises(ValueError, match="no contractive twin"):
        tef.EFCodec(OpaqueCodec()).pack(x[0], R.PRNGKey(0), 0, cfg)


def test_rotation_forwards_state_in_the_rotated_basis():
    """RotatedCodec(EFCodec(binary)) (the order resolve() does not build)
    keeps an (L, padded d) residual in the rotated basis and equals the EF
    round on the rotated stack, unrotated once."""
    from repro_torch.core import rotation
    cfg = convert.compression_config(_cfg("binary", ef=True))
    inner = twire.get("ef_binary")
    codec = twire.rotated.RotatedCodec(inner)
    d, n = 3000, 3
    dp = rotation.padded_dim(d)
    assert codec.stateful and codec.state_shape(d, cfg) == (dp,)
    x = torch.from_numpy(np.stack([_x(d, s, "gauss") for s in range(n)]))
    key = R.PRNGKey(4)
    state = torch.full((n, dp), 0.01)
    want_state = state.clone()
    est, new_state = codec.mean_flat_stateful(x, state, key, cfg, tcoll.StackedComm(n, "cpu"))
    krot = rotation.rotation_key(key)
    zbar, want_state = inner._round_stateful(rotation.rotate(krot, x), want_state, key, cfg,
                                             tcoll.StackedComm(n, "cpu"))
    assert torch.equal(new_state, want_state) and new_state.shape == (n, dp)
    assert torch.equal(est, rotation.unrotate(krot, zbar, d))
