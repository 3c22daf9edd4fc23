"""The port's plain Bernoulli wire functions against the JAX package's
``kernels/bernoulli_wire/ref.py``, bit for bit.

Both sides get the same μ (the reference's jnp mean): μ = mean(x) is not
bit-reproducible across frameworks, and this file tests the wire functions,
not the mean.  Decode inputs are arbitrary buffers (no encode), which
reaches every rank/cap combination, cap overflow included.  JAX calls run
inside ``jax.threefry_partitionable(False)``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import comm_cost
from repro.kernels.bernoulli_wire import ref as jref
from repro_torch import random as R
from repro_torch.kernels.bernoulli_wire import ops as tops
from repro_torch.kernels.bernoulli_wire import ref as tref
from repro_torch.kernels.threefry import ref as tf_ref

# one intra-op thread: beside other test workers on a loaded machine, torch's
# thread pool stalls for tens of seconds
torch.set_num_threads(1)


# the reference functions, compiled once per static shape instead of op by op
_encode = jax.jit(jref.encode, static_argnames=("p", "cap"))
_rank_select = jax.jit(jref.rank_select, static_argnums=2)
_sequential = jax.jit(jref.decode_sum_sequential, static_argnums=(3, 4, 5))
_support_shard = jax.jit(jref.support_shard, static_argnums=(1, 2, 4))
_decode_shard = jax.jit(jref.decode_sum_shard, static_argnums=4)


def _bits(a):
    a = np.asarray(a, np.float32)
    return a.view(np.uint32)


def _keys(seed, n):
    """(n, 2) uint32 rank-folded keys from PRNGKey(seed) — numpy, torch."""
    with jax.threefry_partitionable(False):
        ks = np.stack([np.asarray(jax.random.key_data(
            jax.random.fold_in(jax.random.PRNGKey(seed), i))) for i in range(n)])
    return ks, torch.from_numpy(ks.astype(np.int64))


def _case(seed, n, cap):
    rng = np.random.default_rng(seed)
    bufs = (rng.standard_normal((n, cap)) * 0.7).astype(np.float32)
    mus = (rng.standard_normal(n) * 0.1).astype(np.float32)
    return bufs, mus


@pytest.mark.parametrize("d", (1, 33, 1000, 4103, 70001))
@pytest.mark.parametrize("p", (0.0625, 0.5))
def test_encode_bit_exact(d, p):
    x = (np.random.default_rng(d).standard_normal(d) * 0.5 + 0.2).astype(np.float32)
    cap = comm_cost.bernoulli_capacity(d, p)
    jk, tk = _keys(d, 2)
    with jax.threefry_partitionable(False):
        mu = jnp.mean(jnp.asarray(x))
        want = np.asarray(_encode(jnp.asarray(x), jk[1], p=p, cap=cap, mu=mu))
    got = tops.encode(torch.from_numpy(x), tk[1], p, cap, torch.tensor(float(mu)))
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))


def test_encode_cap_overflow_drops():
    d, p, cap = 5000, 0.5, 700
    x = np.random.default_rng(1).standard_normal(d).astype(np.float32)
    jk, tk = _keys(11, 1)
    with jax.threefry_partitionable(False):
        want = np.asarray(_encode(jnp.asarray(x), jk[0], p=p, cap=cap, mu=jnp.float32(0.25)))
    got = tops.encode(torch.from_numpy(x), tk[0], p, cap, 0.25).numpy()
    np.testing.assert_array_equal(_bits(got), _bits(want))
    assert np.count_nonzero(got) == cap          # every slot filled, tail dropped


def test_encode_general_p_within_one_ulp():
    """1/p not a power of two: the reference divides by p, the port (and
    the reference's own kernel) multiplies by the f32 reciprocal — one ulp
    on values at most (the reference's FMA carve-out), slots exact."""
    d, p = 4103, 0.3
    cap = comm_cost.bernoulli_capacity(d, p)
    x = np.random.default_rng(2).standard_normal(d).astype(np.float32)
    jk, tk = _keys(5, 1)
    with jax.threefry_partitionable(False):
        want = np.asarray(_encode(jnp.asarray(x), jk[0], p=p, cap=cap, mu=jnp.float32(0.1)))
    got = tops.encode(torch.from_numpy(x), tk[0], p, cap, 0.1).numpy()
    np.testing.assert_array_equal(got == 0, want == 0)
    sent = (R.uniform(tk[0], d) < np.float32(p)).numpy()
    scaled = np.zeros(cap, np.float32)
    xs = x[sent][:cap] / np.float32(p)
    scaled[:xs.size] = xs
    # the roundings that may differ (the reciprocal, the products, an FMA
    # contraction, the result) add to at most an f32 epsilon of the terms;
    # the difference can cancel, so relative ulps of the result say nothing
    cmu = abs((1.0 - p) / p * 0.1)
    tol = 2.0 ** -23 * (np.abs(scaled) + cmu + np.abs(want))
    assert np.all(np.abs(got - want) <= tol)


def _pair_order_encode(x, key, p, cap, mu):
    """A torch model of the card's encode bookkeeping (``bw_encode`` in
    csrc/bernoulli_wire.cu): one cipher call per pair (j, j + half) with x0
    to j and x1 to j + half, chunks of 1024 taken low then high, 32 mask
    words a chunk, rank = exclusive scan of the chunk counts + the popcount
    prefix of the chunk's words + the set bits below the lane in its word."""
    d = x.shape[0]
    half = (d + 1) // 2
    nl, nh = -(-half // 1024), -(-(d - half) // 1024)
    p32, inv_p, c = tref.coefficients(p)
    k0, k1 = (int(w) & 0xFFFFFFFF for w in key)
    j = torch.arange(nl * 1024, dtype=torch.int64)
    c1 = j + half
    x0, x1 = tf_ref.threefry2x32(k0, k1, j, torch.where(c1 < d, c1, torch.zeros_like(c1)))
    lo = (j < half) & (tf_ref.bits_to_uniform(x0) < p32)
    hi = (j < half) & (c1 < d) & (tf_ref.bits_to_uniform(x1) < p32)
    sent = torch.cat([lo.reshape(nl, 1024), hi.reshape(nl, 1024)[:nh]])
    coord = torch.cat([j.reshape(nl, 1024), c1.reshape(nl, 1024)[:nh]])
    words = tref.pack_bits(sent)                                   # (nl + nh, 32)
    bits = tref.unpack_bits(words).reshape(-1, 32, 32).to(torch.int64)
    per_word = bits.sum(-1)
    counts = per_word.sum(-1)
    offset = torch.cumsum(counts, 0) - counts
    word_prefix = torch.cumsum(per_word, 1) - per_word
    below = torch.cumsum(bits, -1) - bits
    rank = (offset[:, None, None] + word_prefix[..., None] + below).reshape(sent.shape)
    keep = sent & (rank < cap)
    out = torch.zeros(cap, dtype=torch.float32)
    vals = (x[coord[keep]] * torch.tensor(inv_p, dtype=torch.float32)
            - torch.tensor(c, dtype=torch.float32) * torch.tensor(mu, dtype=torch.float32))
    out[rank[keep]] = vals
    return out


@pytest.mark.parametrize("d,cap", [(1, None), (2, None), (2047, None), (2049, None),
                                   (70001, None), (70001, 100), ((1 << 17) + 3, None)])
def test_pair_order_rank_model_equals_encode(d, cap):
    """The card's encode order (pairs, low chunks then high) gives the slots
    of the coordinate-order encode, bit for bit, ragged halves included."""
    p = 1 / 16
    cap = cap or comm_cost.bernoulli_capacity(d, p)
    x = torch.from_numpy((np.random.default_rng(d).standard_normal(d) * 0.5 + 0.1)
                         .astype(np.float32))
    key = R.fold_in(R.PRNGKey(7), 3)
    want = tref.encode(x, key, p, cap, 0.05)
    got = _pair_order_encode(x, key, p, cap, 0.05)
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want.numpy()))


def _pair_order_decode(bufs, mus, keys, p, cap, d):
    """A torch model of the card's flat decode bookkeeping (``bw_decode_sum``
    in csrc/bernoulli_wire.cu): per peer, the encode's pair draws (x0 to j,
    x1 to j + half) in chunks of 1024 taken low then high, 32 mask words a
    chunk; offsets by a scan of the peer's chunk counts in chunk order; rank
    = offset + the popcount prefix of the chunk's words + the set bits below
    the lane in its word; chunk q written back from 1024q (low) or half +
    1024(q − nl) (high), up to half or d; the peers added in ascending order
    from 0 in f32."""
    half = (d + 1) // 2
    nl, nh = -(-half // 1024), -(-(d - half) // 1024)
    p32 = tref.coefficients(p)[0]
    j = torch.arange(nl * 1024, dtype=torch.int64)
    c1 = j + half
    coord = torch.cat([j.reshape(nl, 1024), c1.reshape(nl, 1024)[:nh]])
    real = torch.cat([(j < half).reshape(nl, 1024), (c1 < d).reshape(nl, 1024)[:nh]])
    acc = torch.zeros(coord.shape, dtype=torch.float32)
    for i in range(bufs.shape[0]):
        k0, k1 = (int(w) & 0xFFFFFFFF for w in keys[i])
        x0, x1 = tf_ref.threefry2x32(k0, k1, j, torch.where(c1 < d, c1, torch.zeros_like(c1)))
        lo = (j < half) & (tf_ref.bits_to_uniform(x0) < p32)
        hi = (j < half) & (c1 < d) & (tf_ref.bits_to_uniform(x1) < p32)
        sent = torch.cat([lo.reshape(nl, 1024), hi.reshape(nl, 1024)[:nh]])
        bits = tref.unpack_bits(tref.pack_bits(sent)).reshape(-1, 32, 32).to(torch.int64)
        per_word = bits.sum(-1)
        counts = per_word.sum(-1)
        offset = torch.cumsum(counts, 0) - counts
        word_prefix = torch.cumsum(per_word, 1) - per_word
        below = torch.cumsum(bits, -1) - bits
        rank = (offset[:, None, None] + word_prefix[..., None] + below).reshape(sent.shape)
        valid = sent & (rank < cap)
        vals = bufs[i][rank.clamp(0, max(cap - 1, 0))] if cap else torch.zeros(())
        acc = acc + torch.where(valid, vals, mus[i])
    out = torch.full((d,), float("nan"))
    out[coord[real]] = acc[real]
    return out


@pytest.mark.parametrize("d,n,p,cap", [
    (1, 1, 1 / 16, None), (2, 3, 1 / 16, None), (2047, 8, 0.5, None), (2049, 3, 0.5, None),
    (70001, 8, 1 / 16, None), (70001, 3, 1 / 16, 1000),        # cap overflow
    ((1 << 21) + 3, 8, 1 / 16, None)])
def test_pair_order_decode_model_equals_sequential(d, n, p, cap):
    """The card's flat decode order (pair draws, chunks low then high, a scan
    of chunk counts in chunk order, peers in ascending order) gives the
    sequential decode bit for bit: odd d, a partial last low chunk, a high
    chunk of one coordinate, n = 1, 3, 8 and cap overflow."""
    cap = cap or comm_cost.bernoulli_capacity(d, p)
    bufs, mus = _case(d + 5, n, cap)
    _, tk = _keys(d + 9, n)
    bufs, mus = torch.from_numpy(bufs), torch.from_numpy(mus)
    want = tref.decode_sum_sequential(bufs, mus, tk, p, cap, d)
    got = _pair_order_decode(bufs, mus, tk, p, cap, d)
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want.numpy()))
    if d <= 70001:
        np.testing.assert_array_equal(
            _bits(got.numpy()), _bits(tref.decode_sum(bufs, mus, tk, p, cap, d).numpy()))


@pytest.mark.parametrize("p", (1 / 16, 0.5, 0.3, 0.1, 1.0, float(np.nextafter(np.float32(1), 0)),
                               1e-7, 2.0 ** -30, 3e-39, 0.0))
def test_integer_threshold_equals_uniform_compare(p):
    """The card's count kernels compare u < p on the bits: u = (bits >> 9)
    · 2⁻²³ exactly, so u < p iff bits >> 9 < ⌈p · 2²³⌉
    (``threefry.cuh::uniform_threshold``); every mantissa checked."""
    p32 = np.float32(p)
    thr = min(max(int(np.ceil(np.float64(p32) * 2.0 ** 23)), 0), 1 << 23)
    m = torch.arange(1 << 23, dtype=torch.int64)
    want = tf_ref.bits_to_uniform(m << 9) < torch.tensor(float(p32), dtype=torch.float32)
    assert torch.equal(m < thr, want)


def test_rank_select_matches():
    rng = np.random.default_rng(3)
    vals = rng.standard_normal(3000).astype(np.float32)
    sent = rng.random(3000) < 0.3
    for cap in (1, 500, 900, 3000):
        want = np.asarray(_rank_select(jnp.asarray(vals), jnp.asarray(sent), cap))
        got = tref.rank_select(torch.from_numpy(vals), torch.from_numpy(sent), cap).numpy()
        np.testing.assert_array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("d,n", [(33, 2), (4103, 8), (20000, 3)])
@pytest.mark.parametrize("p", (0.0625, 0.5))
def test_decode_sum_equals_sequential_oracle(d, n, p):
    cap = max(1, int(d * p * 1.1))
    bufs, mus = _case(d + n, n, cap)
    jk, tk = _keys(d + 7, n)
    with jax.threefry_partitionable(False):
        want = np.asarray(_sequential(
            jnp.asarray(bufs), jnp.asarray(mus), jnp.asarray(jk), p, cap, d))
    got = tops.decode_sum(torch.from_numpy(bufs), torch.from_numpy(mus), tk, p, cap, d)
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(want))
    seq = tref.decode_sum_sequential(torch.from_numpy(bufs), torch.from_numpy(mus),
                                     tk, p, cap, d)
    np.testing.assert_array_equal(_bits(seq.numpy()), _bits(want))


def _jax_stitch(bufs, mus, jk, p, cap, d, nshards):
    """The reference's §12 decomposition: support_shard per shard, counts,
    exclusive-cumsum priors, decode_sum_shard, concatenate."""
    ds = -(-d // nshards)
    with jax.threefry_partitionable(False):
        sent = [_support_shard(jnp.asarray(jk), p, d, jnp.int32(s * ds), ds)
                for s in range(nshards)]
        counts = jnp.stack([jnp.sum(s.astype(jnp.int32), axis=1) for s in sent])
        prior = jnp.cumsum(counts, axis=0) - counts
        parts = [_decode_shard(jnp.asarray(bufs), jnp.asarray(mus), sent[s], prior[s], cap)
                 for s in range(nshards)]
        return np.asarray(jnp.concatenate(parts)[:d]), [np.asarray(s) for s in sent]


def _torch_stitch(bufs, mus, tk, p, cap, d, nshards):
    ds = -(-d // nshards)
    sups = [tops.support_counts(tk, p, d, s * ds, ds, "cpu") for s in range(nshards)]
    counts = torch.stack([s.counts.sum(1, dtype=torch.int32) for s in sups])
    prior = torch.cumsum(counts, 0, dtype=torch.int32) - counts
    parts = [tops.decode_sum_shard(torch.from_numpy(bufs), torch.from_numpy(mus),
                                   sups[s], prior[s], cap=cap) for s in range(nshards)]
    return torch.cat(parts)[:d].numpy(), sups


@pytest.mark.parametrize("d,n,nshards,p,cap", [
    (4103, 4, 4, 0.0625, None),
    (20000, 8, 8, 0.0625, None),
    (1000, 2, 3, 0.5, None),
    # cap overflow inside shard 2 of 4: ~2500 sends per peer, cap 1500
    (5000, 4, 4, 0.5, 1500),
])
def test_shard_stitch_bit_exact(d, n, nshards, p, cap):
    cap = cap or comm_cost.bernoulli_capacity(d, p)
    bufs, mus = _case(d * 3 + n, n, cap)
    jk, tk = _keys(d + 1, n)
    want, jsent = _jax_stitch(bufs, mus, jk, p, cap, d, nshards)
    got, sups = _torch_stitch(bufs, mus, tk, p, cap, d, nshards)
    np.testing.assert_array_equal(_bits(got), _bits(want))
    with jax.threefry_partitionable(False):
        seq = np.asarray(_sequential(
            jnp.asarray(bufs), jnp.asarray(mus), jnp.asarray(jk), p, cap, d))
    np.testing.assert_array_equal(_bits(got), _bits(seq))
    for s, sup in enumerate(sups):
        sent = tref.unpack_bits(sup.mask)[:, :sup.ds].numpy()
        np.testing.assert_array_equal(sent, jsent[s])
        np.testing.assert_array_equal(sup.counts.sum(1).numpy(), jsent[s].sum(1))


def test_pack_unpack_roundtrip():
    sent = torch.from_numpy(np.random.default_rng(4).random((3, 64 * 32)) < 0.4)
    words = tref.pack_bits(sent)
    assert words.dtype == torch.int32 and words.shape == (3, 64)
    assert torch.equal(tref.unpack_bits(words), sent)
    assert int(tref.pack_bits(torch.ones(1, 32, dtype=torch.bool))[0, 0]) == -1


def test_support_shard_matches_reference():
    jk, tk = _keys(17, 3)
    for start, ds in ((0, 700), (650, 700), (1300, 700)):
        with jax.threefry_partitionable(False):
            want = np.asarray(_support_shard(jnp.asarray(jk), 0.25, 1999, jnp.int32(start), ds))
        got = tref.support_shard(tk, 0.25, 1999, start, ds).numpy()
        np.testing.assert_array_equal(got, want)


def test_keys_are_rank_folded():
    _, tk = _keys(23, 3)
    for i in range(3):
        assert torch.equal(tk[i], R.fold_in(R.PRNGKey(23), i))
