"""The port's Threefry stream and jax.random calls against the JAX package.

Every JAX call runs inside ``jax.threefry_partitionable(False)``: the
reference's ``kernels/threefry/ref.py`` and the golden wire bytes pin JAX's
non-partitionable layout, which is not the default of recent JAX releases.
Checks are exact uint32 / float32 bit equality, except the Gumbel values
(``log`` differs by an ulp between XLA and PyTorch; the order of the values,
which is all the fixed-k block sampling reads, is exact).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.threefry import ref as jref
from repro_torch import random as R
from repro_torch.kernels.threefry import ref as tref

# one intra-op thread: beside other test workers on a loaded machine, torch's
# thread pool stalls for tens of seconds
torch.set_num_threads(1)

SEEDS = (0, 1, 7, 123456789, 2**31 - 1)
LENGTHS = (1, 2, 3, 31, 32, 33, 255, 256, 1000, 1001, 4096, 5000)

# the reference functions, compiled once per length instead of op by op
_ref_bits = jax.jit(jref.random_bits, static_argnums=1)
_ref_uniform = jax.jit(jref.uniform, static_argnums=1)
_ref_uniform_at = jax.jit(jref.uniform_at, static_argnums=2)


def _jkey(seed):
    return jax.random.PRNGKey(seed)


def _u32(t):
    return t.numpy().astype(np.uint32)


@pytest.mark.parametrize("seed", SEEDS)
def test_prng_key_matches(seed):
    with jax.threefry_partitionable(False):
        want = np.asarray(jax.random.key_data(_jkey(seed)))
    np.testing.assert_array_equal(_u32(R.PRNGKey(seed)), want)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("d", LENGTHS)
def test_random_bits_and_uniform_bit_exact(seed, d):
    raw = np.asarray(jax.random.key_data(_jkey(seed)))
    want_bits = np.asarray(_ref_bits(raw, d))
    got_bits = _u32(tref.random_bits(R.PRNGKey(seed), d))
    np.testing.assert_array_equal(got_bits, want_bits)
    want_u = np.asarray(_ref_uniform(raw, d))
    got_u = R.uniform(R.PRNGKey(seed), d).numpy()
    assert got_u.dtype == np.float32
    np.testing.assert_array_equal(got_u.view(np.uint32), want_u.view(np.uint32))


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("d", (1, 33, 1001, 5000))
def test_uniform_equals_jax_random_non_partitionable(seed, d):
    with jax.threefry_partitionable(False):
        want = np.asarray(jax.random.uniform(_jkey(seed), (d,), jnp.float32))
    got = R.uniform(R.PRNGKey(seed), d).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("chunk", (1, 3, 4))
@pytest.mark.parametrize("d", (1, 2, 5, 6, 7, 8, 33, 1001))
def test_uniform_in_chunks_equals_jax_random(d, chunk, monkeypatch):
    """The chunked draw at chunk boundaries of every kind (the last chunk's
    high lanes partly real, the odd-d pad inside a chunk) equals JAX's."""
    monkeypatch.setattr(tref, "UNIFORM_CHUNK", chunk)
    with jax.threefry_partitionable(False):
        want = np.asarray(jax.random.uniform(_jkey(3), (d,), jnp.float32))
    got = R.uniform(R.PRNGKey(3), d).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))


def test_threefry2x32_words():
    rng = np.random.default_rng(0)
    k0, k1 = (int(v) for v in rng.integers(0, 2**32, 2, dtype=np.uint64))
    x0 = rng.integers(0, 2**32, 257, dtype=np.uint64).astype(np.uint32)
    x1 = rng.integers(0, 2**32, 257, dtype=np.uint64).astype(np.uint32)
    w0, w1 = jref.threefry2x32(np.uint32(k0), np.uint32(k1), x0, x1)
    g0, g1 = tref.threefry2x32(k0, k1, torch.from_numpy(x0.astype(np.int64)),
                               torch.from_numpy(x1.astype(np.int64)))
    np.testing.assert_array_equal(_u32(g0), np.asarray(w0))
    np.testing.assert_array_equal(_u32(g1), np.asarray(w1))


@pytest.mark.parametrize("seed", (0, 42, 2**31 - 1))
@pytest.mark.parametrize("data", (0, 1, 5, 12345, 2**32 - 1))
def test_fold_in_matches(seed, data):
    with jax.threefry_partitionable(False):
        want = np.asarray(jax.random.key_data(
            jax.random.fold_in(_jkey(seed), np.uint32(data))))
    np.testing.assert_array_equal(_u32(R.fold_in(R.PRNGKey(seed), data)), want)


@pytest.mark.parametrize("seed", SEEDS[:3])
@pytest.mark.parametrize("d", (1, 31, 32, 33, 1000, 4099))
def test_uniform_at_random_access_bit_exact(seed, d):
    raw = np.asarray(jax.random.key_data(_jkey(seed)))
    idx = np.random.default_rng(seed).permutation(d).astype(np.int64)
    want = np.asarray(_ref_uniform_at(raw, idx.astype(np.int32), d))
    got = tref.uniform_at(R.PRNGKey(seed), torch.from_numpy(idx), d).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    full = R.uniform(R.PRNGKey(seed), d).numpy()
    np.testing.assert_array_equal(got.view(np.uint32), full[idx].view(np.uint32))


def test_uniform_at_stacked_keys():
    keys = torch.stack([R.fold_in(R.PRNGKey(3), i) for i in range(4)])
    idx = torch.arange(0, 777, 3)
    got = tref.uniform_at(keys, idx, 777)
    for i in range(4):
        want = R.uniform(keys[i], 777)[idx]
        assert torch.equal(got[i].view(torch.int32), want.view(torch.int32))


def test_bits_to_uniform_edge_values():
    u = tref.bits_to_uniform(torch.tensor([0, 0xFFFFFFFF, 1 << 9], dtype=torch.int64))
    vals = u.numpy()
    assert vals[0] == 0.0
    assert 0.0 < vals[2] < vals[1] < 1.0
    want = np.asarray(jref.bits_to_uniform(jnp.array([0, 0xFFFFFFFF, 1 << 9], jnp.uint32)))
    np.testing.assert_array_equal(vals.view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("seed", (0, 9))
def test_gumbel_within_one_ulp_and_same_order(seed):
    d = 20000
    with jax.threefry_partitionable(False):
        want = np.asarray(jax.random.gumbel(_jkey(seed), (d,)))
    got = R.gumbel(R.PRNGKey(seed), d).numpy()
    # g = −log(L), L = −log u, and each side rounds both logs.  The inner
    # log's results may differ by one ulp of L, a relative error of at most
    # 2⁻²³; g = −log L carries a relative error e of L as an absolute one,
    # −log(L(1 + e)) = g − e + O(e²): up to 2⁻²³.  The outer log's results may
    # differ by one more ulp of g: up to 2⁻²³·max(1, |g|) (many ulps where g
    # is near 0).  So |Δg| ≤ 2⁻²³·(1 + max(1, |g|)), one epsilon per log.
    assert np.all(np.abs(got - want) <= 2.0 ** -23 * (1.0 + np.maximum(1.0, np.abs(want))))
    # the orderings (what top-k sees) agree exactly, ties to the lower index
    np.testing.assert_array_equal(np.argsort(-got, kind="stable"),
                                  np.argsort(-want, kind="stable"))
