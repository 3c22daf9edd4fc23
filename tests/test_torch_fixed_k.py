"""The port's block-structured fixed-k encoder against the JAX package's
``kernels/fixed_k_encode`` — block ids equal, encode and decode bit-equal.

Both sides get the same μ; JAX calls run inside
``jax.threefry_partitionable(False)``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.fixed_k_encode import ops as jops
from repro.kernels.fixed_k_encode import ref as jref
from repro_torch import random as R
from repro_torch.kernels.fixed_k_encode import ops as tops
from repro_torch.kernels.fixed_k_encode import ref as tref

# one intra-op thread: beside other test workers on a loaded machine, torch's
# thread pool stalls for tens of seconds
torch.set_num_threads(1)

_sample = jax.jit(jref.sample_blocks, static_argnums=(1, 2))


def _key(seed, fold):
    with jax.threefry_partitionable(False):
        k = jax.random.fold_in(jax.random.PRNGKey(seed), fold)
    return k, R.fold_in(R.PRNGKey(seed), fold)


@pytest.mark.parametrize("nb,kb", [(1, 1), (10, 3), (1000, 63), (20000, 1250), (37985, 2374)])
@pytest.mark.parametrize("seed", (0, 99))
def test_sample_blocks_ids_equal(nb, kb, seed):
    jk, tk = _key(seed, nb)
    with jax.threefry_partitionable(False):
        want = np.asarray(_sample(jk, nb, kb))
    got = tref.sample_blocks(tk, nb, kb).numpy()
    np.testing.assert_array_equal(got, want)
    assert np.all(np.diff(got) > 0)


@pytest.mark.parametrize("n", (1024, 4096, 70001))
@pytest.mark.parametrize("scale", (None, 1.0))
def test_encode_bit_exact(n, scale):
    x = (np.random.default_rng(n).standard_normal(n) * 0.3).astype(np.float32)
    nb = -(-n // 1024)
    kb = max(1, round(nb / 16))
    jk, tk = _key(3, n)
    with jax.threefry_partitionable(False):
        ids = jref.sample_blocks(jk, nb, kb)
        mu = jnp.mean(jnp.asarray(x))
        want = np.asarray(jops.fixed_k_encode(jnp.asarray(x), ids, mu, scale=scale))
    tids = tref.sample_blocks(tk, nb, kb)
    np.testing.assert_array_equal(tids.numpy(), np.asarray(ids))
    got = tops.fixed_k_encode(torch.from_numpy(x), tids, torch.tensor(float(mu)), scale=scale)
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want.view(np.uint32))


@pytest.mark.parametrize("n", (4096, 70001))
def test_decode_bit_exact(n):
    nb = -(-n // 1024)
    kb = max(1, round(nb / 16))
    rng = np.random.default_rng(n + 1)
    vals = rng.standard_normal((kb, 1024)).astype(np.float32)
    jk, tk = _key(4, n)
    with jax.threefry_partitionable(False):
        ids = jref.sample_blocks(jk, nb, kb)
        want = np.asarray(jops.fixed_k_decode(jnp.asarray(vals), ids, jnp.float32(0.125), (n,)))
    got = tops.fixed_k_decode(torch.from_numpy(vals), tref.sample_blocks(tk, nb, kb),
                              torch.tensor(0.125), (n,))
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want.view(np.uint32))


def test_num_blocks_matches():
    for n in (1, 1023, 1024, 1025, 388_956_160):
        assert tops.num_blocks(n) == jops.num_blocks(n)
