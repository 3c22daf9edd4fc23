"""The port's encoders, node centers and §6 ternary split against the JAX
package's ``core/encoders``, ``core/centers`` and ``core/optimal``.

Bit-equal: the binary support and message, the ternary branch symbols,
messages and pass-through values (uniform and §6-optimal split), the
optimal split itself, the ``zero`` and ``min`` centers, and the Bernoulli
and fixed-k messages given the same μ.  The ``mean`` and ``optimal``
centers sum in another order than jnp and are held to a stated bound.
JAX calls run op by op (as the golden wire bytes were made; under ``jit``
XLA contracts the optimal split's multiply-adds into FMAs) inside
``jax.threefry_partitionable(False)``; inputs come from numpy seeds.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import centers as jcenters
from repro.core import encoders as jenc
from repro.core import optimal as jopt
from repro.core import types as jtypes
from repro_torch import convert
from repro_torch import random as R
from repro_torch.core import centers as tcenters
from repro_torch.core import encoders as tenc
from repro_torch.core import optimal as topt

# one intra-op thread: beside other test workers on a loaded machine, torch's
# thread pool stalls for tens of seconds
torch.set_num_threads(1)

DS = (1, 33, 4099, 20_011)
EPS = 2.0 ** -23


def _x(d, seed=0, off=0.1):
    return (np.random.default_rng(seed + d).standard_normal(d) * 0.5 + off).astype(np.float32)


def _keys(seed, fold):
    with jax.threefry_partitionable(False):
        jk = jax.random.fold_in(jax.random.PRNGKey(seed), fold)
    return jk, R.fold_in(R.PRNGKey(seed), fold)


def _spec(jspec):
    return convert.compression_config(jtypes.CompressionConfig(encoder=jspec)).encoder


def _same(got, want):
    want = np.asarray(want)
    got = got.numpy()
    assert got.shape == want.shape
    if want.dtype == np.float32:
        np.testing.assert_array_equal(got.view(np.uint32), want.view(np.uint32))
    else:
        np.testing.assert_array_equal(got.astype(np.int64), want.astype(np.int64))


@pytest.mark.parametrize("d", DS)
def test_binary_encode_bit_equal(d):
    x = _x(d)
    jk, tk = _keys(3, d)
    with jax.threefry_partitionable(False):
        want = jenc.encode_binary(jk, jnp.asarray(x))
    got = tenc.encode_binary(tk, torch.from_numpy(x))
    _same(got.support, want.support)
    _same(got.y, want.y)
    for k in ("vmin", "vmax"):
        _same(got.extras[k], want.extras[k])
    assert int(got.nsent) == int(want.nsent)


@pytest.mark.parametrize("d", DS)
@pytest.mark.parametrize("probs", ("uniform", "optimal"))
def test_ternary_encode_bit_equal(d, probs):
    x = _x(d, seed=1)
    jk, tk = _keys(4, d)
    jspec = jtypes.EncoderSpec(kind="ternary", fraction=1 / 16, probs=probs, center="min")
    with jax.threefry_partitionable(False):
        want = jenc.encode(jk, jnp.asarray(x), jspec)
    got = tenc.encode(tk, torch.from_numpy(x), _spec(jspec))
    _same(got.extras["branch"], want.extras["branch"])
    _same(got.y, want.y)          # c1, c2 and every pass-through value
    _same(got.support, want.support)
    for k in ("c1", "c2"):
        _same(got.extras[k], want.extras[k])
    assert int(got.nsent) == int(want.nsent)


@pytest.mark.parametrize("d", (1, 4099, 20_011))
@pytest.mark.parametrize("q", (1 / 16, 0.3))
def test_ternary_optimal_probs_bit_equal(d, q):
    x = _x(d, seed=2, off=-0.4)
    want = jopt.ternary_optimal_probs(jnp.asarray(x), q)
    got = topt.ternary_optimal_probs(torch.from_numpy(x), q)
    for g, w in zip(got, want):
        _same(g.contiguous(), w)
    const = np.full(7, 0.25, np.float32)        # span 0: all branch mass on c1
    for g, w in zip(topt.ternary_optimal_probs(torch.from_numpy(const), q),
                    jopt.ternary_optimal_probs(jnp.asarray(const), q)):
        _same(g.contiguous(), w)


def test_centers_zero_and_min_exact():
    xs = np.stack([_x(4099, s) for s in range(3)])
    for policy in ("zero", "min"):
        _same(tcenters.compute_centers(torch.from_numpy(xs), policy),
              jcenters.compute_centers(jnp.asarray(xs), policy))


@pytest.mark.parametrize("d", (4099, 70_001))
def test_centers_mean_and_optimal_within_bound(d):
    """``mean``: within 4 f32 epsilons of mean|x| (the bound slice 1 holds
    the wire μ to).  ``optimal`` (Eq. 16): a ratio of two f32 sums of d
    terms each, summed in other orders; within 8 f32 epsilons of the
    weighted mean of |x| (measured at most 3.6, and ``mean`` at most 1.8,
    over 60 draws at these d)."""
    rng = np.random.default_rng(d)
    xs = np.stack([_x(d, s, off=s - 1.0) for s in range(3)])
    probs = rng.uniform(0.05, 1.0, xs.shape).astype(np.float32)
    got = tcenters.compute_centers(torch.from_numpy(xs), "mean").numpy()
    want = np.asarray(jcenters.compute_centers(jnp.asarray(xs), "mean"))
    assert np.all(np.abs(got - want) <= 4 * EPS * np.abs(xs).mean(1))
    got = tcenters.compute_centers(torch.from_numpy(xs), "optimal",
                                   torch.from_numpy(probs)).numpy()
    want = np.asarray(jcenters.compute_centers(jnp.asarray(xs), "optimal", jnp.asarray(probs)))
    w = 1.0 / probs.astype(np.float64) - 1.0
    scale = (w * np.abs(xs)).sum(1) / w.sum(1)
    assert np.all(np.abs(got - want) <= 8 * EPS * scale)
    ones = np.ones_like(probs)                   # every weight 0: the plain mean
    got = tcenters.compute_centers(torch.from_numpy(xs), "optimal", torch.from_numpy(ones))
    assert torch.equal(got, tcenters.compute_centers(torch.from_numpy(xs), "mean"))


@pytest.mark.parametrize("kind,fraction", [("bernoulli", 1 / 16), ("bernoulli", 0.5),
                                           ("fixed_k", 1 / 16)])
def test_encode_given_mu_bit_equal(kind, fraction):
    d = 4099
    x = _x(d, seed=5)
    jk, tk = _keys(6, d)
    jspec = jtypes.EncoderSpec(kind=kind, fraction=fraction)
    with jax.threefry_partitionable(False):
        mu = jnp.mean(jnp.asarray(x))
        want = jenc.encode(jk, jnp.asarray(x), jspec, mu=mu)
    got = tenc.encode(tk, torch.from_numpy(x), _spec(jspec), mu=torch.tensor(float(mu)))
    _same(got.y, want.y)
    _same(got.support, want.support)
    assert int(got.nsent) == int(want.nsent)


def test_encode_batch_folds_rank_keys():
    xs = np.stack([_x(1000, s) for s in range(3)])
    jspec = jtypes.EncoderSpec(kind="binary", center="min")
    with jax.threefry_partitionable(False):
        want = jenc.encode_batch(jax.random.PRNGKey(11), jnp.asarray(xs), jspec)
    got = tenc.encode_batch(R.PRNGKey(11), torch.from_numpy(xs), _spec(jspec))
    _same(got.y, want.y)
    _same(got.extras["vmax"], want.extras["vmax"])
