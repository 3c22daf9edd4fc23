"""The port's §7.2 rotation against the JAX package, bit for bit: the
Rademacher signs, the plain butterfly FWHT, ``rotate`` / ``unrotate``
(padding and the block-diagonal MAX_D chunks included), and the rotated
closed forms (f32 sums in other orders: rtol 1e-5).

The reference runs inside ``jax.threefry_partitionable(False)`` (the
Threefry layout the golden wire bytes pin), on its CPU path: the butterfly
of ``repro.kernels.hadamard.ref``.  It runs op by op, except that its
butterfly is compiled once per shape with ``jax.jit`` (:func:`jit_butterfly`):
the butterfly only adds and subtracts, which jit leaves bit for bit, while
the per-op compiles would cost seconds per shape (ROADMAP.md queue 3: jit
moves the reference's bits only where it multiplies or divides).  Inputs
come from numpy seeds.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import mse as jmse
from repro.core import rotation as jrot
from repro.kernels.hadamard import ops as jhops
from repro.kernels.hadamard import ref as jhref
from repro_torch import random as R
from repro_torch.core import mse as tmse
from repro_torch.core import rotation as trot
from repro_torch.kernels.hadamard import ops as thops
from repro_torch.kernels.hadamard import ref as thref

# one intra-op thread: beside other test workers on a loaded machine, torch's
# thread pool stalls for tens of seconds
torch.set_num_threads(1)

KEY_SEED = 5
_JIT_FWHT = jax.jit(jhops.fwht)
_JIT_REF_FWHT = jax.jit(jhref.fwht)


@pytest.fixture
def jit_butterfly(monkeypatch):
    """The reference's rotation with its butterfly jitted (module docstring)."""
    monkeypatch.setattr(jrot.hadamard_ops, "fwht", _JIT_FWHT)


def _bits(a):
    return np.ascontiguousarray(np.asarray(a, np.float32)).view(np.uint32)


def _keys(seed=KEY_SEED):
    return jax.random.PRNGKey(seed), R.PRNGKey(seed)


@pytest.mark.parametrize("d", (1, 7, 4096, 70_001))
def test_rademacher_equals_jax(d):
    jkey, tkey = _keys()
    with jax.threefry_partitionable(False):
        want = jax.random.rademacher(jkey, (d,), jnp.float32)
    got = R.rademacher(tkey, (d,))
    np.testing.assert_array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("b", (1, 3))
@pytest.mark.parametrize("c", (1, 2, 4, 256, 1 << 16))
def test_fwht_equals_reference(c, b):
    x = np.random.default_rng(c + b).standard_normal((b, c)).astype(np.float32)
    want = _JIT_REF_FWHT(jnp.asarray(x))
    got = thref.fwht(torch.from_numpy(x))
    np.testing.assert_array_equal(_bits(got), _bits(want))
    np.testing.assert_array_equal(_bits(thops.fwht(torch.from_numpy(x))), _bits(want))


def test_hadamard_matrix_and_fwht_agree():
    h = thref.hadamard_matrix(64)
    i = np.arange(64)
    parity = np.array([[bin(a & b).count("1") % 2 for b in i] for a in i])
    np.testing.assert_array_equal(h.numpy(), 1 - 2 * parity)
    x = torch.from_numpy(np.random.default_rng(1).standard_normal((2, 64)).astype(np.float32))
    torch.testing.assert_close(thref.fwht(x), x @ h.T, rtol=1e-5, atol=1e-5)


def test_fwht_rejects_bad_lengths():
    with pytest.raises(ValueError, match="power-of-two"):
        thops.fwht(torch.zeros(3))
    with pytest.raises(ValueError, match="chunk"):
        thops.fwht(torch.zeros(2 * thops.MAX_D))


@pytest.mark.parametrize("d", (300, 4096, 70_001, (1 << 20) + 5))
def test_rotate_unrotate_equal_reference(d, jit_butterfly):
    """Padding to the next power of two, and at 2²⁰ + 5 two MAX_D chunks."""
    jkey, tkey = _keys()
    x = (np.random.default_rng(d).standard_normal(d) * 0.3).astype(np.float32)
    assert trot.padded_dim(d) == jrot.padded_dim(d)
    with jax.threefry_partitionable(False):
        jkrot = jrot.rotation_key(jkey)
        jz = jrot.rotate(jkrot, jnp.asarray(x))
        jx = jrot.unrotate(jkrot, jz, d)
    tkrot = trot.rotation_key(tkey)
    np.testing.assert_array_equal(tkrot.numpy(), np.asarray(jkrot))
    tz = trot.rotate(tkrot, torch.from_numpy(x))
    np.testing.assert_array_equal(_bits(tz), _bits(jz))
    tx = trot.unrotate(tkrot, tz, d)
    np.testing.assert_array_equal(_bits(tx), _bits(jx))
    np.testing.assert_allclose(tx.numpy(), x, atol=1e-5)


def test_rotated_closed_forms_match(jit_butterfly):
    """mse_fixed_k (Lemma 3.4), mse_rotated_binary and mse_rotated_fixed_k
    at n = 3, d = 3000 (dp = 4096)."""
    jkey, tkey = _keys(2)
    rng = np.random.default_rng(3)
    xs = (rng.standard_normal((3, 3000)) * 0.1 + rng.standard_normal((1, 3000)) * 0.2
          + np.arange(3)[:, None] * 1e-3).astype(np.float32)
    jx, tx = jnp.asarray(xs), torch.from_numpy(xs)
    mus = xs.mean(1)
    assert (float(tmse.mse_fixed_k(tx, 512, torch.from_numpy(mus)))
            == pytest.approx(float(jmse.mse_fixed_k(jx, 512, jnp.asarray(mus))), rel=1e-5))
    with jax.threefry_partitionable(False):
        jkrot = jrot.rotation_key(jkey)
        want_b = float(jmse.mse_rotated_binary(jx, jkrot))
        want_k = float(jmse.mse_rotated_fixed_k(jx, 1024, jkrot))
    tkrot = trot.rotation_key(tkey)
    assert float(tmse.mse_rotated_binary(tx, tkrot)) == pytest.approx(want_b, rel=1e-5)
    assert float(tmse.mse_rotated_fixed_k(tx, 1024, tkrot)) == pytest.approx(want_k, rel=1e-5)
