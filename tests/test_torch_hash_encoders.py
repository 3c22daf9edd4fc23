"""The hash-PRNG encoders of the port against the JAX package: the murmur3
hash of ``kernels/prng.py``, the dense Bernoulli encoder (kernel 14) and
binary quantization (kernel 15) as plain versions, their ``ops`` wrappers at
an arbitrary shape and the binary decode.

Tolerances.  The hash, the masks and the packed bytes are integer results:
bit for bit.  The plain encoders against the reference's op-by-op ``ref``
functions: bit for bit too, in f32 and bf16 (the same f32 operations in the
same order, then one round to bf16).  Against the Pallas kernels, run
jitted in interpret mode, the values are held to the reference's own
tolerances for its kernel (tests/test_kernels.py:77): atol 1e-6 in f32,
2e-2 in bf16, since XLA may contract ``x/p − c·μ`` into an FMA inside the
jitted kernel; the masks stay bit-exact.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import prng as jprng
from repro.kernels.bernoulli_encode import bernoulli_encode as jbk
from repro.kernels.bernoulli_encode import ops as jbo
from repro.kernels.bernoulli_encode import ref as jbr
from repro.kernels.binary_quant import binary_quant as jqk
from repro.kernels.binary_quant import ops as jqo
from repro.kernels.binary_quant import ref as jqr
from repro_torch.kernels import prng as tprng
from repro_torch.kernels.bernoulli_encode import ops as tbo
from repro_torch.kernels.bernoulli_encode import ref as tbr
from repro_torch.kernels.binary_quant import ops as tqo
from repro_torch.kernels.binary_quant import ref as tqr

# one intra-op thread: beside other test workers on a loaded machine, torch's
# thread pool stalls for tens of seconds
torch.set_num_threads(1)

DTYPES = {"float32": (jnp.float32, torch.float32), "bfloat16": (jnp.bfloat16, torch.bfloat16)}
KERNEL_ATOL = {"float32": 1e-6, "bfloat16": 2e-2}
SEEDS = (0, 7, 0xDEADBEEF, 0xFFFFFFFF)


@pytest.fixture(autouse=True)
def _golden_threefry_layout():
    with jax.threefry_partitionable(False):
        yield


def _x(shape, seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def _as(x, dtype):
    jd, td = DTYPES[dtype]
    return jnp.asarray(x).astype(jd), torch.from_numpy(x).to(td)


def _f32_bits(a):
    return np.asarray(a, np.float32).view(np.int32)


def _scal(a, b, seed):
    seed_u = jnp.uint32(seed)
    return jnp.stack([jnp.float32(a), jnp.float32(b),
                      (seed_u >> jnp.uint32(16)).astype(jnp.float32),
                      (seed_u & jnp.uint32(0xFFFF)).astype(jnp.float32)]).reshape(1, 4)


# --------------------------- the hash ------------------------------------ #

@pytest.mark.parametrize("seed", SEEDS)
def test_hash_and_uniform_equal_reference(seed):
    idx = np.concatenate([np.arange(70_001), [2**31 - 1, 2**31, 2**32 - 2, 2**32 - 1]])
    idx = idx.astype(np.uint32)
    want_h = np.asarray(jprng.hash_u32(jnp.uint32(seed), jnp.asarray(idx)))
    want_u = np.asarray(jprng.uniform_hash(jnp.uint32(seed), jnp.asarray(idx)))
    t_idx = torch.from_numpy(idx.astype(np.int64))
    got_h = tprng.hash_u32(seed, t_idx)
    got_u = tprng.uniform_hash(seed, t_idx)
    assert got_h.dtype == torch.int64 and int(got_h.min()) >= 0 and int(got_h.max()) < 2**32
    np.testing.assert_array_equal(got_h.numpy().astype(np.uint32), want_h)
    assert got_u.dtype == torch.float32
    np.testing.assert_array_equal(got_u.numpy().view(np.int32), want_u.view(np.int32))


def test_hash_uniformity():
    u = tprng.uniform_hash(9, torch.arange(1 << 16))
    assert abs(float(u.mean()) - 0.5) < 0.01
    assert abs(float(u.var()) - 1 / 12) < 0.01
    assert float(u.min()) >= 0.0 and float(u.max()) < 1.0


# --------------------------- kernel 14 ------------------------------------ #

@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("rows", (512, 1024))
def test_bernoulli_plain_equals_reference_and_kernel(rows, dtype):
    jx, tx = _as(_x((rows, 128), rows), dtype)
    p, mu, seed = 0.3, 0.1, 0xDEADBEEF
    got = tbr.bernoulli_encode(tx, p, mu, seed)
    assert got.dtype == tx.dtype and got.shape == tx.shape
    got32 = got.to(torch.float32).numpy()
    want = jbr.bernoulli_encode(jx, p, mu, seed)
    np.testing.assert_array_equal(got32.view(np.int32), _f32_bits(want))
    kern = np.asarray(jbk.bernoulli_encode_2d(jx, _scal(p, mu, seed), interpret=True), np.float32)
    np.testing.assert_array_equal(got32 != np.float32(mu), kern != np.float32(mu))
    np.testing.assert_allclose(got32, kern, rtol=0, atol=KERNEL_ATOL[dtype])


def test_bernoulli_mask_is_the_hash():
    """Sent where uniform_hash(seed, j) < p, μ elsewhere, j the flat index."""
    x = torch.from_numpy(_x((3, 1000), 5))
    y = tbr.bernoulli_encode(x, 0.25, -0.5, 123)
    u = tprng.uniform_hash(123, torch.arange(3000)).reshape(3, 1000)
    assert torch.equal(y != -0.5, u < 0.25)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_bernoulli_ops_arbitrary_shape(dtype):
    jx, tx = _as(_x((3, 1000), 1), dtype)
    got = tbo.bernoulli_encode(tx, 0.5, 0.0, 123)
    want = jbo.bernoulli_encode(jx, 0.5, 0.0, 123)
    assert got.shape == (3, 1000) and got.dtype == tx.dtype
    np.testing.assert_array_equal(got.to(torch.float32).numpy().view(np.int32), _f32_bits(want))


def test_bernoulli_unbiased():
    x = torch.ones(1 << 18)
    for p in (0.1, 0.5):
        y = tbo.bernoulli_encode(x, p, 0.0, 77)
        assert abs(float((y != 0).float().mean()) - p) < 0.01
        assert abs(float(y.mean()) - 1.0) < 0.02


# --------------------------- kernel 15 ------------------------------------ #

@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("rows", (512, 1024))
def test_binary_plain_equals_reference_and_kernel(rows, dtype):
    jx, tx = _as(_x((rows, 128), rows + 1), dtype)
    got, vmin, vmax = tqr.binary_encode(tx, 42)
    want, jmin, jmax = jqr.binary_encode(jx, 42)
    assert got.dtype == torch.uint8 and got.shape == (rows * 16,)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert float(vmin) == float(jmin) and float(vmax) == float(jmax)
    kern = jqk.binary_encode_2d(jx, _scal(jmin, jmax, 42), interpret=True)
    np.testing.assert_array_equal(got.numpy(), np.asarray(kern).reshape(-1))


def test_binary_zero_spread_sets_no_bit():
    """Δ = vmax − vmin ≤ 0: p = 0 everywhere, every bit 0."""
    x = torch.full((4096,), 0.75)
    packed, vmin, vmax = tqr.binary_encode(x, 3)
    assert float(vmin) == float(vmax) == 0.75 and not bool(packed.any())


@pytest.mark.parametrize("dtype", sorted(DTYPES))
def test_binary_ops_arbitrary_shape(dtype):
    jx, tx = _as(_x((3, 1000), 2), dtype)
    got, vmin, vmax = tqo.binary_encode(tx, 7)
    want, jmin, jmax = jqo.binary_encode(jx, 7)
    assert got.shape == (tqo.TILE // 8,)    # 3000 coordinates padded to one tile
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert not bool(got[3000 // 8:].any())   # the vmin padding sends no bit
    assert float(vmin) == float(jmin) and float(vmax) == float(jmax)


def test_binary_decode_roundtrip():
    jx, tx = _as(_x((4, 512), 3), "float32")
    packed, vmin, vmax = tqo.binary_encode(tx, 7)
    y = tqo.binary_decode(packed, vmin, vmax, tx.shape)
    jp, jmin, jmax = jqo.binary_encode(jx, 7)
    want = jqo.binary_decode(jp, jmin, jmax, jx.shape)
    assert y.shape == tx.shape and y.dtype == torch.float32
    np.testing.assert_array_equal(y.numpy(), np.asarray(want))
    assert set(np.unique(y.numpy())) <= {float(vmin), float(vmax)}
    bits = tqr.encode_bits(tx, vmin, vmax, 7).reshape(tx.shape)
    assert torch.equal(y == vmax, bits)
    back = tqo.binary_decode(packed, vmin, vmax, (2, 1024), torch.bfloat16)
    assert back.dtype == torch.bfloat16
    assert torch.equal(back.reshape(-1), y.reshape(-1).to(torch.bfloat16))


def test_binary_unbiased():
    x = torch.from_numpy(_x((1 << 14,), 4))
    recon = torch.stack([tqo.binary_decode(*tqo.binary_encode(x, s), x.shape)
                         for s in range(64)])
    err = recon.mean(0) - x
    assert abs(float(err.mean())) < 0.02
    assert float(err.abs().mean()) < 0.6
