"""The port's fused rotate + 1-bit encode path (``kernels/rotated_encode``)
against the JAX package.

* plain ``rotate_minmax`` equals the reference's CPU chain —
  ``rotation.rotate`` over the block-diagonal chunks, then each chunk's
  (min, max) — bit for bit (one chunk, and two MAX_D chunks);
* plain ``rotate_minmax`` against the reference's TPU oracle
  (``repro.kernels.rotated_encode.ref.rotate_minmax``, the Kronecker matmul
  FWHT) within rtol 1e-5 / atol 1e-6, the reference's own tolerance for
  that oracle (tests/test_rotated_encode_kernel.py, which applies it at
  d ≤ 5000), at c up to 2¹⁴;
* plain ``binary_plane`` equals the reference's, bit for bit (a ragged dp
  and delta = 0 included);
* ``ops.pack_binary`` equals the reference's at both wire dtypes;
* the fused plain versions composed as the card composes its kernels equal
  the port's chain, so the card's route gives the chain's bytes.

Reference calls run inside ``jax.threefry_partitionable(False)``, op by op
but for the butterfly (see tests/test_torch_rotation.py::jit_butterfly).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import rotation as jrot
from repro.kernels.hadamard import ops as jhops
from repro.kernels.rotated_encode import ops as jro_ops
from repro.kernels.rotated_encode import ref as jro_ref
from repro_torch import random as R
from repro_torch.core import bitplane as tbp
from repro_torch.core import rotation as trot
from repro_torch.kernels.rotated_encode import ops as tro_ops
from repro_torch.kernels.rotated_encode import ref as tro_ref
from repro_torch.kernels.threefry import ref as tf_ref
from test_torch_rotation import jit_butterfly  # noqa: F401  (fixture)

# one intra-op thread: beside other test workers on a loaded machine, torch's
# thread pool stalls for tens of seconds
torch.set_num_threads(1)

KEY_SEED = 17


def _bits(a):
    return np.ascontiguousarray(np.asarray(a, np.float32)).view(np.uint32)


def _x(d, scale=0.3):
    return (np.random.default_rng(d).standard_normal(d) * scale).astype(np.float32)


@pytest.mark.parametrize("dp", (4096, 1 << 17, 1 << 21))
def test_rotate_minmax_equals_reference_chain(dp, jit_butterfly):  # noqa: F811
    x = _x(dp)
    c = min(dp, jhops.MAX_D)
    with jax.threefry_partitionable(False):
        krot = jrot.rotation_key(jax.random.PRNGKey(KEY_SEED))
        want = np.asarray(jrot.rotate(krot, jnp.asarray(x))).reshape(-1, c)
        signs = np.array(jrot.rademacher_diag(krot, dp))
    z, mm = tro_ref.rotate_minmax(torch.from_numpy(x).reshape(-1, c),
                                  torch.from_numpy(signs).reshape(-1, c),
                                  float(trot.chunk_scale(c, "cpu")))
    np.testing.assert_array_equal(_bits(z), _bits(want))
    np.testing.assert_array_equal(_bits(mm), _bits(np.stack([want.min(1), want.max(1)], 1)))


@pytest.mark.parametrize("c", (256, 1 << 11, 1 << 13, 1 << 14))
def test_rotate_minmax_within_tpu_oracle(c):
    """The TPU oracle computes H as two f32 Kronecker matmuls, the port the
    butterfly; they differ in the last bits (odd log2 c: 1/√c not a power of
    two).  The gap grows with c: at 2¹⁶ a few coordinates near zero differ
    by up to 3.1e-6, past atol 1e-6 (4–6 of 131,072 over three seeds)."""
    b = 2
    rng = np.random.default_rng(c)
    x = rng.standard_normal((b, c)).astype(np.float32)
    s = np.where(rng.random((b, c)) < 0.5, 1.0, -1.0).astype(np.float32)
    scale = float(np.sqrt(np.float32(c)))
    d1, d2 = jhops._factorize(c)
    jz, jmin, jmax = jro_ref.rotate_minmax(jnp.asarray(x), jnp.asarray(s), d1=d1, d2=d2,
                                           scale=scale)
    z, mm = tro_ref.rotate_minmax(torch.from_numpy(x), torch.from_numpy(s), scale)
    np.testing.assert_allclose(z.numpy(), np.asarray(jz), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(mm.numpy(), np.stack([jmin, jmax], 1), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("dp", (1, 33, 4096, 70_001))
def test_binary_plane_equals_reference(dp):
    z = _x(dp, 1.0)
    jkey = jax.random.fold_in(jax.random.PRNGKey(KEY_SEED), 3)
    tkey = R.fold_in(R.PRNGKey(KEY_SEED), 3)
    for lo, hi in ((z.min(), z.max()), (z[0], z[0])):     # delta = 0 last
        with jax.threefry_partitionable(False):
            want = np.asarray(jro_ref.binary_plane(jnp.asarray(z), jkey, jnp.float32(lo),
                                                   jnp.float32(hi), dp))
        got = tro_ref.binary_plane(torch.from_numpy(z), tkey, torch.tensor(lo),
                                   torch.tensor(hi), dp)
        np.testing.assert_array_equal(got.numpy().view(np.uint32), want)
    assert not want.any()


def _pair_order_plane(z, key, vmin, vmax, dp):
    """A torch model of ``re_encode_pack``'s word placement
    (csrc/rotated_encode.cu): one cipher call per pair (j, j + half), half =
    ⌈dp/2⌉; the low ballot of pairs j0 .. j0 + 31 is word j0/32; the high
    ballot is shifted by r = half % 32 into word (half + j0)/32 and, for r ≠
    0, its top r bits into the next; the parts meet by OR (their bits are
    disjoint, so an add), the seam word at coordinate half included."""
    half = (dp + 1) // 2
    r = half % 32
    nb = -(-half // 32)
    nw = -(-dp // 32)
    k0, k1 = (int(w) & 0xFFFFFFFF for w in key)
    j = torch.arange(nb * 32, dtype=torch.int64)
    c1 = j + half
    x0, x1 = tf_ref.threefry2x32(k0, k1, j, torch.where(c1 < dp, c1, torch.zeros_like(c1)))
    delta = vmax - vmin
    zz = torch.cat([z, torch.zeros(2 * nb * 32 - dp)])

    def vote(v, bits):
        p = torch.where(delta > 0, (v - vmin) / torch.where(delta > 0, delta, 1.0),
                        torch.zeros_like(v))
        return tf_ref.bits_to_uniform(bits) < p

    lo = (j < half) & vote(zz[j], x0)
    hi = (j < half) & (c1 < dp) & vote(zz[c1], x1)
    weights = torch.tensor([1 << b for b in range(32)], dtype=torch.int64)
    bl = (lo.reshape(nb, 32).to(torch.int64) * weights).sum(1)
    bh = (hi.reshape(nb, 32).to(torch.int64) * weights).sum(1)
    b = torch.arange(nb)
    plane = torch.zeros(nw + 2, dtype=torch.int64)
    plane.index_add_(0, b, bl)
    plane.index_add_(0, half // 32 + b, (bh << r) & 0xFFFFFFFF)
    if r:
        plane.index_add_(0, half // 32 + b + 1, bh >> (32 - r))
    assert not plane[nw:].any()
    plane = plane[:nw]
    return torch.where(plane >= 1 << 31, plane - (1 << 32), plane).to(torch.int32)


@pytest.mark.parametrize("dp", (1, 2, 33, 65, 70_001, 131_072, 2 * ((1 << 16) + 5) + 1))
def test_pair_order_plane_model_equals_binary_plane(dp):
    """The card's pair-drawing encode-pack places every bit where
    ``binary_plane`` does: half % 32 ∈ {1, 17, 25, 0, 6}, odd dp; delta = 0
    sets no bit."""
    z = torch.from_numpy(_x(dp, 1.0))
    key = R.fold_in(R.PRNGKey(KEY_SEED), 5)
    for lo, hi in ((z.min(), z.max()), (z[0], z[0].clone())):     # delta = 0 last
        got = _pair_order_plane(z, key, lo, hi, dp)
        assert torch.equal(got, tro_ref.binary_plane(z, key, lo, hi, dp))
    assert not got.any()


@pytest.mark.parametrize("wire", ("bfloat16", "float32"))
@pytest.mark.parametrize("d", (100, 300, 5000))
def test_pack_binary_equals_reference(d, wire, jit_butterfly):  # noqa: F811
    x = _x(d)
    with jax.threefry_partitionable(False):
        want = np.asarray(jro_ops.pack_binary(jnp.asarray(x), jax.random.PRNGKey(KEY_SEED), 2,
                                              jnp.dtype(wire)))
    got = tro_ops.pack_binary(torch.from_numpy(x), R.PRNGKey(KEY_SEED), 2, wire)
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)


@pytest.mark.parametrize("d", (300, 70_001))
def test_fused_plain_versions_equal_chain(d):
    """ref.rotate_minmax → (min, max) reduce → ref.binary_plane → tail, as
    ops.pack_binary composes the kernels on the card, gives the chain's words."""
    x = torch.from_numpy(_x(d))
    key = R.PRNGKey(KEY_SEED)
    dp = trot.padded_dim(d)
    krot = trot.rotation_key(key)
    signs = trot.rademacher_diag(krot, dp)
    z2, mm = tro_ref.rotate_minmax(trot._pad(x, dp).reshape(1, dp), signs.reshape(1, dp),
                                   float(trot.chunk_scale(dp, "cpu")))
    vmin, vmax = mm[:, 0].amin(), mm[:, 1].amax()
    plane = tro_ref.binary_plane(z2.reshape(-1), R.fold_in(key, 4), vmin, vmax, dp)
    fused = torch.cat([plane, tbp.floats_to_words(torch.stack([vmin, vmax]), "bfloat16")])
    assert torch.equal(fused, tro_ops.pack_binary(x, key, 4, "bfloat16"))
