"""The port's rotated codecs (``rotated_binary``, ``rotated_fixed_k``) in
whole ``compressed_mean`` rounds on ``StackedComm(n, "cpu")`` against the
JAX package's meshless round, bit for bit, and their accounting against
the reference's.

* ``rotated_binary`` with the flat decode and with the §13 scatter decode
  in rotated space (the reference's scatter decode equals its flat one),
  plus the gather codecs' own ``pack`` rows and ``decode_gathered``, and
  ``unpack`` over the binary plane;
* ``rotated_fixed_k`` (gather), and the rotation over the psum codec
  ``fixed_k_shared`` (``decode_reduced``);
* the bytes the communicator carried equal ``wire_bits + scatter_bits``;
* ``wire_slots``, ``wire_bits``, ``seed_bits``, ``scatter_bits`` and
  ``comm_cost_bits`` equal the reference's, at the padded length.

D = 3000 pads to dp = 4096.  The fixed-k codecs center at μ = mean(z) of
the rotated vector; the inputs sit on a 2⁻⁶ grid small enough that z = Qx
(√dp = 64) and every partial sum of it are exact in f32, so torch's and
jnp's means agree bit for bit (asserted), as tests/test_torch_collective.py
arranges for unrotated inputs.  The reference runs inside
``jax.threefry_partitionable(False)``, op by op but for its butterfly
(tests/test_torch_rotation.py::jit_butterfly).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import compression_preset as jpreset
from repro.core import rotation as jrot
from repro.core import wire as jwire
from repro_torch import convert
from repro_torch import random as R
from repro_torch.core import collectives as tcoll
from repro_torch.core import rotation as trot
from repro_torch.core import wire as twire
from repro_torch.core.wire import base as tbase
from test_torch_collective import reference_round
from test_torch_rotation import jit_butterfly  # noqa: F401  (fixture)

# one intra-op thread: beside other test workers on a loaded machine, torch's
# thread pool stalls for tens of seconds
torch.set_num_threads(1)

D = 3000
KEY_SEED = 23


def _configs():
    binary = dataclasses.replace(jpreset("rotated_binary", axes=("data",)), min_compress_size=1)
    fixed_k = dataclasses.replace(jpreset("rotated_fixed_k", axes=("data",)), min_compress_size=1)
    shared = jpreset("fixed_k_1bit", axes=("data",))
    shared = dataclasses.replace(shared, min_compress_size=1,
                                 encoder=dataclasses.replace(shared.encoder, rotation=True))
    return {"rotated_binary": binary,
            "rotated_binary_scatter": dataclasses.replace(binary, scatter_decode=True),
            "rotated_fixed_k": fixed_k,
            "rotated_fixed_k_shared": shared}


def _xs(n, seed):
    rng = np.random.default_rng(seed)
    x = np.round(rng.standard_normal((n, D)) * 8) / 64
    return (x + (np.arange(n)[:, None] - n / 2) / 64).astype(np.float32)


def _bits(a):
    return np.ascontiguousarray(np.asarray(a, np.float32)).view(np.uint32)


@pytest.mark.parametrize("n", (2, 4))
@pytest.mark.parametrize("name", sorted(_configs()))
def test_stacked_round_equals_reference(name, n, jit_butterfly):  # noqa: F811
    jcfg = _configs()[name]
    xs = _xs(n, seed=n + 30)
    jkey = jax.random.PRNGKey(KEY_SEED)
    with jax.threefry_partitionable(False):
        want = np.asarray(reference_round(jnp.asarray(xs), jkey, jcfg))
        jz = [jrot.rotate(jrot.rotation_key(jkey), jnp.asarray(x)) for x in xs]
        jmus = [float(jnp.mean(z)) for z in jz]
    cfg = convert.compression_config(jcfg)
    tkey = R.PRNGKey(KEY_SEED)
    x = torch.from_numpy(xs)
    tz = [trot.rotate(trot.rotation_key(tkey), r) for r in x]
    assert [float(tbase.center(z, "mean")) for z in tz] == jmus
    comm = tcoll.StackedComm(n, "cpu")
    got = tcoll.compressed_mean(x, tkey, cfg, comm).numpy()
    np.testing.assert_array_equal(_bits(got), _bits(want))
    codec, jcodec = twire.resolve(cfg), jwire.resolve(jcfg)
    assert codec.name == jcodec.name
    if codec.reduce == "all_gather":
        # the codec's own hooks: the rows, the flat decode and (the port's
        # fixed-k codec has no per-peer unpack) one binary peer's unpack
        rows = torch.stack([codec.pack(x[r], tkey, r, cfg) for r in range(n)])
        with jax.threefry_partitionable(False):
            jrows = jnp.stack([jcodec.pack(jnp.asarray(xs[r]), jkey, r, jcfg) for r in range(n)])
            jone = (jcodec.unpack(jrows[1], 1, jkey, jcfg, D)
                    if codec.inner.name == "binary" else None)
        np.testing.assert_array_equal(rows.contiguous().view(torch.uint8).numpy(),
                                      np.asarray(jrows).view(np.uint8))
        np.testing.assert_array_equal(_bits(codec.decode_gathered(rows, tkey, cfg, D, n)),
                                      _bits(want))
        if codec.inner.name == "binary":
            np.testing.assert_array_equal(_bits(codec.unpack(rows[1], 1, tkey, cfg, D)),
                                          _bits(jone))
    bits = (codec.wire_bits(n, D, cfg) + codec.scatter_bits(n, D, cfg)
            if codec.reduce == "all_gather" else codec.wire_bits(n, D, cfg))
    assert (comm.bytes_gathered + comm.bytes_reduced) * 8 == bits


@pytest.mark.parametrize("d", (D, 4096, (1 << 20) + 5, 388_956_160))
@pytest.mark.parametrize("name", sorted(_configs()))
def test_accounting_equals_reference(name, d):
    jcfg = _configs()[name]
    cfg = convert.compression_config(jcfg)
    codec, jcodec = twire.resolve(cfg), jwire.resolve(jcfg)
    assert codec.wire_slots(d, cfg) == jcodec.wire_slots(d, jcfg)
    for n in (2, 8):
        assert codec.wire_bits(n, d, cfg) == jcodec.wire_bits(n, d, jcfg)
        assert codec.seed_bits(n, cfg) == jcodec.seed_bits(n, jcfg)
        assert codec.scatter_bits(n, d, cfg) == jcodec.scatter_bits(n, d, jcfg)
        assert codec.comm_cost_bits(n, d, cfg) == pytest.approx(
            jcodec.comm_cost_bits(n, d, jcfg), rel=1e-12)
        assert codec.comm_cost_bits(n, d, cfg) == pytest.approx(
            codec.wire_bits(n, d, cfg) + codec.seed_bits(n, cfg), rel=1e-12)


def test_registry_wraps_and_later_slices_raise(jit_butterfly):
    """The registry wraps any codec in the rotation; the robust decode under
    rotation (a later slice's, once refused) reduces in rotated space and
    equals the reference's bit for bit."""
    jternary = jpreset("ternary_packed", axes=("data",))
    jcfg = dataclasses.replace(jternary, encoder=dataclasses.replace(jternary.encoder,
                                                                     rotation=True))
    cfg = convert.compression_config(jcfg)
    codec = twire.resolve(cfg)
    assert codec.name == "rotated_ternary" and codec.inner is twire.get("ternary")
    assert codec.scatter_supported and codec.scatter_align(cfg) == 16
    assert {"rotated_binary", "rotated_fixed_k"} <= set(twire.names())
    with pytest.raises(ValueError, match="does not nest"):
        type(codec)(codec)
    assert codec.state_shape(D, cfg) is None and not codec.stateful   # forwarded
    n, xs = 3, _xs(3, 5)
    for policy, mask in (("trim(1)", None), ("median", None), ("mean", [1.0, 0.0, 1.0])):
        jr = dataclasses.replace(jcfg, decode_policy=policy)
        with jax.threefry_partitionable(False):
            jkey, jc = jax.random.PRNGKey(KEY_SEED), jwire.resolve(jr)
            rows = jnp.stack([jc.pack(jnp.asarray(xs[i]), jkey, i, jr) for i in range(n)])
            want = jc.decode_rows_reduce(rows, jkey, jr, D, n,
                                         None if mask is None else jnp.asarray(mask))
        got = codec.decode_rows_reduce(torch.from_numpy(np.array(rows).view(np.int32)),
                                       R.PRNGKey(KEY_SEED), convert.compression_config(jr),
                                       D, n, None if mask is None else torch.tensor(mask))
        np.testing.assert_array_equal(_bits(got), _bits(want))
