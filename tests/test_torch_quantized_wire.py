"""The port's packed bit-plane codecs and the dense simulation against the
JAX package, bit for bit.

* codec ``pack`` bytes of ``binary``, ``ternary`` and ``ternary_opt`` at
  f32 and bf16 wires equal the reference's (the golden matrix pins them at
  D = 4096: tests/test_torch_golden_wire.py);
* the flat decode (``decode_gathered``) of the gathered rows, and the §13
  shard decodes (``binary_decode_shard``; ``ternary_shard_syms`` +
  ``ternary_decode_shard`` with the exclusive-cumsum prior counts, a small
  cap overflowing across shards included) equal the reference's functions;
* stacked rounds on ``StackedComm`` of the four codecs, scatter and flat,
  equal the reference's meshless round (its scatter decode equals its
  flat decode);
* the closed forms ``mse_binary``, ``mse_binary_bound`` and ``mse_ternary``
  match the reference's.

JAX calls run inside ``jax.threefry_partitionable(False)``.  The dense
simulation's Bernoulli encoder centers at μ = mean(x): inputs lie on a 2⁻⁶
grid and the port's mean is computed the reference's way (sum × f32(1/d)),
as in tests/test_torch_collective.py.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import compression_preset as jpreset
from repro.core import bitplane as jbp
from repro.core import mse as jmse
from repro.core import optimal as jopt
from repro.core import types as jtypes
from repro.core import wire as jwire
from repro_torch import convert
from repro_torch import random as R
from repro_torch.core import bitplane as tbp
from repro_torch.core import centers as tcenters
from repro_torch.core import collectives as tcoll
from repro_torch.core import comm_cost as tcost
from repro_torch.core import mse as tmse
from repro_torch.core import optimal as topt
from repro_torch.core import wire as twire
from test_torch_collective import _xs, reference_round

# one intra-op thread: beside other test workers on a loaded machine, torch's
# thread pool stalls for tens of seconds
torch.set_num_threads(1)

D = 20_011
KEY_SEED = 99

# the reference's shard functions, compiled once per static shape: they
# only select, add and move bits, which jit leaves as they are (the
# reference's codec rounds run op by op: see test_torch_collective.py)
_binary_shard = jax.jit(jbp.binary_decode_shard, static_argnums=(1, 2, 4, 5))
_ternary_syms = jax.jit(jbp.ternary_shard_syms, static_argnums=(1, 3, 4))
_ternary_shard = jax.jit(jbp.ternary_decode_shard, static_argnums=(3, 4, 5))


def _configs():
    binary = jpreset("binary_packed", axes=("data",))
    ternary = jpreset("ternary_packed", axes=("data",))
    dense = jtypes.CompressionConfig(
        encoder=jtypes.EncoderSpec(kind="bernoulli", fraction=1 / 16, center="mean"),
        mode="dense_sim", axes=("data",))
    return {
        "binary_scatter": binary,
        "binary_flat": dataclasses.replace(binary, scatter_decode=False),
        "ternary_scatter": ternary,
        "ternary_flat": dataclasses.replace(ternary, scatter_decode=False),
        "ternary_opt": jpreset("ternary_opt", axes=("data",)),
        "dense_sim": dense,
    }


def _bits(a):
    return np.ascontiguousarray(np.asarray(a, np.float32)).view(np.uint32)


def _jax_pack_rows(jcfg, xs, key):
    codec = jwire.resolve(jcfg)
    with jax.threefry_partitionable(False):
        return np.stack([np.asarray(codec.pack(jnp.asarray(x), key, r, jcfg))
                         for r, x in enumerate(xs)])


def _port_rows(cfg, xs, key):
    codec = twire.resolve(cfg)
    return torch.stack([codec.pack(torch.from_numpy(x), key, r, cfg) for r, x in enumerate(xs)])


@pytest.mark.parametrize("wire", ("bfloat16", "float32"))
@pytest.mark.parametrize("name", ("binary_flat", "ternary_flat", "ternary_opt"))
def test_pack_bytes_and_flat_decode_equal_reference(name, wire):
    n = 3
    jcfg = dataclasses.replace(_configs()[name], wire_dtype=wire)
    cfg = convert.compression_config(jcfg)
    xs = (np.random.default_rng(7).standard_normal((n, D)) * 0.4).astype(np.float32)
    jkey = jax.random.PRNGKey(KEY_SEED)
    want = _jax_pack_rows(jcfg, xs, jkey)
    got = _port_rows(cfg, xs, R.PRNGKey(KEY_SEED))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)
    codec, jcodec = twire.resolve(cfg), jwire.resolve(jcfg)
    with jax.threefry_partitionable(False):
        jdec = jcodec.decode_gathered(jnp.asarray(want), jkey, jcfg, D, n)
        jone = jcodec.unpack(jnp.asarray(want[1]), 1, jkey, jcfg, D)
    np.testing.assert_array_equal(_bits(codec.decode_gathered(got, None, cfg, D, n)), _bits(jdec))
    np.testing.assert_array_equal(_bits(codec.unpack(got[1], 1, None, cfg, D)), _bits(jone))


@pytest.mark.parametrize("n,d", [(1, 33), (3, 4099), (8, D)])
def test_binary_decode_shard_equals_reference(n, d):
    rng = np.random.default_rng(d)
    pw = jbp.binary_wire_words(d, jnp.bfloat16)
    rows = rng.integers(0, 1 << 32, (n, pw), dtype=np.uint32)
    c = np.sort(rng.standard_normal((n, 2)).astype(np.float32), axis=1)
    for i in range(n):
        rows[i, -1:] = np.asarray(jbp.floats_to_words(jnp.asarray(c[i]), jnp.bfloat16))
    ds = twire.scatter_shard_len(d, n, tbp.BINARY_ALIGN)
    trows = torch.from_numpy(rows.view(np.int32))
    parts = []
    for s in range(n):
        want = _binary_shard(jnp.asarray(rows), d, jnp.bfloat16, s * ds, ds, n)
        got = tbp.binary_decode_shard(trows, d, "bfloat16", s * ds, ds, n)
        np.testing.assert_array_equal(_bits(got), _bits(want))
        parts.append(got)
    flat = sum((tbp.binary_unpack(trows[i], d, "bfloat16") for i in range(n)),
               torch.zeros(d))
    np.testing.assert_array_equal(_bits(torch.cat(parts)[:d]), _bits(flat))


@pytest.mark.parametrize("n,d,cap", [(2, 33, None), (8, D, None), (4, D, 200)])
def test_ternary_shard_decode_equals_reference(n, d, cap):
    """Shard symbols, pass-through counts, prior ranks and shard sums equal
    the reference's; with cap = 200 the overflow ranks fall in later shards."""
    xs = (np.random.default_rng(d + n).standard_normal((n, d)) * 0.3).astype(np.float32)
    cap = cap or tcost.bernoulli_capacity(d, 1 / 16)
    with jax.threefry_partitionable(False):
        rows = np.stack([np.asarray(jbp.ternary_pack(
            jnp.asarray(xs[i]), jax.random.fold_in(jax.random.PRNGKey(5), i), 1 / 16, cap,
            jnp.bfloat16)) for i in range(n)])
    trows = torch.from_numpy(rows.view(np.int32))
    ds = twire.scatter_shard_len(d, n, tbp.TERNARY_ALIGN)
    syms = [tbp.ternary_shard_syms(trows, d, s * ds, ds, n) for s in range(n)]
    counts = torch.stack([(sy == 2).sum(1, dtype=torch.int32) for sy in syms])
    prior = torch.cumsum(counts, 0, dtype=torch.int32) - counts
    parts = []
    for s in range(n):
        jsy = np.asarray(_ternary_syms(jnp.asarray(rows), d, s * ds, ds, n))
        np.testing.assert_array_equal(syms[s].numpy().astype(np.uint32), jsy)
        want = _ternary_shard(jnp.asarray(rows), jnp.asarray(jsy),
                              jnp.asarray(prior[s].numpy()), d, cap, jnp.bfloat16, s * ds)
        got = tbp.ternary_decode_shard(trows, syms[s], prior[s], d, cap, "bfloat16", s * ds)
        np.testing.assert_array_equal(_bits(got), _bits(want))
        parts.append(got)
    flat = torch.zeros(d)
    for i in range(n):
        flat = flat + tbp.ternary_unpack(trows[i], d, cap, "bfloat16")
    np.testing.assert_array_equal(_bits(torch.cat(parts)[:d]), _bits(flat))


def _reference_style_center(x, policy, probs=None):
    """μ as the reference's jnp.mean computes it on the CPU: sum × f32(1/d)."""
    assert policy == "mean"
    return torch.sum(x, -1) * torch.tensor(np.float32(1.0) / np.float32(x.shape[-1]))


def _jax_round(jcfg, xs):
    with jax.threefry_partitionable(False):
        return np.asarray(reference_round(jnp.asarray(xs), jax.random.PRNGKey(KEY_SEED), jcfg))


@pytest.mark.parametrize("n", (2, 8))
@pytest.mark.parametrize("name", sorted(_configs()))
def test_stacked_round_equals_reference(name, n, monkeypatch):
    # D sits below the presets' min_compress_size: compress every bucket
    jcfg = dataclasses.replace(_configs()[name], min_compress_size=1)
    xs = _xs(n, D, seed=n + 20)
    want = _jax_round(jcfg, xs)
    x = torch.from_numpy(xs)
    if name == "dense_sim":
        with jax.threefry_partitionable(False):
            jmus = [float(jnp.mean(jnp.asarray(r))) for r in xs]
        assert [float(_reference_style_center(r, "mean")) for r in x] == jmus
        monkeypatch.setattr(tcenters, "compute_centers", _reference_style_center)
    cfg = convert.compression_config(jcfg)
    comm = tcoll.StackedComm(n, "cpu")
    got = tcoll.compressed_mean(x, R.PRNGKey(KEY_SEED), cfg, comm).numpy()
    np.testing.assert_array_equal(_bits(got), _bits(want))
    codec = twire.resolve(cfg)
    bits = codec.wire_bits(n, D, cfg) + codec.scatter_bits(n, D, cfg)
    assert (comm.bytes_gathered + comm.bytes_reduced) * 8 == bits


def test_closed_forms_match():
    """f32 sums in different orders on the two sides: relative 1e-5."""
    rng = np.random.default_rng(0)
    xs = (rng.standard_normal((4, 30_000)) * 0.1 + rng.standard_normal((1, 30_000)) * 0.2
          + np.arange(4)[:, None] * 1e-3).astype(np.float32)
    jx, tx = jnp.asarray(xs), torch.from_numpy(xs)
    assert float(tmse.mse_binary(tx)) == pytest.approx(float(jmse.mse_binary(jx)), rel=1e-5)
    assert (float(tmse.mse_binary_bound(tx))
            == pytest.approx(float(jmse.mse_binary_bound(jx)), rel=1e-5))
    c1, c2 = xs.min(1), xs.max(1)
    half = (1 - 1 / 16) / 2
    want = float(jmse.mse_ternary(jx, half, half, jnp.asarray(c1), jnp.asarray(c2)))
    got = float(tmse.mse_ternary(tx, half, half, torch.from_numpy(c1), torch.from_numpy(c2)))
    assert got == pytest.approx(want, rel=1e-5)
    jp = [jopt.ternary_optimal_probs(jx[i], 1 / 16) for i in range(4)]
    tp = [topt.ternary_optimal_probs(tx[i], 1 / 16) for i in range(4)]
    want = float(jmse.mse_ternary(jx, jnp.stack([p[0] for p in jp]), jnp.stack([p[1] for p in jp]),
                                  jnp.asarray(c1), jnp.asarray(c2)))
    got = float(tmse.mse_ternary(tx, torch.stack([p[0] for p in tp]),
                                 torch.stack([p[1] for p in tp]),
                                 torch.from_numpy(c1), torch.from_numpy(c2)))
    assert got == pytest.approx(want, rel=1e-5)
