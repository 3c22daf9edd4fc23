"""The port's gradient-bucketing plan and bucketed sync against the JAX
package's ``train/bucketing.py``.

* ``param_shapes`` equals the reference's abstract init (names, global
  shapes, specs) for qwen3-4b at 36 and at 4 layers, pure DP {"data": 8};
* ``build_plan`` equals the reference's (ids, kinds, slots, offsets,
  sizes, readiness) on those trees and on a smoke-size tree with a small
  capacity (multi-leaf buckets);
* ``sync_grads_bucketed`` on the smoke-size tree (vocabulary cut to 256)
  equals the reference's per-bucket rounds run meshless, leaf for leaf,
  bit for bit, for the fixed-k, Bernoulli, binary and ternary presets.

Gradients lie on a 2⁻⁶ grid and the port's center is computed the
reference's way (sum × f32(1/d)), so μ is the same on both sides — see
tests/test_torch_collective.py for why.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jregistry
from repro.core import types as jtypes
from repro.models import model as jmodel
from repro.train import bucketing as jbucketing
from repro_torch import convert
from repro_torch import random as R
from repro_torch.configs import base as tbase_cfg
from repro_torch.configs import registry as tregistry
from repro_torch.core import collectives as tcoll
from repro_torch.core.wire import base as twire_base
from repro_torch.train import bucketing as tbucketing
from test_torch_collective import reference_round

# one intra-op thread: beside other test workers on a loaded machine, torch's
# thread pool stalls for tens of seconds
torch.set_num_threads(1)

MSIZES = {"data": 8}
MESH_AXES = ("data",)


def _jax_tree(cfg, msizes):
    run = jregistry.get_run_config("qwen3-4b", "train_4k")
    ctx = jmodel.make_ctx(cfg, run, msizes)
    aparams, specs = jmodel.init(jax.random.PRNGKey(0), cfg, ctx, msizes, run, abstract=True)
    return {k: tuple(v.shape) for k, v in aparams.items()}, specs


def _port_cfg(jcfg):
    return tbase_cfg.ArchConfig(**{f.name: getattr(jcfg, f.name)
                                   for f in dataclasses.fields(tbase_cfg.ArchConfig)})


def _plan_rows(plan):
    return ([(b.bid, b.kind, tuple(b.caxes), tuple(b.eaxes), b.size, b.ready,
              tuple((s.name, s.offset, s.size, tuple(s.shape)) for s in b.slots))
             for b in plan.buckets], tuple(plan.passthrough), plan.schedule())


@pytest.mark.parametrize("layers", (36, 4))
def test_param_shapes_match_abstract_init(layers):
    jcfg = dataclasses.replace(jregistry.get_config("qwen3-4b"), num_layers=layers)
    want_shapes, want_specs = _jax_tree(jcfg, MSIZES)
    tcfg = dataclasses.replace(tregistry.get_config("qwen3-4b"), num_layers=layers)
    assert _port_cfg(jcfg) == tcfg
    shapes, specs = tregistry.param_shapes(tcfg)
    assert shapes == want_shapes
    assert specs == {k: tuple(v) for k, v in want_specs.items()}


@pytest.mark.parametrize("layers", (36, 4))
@pytest.mark.parametrize("preset", ("fixed_k_1bit", "bernoulli_seed_1bit", None))
def test_build_plan_matches(layers, preset):
    jcfg = dataclasses.replace(jregistry.get_config("qwen3-4b"), num_layers=layers)
    shapes, specs = _jax_tree(jcfg, MSIZES)
    jcmp = (jregistry.compression_preset(preset, axes=MESH_AXES) if preset
            else jtypes.CompressionConfig(mode="none"))
    want = jbucketing.build_plan(shapes, specs, MESH_AXES, MSIZES, jcmp)
    tshapes, tspecs = tregistry.param_shapes(_port_cfg(jcfg))
    got = tbucketing.build_plan(tshapes, tspecs, MESH_AXES, MSIZES,
                                convert.compression_config(jcmp))
    assert _plan_rows(got) == _plan_rows(want)
    if preset and layers == 4:
        comp = sum(b.size for b in got.buckets if b.kind == "compressed")
        assert comp == 792_657_920
        assert (tbucketing.bucket_wire_bits(got, convert.compression_config(jcmp), 8)
                == jbucketing.bucket_wire_bits(want, jcmp, 8))


def _smoke(preset):
    # the smoke tree with its vocabulary cut from 512 to 256: two bucket
    # sizes (16384, 12288) instead of three, and fewer reference compiles
    jcfg = dataclasses.replace(jregistry.smoke_config("qwen3-4b"), vocab_size=256)
    jcmp = dataclasses.replace(
        jregistry.compression_preset(preset, axes=MESH_AXES), min_compress_size=2048,
        bucket=jtypes.BucketSpec(capacity=1 << 14))
    shapes, specs = _jax_tree(jcfg, {"data": 4})
    return jcfg, jcmp, shapes, specs


def test_smoke_plan_has_multi_leaf_buckets():
    jcfg, jcmp, shapes, specs = _smoke("fixed_k_1bit")
    want = jbucketing.build_plan(shapes, specs, MESH_AXES, {"data": 4}, jcmp)
    tshapes, tspecs = tregistry.param_shapes(_port_cfg(jcfg))
    got = tbucketing.build_plan(tshapes, tspecs, MESH_AXES, {"data": 4},
                                convert.compression_config(jcmp))
    assert _plan_rows(got) == _plan_rows(want)
    assert any(len(b.slots) > 1 for b in got.buckets if b.kind == "compressed")
    assert any(b.kind == "exact" for b in got.buckets)


def _grads(shapes, n, seed):
    rng = np.random.default_rng(seed)
    return {k: (np.round(rng.standard_normal((n,) + s) * 32) / 64).astype(np.float32)
            for k, s in sorted(shapes.items())}


def _jax_bucketed(grads, plan, jcmp, key, n):
    """The reference's sync_grads_bucketed, one bucket at a time, meshless."""
    out = {}
    with jax.threefry_partitionable(False):
        for j, b in enumerate(plan.buckets):
            v = np.concatenate([grads[s.name].reshape(n, -1) for s in b.slots], axis=1)
            if b.kind == "exact" or b.size < jcmp.min_compress_size:
                acc = np.zeros(b.size, np.float32)
                for r in range(n):
                    acc = acc + v[r]
                y = acc / np.float32(n)
            else:
                lcfg = jbucketing._bucket_cfg(b, jcmp, error_feedback=False)
                y = np.asarray(reference_round(jnp.asarray(v), jax.random.fold_in(key, j), lcfg))
            for s in b.slots:
                out[s.name] = y[s.offset:s.offset + s.size].reshape(s.shape)
    return out


@pytest.mark.parametrize("preset", ("fixed_k_1bit", "bernoulli_seed_1bit", "binary_packed",
                                    "ternary_packed", "ternary_opt"))
def test_sync_grads_bucketed_equals_reference(preset, monkeypatch):
    n = 4
    jcfg, jcmp, shapes, specs = _smoke(preset)
    plan = jbucketing.build_plan(shapes, specs, MESH_AXES, {"data": 4}, jcmp)
    grads = _grads(shapes, n, seed=3)
    want = _jax_bucketed(grads, plan, jcmp, jax.random.PRNGKey(5), n)

    def center(x, policy):
        return torch.sum(x) * torch.tensor(np.float32(1.0) / np.float32(x.numel()))

    monkeypatch.setattr(twire_base, "center", center)
    cmp = convert.compression_config(jcmp)
    tshapes, tspecs = tregistry.param_shapes(_port_cfg(jcfg))
    tplan = tbucketing.build_plan(tshapes, tspecs, MESH_AXES, {"data": 4}, cmp)
    comm = tcoll.StackedComm(n, "cpu")
    got, ef = tbucketing.sync_grads_bucketed(convert.tree_to_torch(grads), tplan, cmp,
                                             R.PRNGKey(5), comm)
    assert ef is None
    assert sorted(got) == sorted(want)
    for name in want:
        np.testing.assert_array_equal(got[name].numpy(), want[name], err_msg=name)


def test_pack_unpack_round_trip():
    grads = convert.tree_to_torch(_grads({"a": (3, 5), "b": (7,)}, 2, 0))
    b = tbucketing.Bucket("exact:-:data:0", "exact", (), ("data",),
                          (tbucketing.LeafSlot("a", 0, 15, (3, 5)),
                           tbucketing.LeafSlot("b", 15, 7, (7,))), 22)
    v = tbucketing.pack_bucket(grads, b)
    assert v.shape == (2, 22)
    back = tbucketing.unpack_bucket(v[1], b, grads)
    assert torch.equal(back["a"], grads["a"][1]) and torch.equal(back["b"], grads["b"][1])
