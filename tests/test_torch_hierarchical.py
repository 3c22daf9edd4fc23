"""The port's §11 hierarchical two-level schedule (``inner_axes``) and its
multi-axis communicators against the JAX package, inside
``jax.threefry_partitionable(False)``.

The reference's contract (``repro/core/wire/base.py``): the hierarchical
round equals "the exact mean over the inner axes, then the flat codec over
``cfg.axes`` at n_eff = n / n_in nodes".  The inner mean is the
reference's ``pmean`` under ``shard_map``, which XLA on the CPU computes as
the rank-order sum times f32(1/n_in), not as a division, and whose −0.0
columns come out +0.0: the port's ``mean_over`` takes the same steps (an
f32 sum from +0.0 in rank order, times f32(1/n_in)), held here against the
reference's ``shard_map`` run bit for bit at n_in = 2 and 3
(:func:`test_inner_mean_is_the_references_pmean`).

* Meshless parity: the port's round on stacked ``(pod 4, data 2)`` and
  ``(pod 2, data 3)`` meshes, bit for bit against that rule followed by
  the reference's packs per codec rank and its op-by-op decode at n_eff
  (fixed-k's scatter decode as ``decode_gathered_shard`` with nshards =
  n_in concatenated, the other scatter decodes as the flat decode they
  equal), for ``hier_fixed_k`` (with and without scatter),
  ``hier_bernoulli``, a hierarchical ``rotated_fixed_k``, ``ef_bernoulli``
  over 3 steps with residuals carried, and ``binary_packed`` /
  ``ternary_packed`` with ``inner_axes=("data",)``.  The node center μ is
  the reference's own ``jnp.mean`` of the same f32 vector (its order of
  sums is not the port's; tests/test_torch_collective.py holds the port's
  μ to it separately).  n_eff is 4 and 2: the decodes' ``/ n_eff`` is a
  power of two, so the op-by-op reference's division and a jitted
  reference's reciprocal multiply give the same bits.
* The real mesh, one subprocess: the reference's ``shard_map`` on 8 fake
  CPU devices ``(4, 2)`` and on 6 ``(2, 3)``: the inner ``pmean`` on
  Gaussian rows with −0.0 entries; ``hier_fixed_k``, ``hier_bernoulli``
  and ``fixed_k_1bit`` over ``pod`` after the exact in-pod mean; one
  bucketed ``hier_fixed_k`` sync of the smoke tree on ``(4, 2)``; and the
  multi-pod ``fixed_k_1bit`` training sync, per leaf and bucketed, on
  ``(2, 2)``.  The stacked port equals each bit for bit.  Its codec inputs
  are built so that each inner group's mean lies on the 2⁻⁶ grid (rows a +
  b, a − b [, a]): the jitted reference computes μ with its own order of
  sums, which equals the port's only where every partial sum is exact.
* ``DistComm`` over gloo: 4 processes as ``(pod 2, data 2)``, for
  ``hier_bernoulli``, ``hier_fixed_k`` and the multi-pod ``fixed_k_1bit``
  bucketed sync: bit for bit the stacked results, the cross-host bytes of
  one pod group equal to the accounting.
* Accounting: ``cost_config(..., mesh_sizes)`` and ``bucket_wire_bits``
  equal the reference's; the cross-host bytes shrink by exactly n_in
  against the flat all-axes config.
* Shard windows: the hierarchical Bernoulli and binary scatter decodes at
  n_in = 2 and 3 shards, d odd and d = 2·32·64 ± 1, equal the flat decode
  of the same rows.
* Golden bytes: ``hier_fixed_k`` and ``hier_bernoulli`` packed unflattened
  (``axes=("pod",)``, ``inner_axes=("data",)``) match the golden matrix.
"""
import dataclasses
import json
import pathlib
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jregistry
from repro.core import comm_cost as jcost
from repro.core import types as jtypes
from repro.core import wire as jwire
from repro.core.wire import ef as jef
from repro.train import bucketing as jbucketing
from repro_torch import convert
from repro_torch import random as R
from repro_torch.configs import registry as tregistry
from repro_torch.core import collectives as tcoll
from repro_torch.core import comm_cost as tcost
from repro_torch.core import wire as twire
from repro_torch.core.wire import base as twire_base
from repro_torch.train import bucketing as tbucketing
from test_torch_bucketing import _port_cfg
from test_torch_collective import GLOO_INIT_TIMEOUT_S, GlooWorld
from test_torch_rotation import jit_butterfly  # noqa: F401  (fixture)

# one intra-op thread: beside other test workers on a loaded machine, torch's
# thread pool stalls for tens of seconds
torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent
MESHES = {"4x2": {"pod": 4, "data": 2}, "2x3": {"pod": 2, "data": 3}}
D = 4097                  # 2·32·64 + 1: odd, one past the 1-bit plane's word edge
KEY_SEED = 99


def _n(mesh):
    return int(np.prod(list(mesh.values())))


def _hier(name, **kw):
    """A reference preset on the (pod, data) mesh, compressing every size."""
    cfg = jregistry.compression_preset(name)
    if not cfg.inner_axes:
        cfg = dataclasses.replace(cfg, inner_axes=("data",))
    return dataclasses.replace(cfg, min_compress_size=1, **kw)


MATRIX = {
    "hier_fixed_k": _hier("hier_fixed_k"),
    "hier_fixed_k_noscatter": _hier("hier_fixed_k", scatter_decode=False),
    "hier_bernoulli": _hier("hier_bernoulli"),
    "rotated_fixed_k": _hier("rotated_fixed_k"),
    "binary_packed": _hier("binary_packed"),
    "ternary_packed": _hier("ternary_packed"),
}


def _grid_rows(n, d, seed):
    rng = np.random.default_rng(seed)
    x = np.round(rng.standard_normal((n, d)) * 32) / 64
    x += (np.arange(n)[:, None] - n / 2) / 64
    x[:, ::97] = -0.0
    return x.astype(np.float32)


def inner_mean_rule(xs, n_in):
    """The reference's in-pod ``pmean`` under ``shard_map``: per pod, an
    f32 sum from +0.0 over its ranks in rank order, times f32(1/n_in)."""
    x = xs.reshape(-1, n_in, xs.shape[1])
    acc = np.zeros((x.shape[0], x.shape[2]), np.float32)
    for j in range(n_in):
        acc = acc + x[:, j]
    return acc * np.float32(1.0 / n_in)


def _reference_center(x, policy):
    """The reference's μ of the same f32 vector (``jnp.mean``)."""
    assert policy == "mean"
    return torch.tensor(np.asarray(jnp.mean(jnp.asarray(x.numpy()))))


def _flat(jcfg):
    return dataclasses.replace(jcfg, inner_axes=())


def reference_hier_round(jcfg, xs, key, n_in):
    """The rule's inner mean, then the reference's packs per codec rank and
    its decode at n_eff, op by op."""
    v = inner_mean_rule(xs, n_in)
    n, d = v.shape
    flat = _flat(jcfg)
    codec = jwire.resolve(flat)
    rows = jnp.stack([codec.pack(jnp.asarray(v[r]), key, r, flat) for r in range(n)])
    if flat.scatter_decode and codec.name == "fixed_k":
        parts = [codec.decode_gathered_shard(rows, key, flat, d, n, s, n_in)
                 for s in range(n_in)]
        return np.asarray(jnp.concatenate(parts)[:d])
    return np.asarray(codec.decode_gathered(rows, key, flat, d, n))


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("name", sorted(MATRIX))
def test_meshless_round_equals_reference(name, mesh, monkeypatch, jit_butterfly):
    m = MESHES[mesh]
    jcfg = MATRIX[name]
    xs = _grid_rows(_n(m), D, seed=len(name))
    with jax.threefry_partitionable(False):
        want = reference_hier_round(jcfg, xs, jax.random.PRNGKey(KEY_SEED), m["data"])
    monkeypatch.setattr(twire_base, "center", _reference_center)
    cfg = convert.compression_config(jcfg)
    comm = tcoll.StackedComm(device="cpu", mesh=m)
    got = tcoll.compressed_mean(torch.from_numpy(xs), R.PRNGKey(KEY_SEED), cfg, comm).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    codec = twire.resolve(cfg)
    bits = codec.wire_bits(_n(m) // m["data"], D, cfg)
    assert (comm.bytes_gathered + comm.bytes_reduced) * 8 == bits
    assert comm.bytes_inner > 0


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_ef_bernoulli_trajectory_equals_reference(mesh, monkeypatch):
    """ef_bernoulli over 3 steps, residuals carried: the estimates and the
    residuals of each codec rank equal the reference's EF round over the
    rule's inner means; every rank of an inner group holds its codec rank's
    residual."""
    m = MESHES[mesh]
    n, n_in = _n(m), m["data"]
    jcfg = _hier("ef_bernoulli")
    flat = _flat(jcfg)
    inner = jwire.resolve(flat).inner
    xs = np.stack([_grid_rows(n, D, seed=t) for t in range(3)])
    monkeypatch.setattr(twire_base, "center", _reference_center)
    cfg = convert.compression_config(jcfg)
    comm = tcoll.StackedComm(device="cpu", mesh=m)
    state = torch.zeros(n, D)
    e = np.zeros((n // n_in, D), np.float32)
    for t in range(3):
        v = inner_mean_rule(xs[t], n_in)
        with jax.threefry_partitionable(False):
            key = jax.random.fold_in(jax.random.PRNGKey(KEY_SEED), t)
            bufs, new_e = [], []
            for r in range(v.shape[0]):
                vi = jnp.asarray(v[r]) + jnp.asarray(e[r])
                buf, recon = jef._twin_pack_recon(inner, vi, key, r, flat)
                bufs.append(buf)
                new_e.append(np.asarray(vi - recon))
            want = np.asarray(inner.decode_gathered(jnp.stack(bufs), key, flat, D, v.shape[0]))
        e = np.stack(new_e)
        got, st = tcoll.compressed_mean_stateful(torch.from_numpy(xs[t]), state,
                                                 R.fold_in(R.PRNGKey(KEY_SEED), t), cfg, comm)
        assert st.data_ptr() == state.data_ptr()
        np.testing.assert_array_equal(got.numpy().view(np.int32), want.view(np.int32))
        np.testing.assert_array_equal(state.numpy().view(np.int32),
                                      np.repeat(e, n_in, axis=0).view(np.int32))


# --------------------------------------------------------------------------- #
# The real mesh: the reference's shard_map on fake CPU devices.
# --------------------------------------------------------------------------- #

SMOKE_CMP = dict(min_compress_size=2048, bucket=jtypes.BucketSpec(capacity=1 << 14))
MULTIPOD = dataclasses.replace(
    jregistry.get_run_config("qwen3-4b", "train_4k", multi_pod=True).compression, **SMOKE_CMP)


def _structured_rows(mesh, d, seed):
    """Rows whose in-pod mean lies on the 2⁻⁶ grid: per pod a + b, a − b
    (and a at n_in = 3), so every partial sum of μ is exact on both sides."""
    rng = np.random.default_rng(seed)
    pods, n_in = mesh["pod"], mesh["data"]
    a = np.round(rng.standard_normal((pods, d)) * 32) / 64 + np.arange(pods)[:, None] / 64
    b = np.round(rng.standard_normal((pods, d)) * 32) / 64
    rows = [a + b, a - b, a][:n_in]
    x = np.stack(rows, axis=1).reshape(pods * n_in, d)
    x[:, ::97] = -0.0
    return x.astype(np.float32)


def _smoke_tree():
    jcfg = dataclasses.replace(jregistry.smoke_config("qwen3-4b"), vocab_size=256)
    return tregistry.param_shapes(_port_cfg(jcfg))


def _tree_grads(shapes, mesh, seed):
    """(n, *shape) gradients per leaf, on the structured rows."""
    return {k: _structured_rows(mesh, int(np.prod(s)), seed + i).reshape((_n(mesh),) + tuple(s))
            for i, (k, s) in enumerate(sorted(shapes.items()))}


_REF = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
sys.path.insert(0, sys.argv[1])
import dataclasses, functools, json
import jax
jax.config.update("jax_threefry_partitionable", False)
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P
from repro import compat
from repro.core import collectives, types
from repro.train import bucketing, train_step

out_dir = sys.argv[2]
spec = json.load(open(out_dir + "/spec.json"))
inp = dict(np.load(out_dir + "/inputs.npz"))
res = {}
BATCH = ("pod", "data")

def mesh_of(p, q):
    return Mesh(np.array(jax.devices()[:p * q]).reshape(p, q), ("pod", "data"))

def run(mesh, fn, args, in_specs, out_specs):
    f = compat.shard_map(fn, mesh=mesh, in_specs=in_specs, out_specs=out_specs,
                         check_vma=False)
    return jax.jit(f)(*args)

def cfg_of(d):
    d = dict(d)
    d["encoder"] = types.EncoderSpec(**d["encoder"])
    d["bucket"] = types.BucketSpec(**d["bucket"])
    for k in ("axes", "inner_axes"):
        d[k] = tuple(d[k])
    return types.CompressionConfig(**d)

key = jax.random.PRNGKey(spec["key"])
for m, (p, q) in spec["meshes"].items():
    mesh = mesh_of(p, q)
    x = jnp.asarray(inp[f"gauss.{m}"])
    d = x.shape[1]
    res[f"pmean.{m}"] = np.asarray(run(
        mesh, lambda v, d=d: jax.lax.pmean(v.reshape(1, d), ("data",)), (x,),
        (P(BATCH),), P("pod", None)))
    x = jnp.asarray(inp[f"rows.{m}"])
    d = x.shape[1]
    for name, c in spec["rounds"].items():
        cfg = cfg_of(c)
        if cfg.inner_axes:
            fn = lambda v, k, cfg=cfg, d=d: collectives.compressed_mean(v.reshape(d), k, cfg)
        else:
            fn = lambda v, k, cfg=cfg, d=d: collectives.compressed_mean(
                jax.lax.pmean(v.reshape(d), ("data",)), k, cfg)
        res[f"{name}.{m}"] = np.asarray(run(mesh, fn, (x, key), (P(BATCH), P()), P()))

for name, s in spec["syncs"].items():
    p, q = s["pq"]
    mesh = mesh_of(p, q)
    cmp = cfg_of(s["cfg"])
    grads = {k[len(name) + 1:]: jnp.asarray(v) for k, v in inp.items()
             if k.startswith(name + ".")}
    specs = {k: tuple(v) for k, v in s["specs"].items()}
    shapes = {k: tuple(v.shape[1:]) for k, v in grads.items()}
    msizes = {"pod": p, "data": q}
    gspec = {k: P(BATCH, *([None] * len(shapes[k]))) for k in grads}
    if s["bucketed"]:
        plan = bucketing.build_plan(shapes, specs, ("pod", "data"), msizes, cmp)
        fn = lambda g, k: bucketing.sync_grads_bucketed(
            {n: v.reshape(shapes[n]) for n, v in g.items()}, plan, cmp, k)[0]
    else:
        fn = lambda g, k: train_step.sync_grads(
            {n: v.reshape(shapes[n]) for n, v in g.items()}, specs, ("pod", "data"), cmp, k,
            BATCH)[0]
    got = run(mesh, fn, (grads, key), (gspec, P()), {k: P() for k in grads})
    for k, v in got.items():
        res[f"{name}.{k}"] = np.asarray(v)
np.savez(out_dir + "/ref.npz", **res)
"""


def _cfg_json(c):
    return dataclasses.asdict(c)


REAL_ROUNDS = {"hier_fixed_k": _hier("hier_fixed_k"),
               "hier_bernoulli": _hier("hier_bernoulli"),
               "fixed_k_1bit_pod": dataclasses.replace(MULTIPOD, min_compress_size=1)}


def _syncs():
    shapes, specs = _smoke_tree()
    hier = dataclasses.replace(jregistry.compression_preset("hier_fixed_k"), **SMOKE_CMP)
    return {
        "bucketed_hier_fixed_k": ("4x2", hier, True),
        "bucketed_multipod": ("2x2", MULTIPOD, True),
        "per_leaf_multipod": ("2x2", MULTIPOD, False),
    }, shapes, specs


# the reference's shard_map programs on 8 fake CPU devices: 28 s of the
# module's setup alone on an 8-core machine
REF_WAIT_S = 150


@pytest.fixture(scope="module")
def real_mesh(tmp_path_factory):
    """Runs the reference's shard_map programs once; returns (inputs,
    results, syncs)."""
    tmp = tmp_path_factory.mktemp("hier_ref")
    meshes = {k: (v["pod"], v["data"]) for k, v in MESHES.items()}
    meshes["2x2"] = (2, 2)
    inputs = {}
    for m, (p, q) in meshes.items():
        if m == "2x2":
            continue
        rng = np.random.default_rng(p * 10 + q)
        g = rng.standard_normal((p * q, 1001)).astype(np.float32)
        g[:, ::13] = -0.0
        g[:, ::29] = 0.0
        inputs[f"gauss.{m}"] = g
        inputs[f"rows.{m}"] = _structured_rows({"pod": p, "data": q}, D, seed=p + q)
    syncs, shapes, specs = _syncs()
    sync_spec = {}
    for name, (m, cmp, bucketed) in syncs.items():
        p, q = meshes[m]
        for k, v in _tree_grads(shapes, {"pod": p, "data": q}, seed=7).items():
            inputs[f"{name}.{k}"] = v
        sync_spec[name] = {"pq": [p, q], "cfg": _cfg_json(cmp), "bucketed": bucketed,
                           "specs": {k: list(v) for k, v in specs.items()}}
    np.savez(tmp / "inputs.npz", **inputs)
    (tmp / "spec.json").write_text(json.dumps({
        "key": KEY_SEED, "meshes": {k: v for k, v in meshes.items() if k != "2x2"},
        "rounds": {k: _cfg_json(v) for k, v in REAL_ROUNDS.items()},
        "syncs": sync_spec}))
    proc = subprocess.run([sys.executable, "-c", _REF, str(ROOT / "src"), str(tmp)],
                          capture_output=True, text=True, timeout=REF_WAIT_S)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    with np.load(tmp / "ref.npz") as z:
        ref = {k: z[k] for k in z.files}
    return inputs, ref, syncs


def _bits(a):
    return np.asarray(a, np.float32).view(np.int32)


@pytest.mark.parametrize("mesh", sorted(MESHES))
def test_inner_mean_is_the_references_pmean(real_mesh, mesh):
    """``mean_over`` on Gaussian rows with ±0.0 entries equals the
    reference's in-pod ``pmean`` under ``shard_map`` bit for bit; at n_in =
    3 a true division by 3 gives other bits, and −0.0 columns come out
    +0.0."""
    inputs, ref, _ = real_mesh
    m = MESHES[mesh]
    x = torch.from_numpy(inputs[f"gauss.{mesh}"])
    comm = tcoll.StackedComm(device="cpu", mesh=m)
    got = comm.mean_over(x, ("data",)).numpy()
    np.testing.assert_array_equal(_bits(got), _bits(ref[f"pmean.{mesh}"]))
    assert comm.bytes_inner == x.numel() * 4 and comm.bytes_gathered == comm.bytes_reduced == 0
    assert not np.signbit(got[:, ::13]).any()
    if m["data"] == 3:
        div = (x.reshape(m["pod"], 3, -1).sum(1) / 3).numpy()
        assert (_bits(div) != _bits(got)).any()


@pytest.mark.parametrize("mesh", sorted(MESHES))
@pytest.mark.parametrize("name", sorted(REAL_ROUNDS))
def test_stacked_round_equals_shard_map(real_mesh, name, mesh):
    inputs, ref, _ = real_mesh
    m = MESHES[mesh]
    cfg = convert.compression_config(REAL_ROUNDS[name])
    x = torch.from_numpy(inputs[f"rows.{mesh}"])
    comm = tcoll.StackedComm(device="cpu", mesh=m)
    if cfg.inner_axes:
        got = tcoll.compressed_mean(x, R.PRNGKey(KEY_SEED), cfg, comm)
    else:           # fixed_k_1bit over pod after the exact in-pod mean
        got = tcoll.compressed_mean(comm.mean_over(x, ("data",)), R.PRNGKey(KEY_SEED), cfg,
                                    comm.over(("pod",)))
    np.testing.assert_array_equal(_bits(got.numpy()), _bits(ref[f"{name}.{mesh}"]))


@pytest.mark.parametrize("name", ("bucketed_hier_fixed_k", "bucketed_multipod",
                                  "per_leaf_multipod"))
def test_stacked_sync_equals_shard_map(real_mesh, name):
    """A bucketed ``hier_fixed_k`` sync on (4, 2), and the multi-pod
    ``fixed_k_1bit`` training sync per leaf and bucketed on (2, 2), against
    the reference's ``sync_grads_bucketed`` / ``sync_grads`` under
    ``shard_map``, leaf for leaf.  The exact buckets divide by n = 8 or 4 and
    by n_pod = 2: powers of two, where the reference's reciprocal multiply
    is the port's division."""
    from repro_torch.train import train_step as tts

    inputs, ref, syncs = real_mesh
    mesh_name, jcmp, bucketed = syncs[name]
    p, q = {"4x2": (4, 2), "2x2": (2, 2)}[mesh_name]
    mesh = {"pod": p, "data": q}
    shapes, specs = _smoke_tree()
    grads = {k[len(name) + 1:]: torch.from_numpy(v) for k, v in inputs.items()
             if k.startswith(name + ".")}
    cmp = convert.compression_config(jcmp)
    comm = tcoll.StackedComm(device="cpu", mesh=mesh)
    if bucketed:
        plan = tbucketing.build_plan(shapes, specs, ("pod", "data"), mesh, cmp)
        got, _ = tbucketing.sync_grads_bucketed(grads, plan, cmp, R.PRNGKey(KEY_SEED), comm)
        if cmp.mode == "gather_decode":
            want = tbucketing.bucket_wire_bits(plan, cmp, p * q, mesh)
            assert comm.bytes_gathered * 8 == sum(want.values())
    else:
        got, _ = tts.sync_grads(grads, specs, ("pod", "data"), cmp, R.PRNGKey(KEY_SEED), comm)
    assert sorted(got) == sorted(shapes)
    for k in shapes:
        np.testing.assert_array_equal(_bits(got[k].numpy()), _bits(ref[f"{name}.{k}"]),
                                      err_msg=k)


# --------------------------------------------------------------------------- #
# DistComm over gloo, (pod 2, data 2).
# --------------------------------------------------------------------------- #

_GLOO = r"""
import json, sys, numpy as np, torch, torch.distributed as dist
sys.path.insert(0, sys.argv[1])
import dataclasses
from repro_torch import random as R
from repro_torch.configs.registry import compression_preset, get_run_config, param_shapes
from repro_torch.core.collectives import DistComm, compressed_mean
from repro_torch.core import types as t
from repro_torch.train import bucketing
import datetime
rank, port, out = int(sys.argv[2]), sys.argv[3], sys.argv[4]
torch.set_num_threads(1)
dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", world_size=4, rank=rank,
                        timeout=datetime.timedelta(seconds=float(sys.argv[5])))
mesh = {"pod": 2, "data": 2}
inp = dict(np.load(out + "/inputs.npz"))
spec = json.load(open(out + "/spec.json"))
xs = torch.from_numpy(inp["rows"])
res = {}
for name in ("hier_fixed_k", "hier_bernoulli"):
    cfg = dataclasses.replace(compression_preset(name), min_compress_size=1)
    comm = DistComm(device="cpu", mesh=mesh)
    res[name] = compressed_mean(xs[rank:rank + 1], R.PRNGKey(7), cfg, comm).numpy()
    res[name + ".bytes"] = np.array([comm.bytes_gathered, comm.bytes_reduced, comm.bytes_inner])
cmp = dataclasses.replace(get_run_config("qwen3-4b", "train_4k", multi_pod=True).compression,
                          min_compress_size=2048, bucket=t.BucketSpec(capacity=1 << 14))
specs = {k: tuple(v) for k, v in spec["specs"].items()}
grads = {k[5:]: torch.from_numpy(v[rank:rank + 1]) for k, v in inp.items() if k.startswith("grad.")}
shapes = {k: tuple(v.shape[1:]) for k, v in grads.items()}
plan = bucketing.build_plan(shapes, specs, ("pod", "data"), mesh, cmp)
comm = DistComm(device="cpu", mesh=mesh)
got, _ = bucketing.sync_grads_bucketed(grads, plan, cmp, R.PRNGKey(7), comm)
for k, v in got.items():
    res["sync." + k] = v.numpy()
res["sync.bytes"] = np.array([comm.bytes_gathered, comm.bytes_reduced, comm.bytes_inner])
np.savez(f"{out}/out.{rank}.npz", **res)
dist.destroy_process_group()
"""


def test_distcomm_gloo_mesh_equals_stacked(tmp_path):
    mesh = {"pod": 2, "data": 2}
    xs = _structured_rows(mesh, D, seed=5)
    shapes, specs = _smoke_tree()
    grads = _tree_grads(shapes, mesh, seed=11)
    np.savez(tmp_path / "inputs.npz", rows=xs, **{f"grad.{k}": v for k, v in grads.items()})
    (tmp_path / "spec.json").write_text(json.dumps({"specs": {k: list(v)
                                                              for k, v in specs.items()}}))
    GlooWorld(lambda port: [[sys.executable, "-c", _GLOO, str(ROOT / "src"), str(r), port,
                             str(tmp_path), str(GLOO_INIT_TIMEOUT_S)] for r in range(4)]).wait()
    res = [dict(np.load(tmp_path / f"out.{r}.npz")) for r in range(4)]
    for name in ("hier_fixed_k", "hier_bernoulli"):
        cfg = dataclasses.replace(tregistry.compression_preset(name), min_compress_size=1)
        comm = tcoll.StackedComm(device="cpu", mesh=mesh)
        want = tcoll.compressed_mean(torch.from_numpy(xs), R.PRNGKey(7), cfg, comm).numpy()
        for r in range(4):
            np.testing.assert_array_equal(_bits(res[r][name]), _bits(want), err_msg=f"{r}")
            # each pod group gathers n_eff = 2 rows: its two ranks' buffers
            g, red, _ = res[r][name + ".bytes"]
            assert 2 * g == comm.bytes_gathered and red == comm.bytes_reduced == 0
        codec = twire.resolve(cfg)
        assert comm.bytes_gathered * 8 == codec.wire_bits(2, D, cfg)
    cmp = convert.compression_config(MULTIPOD)
    plan = tbucketing.build_plan(shapes, specs, ("pod", "data"), mesh, cmp)
    comm = tcoll.StackedComm(device="cpu", mesh=mesh)
    want, _ = tbucketing.sync_grads_bucketed(convert.tree_to_torch(grads), plan, cmp,
                                             R.PRNGKey(7), comm)
    codec = twire.resolve(cmp)
    wire = sum(codec.wire_bits(2, b.size, cmp) for b in plan.buckets if b.kind == "compressed")
    exact = sum(4 * b.size * 32 for b in plan.buckets if b.kind == "exact")
    assert comm.bytes_reduced * 8 == wire + exact
    for r in range(4):
        for k in shapes:
            np.testing.assert_array_equal(_bits(res[r]["sync." + k]), _bits(want[k].numpy()),
                                          err_msg=f"{r} {k}")
        # each rank hands its pod group its one of the n_eff = 2 wire buffers
        # (so the two ranks of a group hand over the accounting's wire bits)
        # and its row of every exact bucket
        g, red, inner = res[r]["sync.bytes"]
        assert red * 8 == wire / 2 + exact / 4 and 4 * inner == comm.bytes_inner


# --------------------------------------------------------------------------- #
# Accounting, shard windows, golden bytes.
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("name", ("hier_fixed_k", "hier_bernoulli"))
def test_cross_host_bytes_shrink_by_n_in(name):
    """The hierarchical round hands the cross-host link exactly 1/n_in of
    the flat all-axes config's wire, and that equals ``cost_config`` less
    the seed bits at the effective node count."""
    mesh = {"pod": 4, "data": 2}
    xs = torch.from_numpy(_grid_rows(8, D, 1))
    cfg = dataclasses.replace(tregistry.compression_preset(name), min_compress_size=1)
    flat = dataclasses.replace(cfg, axes=("data",), inner_axes=(), scatter_decode=False)
    hier_comm = tcoll.StackedComm(device="cpu", mesh=mesh)
    tcoll.compressed_mean(xs, R.PRNGKey(3), cfg, hier_comm)
    flat_comm = tcoll.StackedComm(8, "cpu")
    tcoll.compressed_mean(xs, R.PRNGKey(3), flat, flat_comm)
    assert flat_comm.bytes_gathered == 2 * hier_comm.bytes_gathered
    codec = twire.resolve(cfg)
    assert (hier_comm.bytes_gathered * 8
            == tcost.cost_config(cfg, n=8, d=D, mesh_sizes=mesh) - codec.seed_bits(4, cfg))


@pytest.mark.parametrize("mesh", ({"pod": 4, "data": 2}, {"pod": 2, "data": 3},
                                  {"pod": 2, "data": 4}))
@pytest.mark.parametrize("name", ("hier_fixed_k", "hier_bernoulli", "fixed_k_1bit",
                                  "rotated_fixed_k", "binary_packed"))
def test_accounting_equals_reference(name, mesh):
    jcfg = jregistry.compression_preset(name)
    if not jcfg.inner_axes:
        jcfg = dataclasses.replace(jcfg, inner_axes=("data",))
    cfg = convert.compression_config(jcfg)
    n = _n(mesh)
    for d in (4097, 1 << 20):
        assert (tcost.cost_config(cfg, n=n, d=d, mesh_sizes=mesh)
                == jcost.cost_config(jcfg, n=n, d=d, mesh_sizes=mesh))
    shapes, specs = _smoke_tree()
    jcmp = dataclasses.replace(jcfg, **SMOKE_CMP)
    plan = jbucketing.build_plan(shapes, specs, ("pod", "data"), mesh, jcmp)
    tplan = tbucketing.build_plan(shapes, specs, ("pod", "data"), mesh,
                                  convert.compression_config(jcmp))
    assert (tbucketing.bucket_wire_bits(tplan, convert.compression_config(jcmp), n, mesh)
            == jbucketing.bucket_wire_bits(plan, jcmp, n, mesh))


@pytest.mark.parametrize("d", (1001, 4095, 4097))
@pytest.mark.parametrize("n_in", (2, 3))
@pytest.mark.parametrize("name", ("hier_bernoulli", "binary_packed", "rotated_fixed_k"))
def test_inner_shard_windows_stitch_to_flat_decode(name, n_in, d):
    """The scatter decode at n_in shards of ⌈d/n_in⌉ (word-aligned for the
    plane; of the rotated estimate at the padded length for the rotation)
    equals the flat decode of the same codec rows bit for bit, the
    Bernoulli windows' Threefry pairs straddling the shards included."""
    mesh = {"pod": 2, "data": n_in}
    cfg = convert.compression_config(_hier(name, scatter_decode=True))
    xs = torch.from_numpy(_grid_rows(2 * n_in, d, seed=d + n_in))
    comm = tcoll.StackedComm(device="cpu", mesh=mesh)
    got = tcoll.compressed_mean(xs, R.PRNGKey(5), cfg, comm)
    v = comm.mean_over(xs, ("data",))
    flat = dataclasses.replace(cfg, axes=("pod",), inner_axes=(), scatter_decode=False)
    want = tcoll.compressed_mean(v, R.PRNGKey(5), flat, tcoll.StackedComm(2, "cpu"))
    assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize("name", ("hier_fixed_k", "hier_bernoulli"))
def test_unflattened_packs_match_golden(name):
    sys.path.insert(0, str(ROOT / "tests" / "golden"))
    import regen_golden_wire as regen

    with np.load(regen.GOLDEN) as z:
        golden = z[f"{name}.bytes"]
    with jax.threefry_partitionable(False):
        xs = np.asarray(jax.random.normal(jax.random.PRNGKey(regen.X_SEED),
                                          (regen.N_RANKS, regen.D)) * 0.5)
    cfg = tregistry.compression_preset(name)
    assert cfg.axes == ("pod",) and cfg.inner_axes == ("data",)
    codec = twire.resolve(cfg)
    key = R.PRNGKey(regen.KEY_SEED)
    rows = [codec.pack(torch.from_numpy(np.array(xs[r])), key, r, cfg)
            .contiguous().view(torch.uint8).numpy() for r in range(regen.N_RANKS)]
    np.testing.assert_array_equal(np.stack(rows), golden)


def test_flat_communicator_refuses_inner_axes():
    cfg = dataclasses.replace(tregistry.compression_preset("hier_bernoulli"), min_compress_size=1)
    with pytest.raises(ValueError, match="mesh"):
        tcoll.compressed_mean(torch.zeros(4, 100), R.PRNGKey(0), cfg,
                              tcoll.StackedComm(4, "cpu"))
    with pytest.raises(ValueError, match="axes"):
        tcoll.compressed_mean(torch.zeros(4, 100), R.PRNGKey(0), cfg,
                              tcoll.StackedComm(device="cpu", mesh={"pod": 2, "model": 2}))
