"""FSDP on a mesh with a ``pod`` axis (the reference's multi-pod run of its
FSDP archs) in the port's train step, against the JAX package's and
against itself.

* The reference, in one subprocess on 4 fake CPU devices (started as the
  module's first test starts, beside the port-only tests), runs its
  ``build_train_step`` with ``fsdp=True`` and the compression over ``pod``
  on a (pod 2, data 2, model 1) mesh for 2 steps: the dense smoke under
  ``none``, ``fixed_k_1bit`` (1 and 2 microbatches) and ``ef_fixed_k``, and
  the MoE smoke under ``fixed_k_1bit`` with each rank's routes recorded.
  Its parameters are the port's whole arrays placed with ``NamedSharding``
  (its FSDP ``init_fn`` repeats one draw per data shard).  It also
  restores the port's (pod 2, data 2) FSDP checkpoint onto its mesh.
* The port's stacked (pod 2, data 2) step matches those runs under
  ``tests/test_torch_fsdp.py``'s bf16 limits (the MoE on the reference's
  routes); its bucket plan is the reference's; FSDP on against off from
  the same parameters; the per-data-coordinate rounds of ``by_shard``.
* Four gloo processes (``DistComm`` on the (pod 2, data 2) mesh, each
  holding its data coordinate's shards) bit-equal to the stacked step;
  checkpoints across meshes, both ways.
"""
import contextlib
import dataclasses
import json
import math
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.configs import registry as jregistry
from repro.train import bucketing as jbucketing
from repro_torch import convert
from repro_torch import random as prandom
from repro_torch.checkpoint import checkpointing as ckpt
from repro_torch.configs import registry as tregistry
from repro_torch.configs.base import RunConfig, ShapeSpec
from repro_torch.core import collectives as tcoll
from repro_torch.core import types as ttypes
from repro_torch.core.wire.base import NotPortedError
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.models import model as tmodel
from repro_torch.models import moe as tmoe
from repro_torch.optim import optimizers as topt
from repro_torch.train import bucketing as tbucketing
from repro_torch.train import train_step as tts
from repro_torch.train.trainer import Trainer, TrainerConfig

# one intra-op thread: beside other test workers on a loaded machine, torch's
# thread pool stalls for tens of seconds
torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent
DENSE, MOE = "mistral-large-123b", "qwen2-moe-a2.7b"
MESH = {"pod": 2, "data": 2}
B, S = 8, 32            # two rows a rank: one microbatch of 2 or two of 1
SHAPE = ShapeSpec("fsdp_pod", "train", S, B)
# tests/test_torch_fsdp.py's limits: tests/test_torch_training.py's bf16
# limits on the loss, grad norm and moments, and one bf16 rounding of a rank sum
LOSS_TOL, GRAD_TOL = 1e-3, 5e-2
SUM_RTOL = 2.0 ** -9
# the reference's runs: name -> (arch, preset or "none", microbatches)
REF_RUNS = {"dense-none-mb1": (DENSE, "none", 1),
            "dense-fixed_k_1bit-mb1": (DENSE, "fixed_k_1bit", 1),
            "dense-fixed_k_1bit-mb2": (DENSE, "fixed_k_1bit", 2),
            "dense-ef_fixed_k-mb1": (DENSE, "ef_fixed_k", 1),
            "moe-fixed_k_1bit-mb1": (MOE, "fixed_k_1bit", 1)}
REF_WAIT_S = 300


def _cmp(preset: str) -> ttypes.CompressionConfig:
    if preset == "none":
        return ttypes.CompressionConfig(mode="none")
    return dataclasses.replace(tregistry.compression_preset(preset, axes=("pod",)),
                               min_compress_size=1024)


def _run(arch: str, preset: str, mb: int, fsdp: bool = True, overlap: bool = True) -> RunConfig:
    # no remat for the MoE: each layer routes once a forward, as recorded
    cmp = _cmp(preset)
    cmp = dataclasses.replace(cmp, bucket=dataclasses.replace(cmp.bucket, overlap=overlap))
    return RunConfig(microbatches=mb, fsdp=fsdp, attn_chunk_q=16, attn_chunk_k=16,
                     remat=arch != MOE, compression=cmp)


def _params(arch: str):
    """The port's draw of the smoke config's whole parameters (numpy)."""
    cfg = tregistry.smoke_config(arch)
    return {k: v.numpy() for k, v in tmodel.init(0, cfg, device="cpu").items()}


def _rel(got, want) -> float:
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(np.asarray(got, np.float64) - want) / np.linalg.norm(want))


def _bits(a):
    return np.asarray(a).view(np.int32)


def _fit(arch: str, mesh, steps: int, ckpt_dir=None, seed: int = 0):
    tr = Trainer(tregistry.smoke_config(arch), _run(arch, "fixed_k_1bit", 1), SHAPE,
                 TrainerConfig(steps=steps, ckpt_dir=ckpt_dir, ckpt_every=steps, log_every=1,
                               seed=seed),
                 device="cpu", mesh=mesh)
    return tr, tr.fit()


# ------------------------------------------------------------ the reference

_REF = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
sys.path.insert(0, sys.argv[1])
import dataclasses, json
import jax
jax.config.update("jax_threefry_partitionable", False)
import jax.numpy as jnp
import numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.checkpoint import checkpointing as jckpt
from repro.configs.base import RunConfig, ShapeSpec
from repro.configs.registry import compression_preset, smoke_config
from repro.core import types as jtypes
from repro.data.pipeline import SyntheticLM
from repro.models import moe as jmoe
from repro.optim import optimizers as jopt
from repro.train import bucketing as jbucketing
from repro.train import train_step as jts

out = sys.argv[2]
spec = json.load(open(out + "/spec.json"))
res = {}
mesh = jax.make_mesh((2, 2, 1), ("pod", "data", "model"))
order = [d.id for d in mesh.devices.flat]      # the devices in rank order
shape = ShapeSpec("fsdp_pod", "train", spec["seq"], spec["batch"])

def run_config(arch, c, mb):
    if c == "none":
        cmp = jtypes.CompressionConfig(mode="none")
    else:
        cmp = dataclasses.replace(compression_preset(c, axes=("pod",)), min_compress_size=1024)
    return RunConfig(microbatches=mb, fsdp=True, attn_chunk_q=16, attn_chunk_k=16,
                     remat=arch != "qwen2-moe-a2.7b", compression=cmp)

def by_rank(arr):
    got = {s.device.id: np.asarray(s.data) for s in arr.addressable_shards}
    return np.stack([got[i] for i in order])

for name, (arch, c, mb) in spec["runs"].items():
    jcfg = smoke_config(arch)
    run = run_config(arch, c, mb)
    step_fn, init_fn, specs, bspecs, plan = jts.build_train_step(mesh, jcfg, run, shape)
    whole = dict(np.load(f"{out}/{arch}.params.npz"))
    params = {k: jax.device_put(v, NamedSharding(mesh, P(*specs[k]))) for k, v in whole.items()}
    opt = jopt.adamw_init(params)
    if run.compression.error_feedback:
        ef = jbucketing.init_ef_state(plan, run.compression)
    else:
        ef = jax.tree.map(lambda p: jnp.zeros((), jnp.float32), params)
    data = SyntheticLM(jcfg, shape)
    log = []
    block = jmoe.moe_block

    def recorded(ctx, p, x, cfg):
        t = x.shape[0] * x.shape[1]
        logits = jnp.einsum("td,de->te", x.reshape(t, -1).astype(jnp.float32),
                            p["router"].astype(jnp.float32))
        ids = jax.lax.top_k(jax.nn.softmax(logits, axis=-1), cfg.top_k)[1]
        r = jax.lax.axis_index("pod") * 2 + jax.lax.axis_index("data")
        jax.debug.callback(lambda r, i: log.append((int(r), np.asarray(i))), r, ids)
        return block(ctx, p, x, cfg)

    jmoe.moe_block = recorded
    try:
        for step in range(2):
            params, opt, ef, m = step_fn(params, opt, ef, data.device_batch(step, mesh, bspecs),
                                         jnp.int32(step))
            jax.effects_barrier()
            for k in ("loss", "grad_norm", "lr"):
                res[f"{name}.{step}.{k}"] = np.asarray(m[k])
            for r in range(4):
                calls = [i for rr, i in log if rr == r]
                if calls:
                    res[f"{name}.{step}.routes.{r}"] = np.stack(calls)
            log.clear()
    finally:
        jmoe.moe_block = block
    for k in params:
        res[f"{name}.p.{k}"] = np.asarray(params[k])
        res[f"{name}.m.{k}"] = np.asarray(opt.m[k])
        res[f"{name}.v.{k}"] = np.asarray(opt.v[k])
    if run.compression.error_feedback:
        for j, b in enumerate(plan.buckets):
            if b.bid in ef:
                res[f"{name}.ef.{j}"] = by_rank(ef[b.bid])

# the port's (pod 2, data 2) FSDP checkpoint, restored onto the same mesh
template = jopt.AdamWState(step=None, m={}, v={})
step, params, opt, _ = jckpt.restore(out + "/ckpt", mesh, None, template)
res["ckpt.step"] = np.asarray(step)
for k in params:
    res[f"ckpt.p.{k}"] = np.asarray(params[k])
    res[f"ckpt.m.{k}"] = np.asarray(opt.m[k])
    res[f"ckpt.spec.{k}"] = np.asarray(str(params[k].sharding.spec))
np.savez(out + "/ref.npz", **res)
"""


@pytest.fixture(scope="module", autouse=True)
def _reference_run(tmp_path_factory):
    """Writes the parameters and a (pod 2, data 2) FSDP checkpoint of the
    port, then starts the reference's subprocess as the module's first test
    starts; :func:`reference` waits for it."""
    tmp = tmp_path_factory.mktemp("fsdp_pod_ref")
    for arch in (DENSE, MOE):
        np.savez(tmp / f"{arch}.params.npz", **_params(arch))
    _fit(DENSE, MESH, 2, str(tmp / "ckpt"))
    (tmp / "spec.json").write_text(json.dumps({"runs": REF_RUNS, "seq": S, "batch": B}))
    proc = subprocess.Popen([sys.executable, "-c", _REF, str(ROOT / "src"), str(tmp)],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                            env={**os.environ, "JAX_PLATFORMS": "cpu"})
    yield tmp, proc
    if proc.poll() is None:
        proc.kill()
        proc.wait()


@pytest.fixture(scope="module")
def reference(_reference_run):
    tmp, proc = _reference_run
    out = proc.communicate(timeout=REF_WAIT_S)[0]
    assert proc.returncode == 0, out
    with np.load(tmp / "ref.npz") as z:
        return {k: z[k] for k in z.files}


# ------------------------------------------------------------ the port alone

def _as_tuple(plan, drop=()):
    """A plan's buckets as plain tuples, the axes in ``drop`` left out of
    their ids and exact axes."""
    def ax(axes):
        return tuple(a for a in axes if a not in drop)

    def bid(b):
        kind, c, e, i = b.bid.split(":")
        e = "+".join(ax(e.split("+"))) if e != "-" else "-"
        return ":".join((kind, c, e or "-", i))

    return [(bid(b), b.kind, tuple(b.caxes), ax(b.eaxes), b.size, b.ready,
             [(s.name, s.offset, s.size, tuple(s.shape)) for s in b.slots])
            for b in plan.buckets]


def _cfg_fields(c):
    return (tuple(c.axes), tuple(c.inner_axes), c.scatter_decode, c.error_feedback, c.mode,
            c.min_compress_size)


@pytest.mark.parametrize("preset", ["fixed_k_1bit", "hier_fixed_k", "ef_fixed_k", "none"])
def test_plan_with_a_pod_axis_is_the_reference_s(preset):
    """The FSDP leaves' shard buckets sync over pod alone, the others over
    (pod, data): ids, slots (the local shards), sizes, readiness — hence
    the keys and the sync points — and each bucket's codec config equal the
    reference's, on the same mesh, and for the dense and MoE smokes on its
    (pod, data, model 1) mesh less the model axis.  Under ``hier_fixed_k`` a shard bucket has no inner axis
    and loses ``scatter_decode``; the others keep both."""
    for arch in (DENSE, MOE, "jamba-v0.1-52b"):
        cfg = tregistry.smoke_config(arch)
        shapes, specs = tregistry.param_shapes(cfg, fsdp="data")
        cmp = _cmp(preset)
        jcmp = (jregistry.compression_preset(preset, axes=("pod",)) if preset != "none"
                else cmp)
        jcmp = dataclasses.replace(jcmp, min_compress_size=1024)
        got = tbucketing.build_plan(shapes, specs, tuple(MESH), MESH, cmp)
        same = jbucketing.build_plan(shapes, specs, tuple(MESH), MESH, jcmp)
        full = jbucketing.build_plan(shapes, specs, ("pod", "data", "model"),
                                     {**MESH, "model": 1}, jcmp)
        assert _as_tuple(got) == _as_tuple(same), arch
        if arch == "jamba-v0.1-52b":
            # its SSM leaves shard over data but name no model axis: on the
            # reference's mesh a model axis of 1 gives them a bucket of their
            # own, and the buckets after it other positions (other keys)
            assert _as_tuple(full, drop=("model",)) != _as_tuple(same)
            continue
        assert _as_tuple(same) == _as_tuple(full, drop=("model",)), arch
        assert not got.passthrough and not full.passthrough
        dims = tts.fsdp_leaf_dims(specs)
        for b, jb in zip(got.buckets, full.buckets):
            sharded = {s.name for s in b.slots} <= set(dims)
            assert sharded == (tbucketing.held_axes(b, tcoll.StackedComm(device="cpu",
                                                                         mesh=MESH)) == ("data",))
            if sharded:
                assert b.caxes + b.eaxes == ("pod",)
                assert all(s.shape == tbucketing.local_shape(shapes[s.name], specs[s.name], MESH)
                           for s in b.slots)
            if b.kind == "compressed":
                mine = tbucketing._bucket_cfg(b, cmp, error_feedback=False)
                theirs = jbucketing._bucket_cfg(jb, jcmp, error_feedback=False)
                assert _cfg_fields(mine) == _cfg_fields(theirs), (arch, b.bid)
                if preset == "hier_fixed_k":
                    assert mine.scatter_decode == (not sharded), b.bid
                    assert mine.inner_axes == (() if sharded else ("data",)), b.bid


def test_by_shard_runs_each_data_coordinate_with_the_same_keys():
    """``by_shard(("data",))``: each data coordinate's rows (a view of the
    stack), the communicator over pod; a round on them is the round of a
    (pod) communicator on those rows alone, keys and bytes included: n_data
    times one round's bytes."""
    rng = np.random.default_rng(4)
    cmp = dataclasses.replace(_cmp("fixed_k_1bit"), axes=("pod",))
    key = prandom.PRNGKey(7)
    for mesh in ({"pod": 2, "data": 2}, {"pod": 2, "data": 3}):
        n = math.prod(mesh.values())
        x = torch.from_numpy(rng.standard_normal((n, 4096)).astype(np.float32))
        comm = tcoll.StackedComm(device="cpu", mesh=mesh)
        groups = comm.by_shard(("data",))
        assert len(groups) == mesh["data"]
        for d, (rows, sub) in enumerate(groups):
            assert list(range(n))[rows] == list(range(d, n, mesh["data"]))
            assert isinstance(rows, slice) and sub.axes == ("pod",)
            assert x[rows].data_ptr() == x[d].data_ptr()
            got = tcoll.compressed_mean(x[rows], key, cmp, sub)
            alone = tcoll.StackedComm(device="cpu", mesh={"pod": 2})
            want = tcoll.compressed_mean(x[d::mesh["data"]].clone(), key, cmp, alone)
            assert torch.equal(got, want)
        one = alone.bytes_reduced
        assert comm.bytes_reduced == mesh["data"] * one > 0
    # a coordinate's rows are a view of the stack, never a copy
    assert tcoll._index([2]) == slice(2, 3, 1)
    with pytest.raises(ValueError):
        tcoll._index([0, 1, 3])


def test_fsdp_on_against_off_with_a_pod_axis():
    """From the same parameters under ``none``: the unsharded leaves take
    the same exact mean over (pod, data), bit for bit; each FSDP leaf is the
    mean over pod of each pod's data sum, n_data × the exact mean within
    one bf16 rounding."""
    cfg = tregistry.smoke_config(DENSE)
    synced = {}
    for fsdp in (False, True):
        seen = {}
        step_fn, init_fn, _ = tts.build_train_step(
            cfg, _run(DENSE, "none", 1, fsdp), SHAPE, device="cpu", mesh=MESH,
            on_phase=lambda name, **st: seen.update(st) if name == "sync" else None)
        step_fn(*init_fn(0), SyntheticLM(cfg, SHAPE).batch(0, "cpu"), 0)
        synced[fsdp] = seen["synced"]
    dims = tts.fsdp_leaf_dims(tregistry.param_shapes(cfg, fsdp="data")[1])
    assert len(dims) == 7 and sorted(synced[True]) == sorted(synced[False])
    rel = {}
    for k, off in synced[False].items():
        on = synced[True][k]
        assert on.shape == off.shape, k
        if k in dims:
            rel[k] = _rel(on.numpy(), MESH["data"] * off.numpy())
        else:
            assert torch.equal(on, off), k
    assert max(rel.values()) <= SUM_RTOL, rel


def test_per_leaf_sync_with_a_pod_axis_raises():
    cmp = _cmp("fixed_k_1bit")
    cmp = dataclasses.replace(cmp, bucket=dataclasses.replace(cmp.bucket, enabled=False))
    run = dataclasses.replace(_run(DENSE, "fixed_k_1bit", 1), compression=cmp)
    with pytest.raises(NotPortedError, match="per-leaf"):
        tts.build_train_step(tregistry.smoke_config(DENSE), run, SHAPE, device="cpu", mesh=MESH)


@pytest.mark.parametrize("preset", ["fixed_k_1bit", "ef_fixed_k", "hier_fixed_k"])
def test_both_schedules_give_the_same_bits(preset):
    """The backward-pipelined schedule (the last rank's sync points add its
    cotangents into the last pod's sum, then run every bucket's rounds) and
    the post-backward one end bit-equal after two steps, residuals
    included."""
    cfg = tregistry.smoke_config(DENSE)
    data = SyntheticLM(cfg, SHAPE)
    ends = []
    for overlap in (True, False):
        step_fn, init_fn, plan = tts.build_train_step(
            cfg, _run(DENSE, preset, 1, overlap=overlap), SHAPE, device="cpu", mesh=MESH)
        assert tts.overlap_enabled(plan, _run(DENSE, preset, 1, overlap=overlap)) == overlap
        params, opt, ef = init_fn(0)
        for step in range(2):
            params, opt, ef, m = step_fn(params, opt, ef, data.batch(step, "cpu"), step)
        ends.append((params, opt, ef, m))
    (p0, o0, e0, m0), (p1, o1, e1, m1) = ends
    assert torch.equal(m0["loss"], m1["loss"]) and torch.equal(m0["grad_norm"], m1["grad_norm"])
    for k in p0:
        assert torch.equal(p0[k], p1[k]) and torch.equal(o0.v[k], o1.v[k]), k
    assert sorted(e0) == sorted(e1) and all(torch.equal(e0[b], e1[b]) for b in e0)


def test_checkpoints_restore_across_meshes(tmp_path):
    """A (pod 2, data 2) run's checkpoint resumes a run on a lone data axis
    of 2 and of 4, and a data-4 run's checkpoint resumes a (pod 2, data 2)
    run: whole leaves, the same state."""
    cfg = tregistry.smoke_config(DENSE)
    run = _run(DENSE, "fixed_k_1bit", 1)
    for i, (first, then) in enumerate(((MESH, {"data": 2}), (MESH, {"data": 4}),
                                       ({"data": 4}, MESH))):
        d = str(tmp_path / f"ckpt{i}")
        _, (p, o, _) = _fit(DENSE, first, 2, d)
        tr = Trainer(cfg, run, SHAPE, TrainerConfig(steps=3, ckpt_dir=d, ckpt_every=3,
                                                    log_every=1), device="cpu", mesh=then)
        start, params, opt, _ = tr.init_or_restore()
        assert start == 2 and all(torch.equal(params[k], p[k]) and torch.equal(opt.v[k], o.v[k])
                                  for k in p), (first, then)
        _, _, hist = tr.fit()
        assert [h["step"] for h in hist] == [2] and math.isfinite(hist[0]["loss"])


# ----------------------------------------------------- one rank a process

GLOO_RUNS = {"moe": (MOE, "fixed_k_1bit", 1), "dense-mb2": (DENSE, "fixed_k_1bit", 2),
             "dense-ef": (DENSE, "ef_fixed_k", 1), "dense-hier": (DENSE, "hier_fixed_k", 1)}

_WORKER = r"""
import datetime, json, sys
sys.path.insert(0, sys.argv[1])
sys.path.insert(0, sys.argv[2])
import numpy as np, torch, torch.distributed as dist
torch.set_num_threads(1)
import test_torch_fsdp_pod as t
from repro_torch.configs import registry
from repro_torch.core.collectives import DistComm
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.train import train_step as tts
from repro_torch.train.trainer import Trainer, TrainerConfig
rank, port, out = int(sys.argv[3]), sys.argv[4], sys.argv[5]
timeout = datetime.timedelta(seconds=float(sys.argv[6]))
dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", world_size=4,
                        rank=rank, timeout=timeout)
comm = DistComm(device="cpu", mesh=t.MESH, timeout=timeout)
res = {"data_rank": np.array(comm.over(("data",)).rank),
       "pod_rank": np.array(comm.over(("pod",)).rank)}
for name, (arch, preset, mb) in t.GLOO_RUNS.items():
    cfg = registry.smoke_config(arch)
    step_fn, init_fn, _ = tts.build_train_step(cfg, t._run(arch, preset, mb), t.SHAPE,
                                               device="cpu", comm=comm)
    params, opt, ef = init_fn(0)
    data = SyntheticLM(cfg, t.SHAPE)
    comm.reset_bytes()
    for step in range(2):
        params, opt, ef, m = step_fn(params, opt, ef, data.batch(step, "cpu"), step)
        res[f"{name}.loss.{step}"] = m["loss"].numpy()
        res[f"{name}.gnorm.{step}"] = m["grad_norm"].numpy()
    res[f"{name}.bytes"] = np.array([comm.bytes_fsdp, comm.bytes_inner,
                                     comm.bytes_gathered + comm.bytes_reduced])
    for k in params:
        res[f"{name}.p.{k}"] = params[k].numpy()
        res[f"{name}.v.{k}"] = opt.v[k].numpy()
    for b, e in ef.items():
        res[f"{name}.ef.{b}"] = e.numpy()
# restore the data-4 checkpoint on the (pod 2, data 2) mesh, then save whole
cfg = registry.smoke_config(t.DENSE)
tr = Trainer(cfg, t._run(t.DENSE, "fixed_k_1bit", 1), t.SHAPE,
             TrainerConfig(steps=3, ckpt_dir=sys.argv[7], ckpt_every=3, log_every=1),
             device="cpu", comm=comm)
start, params, opt, _ = tr.init_or_restore()
res["restored.start"] = np.array(start)
for k in params:
    res[f"restored.p.{k}"] = params[k].numpy()
tr.fit()
np.savez(f"{out}/rank{rank}.npz", **res)
dist.destroy_process_group()
"""


@pytest.fixture(scope="module")
def gloo_run(tmp_path_factory):
    """Four gloo workers on the (pod 2, data 2) mesh (see ``_WORKER``),
    after a data-4 stacked run has written the checkpoint they restore;
    returns the directory."""
    from test_torch_collective import GLOO_INIT_TIMEOUT_S, GlooWorld

    tmp = tmp_path_factory.mktemp("fsdp_pod_gloo")
    _fit(DENSE, {"data": 4}, 2, str(tmp / "ckpt"))
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    GlooWorld(lambda port: [[sys.executable, "-c", _WORKER, str(ROOT / "src"),
                             str(ROOT / "tests"), str(r), port, str(tmp),
                             str(GLOO_INIT_TIMEOUT_S), str(tmp / "ckpt")]
                            for r in range(4)], env=env).wait(timeout=240)
    return tmp


def _rank(tmp, r):
    with np.load(tmp / f"rank{r}.npz") as z:
        return {k: z[k] for k in z.files}


@pytest.mark.parametrize("name", sorted(GLOO_RUNS))
def test_distcomm_step_with_a_pod_axis_equals_stacked(gloo_run, name):
    """Each process holds its data coordinate's shards; two steps end
    bit-equal to the stacked step's state cut into the same shards (every
    pod the same), with the same losses, norms and residual rows; each
    process hands bytes to its data group (FSDP) and its pod group (the
    codec)."""
    arch, preset, mb = GLOO_RUNS[name]
    cfg = tregistry.smoke_config(arch)
    step_fn, init_fn, plan = tts.build_train_step(cfg, _run(arch, preset, mb), SHAPE,
                                                  device="cpu", mesh=MESH)
    params, opt, ef = init_fn(0)
    data = SyntheticLM(cfg, SHAPE)
    metrics = []
    for step in range(2):
        params, opt, ef, m = step_fn(params, opt, ef, data.batch(step, "cpu"), step)
        metrics.append(m)
    specs = tregistry.param_shapes(cfg, fsdp="data")[1]
    dims = tts.fsdp_leaf_dims(specs)
    for r in range(4):
        got = _rank(gloo_run, r)
        d = int(got["data_rank"])
        assert (d, int(got["pod_rank"])) == (r % 2, r // 2)
        for step, m in enumerate(metrics):
            assert _bits(got[f"{name}.loss.{step}"]) == _bits(m["loss"].numpy())
            assert _bits(got[f"{name}.gnorm.{step}"]) == _bits(m["grad_norm"].numpy())
        for k in params:
            for pre, t in (("p", params[k]), ("v", opt.v[k])):
                want = convert.fsdp_shard(t, specs[k], d, 2) if k in dims else t
                np.testing.assert_array_equal(_bits(got[f"{name}.{pre}.{k}"]),
                                              _bits(want.contiguous().numpy()),
                                              err_msg=f"{r} {pre}.{k}")
        for b, e in ef.items():
            np.testing.assert_array_equal(_bits(got[f"{name}.ef.{b}"]), _bits(e[r:r + 1].numpy()),
                                          err_msg=f"{r} ef {b}")
        assert all(int(x) > 0 for x in got[f"{name}.bytes"]), got[f"{name}.bytes"]


def test_distcomm_restores_the_data4_checkpoint_on_the_pod_mesh(gloo_run):
    """Each process restores its data coordinate's slices of a data-4
    checkpoint; rank 0's save at step 3 writes the leaves whole."""
    step, whole, _, _ = ckpt.restore(str(gloo_run / "ckpt"), None,
                                     topt.AdamWState(None, {}, {}), step=2, device="cpu")
    specs = tregistry.param_shapes(tregistry.smoke_config(DENSE), fsdp="data")[1]
    dims = tts.fsdp_leaf_dims(specs)
    for r in range(4):
        got = _rank(gloo_run, r)
        assert int(got["restored.start"]) == step == 2
        for k, v in whole.items():
            want = convert.fsdp_shard(v, specs[k], r % 2, 2) if k in dims else v
            np.testing.assert_array_equal(got[f"restored.p.{k}"], want.numpy(), err_msg=k)
    _, saved, _, _ = ckpt.restore(str(gloo_run / "ckpt"), specs, topt.AdamWState(None, {}, {}),
                                  step=3, device="cpu")
    assert all(tuple(saved[k].shape) == tuple(s) for k, s in
               tregistry.param_shapes(tregistry.smoke_config(DENSE))[0].items())


# -------------------------------------------- the step against the reference

@contextlib.contextmanager
def _forced(calls):
    """Within the span the port's ``moe.route`` takes the expert ids of
    ``calls`` in order, gated with its own probabilities."""
    route = tmoe.route
    it = iter(calls)

    def forced(router, x, cfg):
        probs, _, ids = route(router, x, cfg)
        ids = torch.from_numpy(np.array(next(it))).to(ids)
        gates = probs.gather(1, ids)
        return probs, gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9), ids

    tmoe.route = forced
    try:
        yield
        assert next(it, None) is None, "routes left over"
    finally:
        tmoe.route = route


@pytest.mark.parametrize("name", sorted(REF_RUNS))
def test_stacked_step_with_a_pod_axis_matches_reference(reference, name):
    """Two steps from the same whole parameters: loss and grad norm within
    the bf16 limits, the learning rate to f32, parameters within twice the
    summed learning rates, the moments within the bf16 limits; under
    ``ef_fixed_k`` every rank's residual of every bucket (the FSDP shard
    bucket's one row a rank) within the gradient limit."""
    arch, preset, mb = REF_RUNS[name]
    cfg = tregistry.smoke_config(arch)
    run = _run(arch, preset, mb)
    step_fn, _, plan = tts.build_train_step(cfg, run, SHAPE, device="cpu", mesh=MESH)
    params = convert.tree_to_torch(_params(arch))
    opt = topt.adamw_init(params)
    ef = (tbucketing.init_ef_state(plan, run.compression, 4, "cpu")
          if run.compression.error_feedback else {})
    data = SyntheticLM(cfg, SHAPE)
    lrs = []
    for step in range(2):
        span = contextlib.nullcontext()
        if arch == MOE:
            per_rank = [reference[f"{name}.{step}.routes.{r}"] for r in range(4)]
            L = cfg.num_layers
            assert all(len(r) == mb * L for r in per_rank)
            span = _forced([per_rank[r][j * L + i] for j in range(mb) for r in range(4)
                            for i in range(L)])
        with span:
            params, opt, ef, m = step_fn(params, opt, ef, data.batch(step, "cpu"), step)
        want = {k: float(reference[f"{name}.{step}.{k}"]) for k in ("loss", "grad_norm", "lr")}
        np.testing.assert_allclose(float(m["loss"]), want["loss"], rtol=LOSS_TOL)
        np.testing.assert_allclose(float(m["grad_norm"]), want["grad_norm"], rtol=GRAD_TOL)
        np.testing.assert_allclose(float(m["lr"]), want["lr"], rtol=1e-6)
        lrs.append(float(m["lr"]))
    assert int(opt.step) == 2
    for k in sorted(params):
        np.testing.assert_allclose(params[k].numpy(), reference[f"{name}.p.{k}"], rtol=0,
                                   atol=2 * sum(lrs), err_msg=k)
        assert _rel(opt.m[k].numpy(), reference[f"{name}.m.{k}"]) <= GRAD_TOL, k
        assert _rel(opt.v[k].numpy(), reference[f"{name}.v.{k}"]) <= 2 * GRAD_TOL, k
    if ef:
        for j, b in enumerate(plan.buckets):
            if b.bid in ef:
                want = reference[f"{name}.ef.{j}"]
                assert want.shape == tuple(ef[b.bid].shape), b.bid
                for r in range(4):
                    assert _rel(ef[b.bid][r].numpy(), want[r]) <= GRAD_TOL, (b.bid, r)


def test_reference_restores_the_port_pod_checkpoint(reference, _reference_run):
    """The port's (pod 2, data 2) FSDP checkpoint holds whole leaves; the
    reference's ``restore`` places them on its (pod 2, data 2, model 1)
    mesh unchanged, the FSDP leaves sharded over data."""
    tmp, _ = _reference_run
    step, params, opt, _ = ckpt.restore(str(tmp / "ckpt"), None,
                                        topt.AdamWState(None, {}, {}), device="cpu")
    assert int(reference["ckpt.step"]) == step == 2
    for k, v in params.items():
        np.testing.assert_array_equal(reference[f"ckpt.p.{k}"], v.numpy())
        np.testing.assert_array_equal(reference[f"ckpt.m.{k}"], opt.m[k].numpy())
    assert "data" in str(reference["ckpt.spec.layers.attn.wq"])
    assert "data" not in str(reference["ckpt.spec.embed"])
