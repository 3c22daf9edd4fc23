"""FSDP (ZeRO-3 over ``data``) in the port's train step, against the JAX
package's and against itself.

* The reference, in one subprocess on 4 fake CPU devices (started as the
  module's first test starts, beside the port-only tests), pins the three
  behaviours of its FSDP that the port follows: (1) FSDP leaves take the
  *sum* over ``data`` (the transpose of the gather) where the other leaves
  take the mean; (2) XLA on the CPU sums a bf16 ``psum_scatter`` in f32 in
  rank order and rounds once; (3) its FSDP ``init_fn`` repeats one draw on
  every data shard at tp = 1, so parity runs hand it whole arrays placed
  with ``NamedSharding``, as ``checkpoint.restore`` places them.  It then
  runs its ``build_train_step`` with ``fsdp=True`` on a (data 2, model 1)
  mesh for 2 steps (the dense smoke under ``none`` and ``fixed_k_1bit``, the
  MoE smoke under ``fixed_k_1bit``, each with 1 and 2 microbatches), records
  the MoE routes of each rank, and restores the port's FSDP checkpoint.
* The port's stacked FSDP step matches those runs under
  ``tests/test_torch_training.py``'s bf16 limits (the MoE runs on the
  reference's routes); FSDP on against off from the same parameters at n =
  2 and 4: the unsharded leaves bit-equal, each FSDP leaf n × the exact
  mean within one bf16 rounding; the layers' ``unbind`` path bit-equal to
  the per-layer select it replaced, gradients included.
* Two gloo processes (``DistComm``, each holding its shards) bit-equal to
  the stacked step; the communicators' gather and reduce-scatter; a
  checkpoint saved at n = 4 restores at n = 2, stacked and one rank a
  process.
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
B, S = 4, 32
SHAPE = ShapeSpec("fsdp", "train", S, B)
# tests/test_torch_training.py's bf16 limits: loss, grad norm and moments
LOSS_TOL, GRAD_TOL = 1e-3, 5e-2
# one bf16 rounding of the rank sum: 2⁻⁹ relative, in the Frobenius norm
SUM_RTOL = 2.0 ** -9
# the reference's runs: name -> (arch, preset or "none", microbatches)
REF_RUNS = {f"{a}-{c}-mb{mb}": (arch, c, mb)
            for a, arch in (("dense", DENSE), ("moe", MOE))
            for c in (("none", "fixed_k_1bit") if arch == DENSE else ("fixed_k_1bit",))
            for mb in (1, 2)}
# the reference's FSDP step, 6 configs on 4 fake devices: 40-70 s alone
REF_WAIT_S = 300


def _cmp(preset: str) -> ttypes.CompressionConfig:
    if preset == "none":
        return ttypes.CompressionConfig(mode="none")
    return dataclasses.replace(tregistry.compression_preset(preset, axes=("data",)),
                               min_compress_size=1024)


def _run(arch: str, preset: str, mb: int, fsdp: bool = True) -> RunConfig:
    # no remat for the MoE: each layer routes once a forward, as recorded
    return RunConfig(microbatches=mb, fsdp=fsdp, attn_chunk_q=16, attn_chunk_k=16,
                     remat=arch != MOE, compression=_cmp(preset))


def _params(arch: str):
    """The port's draw of the smoke config's whole parameters (numpy)."""
    cfg = tregistry.smoke_config(arch)
    return {k: v.numpy() for k, v in tmodel.init(0, cfg, device="cpu").items()}


def _rel(got, want) -> float:
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(np.asarray(got, np.float64) - want) / np.linalg.norm(want))


def _bits(a):
    return np.asarray(a).view(np.int32)


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
from repro import compat
from repro.checkpoint import checkpointing as jckpt
from repro.configs.base import RunConfig, ShapeSpec
from repro.configs.registry import compression_preset, smoke_config
from repro.core import types as jtypes
from repro.data.pipeline import SyntheticLM
from repro.models import moe as jmoe
from repro.optim import optimizers as jopt
from repro.train import train_step as jts

out = sys.argv[2]
spec = json.load(open(out + "/spec.json"))
res = {}

# (1) FSDP leaves take the sum over data: a gathered bf16 shard
mesh4 = jax.make_mesh((4,), ("data",))
rng = np.random.default_rng(0)
w = rng.standard_normal((64, 32)).astype(np.float32)
xs = rng.standard_normal((4, 8, 64)).astype(np.float32)

def loss(wf, x):
    y = x.astype(jnp.bfloat16) @ wf
    return jnp.sum(jnp.square(y.astype(jnp.float32))) / 100.0

def fsdp_grad(ws, x):
    # the shard's gradient through the gather, and this rank's own bf16
    # cotangent of the gathered weight
    gather = lambda v: jax.lax.all_gather(v.astype(jnp.bfloat16), "data", axis=0, tiled=True)
    g = jax.grad(lambda v: loss(gather(v), x[0]))(ws)
    own = jax.grad(lambda full: loss(full, x[0]))(gather(ws))
    return g, own.astype(jnp.float32)[None]

g_fsdp, own = jax.jit(compat.shard_map(fsdp_grad, mesh=mesh4, in_specs=(P("data"), P("data")),
                                       out_specs=(P("data"), P("data")),
                                       check_vma=False))(w, xs)
res["h1.fsdp"], res["h1.ranks"] = np.asarray(g_fsdp), np.asarray(own)

# (2) the bf16 psum_scatter: f32 sums in rank order, rounded once
mag = rng.uniform(-20, 20, (4, 4096))
vals = (np.sign(rng.standard_normal((4, 4096))) * 2.0 ** mag).astype(np.float32)
xb = jnp.asarray(vals).astype(jnp.bfloat16)
rs = jax.jit(compat.shard_map(
    lambda x: jax.lax.psum_scatter(x[0], "data", scatter_dimension=0, tiled=True),
    mesh=mesh4, in_specs=P("data"), out_specs=P("data"), check_vma=False))(xb)
res["h2.in"] = np.asarray(xb.astype(jnp.float32))
res["h2.out"] = np.asarray(rs.astype(jnp.float32))

# (3) the FSDP init_fn at tp = 1 repeats one draw on every data shard
mesh = jax.make_mesh((2, 1), ("data", "model"))
shape = ShapeSpec("fsdp", "train", spec["seq"], spec["batch"])

def run_config(arch, c, mb):
    if c == "none":
        cmp = jtypes.CompressionConfig(mode="none")
    else:
        cmp = dataclasses.replace(compression_preset(c, axes=("data",)),
                                  min_compress_size=1024)
    return RunConfig(microbatches=mb, fsdp=True, attn_chunk_q=16, attn_chunk_k=16,
                     remat=arch != "qwen2-moe-a2.7b", compression=cmp)

for name, (arch, c, mb) in spec["runs"].items():
    jcfg = smoke_config(arch)
    step_fn, init_fn, specs, bspecs, _ = jts.build_train_step(mesh, jcfg,
                                                              run_config(arch, c, mb), shape)
    if name == "dense-none-mb1":
        drawn = np.asarray(init_fn(jax.random.PRNGKey(0))[0]["layers.attn.wq"])
        res["h3.wq"] = drawn
    whole = dict(np.load(f"{out}/{arch}.params.npz"))
    params = {k: jax.device_put(v, NamedSharding(mesh, P(*specs[k]))) for k, v in whole.items()}
    opt = jopt.adamw_init(params)
    ef = jax.tree.map(lambda p: jnp.zeros((), jnp.float32), params)
    data = SyntheticLM(jcfg, shape)
    log = []
    block = jmoe.moe_block

    def recorded(ctx, p, x, cfg):
        t = x.shape[0] * x.shape[1]
        logits = jnp.einsum("td,de->te", x.reshape(t, -1).astype(jnp.float32),
                            p["router"].astype(jnp.float32))
        ids = jax.lax.top_k(jax.nn.softmax(logits, axis=-1), cfg.top_k)[1]
        jax.debug.callback(lambda r, i: log.append((int(r), np.asarray(i))),
                           jax.lax.axis_index("data"), ids)
        return block(ctx, p, x, cfg)

    jmoe.moe_block = recorded
    try:
        for step in range(2):
            params, opt, ef, m = step_fn(params, opt, ef, data.device_batch(step, mesh, bspecs),
                                         jnp.int32(step))
            jax.effects_barrier()
            for k in ("loss", "grad_norm", "lr"):
                res[f"{name}.{step}.{k}"] = np.asarray(m[k])
            for r in range(2):
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

# the port's FSDP checkpoint, restored by the reference onto the (2, 1) mesh
template = jopt.AdamWState(step=None, m={}, v={})
step, params, opt, _ = jckpt.restore(out + "/ckpt", mesh, None, template)
res["ckpt.step"] = np.asarray(step)
for k in params:
    res[f"ckpt.p.{k}"] = np.asarray(params[k])
    res[f"ckpt.m.{k}"] = np.asarray(opt.m[k])
    res[f"ckpt.spec.{k}"] = np.asarray(str(params[k].sharding.spec))
np.savez(out + "/ref.npz", **res)
"""


def _stacked_fit(tmp, arch: str, n: int, steps: int, ckpt_dir=None):
    run = _run(arch, "fixed_k_1bit", 1)
    tr = Trainer(tregistry.smoke_config(arch), run, SHAPE,
                 TrainerConfig(steps=steps, ckpt_dir=ckpt_dir, ckpt_every=steps, log_every=1),
                 n=n, device="cpu")
    return tr, tr.fit()


@pytest.fixture(scope="module", autouse=True)
def _reference_run(tmp_path_factory):
    """Writes the parameters and an n = 4 FSDP checkpoint of the port, then
    starts the reference's subprocess as the module's first test starts;
    :func:`reference` waits for it."""
    tmp = tmp_path_factory.mktemp("fsdp_ref")
    for arch in (DENSE, MOE):
        np.savez(tmp / f"{arch}.params.npz", **_params(arch))
    _stacked_fit(tmp, DENSE, 4, 2, str(tmp / "ckpt"))
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

def test_run_configs_of_the_fsdp_archs_are_the_reference_s():
    for arch in sorted(tregistry._BIG):
        for shape in ("train_4k", "prefill_32k", "decode_32k"):
            want = jregistry.get_run_config(arch, shape)
            got = tregistry.get_run_config(arch, shape)
            assert want.fsdp and got == convert.run_config(want), (arch, shape)
    assert sorted(tregistry._BIG) == sorted(jregistry._BIG)


def test_tensor_parallelism_raises():
    cfg = tregistry.smoke_config(DENSE)
    with pytest.raises(NotPortedError, match="tensor parallelism"):
        tmodel.make_ctx(cfg, _run(DENSE, "none", 1), {"data": 2, "model": 2})


@pytest.mark.parametrize("n", [2, 4])
def test_fsdp_on_against_off_from_the_same_parameters(n):
    """The unsharded leaves take the same exact mean, bit for bit; each FSDP
    leaf's gradient is the rank sum, n × the exact mean, rounded once to
    bf16."""
    cfg = tregistry.smoke_config(DENSE)
    shape = ShapeSpec("t", "train", S, n)
    synced = {}
    for fsdp in (False, True):
        seen = {}
        step_fn, init_fn, _ = tts.build_train_step(
            cfg, _run(DENSE, "none", 1, fsdp), shape, n, device="cpu",
            on_phase=lambda name, **st: seen.update(st) if name == "sync" else None)
        step_fn(*init_fn(0), SyntheticLM(cfg, shape).batch(0, "cpu"), 0)
        synced[fsdp] = seen["synced"]
    dims = tts.fsdp_leaf_dims(tregistry.param_shapes(cfg, fsdp="data")[1])
    assert len(dims) == 7 and sorted(synced[True]) == sorted(synced[False])
    rel = {}
    for k, off in synced[False].items():
        on = synced[True][k]
        if k in dims:
            rel[k] = _rel(on.numpy(), n * off.numpy())
        else:
            assert torch.equal(on, off), k
    print(f"n = {n}: FSDP sum against n x mean {min(rel.values()):.3e} .. {max(rel.values()):.3e}")
    assert max(rel.values()) <= SUM_RTOL


def _select(v):
    """The per-layer select the unbind replaced: row i is ``v[i]``."""
    return [v[i] for i in range(v.shape[0])]


@pytest.mark.parametrize("arch", [DENSE, MOE, "jamba-v0.1-52b", "whisper-medium"])
def test_unbind_equals_select_with_gradients(arch, monkeypatch):
    """The layers' rows by one ``torch.unbind`` a leaf give the loss and
    every gradient of the per-layer select, bit for bit."""
    cfg = tregistry.smoke_config(arch)
    run = RunConfig(attn_chunk_q=16, attn_chunk_k=16)
    batch = SyntheticLM(cfg, SHAPE).batch(0, "cpu")
    params = tmodel.init(0, cfg, device="cpu")
    out = []
    for select in (False, True):
        if select:
            monkeypatch.setattr(torch, "unbind", _select)
        leaves = {k: v.clone().requires_grad_() for k, v in params.items()}
        loss, _ = tmodel.train_loss(tmodel.make_ctx(cfg, run), leaves, cfg, run, batch, B * S)
        names = sorted(leaves)
        out.append((loss.detach(), torch.autograd.grad(loss, [leaves[k] for k in names])))
        monkeypatch.undo()
    (l0, g0), (l1, g1) = out
    assert torch.equal(l0, l1)
    assert all(torch.equal(a, b) for a, b in zip(g0, g1))


def test_plan_of_the_remaining_leaves_is_the_reference_s():
    """FSDP leaves have no sync axis on a data-only mesh: they pass through,
    and the buckets of the rest (ids, slots, readiness, hence the keys and
    the overlapped sync points) are the reference's."""
    for arch in (DENSE, MOE, "jamba-v0.1-52b"):
        cfg = tregistry.smoke_config(arch)
        shapes, specs = tregistry.param_shapes(cfg, fsdp="data")
        cmp = _cmp("fixed_k_1bit")
        got = tbucketing.build_plan(shapes, specs, ("data",), {"data": 2}, cmp)
        jcmp = jregistry.compression_preset("fixed_k_1bit", axes=("data",))
        jcmp = dataclasses.replace(jcmp, min_compress_size=1024)
        want = jbucketing.build_plan(shapes, specs, ("data",), {"data": 2}, jcmp)
        as_tuple = lambda plan: [(b.bid, b.kind, b.caxes, b.eaxes, b.size, b.ready,
                                  [(s.name, s.offset, s.size, tuple(s.shape)) for s in b.slots])
                                 for b in plan.buckets]
        assert as_tuple(got) == as_tuple(want), arch
        assert got.passthrough == tuple(want.passthrough)
        assert sorted(got.passthrough) == sorted(tts.fsdp_leaf_dims(specs))


def test_global_norm_sums_each_shard_in_rank_order():
    """An FSDP leaf adds each rank shard's squares, summed from +0.0 in rank
    order: cut from the whole leaf, or one shard a process with the sum over
    the ranks done by ``rank_sum`` — the same bits."""
    rng = np.random.default_rng(1)
    tree = {"a": torch.from_numpy(rng.standard_normal((3, 8, 6)).astype(np.float32)),
            "b": torch.from_numpy(rng.standard_normal((5,)).astype(np.float32))}
    got = topt.global_norm(tree, {"a": 1}, shards=2)
    parts = [torch.sum(torch.square(c.contiguous())) for c in torch.chunk(tree["a"], 2, 1)]
    want = torch.sqrt((torch.zeros(()) + parts[0] + parts[1])
                      + torch.sum(torch.square(tree["b"])))
    assert torch.equal(got, want)
    mine = {"a": torch.chunk(tree["a"], 2, 1)[0].contiguous(), "b": tree["b"]}
    one = topt.global_norm(mine, {"a": 1}, rank_sum=lambda t: torch.zeros(1) + t + parts[1])
    assert torch.equal(one, got)


def test_adamw_in_place_is_the_out_of_place_update_bit_for_bit(monkeypatch):
    monkeypatch.setattr(topt, "_CHUNK", 7)          # several chunks a leaf
    rng = np.random.default_rng(2)
    shapes = {"w": (8, 5), "n": (6,)}
    params = {k: torch.from_numpy(rng.standard_normal(s).astype(np.float32)) for k, s in
              shapes.items()}
    grads = {k: torch.from_numpy(rng.standard_normal(s).astype(np.float32)) for k, s in
             shapes.items()}
    state = topt.adamw_init(params)
    state = state._replace(m={k: v + 0.01 for k, v in state.m.items()})
    cfg = topt.AdamWConfig(warmup_steps=2)
    want_p, want_s = topt.adamw_update(cfg, grads, state, params, torch.tensor(3.0))
    copy = {k: v.clone() for k, v in params.items()}
    mstate = state._replace(m={k: v.clone() for k, v in state.m.items()},
                            v={k: v.clone() for k, v in state.v.items()})
    got_p, got_s = topt.adamw_update(cfg, grads, mstate, copy, torch.tensor(3.0), in_place=True)
    for k in shapes:
        assert got_p[k] is copy[k] and got_s.m[k] is mstate.m[k]
        for a, b in ((got_p[k], want_p[k]), (got_s.m[k], want_s.m[k]), (got_s.v[k], want_s.v[k])):
            assert torch.equal(a, b), k


def test_fsdp_shard_and_unshard_round_trip():
    spec = (None, "data", None)
    x = np.arange(2 * 8 * 3, dtype=np.float32).reshape(2, 8, 3)
    shards = [convert.fsdp_shard(x, spec, r, 4) for r in range(4)]
    assert shards[1].shape == (2, 2, 3) and np.array_equal(shards[1], x[:, 2:4])
    np.testing.assert_array_equal(convert.fsdp_unshard(shards, spec), x)
    t = torch.from_numpy(x)
    back = convert.fsdp_unshard([convert.fsdp_shard(t, spec, r, 4) for r in range(4)], spec)
    assert torch.equal(back, t)
    with pytest.raises(ValueError, match="shards"):
        convert.fsdp_shard(x, spec, 0, 3)


def test_stacked_gather_and_reduce_scatter():
    rng = np.random.default_rng(3)
    comm = tcoll.StackedComm(4, "cpu")
    full = torch.from_numpy(rng.standard_normal((3, 8, 5)).astype(np.float32)).to(torch.bfloat16)
    shards = torch.stack(torch.chunk(full, 4, 1))
    assert torch.equal(comm.fsdp_gather(shards, 1), full)
    rows = torch.from_numpy(rng.standard_normal((4, 3, 8, 5)).astype(np.float32)).to(
        torch.bfloat16)
    got = comm.reduce_scatter(rows, 1)
    total = torch.zeros((3, 8, 5))
    for r in range(4):
        total = total + rows[r].float()
    assert got.dtype == torch.bfloat16 and got.shape == (4, 3, 2, 5)
    assert torch.equal(got, torch.stack(torch.chunk(total.to(torch.bfloat16), 4, 1)))


def test_checkpoint_saved_at_n4_restores_at_n2(tmp_path):
    """An n = 4 FSDP run's checkpoint resumes an n = 2 run (stacked: whole
    leaves), and a process of a 2-rank world restores its rank's slices."""
    d = str(tmp_path / "ckpt")
    tr4, (p4, o4, _) = _stacked_fit(tmp_path, DENSE, 4, 2, d)
    cfg = tregistry.smoke_config(DENSE)
    run = _run(DENSE, "fixed_k_1bit", 1)
    tr2 = Trainer(cfg, run, SHAPE, TrainerConfig(steps=3, ckpt_dir=d, ckpt_every=3,
                                                  log_every=1), n=2, device="cpu")
    start, params, opt, _ = tr2.init_or_restore()
    assert start == 2 and all(torch.equal(params[k], p4[k]) for k in p4)
    _, _, hist = tr2.fit()
    assert [h["step"] for h in hist] == [2] and math.isfinite(hist[0]["loss"])
    specs = tr2.specs
    for r in range(2):
        _, got, opt, _ = ckpt.restore(d, specs, topt.AdamWState(None, {}, {}), step=2,
                                      device="cpu",
                                      shard=lambda k, a, r=r: (convert.fsdp_shard(a, specs[k],
                                                                                 r, 2)
                                                               if k in tr2.fsdp_dims else a))
        for k in p4:
            want = convert.fsdp_shard(p4[k], specs[k], r, 2) if k in tr2.fsdp_dims else p4[k]
            assert got[k].is_contiguous() and torch.equal(got[k], want), k


# ----------------------------------------------------- one rank a process

_WORKER = r"""
import datetime, json, sys
sys.path.insert(0, sys.argv[1])
sys.path.insert(0, sys.argv[2])
import numpy as np, torch, torch.distributed as dist
torch.set_num_threads(1)
import test_torch_fsdp as t
from repro_torch.configs import registry
from repro_torch.core.collectives import DistComm, StackedComm
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.train import train_step as tts
from repro_torch.train.trainer import Trainer, TrainerConfig
rank, port, out = int(sys.argv[3]), sys.argv[4], sys.argv[5]
dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", world_size=2,
                        rank=rank, timeout=datetime.timedelta(seconds=float(sys.argv[6])))
comm = DistComm(device="cpu")
res = {}
# the communicators' gather and reduce-scatter
rng = np.random.default_rng(5)
rows = torch.from_numpy(rng.standard_normal((2, 3, 8, 5)).astype(np.float32)).to(torch.bfloat16)
res["rs"] = comm.reduce_scatter(rows[rank:rank + 1], 1)[0].float().numpy()
res["ag"] = comm.fsdp_gather(torch.chunk(rows[0], 2, 1)[rank][None], 1).float().numpy()
for arch, mb in ((t.MOE, 1), (t.MOE, 2), (t.DENSE, 1)):
    cfg = registry.smoke_config(arch)
    step_fn, init_fn, _ = tts.build_train_step(cfg, t._run(arch, "fixed_k_1bit", mb), t.SHAPE,
                                               device="cpu", comm=comm)
    params, opt, ef = init_fn(0)
    data = SyntheticLM(cfg, t.SHAPE)
    comm.reset_bytes()
    for step in range(2):
        params, opt, ef, m = step_fn(params, opt, ef, data.batch(step, "cpu"), step)
        res[f"{arch}.{mb}.loss.{step}"] = m["loss"].numpy()
        res[f"{arch}.{mb}.gnorm.{step}"] = m["grad_norm"].numpy()
    res[f"{arch}.{mb}.fsdp_bytes"] = np.array(comm.bytes_fsdp)
    for k in params:
        res[f"{arch}.{mb}.p.{k}"] = params[k].numpy()
        res[f"{arch}.{mb}.m.{k}"] = opt.m[k].numpy()
        res[f"{arch}.{mb}.v.{k}"] = opt.v[k].numpy()
# restore the n = 4 checkpoint at world 2, then save this world's state whole
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
    """Two gloo workers (see ``_WORKER``), after an n = 4 stacked run has
    written the checkpoint they restore; returns the directory."""
    from test_torch_collective import GLOO_INIT_TIMEOUT_S, GlooWorld

    tmp = tmp_path_factory.mktemp("fsdp_gloo")
    _stacked_fit(tmp, DENSE, 4, 2, str(tmp / "ckpt"))
    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    GlooWorld(lambda port: [[sys.executable, "-c", _WORKER, str(ROOT / "src"),
                             str(ROOT / "tests"), str(r), port, str(tmp),
                             str(GLOO_INIT_TIMEOUT_S), str(tmp / "ckpt")]
                            for r in range(2)], env=env).wait(timeout=180)
    return tmp


def _rank(tmp, r):
    with np.load(tmp / f"rank{r}.npz") as z:
        return {k: z[k] for k in z.files}


def test_distcomm_gather_and_reduce_scatter_equal_stacked(gloo_run):
    rng = np.random.default_rng(5)
    rows = torch.from_numpy(rng.standard_normal((2, 3, 8, 5)).astype(np.float32)).to(
        torch.bfloat16)
    comm = tcoll.StackedComm(2, "cpu")
    want = comm.reduce_scatter(rows, 1).float().numpy()
    for r in range(2):
        got = _rank(gloo_run, r)
        np.testing.assert_array_equal(_bits(got["rs"]), _bits(want[r]))
        np.testing.assert_array_equal(got["ag"], rows[0].float().numpy())


@pytest.mark.parametrize("arch,mb", [(MOE, 1), (MOE, 2), (DENSE, 1)])
def test_distcomm_fsdp_step_equals_stacked(gloo_run, arch, mb):
    """Each process holds its shards; two steps end bit-equal to the stacked
    step's state cut into the same shards, with the same losses and norms."""
    cfg = tregistry.smoke_config(arch)
    step_fn, init_fn, _ = tts.build_train_step(cfg, _run(arch, "fixed_k_1bit", mb), SHAPE, 2,
                                               device="cpu")
    params, opt, ef = init_fn(0)
    data = SyntheticLM(cfg, SHAPE)
    metrics = []
    for step in range(2):
        params, opt, ef, m = step_fn(params, opt, ef, data.batch(step, "cpu"), step)
        metrics.append(m)
    specs = tregistry.param_shapes(cfg, fsdp="data")[1]
    dims = tts.fsdp_leaf_dims(specs)
    for r in range(2):
        got = _rank(gloo_run, r)
        for step, m in enumerate(metrics):
            assert _bits(got[f"{arch}.{mb}.loss.{step}"]) == _bits(m["loss"].numpy())
            assert _bits(got[f"{arch}.{mb}.gnorm.{step}"]) == _bits(m["grad_norm"].numpy())
        for k in params:
            for pre, t in (("p", params[k]), ("m", opt.m[k]), ("v", opt.v[k])):
                want = convert.fsdp_shard(t, specs[k], r, 2) if k in dims else t
                np.testing.assert_array_equal(_bits(got[f"{arch}.{mb}.{pre}.{k}"]),
                                              _bits(want.contiguous().numpy()),
                                              err_msg=f"{r} {pre}.{k}")
        # the gathers (forward and, with remat, its recompute) and the
        # reduce-scatters of every layer: bf16 bytes handed over
        assert int(got[f"{arch}.{mb}.fsdp_bytes"]) > 0


def test_distcomm_restores_the_n4_checkpoint_and_saves_whole(gloo_run):
    """Each process of the 2-rank world restores its rank's slices of the
    n = 4 checkpoint; its own save at step 3 writes the leaves whole."""
    step, whole, _, _ = ckpt.restore(str(gloo_run / "ckpt"), None,
                                     topt.AdamWState(None, {}, {}), step=2, device="cpu")
    specs = tregistry.param_shapes(tregistry.smoke_config(DENSE), fsdp="data")[1]
    dims = tts.fsdp_leaf_dims(specs)
    for r in range(2):
        got = _rank(gloo_run, r)
        assert int(got["restored.start"]) == step == 2
        for k, v in whole.items():
            want = convert.fsdp_shard(v, specs[k], r, 2) if k in dims else v
            np.testing.assert_array_equal(got[f"restored.p.{k}"], want.numpy(), err_msg=k)
    _, saved, _, _ = ckpt.restore(str(gloo_run / "ckpt"), specs, topt.AdamWState(None, {}, {}),
                                  step=3, device="cpu")
    assert all(tuple(saved[k].shape) == tuple(s) for k, s in
               tregistry.param_shapes(tregistry.smoke_config(DENSE))[0].items())


# --------------------------------------------------- the reference's hazards

def test_reference_fsdp_leaves_take_the_sum_over_data(reference):
    """Hazard 1: the transpose of the gather sums every rank's bf16
    cotangent: the rank sum holds to one bf16 rounding, the mean is a
    quarter of it."""
    got, ranks = reference["h1.fsdp"], reference["h1.ranks"]
    assert _rel(got, ranks.sum(0)) <= SUM_RTOL
    assert abs(_rel(ranks.mean(0), got) - 0.75) <= 0.01


def test_reference_bf16_psum_scatter_rounds_once(reference):
    """Hazard 2: XLA on the CPU sums a bf16 psum_scatter in f32 in rank order
    and rounds once; a bf16 rounding after each add differs in about a
    quarter of the values.  The port's reduce-scatter on both communicators'
    rule gives the reference's bits."""
    x = reference["h2.in"]
    want = reference["h2.out"]
    once = torch.from_numpy(x.sum(0, dtype=np.float32)).to(torch.bfloat16).float().numpy()
    np.testing.assert_array_equal(_bits(want), _bits(once))
    step = torch.zeros(x.shape[1], dtype=torch.bfloat16)
    for r in range(4):
        step = (step.float() + torch.from_numpy(x[r])).to(torch.bfloat16)
    assert int((step.float().numpy() != want).sum()) > 100
    comm = tcoll.StackedComm(4, "cpu")
    got = comm.reduce_scatter(torch.from_numpy(x).to(torch.bfloat16), 0)
    np.testing.assert_array_equal(_bits(got.reshape(-1).float().numpy()), _bits(want))


def test_reference_init_repeats_one_draw_per_data_shard(reference):
    """Hazard 3: the reference's FSDP init at tp = 1 folds in no data rank,
    so its two data shards of a leaf hold the same draw; parity runs hand
    it the port's whole arrays instead."""
    wq = reference["h3.wq"]
    half = wq.shape[1] // 2
    np.testing.assert_array_equal(wq[:, :half], wq[:, half:])


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
def test_stacked_fsdp_step_matches_reference(reference, name):
    arch, preset, mb = REF_RUNS[name]
    cfg = tregistry.smoke_config(arch)
    step_fn, _, plan = tts.build_train_step(cfg, _run(arch, preset, mb), SHAPE, 2, device="cpu")
    params = convert.tree_to_torch(_params(arch))
    opt = topt.adamw_init(params)
    data = SyntheticLM(cfg, SHAPE)
    lrs = []
    for step in range(2):
        span = contextlib.nullcontext()
        if arch == MOE:
            per_rank = [reference[f"{name}.{step}.routes.{r}"] for r in range(2)]
            L = cfg.num_layers
            assert all(len(r) == mb * L for r in per_rank)
            span = _forced([per_rank[r][j * L + i] for j in range(mb) for r in range(2)
                            for i in range(L)])
        with span:
            params, opt, _, m = step_fn(params, opt, {}, data.batch(step, "cpu"), step)
        want = {k: float(reference[f"{name}.{step}.{k}"]) for k in ("loss", "grad_norm", "lr")}
        np.testing.assert_allclose(float(m["loss"]), want["loss"], rtol=LOSS_TOL)
        np.testing.assert_allclose(float(m["grad_norm"]), want["grad_norm"], rtol=GRAD_TOL)
        np.testing.assert_allclose(float(m["lr"]), want["lr"], rtol=1e-6)
        lrs.append(float(m["lr"]))
    assert int(opt.step) == 2 and plan is not None
    for k in sorted(params):
        np.testing.assert_allclose(params[k].numpy(), reference[f"{name}.p.{k}"], rtol=0,
                                   atol=2 * sum(lrs), err_msg=k)
        assert _rel(opt.m[k].numpy(), reference[f"{name}.m.{k}"]) <= GRAD_TOL, k
        assert _rel(opt.v[k].numpy(), reference[f"{name}.v.{k}"]) <= 2 * GRAD_TOL, k


def test_reference_restores_the_port_fsdp_checkpoint(reference, _reference_run):
    """The port's checkpoint (an n = 4 stacked FSDP run) holds whole
    leaves with specs naming ``data``; the reference's ``restore`` places
    them on its (data 2, model 1) mesh unchanged."""
    tmp, _ = _reference_run
    step, params, opt, _ = ckpt.restore(str(tmp / "ckpt"), None,
                                        topt.AdamWState(None, {}, {}), device="cpu")
    assert int(reference["ckpt.step"]) == step == 2
    for k, v in params.items():
        np.testing.assert_array_equal(reference[f"ckpt.p.{k}"], v.numpy())
        np.testing.assert_array_equal(reference[f"ckpt.m.{k}"], opt.m[k].numpy())
    assert "data" in str(reference["ckpt.spec.layers.attn.wq"])
    assert "data" not in str(reference["ckpt.spec.embed"])
