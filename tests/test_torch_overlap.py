"""The port's backward-pipelined bucket sync (``bucketing.overlap_params``)
against its post-backward sync and against the JAX package's
``overlap_params``.

* The reference's readiness invariants (tests/test_overlap.py) on the
  port's plan of the 6-layer MLP chain (w_00…w_05 (64, 64), b_00…b_05
  (64,)), which equals the reference's plan.
* The identity case: mode ``none`` at n = 1, the overlapped gradients are
  the unsynced ones exactly.
* Overlapped == post-backward bit for bit at n = 8 stacked, on the chain's
  tanh MLP (rank r on its 4 rows of x), for the presets of
  tests/distributed_checks/overlap_check.py: ``fixed_k_1bit`` (psum),
  ``bernoulli_seed_1bit`` (gather, scatter decode), ``binary_packed`` and
  ``ef_rotated_binary`` over 3 chained steps, residuals included; the
  buckets finish out of ``plan.schedule()`` order.
* Against the reference's ``overlap_params``, run as its own check runs it
  (a subprocess on 8 fake CPU devices importing ``overlap_harness``: its
  tree and its configs), under a loss linear in the parameters, so each
  rank's gradient is an exact 2⁻⁶-grid tensor on both sides: bit for bit,
  gradients and residuals, as tests/test_torch_bucketing.py and
  tests/test_torch_ef_train.py hold the post-backward sync, for
  ``fixed_k_1bit``, ``bernoulli_seed_1bit``, ``binary_packed`` and the first
  error-feedback step of ``ef_bernoulli`` and ``ef_binary``.
  Later EF steps leave the grid (x + e), and the rotated twins' mean center
  is a cancellation near 0, so their last bits part from the jitted
  reference's; the port's own schedules are held to each other there.
* The train step at the smoke config, overlap on against off, fixed-k with
  error feedback, 2 steps at n = 4: bit-identical parameters, m, v, losses
  and residuals (the last check of overlap_check.py).
"""
import dataclasses
import json
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.configs import registry as jregistry
from repro.core import types as jtypes
from repro.train import bucketing as jbucketing
from repro_torch import convert
from repro_torch import random as R
from repro_torch.configs.base import RunConfig, ShapeSpec
from repro_torch.configs.registry import smoke_config
from repro_torch.core import collectives as tcoll
from repro_torch.core import types as ttypes
from repro_torch.core.wire import base as twire_base
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.train import bucketing as tbucketing
from repro_torch.train import train_step as tts
from repro_torch.train.trainer import Trainer, TrainerConfig

# one intra-op thread: beside other test workers on a loaded machine, torch's
# thread pool stalls for tens of seconds
torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent
N, L, M = 8, 6, 64
STEPS = 3
SHAPES = {f"w_{i:02d}": (M, M) for i in range(L)}
SHAPES.update({f"b_{i:02d}": (M,) for i in range(L)})
SPECS = {k: (None,) * len(s) for k, s in SHAPES.items()}
PRESETS = ("fixed_k_1bit", "bernoulli_seed_1bit", "binary_packed", "ef_rotated_binary")
# against the reference: the stateless presets, and error feedback's first
# step (from zero residuals, on grid inputs; later steps' inputs x + e leave
# the grid and the two sides' centers part in the last bits)
REF_PRESETS = ("fixed_k_1bit", "bernoulli_seed_1bit", "binary_packed", "ef_bernoulli",
               "ef_binary")


def _jcfg(preset):
    """overlap_harness.mkcfg: the preset at an f32 wire, capacity 2·M²."""
    cfg = (jtypes.CompressionConfig(mode="none") if preset == "none"
           else jregistry.compression_preset(preset, axes=("data",)))
    return dataclasses.replace(cfg, min_compress_size=1024, wire_dtype="float32",
                               bucket=jtypes.BucketSpec(capacity=2 * M * M))


def _plan(cfg):
    return tbucketing.build_plan(SHAPES, SPECS, ("data",), {"data": N}, cfg)


def _params():
    rng = np.random.default_rng(0)
    return {k: torch.from_numpy((0.2 * rng.standard_normal(s)).astype(np.float32))
            for k, s in sorted(SHAPES.items())}


X = torch.from_numpy(np.random.default_rng(1).standard_normal((N * 4, M)).astype(np.float32))


def _mlp_loss(p, r):
    h = X[4 * r:4 * r + 4]
    for i in range(L):
        h = torch.tanh(h @ p[f"w_{i:02d}"] + p[f"b_{i:02d}"])
    return torch.mean(h * h)


def _rank_grads(loss_fn, params, r):
    leaves = {k: v.detach().requires_grad_() for k, v in params.items()}
    names = sorted(leaves)
    return dict(zip(names, torch.autograd.grad(loss_fn(leaves, r), [leaves[k] for k in names])))


def _post(loss_fn, params, cfg, plan, key, ef):
    stacks = {k: torch.empty((N,) + s) for k, s in SHAPES.items()}
    for r in range(N):
        for k, g in _rank_grads(loss_fn, params, r).items():
            stacks[k][r] = g
    return tbucketing.sync_grads_bucketed(stacks, plan, cfg, key, tcoll.StackedComm(N, "cpu"),
                                          ef)


def _overlapped(loss_fn, params, cfg, plan, key, ef):
    """Ranks 0…N−2 first, then rank N−1's backward through the sync points;
    returns (synced, new residuals, the rounds' issue order)."""
    stacks = {k: torch.empty((N,) + s) for k, s in SHAPES.items()}
    for r in range(N - 1):
        for k, g in _rank_grads(loss_fn, params, r).items():
            stacks[k][r] = g
    leaves = {k: v.detach().requires_grad_() for k, v in params.items()}
    tagged, sync = tbucketing.overlap_params(leaves, plan, cfg, key,
                                             tcoll.StackedComm(N, "cpu"), stacks, N - 1, ef)
    grads = torch.autograd.grad(loss_fn(tagged, N - 1), list(leaves.values()),
                                allow_unused=True)
    assert all(g is None for g in grads)          # every leaf is bucketed here
    synced, new_ef = sync.finish()
    return synced, new_ef, sync.rounds.issued


def _same(a, b):
    return a.dtype == b.dtype and torch.equal(a.view(torch.int32), b.view(torch.int32))


def test_readiness_schedule_orders_backward():
    """ready = backward index of the bucket's last-produced leaf; the
    schedule issues latest-sorted (earliest-backward) buckets first; the
    port's plan is the reference's."""
    jcmp = jtypes.CompressionConfig(
        encoder=jtypes.EncoderSpec(kind="fixed_k", fraction=0.25), mode="shared_support",
        axes=("data",), min_compress_size=1024, bucket=jtypes.BucketSpec(capacity=2 * M * M))
    plan = _plan(convert.compression_config(jcmp))
    want = jbucketing.build_plan(SHAPES, SPECS, ("data",), {"data": N}, jcmp)
    assert plan.schedule() == want.schedule()
    assert [(b.bid, b.ready) for b in plan.buckets] == [(b.bid, b.ready) for b in want.buckets]
    names = sorted(SHAPES)
    for b in plan.buckets:
        assert b.ready == max(len(names) - 1 - names.index(s.name) for s in b.slots), b.bid
    sched = plan.schedule()
    assert sorted(sched) == sorted(b.bid for b in plan.buckets)
    readiness = {b.bid: b.ready for b in plan.buckets}
    assert [readiness[bid] for bid in sched] == sorted(readiness.values())
    first = next(b for b in plan.buckets if b.bid == sched[0])
    assert any(s.name == "w_05" for s in first.slots)


def test_overlap_identity_on_one_rank():
    """n = 1, mode none: the gradients through the sync points are the
    unsynced ones exactly."""
    cfg = ttypes.CompressionConfig(mode="none", bucket=ttypes.BucketSpec(capacity=1 << 12))
    shapes = {"a": (32, 8), "b": (256,)}
    plan = tbucketing.build_plan(shapes, {k: (None,) * len(s) for k, s in shapes.items()},
                                 ("data",), {"data": 1}, cfg)
    gen = torch.Generator().manual_seed(0)
    params = {k: torch.randn(s, generator=gen) for k, s in sorted(shapes.items())}

    def loss(p):
        return torch.sum(p["a"]) + torch.sum(torch.sin(p["b"]))

    leaves = {k: v.clone().requires_grad_() for k, v in params.items()}
    want = dict(zip(sorted(leaves), torch.autograd.grad(loss(leaves), [leaves["a"], leaves["b"]])))
    stacks = {k: torch.empty((1,) + s) for k, s in shapes.items()}
    tagged, sync = tbucketing.overlap_params(leaves, plan, cfg, R.PRNGKey(1),
                                             tcoll.StackedComm(1, "cpu"), stacks, 0)
    torch.autograd.grad(loss(tagged), [leaves["a"], leaves["b"]], allow_unused=True)
    got, ef = sync.finish()
    assert ef is None and sorted(got) == ["a", "b"]
    for k in shapes:
        assert torch.equal(got[k], want[k]), k


@pytest.mark.parametrize("preset", PRESETS)
def test_overlapped_equals_post_backward(preset):
    cfg = convert.compression_config(_jcfg(preset))
    plan = _plan(cfg)
    params = _params()
    use_ef = cfg.error_feedback
    ef_p = tbucketing.init_ef_state(plan, cfg, N) if use_ef else None
    ef_o = tbucketing.init_ef_state(plan, cfg, N) if use_ef else None
    for step in range(STEPS if use_ef else 1):
        key = R.fold_in(R.PRNGKey(7), step)
        g_p, ef_p = _post(_mlp_loss, params, cfg, plan, key, ef_p)
        g_o, ef_o, issued = _overlapped(_mlp_loss, params, cfg, plan, key, ef_o)
        assert sorted(g_o) == sorted(g_p) == sorted(SHAPES)
        for k in SHAPES:
            assert _same(g_o[k], g_p[k]), (step, k)
        if use_ef:
            assert sorted(ef_o) == sorted(ef_p) and ef_o
            for bid in ef_p:
                assert _same(ef_o[bid], ef_p[bid]), (step, bid)
    assert sorted(issued) == sorted(b.bid for b in plan.buckets)
    assert issued != [b.bid for b in plan.buckets]       # not the plan's order
    assert any(b.kind == "compressed" for b in plan.buckets)


# --------------------------------------------------------------------------- #
# The train step, overlap on against off.
# --------------------------------------------------------------------------- #

def test_train_step_overlap_on_equals_off():
    cfg = smoke_config("qwen3-4b")
    shape = ShapeSpec("smoke", "train", 32, 8)
    base = ttypes.CompressionConfig(
        encoder=ttypes.EncoderSpec(kind="fixed_k", fraction=1 / 16), mode="shared_support",
        axes=("data",), min_compress_size=1024, error_feedback=True)
    data = SyntheticLM(cfg, shape)
    outs = {}
    for overlap in (True, False):
        run = RunConfig(attn_chunk_q=16, attn_chunk_k=16, remat=False, compression=dataclasses
                        .replace(base, bucket=ttypes.BucketSpec(overlap=overlap)))
        seen = []
        step_fn, init_fn, plan = tts.build_train_step(
            cfg, run, shape, 4, device="cpu",
            on_phase=lambda name, **st: seen.append(st) if name == "sync" else None)
        assert tts.overlap_enabled(plan, run) == overlap
        assert Trainer(cfg, run, shape, TrainerConfig(steps=1), 4, device="cpu").overlap == overlap
        params, opt, ef = init_fn(0)
        losses = []
        for step in range(2):
            params, opt, ef, m = step_fn(params, opt, ef, data.batch(step, "cpu"), step)
            losses.append(m["loss"])
        assert [st["schedule"] for st in seen] == [
            "backward-pipelined" if overlap else "post-backward"] * 2
        outs[overlap] = params, opt, ef, losses, seen[-1]["rounds"].issued
    (p1, o1, e1, l1, i1), (p0, o0, e0, l0, i0) = outs[True], outs[False]
    assert all(_same(a, b) for a, b in zip(l1, l0))
    for k in p0:
        assert _same(p1[k], p0[k]) and _same(o1.m[k], o0.m[k]) and _same(o1.v[k], o0.v[k]), k
    assert sorted(e1) == sorted(e0) and e0
    assert all(_same(e1[k], e0[k]) for k in e0)
    assert i0 == [b.bid for b in plan.buckets] and sorted(i1) == sorted(i0)


# --------------------------------------------------------------------------- #
# Against the reference's overlap_params on 8 fake CPU devices.
# --------------------------------------------------------------------------- #

_REF = r"""
import os, sys
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
sys.path.insert(0, sys.argv[1])
sys.path.insert(0, sys.argv[2])
import functools, json
import jax
jax.config.update("jax_threefry_partitionable", False)
import jax.numpy as jnp
import numpy as np
from jax.sharding import PartitionSpec as P
import overlap_harness as oh
from repro import compat
from repro.train import bucketing

out = sys.argv[3]
spec = json.load(open(out + "/spec.json"))
grads = dict(np.load(out + "/grads.npz"))
N, L, M = spec["n"], spec["layers"], spec["width"]
mesh = jax.make_mesh((N,), ("data",))
shapes, specs = oh.build_tree(L, M)
params = oh.init_params(shapes)
res = {}
for preset in spec["presets"]:
    cfg = oh.mkcfg(preset, M)
    use_ef = cfg.error_feedback
    plan = bucketing.build_plan(shapes, specs, ("data",), {"data": N}, cfg)
    pspec = {k: P() for k in shapes}
    gspec = {k: P("data") for k in shapes}
    efspec = {b.bid: P() for b in plan.buckets if use_ef and b.kind == "compressed"}

    @functools.partial(compat.shard_map, mesh=mesh, in_specs=(pspec, efspec, gspec, P()),
                       out_specs=(pspec, efspec), check_vma=False)
    def ovl(p, ef, g, key):
        def loss(q, e):
            tagged = bucketing.overlap_params(q, plan, cfg, key, e if use_ef else None)
            return sum(jnp.sum(tagged[k] * g[k][0]) for k in sorted(tagged))
        gr, gef = jax.grad(loss, argnums=(0, 1))(p, ef if use_ef else {})
        return gr, (gef if use_ef else {})

    ovl = jax.jit(ovl)
    ef = bucketing.init_ef_state(plan, cfg) if use_ef else {}
    for step in range(1):
        g = {k: jnp.asarray(grads[f"{step}.{k}"]) for k in shapes}
        gr, ef = ovl(params, ef, g, jax.random.fold_in(jax.random.PRNGKey(7), step))
        for k, v in gr.items():
            res[f"{preset}.{step}.{k}"] = np.asarray(v)
        for k, v in ef.items():
            res[f"{preset}.{step}.ef.{k}"] = np.asarray(v)
np.savez(out + "/ref.npz", **res)
"""


def _grid_grads(step):
    """(N, *shape) per leaf on the 2⁻⁶ grid, with per-rank offsets."""
    rng = np.random.default_rng(100 + step)
    return {k: ((np.round(rng.standard_normal((N,) + s) * 32)
                 + np.arange(N).reshape((N,) + (1,) * len(s))) / 64).astype(np.float32)
            for k, s in sorted(SHAPES.items())}


# the reference's overlap_params on 8 fake CPU devices: 21 s of the module's
# first setup alone on an 8-core machine
REF_WAIT_S = 150


@pytest.fixture(scope="module", autouse=True)
def _reference_run(tmp_path_factory):
    """Starts the reference's subprocess as the module's first test starts,
    so it runs beside the port-only tests; :func:`reference` waits for it."""
    tmp = tmp_path_factory.mktemp("overlap_ref")
    np.savez(tmp / "grads.npz", **{f"0.{k}": v for k, v in _grid_grads(0).items()})
    (tmp / "spec.json").write_text(json.dumps({"n": N, "layers": L, "width": M,
                                               "presets": list(REF_PRESETS)}))
    proc = subprocess.Popen([sys.executable, "-c", _REF, str(ROOT / "src"),
                             str(ROOT / "tests" / "distributed_checks"), str(tmp)],
                            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
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


@pytest.mark.parametrize("preset", REF_PRESETS)
def test_overlapped_equals_reference_overlap_params(reference, preset, monkeypatch):
    def center(x, policy):
        return torch.sum(x) * torch.tensor(np.float32(1.0) / np.float32(x.numel()))

    monkeypatch.setattr(twire_base, "center", center)
    cfg = convert.compression_config(_jcfg(preset))
    plan = _plan(cfg)
    ef = tbucketing.init_ef_state(plan, cfg, N) if cfg.error_feedback else None
    g = {k: torch.from_numpy(v) for k, v in _grid_grads(0).items()}

    def linear(p, r):
        return sum(torch.sum(p[k] * g[k][r]) for k in sorted(p))

    got, ef, _ = _overlapped(linear, _params(), cfg, plan, R.fold_in(R.PRNGKey(7), 0), ef)
    for k in SHAPES:
        np.testing.assert_array_equal(got[k].numpy().view(np.int32),
                                      reference[f"{preset}.0.{k}"].view(np.int32), err_msg=k)
    assert bool(ef) == preset.startswith("ef_")
    for bid, e in (ef or {}).items():       # the reference returns rank 0's residual
        np.testing.assert_array_equal(e.numpy()[0].view(np.int32),
                                      reference[f"{preset}.0.ef.{bid}"].view(np.int32),
                                      err_msg=bid)
