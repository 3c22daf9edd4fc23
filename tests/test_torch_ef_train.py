"""Error feedback through the port's training path against the JAX package:
the bucket plan's state shapes, the bucketed and per-leaf EF syncs over
stacked ranks, two whole train steps on a (1, 1) mesh, the stacked n = 4
step, ``Trainer.fit``'s kept state, ``convert.ef_state`` and the training
example at a tiny size.  The reference runs inside
``jax.threefry_partitionable(False)``.

Tolerances, each with its reason:
* the bucketed EF sync over stacked ranks on 2⁻⁶-grid gradients (every sum
  exact): bit-equal, estimates and residuals, two rounds;
* two whole steps at n = 1 (the reference computes in bf16 whatever the run
  config says, as in tests/test_torch_training.py): parameters within
  2·(lr₀ + lr₁), m within the bf16 gradient tolerance (5e-2), v within
  twice it, as there; the residuals, each bucket's (or leaf's) relative
  Frobenius error within the bf16 gradient tolerance: the residual is the
  off-support gradient (15/16 of the coordinates) plus rounding, so it
  inherits the gradients' error and nothing else.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import types as jtypes
from repro.data.pipeline import SyntheticLM as JSyntheticLM
from repro.optim import optimizers as jopt
from repro.train import bucketing as jbucketing
from repro.train import train_step as jts
from repro_torch import convert
from repro_torch import random as R
from repro_torch.configs.base import RunConfig, ShapeSpec
from repro_torch.configs import registry as tregistry
from repro_torch.configs.registry import smoke_config
from repro_torch.core import collectives as tcoll
from repro_torch.core import types as ttypes
from repro_torch.core import wire as twire
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.examples import train_lm_compressed as example
from repro_torch.kernels.flash_attention import ref as far
from repro_torch.optim import optimizers as topt
from repro_torch.train import bucketing as tbucketing
from repro_torch.train import train_step as tts
from repro_torch.train.trainer import Trainer, TrainerConfig
from test_torch_bucketing import MESH_AXES, _grads, _port_cfg, _smoke
from test_torch_ef_wire import reference_ef_round
from test_torch_training import (CFG, GRAD_TOL, JCFG, JSHAPE, LOSS_TOL, SHAPE, _jparams, _jrun,
                                 _rel, _tparams)

# one intra-op thread: beside other test workers on a loaded machine, torch's
# thread pool stalls for tens of seconds
torch.set_num_threads(1)

EF_PRESETS = ("fixed_k_1bit", "bernoulli_seed_1bit", "binary_packed", "ternary_packed",
              "rotated_binary")


def _ef(cmp):
    return dataclasses.replace(cmp, error_feedback=True)


# ----------------------------------------------------------- plan and state

@pytest.mark.parametrize("preset", EF_PRESETS)
def test_ef_state_shapes_match_reference(preset):
    jcfg, jcmp, shapes, specs = _smoke(preset)
    jcmp = _ef(jcmp)
    plan = jbucketing.build_plan(shapes, specs, MESH_AXES, {"data": 4}, jcmp)
    want = jbucketing.ef_state_shapes(plan, jcmp)
    cmp = convert.compression_config(jcmp)
    tshapes, tspecs = convert_plan_inputs(jcfg)
    tplan = tbucketing.build_plan(tshapes, tspecs, MESH_AXES, {"data": 4}, cmp)
    got = tbucketing.ef_state_shapes(tplan, cmp, 4)
    assert got == {bid: (4,) + tuple(shp) for bid, shp in want.items()} and got
    state = tbucketing.init_ef_state(tplan, cmp, 4, "cpu")
    assert {k: tuple(v.shape) for k, v in state.items()} == got
    assert all(v.dtype == torch.float32 and not v.any() for v in state.values())


def convert_plan_inputs(jcfg):
    return tregistry.param_shapes(_port_cfg(jcfg))


def _jax_bucketed_ef(grads, plan, jcmp, key, n, ef):
    """The reference's EF ``sync_grads_bucketed``, one bucket at a time,
    without a mesh: per compressed bucket the per-rank twin round of
    tests/test_torch_ef_wire.py::reference_ef_round."""
    out, new_ef = {}, {}
    for j, b in enumerate(plan.buckets):
        v = np.concatenate([grads[s.name].reshape(n, -1) for s in b.slots], axis=1)
        if b.kind == "exact":
            acc = np.zeros(b.size, np.float32)
            for r in range(n):
                acc = acc + v[r]
            y = acc / np.float32(n)
        else:
            lcfg = jbucketing._bucket_cfg(b, jcmp, error_feedback=True)
            y, new_ef[b.bid] = reference_ef_round(lcfg, v, ef[b.bid], jax.random.fold_in(key, j))
        for s in b.slots:
            out[s.name] = y[s.offset:s.offset + s.size].reshape(s.shape)
    return out, new_ef


@pytest.mark.parametrize("preset", EF_PRESETS)
def test_sync_grads_bucketed_ef_equals_reference(preset):
    n = 4
    jcfg, jcmp, shapes, specs = _smoke(preset)
    jcmp = _ef(jcmp)
    plan = jbucketing.build_plan(shapes, specs, MESH_AXES, {"data": 4}, jcmp)
    cmp = convert.compression_config(jcmp)
    tshapes, tspecs = convert_plan_inputs(jcfg)
    tplan = tbucketing.build_plan(tshapes, tspecs, MESH_AXES, {"data": 4}, cmp)
    rng = np.random.default_rng(1)
    e0 = {bid: list((np.round(rng.standard_normal(shp) * 4) / 64).astype(np.float32))
          for bid, shp in tbucketing.ef_state_shapes(tplan, cmp, n).items()}
    state = convert.ef_state(e0)
    jef_state = {bid: np.stack(v) for bid, v in e0.items()}
    comm = tcoll.StackedComm(n, "cpu")
    for step in range(2):
        grads = _grads(shapes, n, seed=3 + step)
        jkey = jax.random.fold_in(jax.random.PRNGKey(5), step)
        with jax.threefry_partitionable(False):
            want, jef_state = _jax_bucketed_ef(grads, plan, jcmp, jkey, n, jef_state)
        got, state = tbucketing.sync_grads_bucketed(convert.tree_to_torch(grads), tplan, cmp,
                                                    convert.key_to_torch(jax.random.key_data(jkey)),
                                                    comm, state)
        assert sorted(got) == sorted(want) and sorted(state) == sorted(jef_state)
        for name in want:
            np.testing.assert_array_equal(got[name].numpy(), want[name], err_msg=name)
        for bid in state:
            np.testing.assert_array_equal(state[bid].numpy(), jef_state[bid], err_msg=bid)


def test_per_leaf_sync_threads_state_and_passes_exact_leaves():
    n = 3
    cmp = dataclasses.replace(_ef(convert.compression_config(_smoke("fixed_k_1bit")[1])),
                              bucket=ttypes.BucketSpec(enabled=False))
    shapes, specs = convert_plan_inputs(_smoke("fixed_k_1bit")[0])
    grads = convert.tree_to_torch(_grads({k: tuple(v) for k, v in shapes.items()}, n, seed=4))
    # a leaf sharded over every mesh axis: nothing to sync, its state kept
    grads["zz_sharded"] = torch.ones(n, 4096)
    specs = {**specs, "zz_sharded": ("data",)}
    ef = {k: torch.zeros((n,) + tuple(v.shape[1:])) for k, v in grads.items()}
    ef["zz_sharded"] = torch.full((n, 4096), 0.5)
    before = {k: v.clone() for k, v in ef.items()}
    out, new_ef = tts.sync_grads(grads, specs, MESH_AXES, cmp, R.PRNGKey(2),
                                 tcoll.StackedComm(n, "cpu"), ef)
    assert sorted(new_ef) == sorted(grads) == sorted(out)
    assert out["zz_sharded"] is grads["zz_sharded"]
    assert torch.equal(new_ef["zz_sharded"], before["zz_sharded"])
    for k, g in grads.items():
        if k == "zz_sharded":
            continue
        if g[0].numel() >= cmp.min_compress_size:
            assert new_ef[k].abs().sum() > 0, k          # residual of the compressed leaf
        else:
            assert torch.equal(new_ef[k], before[k]), k  # exact leaf: state passed through
    plain, none = tts.sync_grads(grads, specs, MESH_AXES, dataclasses.replace(
        cmp, error_feedback=False), R.PRNGKey(2), tcoll.StackedComm(n, "cpu"))
    assert none is None and sorted(plain) == sorted(out)


# ------------------------------------------------------- whole steps, n = 1

def _fixed_k_ef(**bucket):
    return jtypes.CompressionConfig(
        encoder=jtypes.EncoderSpec(kind="fixed_k", fraction=1 / 16, center="mean"),
        mode="shared_support", axes=("data",), min_compress_size=1024, error_feedback=True,
        bucket=jtypes.BucketSpec(**bucket))


def _reference_two_steps_ef():
    jcmp = _fixed_k_ef(enabled=False)
    run = _jrun(compression=jcmp)
    mesh = jax.make_mesh((1, 1), ("data", "model"))
    with jax.threefry_partitionable(False):
        step_fn, _, _, bspecs, plan = jts.build_train_step(mesh, JCFG, run, JSHAPE)
        assert plan is None
        params = {k: jnp.asarray(v) for k, v in _jparams()[0].items()}
        opt = jopt.adamw_init(params)
        ef = {k: jnp.zeros(v.shape, jnp.float32) for k, v in params.items()}
        data = JSyntheticLM(JCFG, JSHAPE)
        metrics = []
        for step in range(2):
            params, opt, ef, m = step_fn(params, opt, ef, data.device_batch(step, mesh, bspecs),
                                         jnp.int32(step))
            metrics.append({k: float(v) for k, v in m.items()})
    return ({k: np.asarray(v) for k, v in params.items()},
            {k: np.asarray(v) for k, v in opt.m.items()},
            {k: np.asarray(v) for k, v in opt.v.items()}, metrics,
            {k: np.asarray(v) for k, v in ef.items()})


def test_two_ef_steps_match_reference():
    """The per-leaf path (``bucket.enabled = False``).  The bucketed one
    cannot be held to the reference's step: on the reference's (1, 1) mesh
    the leaves replicated over the model axis sync over it too and form
    buckets of their own, so its plan is not the port's single-axis plan
    (the bucketed EF sync itself is held to the reference, bit for bit, by
    :func:`test_sync_grads_bucketed_ef_equals_reference`)."""
    want_p, want_m, want_v, want_metrics, want_ef = _reference_two_steps_ef()
    run = RunConfig(attn_chunk_q=16, attn_chunk_k=16,
                    compression=convert.compression_config(_fixed_k_ef(enabled=False)))
    step_fn, init_fn, plan = tts.build_train_step(CFG, run, SHAPE, 1, device="cpu")
    assert plan is None
    _, _, ef = init_fn(0)
    assert sorted(ef) == sorted(want_ef)
    assert all(tuple(ef[k].shape) == (1,) + want_ef[k].shape for k in want_ef)
    params = _tparams()
    opt = topt.adamw_init(params)
    data = SyntheticLM(CFG, SHAPE)
    lrs = []
    for step in range(2):
        params, opt, ef, m = step_fn(params, opt, ef, data.batch(step, "cpu"), step)
        np.testing.assert_allclose(float(m["loss"]), want_metrics[step]["loss"],
                                   rtol=LOSS_TOL["bfloat16"])
        np.testing.assert_allclose(float(m["grad_norm"]), want_metrics[step]["grad_norm"],
                                   rtol=GRAD_TOL["bfloat16"])
        lrs.append(float(m["lr"]))
    for k in sorted(want_p):
        np.testing.assert_allclose(params[k].numpy(), want_p[k], rtol=0, atol=2 * sum(lrs),
                                   err_msg=k)
        assert _rel(opt.m[k].numpy(), want_m[k]) <= GRAD_TOL["bfloat16"], k
        assert _rel(opt.v[k].numpy(), want_v[k]) <= 2 * GRAD_TOL["bfloat16"], k
    compressed = 0
    for k in sorted(want_ef):
        got = ef[k][0].numpy()
        if not np.any(want_ef[k]):       # an exact leaf's state stays zero
            assert not got.any(), k
            continue
        compressed += 1
        assert _rel(got, want_ef[k]) <= GRAD_TOL["bfloat16"], k
    assert compressed > 0


# ------------------------------------------------- the port's stacked ranks

def _stacked_run(bucketed):
    cmp = dataclasses.replace(convert.compression_config(_fixed_k_ef(enabled=bucketed)),
                              mode="gather_decode", scatter_decode=False)
    return RunConfig(attn_chunk_q=16, attn_chunk_k=16, compression=cmp)


@pytest.mark.parametrize("bucketed", [True, False])
def test_stacked_ef_step_n4_threads_the_residuals(bucketed):
    """The step's sync is the EF sync of its stacks from the state it was
    given, and it hands back that sync's new residuals, (n, ...) rows."""
    n = 4
    run = _stacked_run(bucketed)
    seen = {}
    step_fn, init_fn, plan = tts.build_train_step(
        CFG, run, SHAPE, n, device="cpu",
        on_phase=lambda name, **st: seen.setdefault(name, dict(st)))
    params, opt, ef = init_fn(0)
    assert ef and all(v.shape[0] == n and not v.any() for v in ef.values())
    before = {k: v.clone() for k, v in ef.items()}
    batch = SyntheticLM(CFG, SHAPE).batch(0, "cpu")
    _, _, ef1, metrics = step_fn(params, opt, ef, batch, 0)
    assert bool(torch.isfinite(metrics["loss"]))
    stacks, synced, key = seen["sync"]["grads"], seen["sync"]["synced"], seen["sync"]["key"]
    assert seen["sync"]["ef_state"] is ef1
    comm = tcoll.StackedComm(n, "cpu")
    if bucketed:
        want, want_ef = tbucketing.sync_grads_bucketed(stacks, plan, run.compression, key, comm,
                                                       before)
    else:
        _, specs = tts.param_shapes(CFG)
        want, want_ef = tts.sync_grads(stacks, specs, ("data",), run.compression, key, comm,
                                       before)
    assert all(torch.equal(synced[k], want[k]) for k in want)
    assert sorted(ef1) == sorted(want_ef)
    assert all(torch.equal(ef1[k], want_ef[k]) for k in want_ef)
    assert any(v.any() for v in ef1.values())


def test_trainer_keeps_the_ef_state():
    run = _stacked_run(True)
    trainer = Trainer(CFG, run, SHAPE, TrainerConfig(steps=3, log_every=1), n=2, device="cpu")
    assert trainer.ef_state is None
    _, opt, hist = trainer.fit()
    assert [h["step"] for h in hist] == [0, 1, 2] and int(opt.step) == 3
    assert all(np.isfinite(h["loss"]) and np.isfinite(h["grad_norm"]) for h in hist)
    shapes = tbucketing.ef_state_shapes(trainer.sync_plan, run.compression, 2)
    assert {k: tuple(v.shape) for k, v in trainer.ef_state.items()} == shapes
    assert all(bool(torch.isfinite(v).all()) and v.any() for v in trainer.ef_state.values())


def test_convert_ef_state_per_leaf_and_stacked():
    per_leaf = {"w": [np.full((2, 3), i, np.float32) for i in range(4)],
                "b": np.arange(12, dtype=np.float64).reshape(4, 3)}
    got = convert.ef_state(per_leaf)
    assert got["w"].shape == (4, 2, 3) and got["w"].dtype == torch.float32
    assert torch.equal(got["w"][3], torch.full((2, 3), 3.0))
    assert torch.equal(got["b"], torch.arange(12, dtype=torch.float32).reshape(4, 3))


# ----------------------------------------------------------------- example

TINY = dict(cfg=smoke_config("qwen3-4b"), shape=ShapeSpec("tiny", "train", 32, 4), n=2)


def test_example_ef_run_at_a_tiny_size(capsys):
    hist, tr = example.run(2, example.ef_compression(), "tiny EF", "cpu", **TINY)
    assert len(hist) == 2 and all(np.isfinite(h["loss"]) for h in hist)
    out = capsys.readouterr().out
    assert "== tiny EF ==" in out and out.count("ef residual") == len(tr.ef_state) > 0
    assert all(v.shape[0] == 2 for v in tr.ef_state.values())


def test_example_attention_takes_the_flash_path(monkeypatch):
    """The example's attention is the flash path, as the reference's is: on
    the CPU the plain blockwise forward, at lm-8m's head dim of 32, once a
    layer and rank."""
    seen = []
    real = far.flash_attention_fwd

    def spy(q, *args, **kwargs):
        seen.append(q.shape[-1])
        return real(q, *args, **kwargs)

    monkeypatch.setattr(far, "flash_attention_fwd", spy)
    cfg = dataclasses.replace(example.CFG, num_layers=1)
    hist, _ = example.run(1, ttypes.CompressionConfig(mode="none"), "tiny flash", "cpu", cfg=cfg,
                          shape=ShapeSpec("tiny", "train", 32, 4), n=2)
    assert np.isfinite(hist[0]["loss"]) and seen == [32, 32]


@pytest.mark.parametrize("argv", (["--steps", "1"], ["--steps", "1", "--preset", "ef_binary"]))
def test_example_main_on_the_cpu(argv, capsys, monkeypatch):
    monkeypatch.setattr(example, "run", functools.partial(example.run, **TINY))
    assert example.main(argv + ["--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "final loss" in out and "ef residual" in out
    assert twire.resolve(example.ef_compression()).name == "ef_fixed_k_shared"
