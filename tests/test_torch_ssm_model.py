"""The port's SSM family against the JAX package at the reference's smoke
SSM config (``smoke_config("mamba2-130m")``: 2 layers, d_model 64, 8
heads of 16, d_state 16, chunk 16, vocab 512, tied embeddings): parameter
names, shapes and specs, the configs and the run config, the train loss and
its gradients on the reference's own parameters, two whole training steps
against the reference's ``build_train_step`` on a (1, 1) mesh, prefill and
three decode steps against the reference's ``engine.build_serve_fns``
with their caches; then the port alone: the stacked n = 4 step under
``fixed_k_1bit``, ``Trainer.fit``, the training CLI, the decode against one
forward, remat.

The reference runs at ``tp = 1``, its parameters from ``model.init`` inside
``jax.threefry_partitionable(False)``; its loss and gradients op by op,
its whole step and its serving functions jitted as the reference builds
them (both compute in bf16 whatever the run config says: the comparisons
of those hold bf16 tolerances).  One shape per test kind: training batches
of 4 × 32 tokens, prompts of 2 × 32 tokens and 3 decode steps.

Tolerances are the dense family's (``tests/test_torch_training.py``,
``tests/test_torch_serving.py``) except bf16 gradients: loss 1e-5 (f32) and
1e-3 (bf16) relative; per-leaf gradients 1e-4 (f32) relative Frobenius;
bf16 logits 5e-2 absolute.  This model's bf16 gradients are far noisier
than the dense family's at the smoke size: the reference's own bf16
gradients sit 1.8–32% from its f32 ones per leaf (``w_C`` and ``conv_C``
farthest: C enters every output through the scan), and the port's
1.1–5.3% from the reference's bf16 ones.  So a bf16 gradient is held to
``GRAD_TOL["bfloat16"]`` = 1e-1 per leaf and, where the reference's f32
gradients are at hand, to no more than the reference's own bf16-to-f32
distance (readings at most 0.61 of it); two whole bf16 steps: parameters
within 2·(lr₀ + lr₁) absolute, m within 1e-1 and v within 2e-1
relative (readings 5.4e-2 and 1.2e-1).  The caches: conv windows (bf16)
within ``CACHE_TOL`` = 2e-2 of their largest |value|, states within
``STATE_TOL`` = 2e-2 relative Frobenius (each a function of bf16
activations that the two sides round in their own order; readings 7.4e-3
and 1.0e-2; the prefill logits 6.9e-3).
"""
import dataclasses
import functools
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import RunConfig as JRunConfig
from repro.configs.base import ShapeSpec as JShapeSpec
from repro.configs.registry import get_config as j_get_config
from repro.configs.registry import get_run_config as j_get_run_config
from repro.configs.registry import smoke_config as j_smoke_config
from repro.core import types as jtypes
from repro.data.pipeline import SyntheticLM as JSyntheticLM
from repro.models import model as jmodel
from repro.optim import optimizers as jopt
from repro.serving import engine as jengine
from repro.train import train_step as jts
from repro_torch import convert
from repro_torch.configs.base import RunConfig, ShapeSpec
from repro_torch.configs.registry import (compression_preset, get_config, get_run_config,
                                          param_shapes, smoke_config)
from repro_torch.core.collectives import StackedComm
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.kernels import backend
from repro_torch.launch import train as train_cli
from repro_torch.models import model as tmodel
from repro_torch.models import transformer as ttfm
from repro_torch.optim import optimizers as topt
from repro_torch.serving import engine as tengine
from repro_torch.train import bucketing
from repro_torch.train import synthetic
from repro_torch.train import train_step as tts
from repro_torch.train.trainer import Trainer, TrainerConfig

# one intra-op thread: beside other test workers on a loaded machine, torch's
# thread pool stalls for tens of seconds
torch.set_num_threads(1)

ARCH = "mamba2-130m"
SIZES = {"data": 1, "model": 1}
B, S0, STEPS = 2, 32, 3            # prompt of S0 tokens, then STEPS decode steps
TB, TS = 4, 32                     # training batch
LOSS_TOL = {"float32": 1e-5, "bfloat16": 1e-3}
GRAD_TOL = {"float32": 1e-4, "bfloat16": 1e-1}
LOGIT_TOL, CACHE_TOL, STATE_TOL = 5e-2, 2e-2, 2e-2
CFG = smoke_config(ARCH)
SHAPE = ShapeSpec("t", "train", TS, TB)
JSHAPE = JShapeSpec("t", "train", TS, TB)


def _jrun(**kw):
    return JRunConfig(remat=False, **kw)


def _rel(got, want) -> float:
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(np.asarray(got, np.float64) - want) / np.linalg.norm(want))


def _close(got, want, tol, what=""):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    err = float(np.abs(got - want).max()) / float(np.abs(want).max())
    assert err <= tol, f"{what}: max |Δ| / max |ref| = {err:.3g} > {tol}"
    return err


@functools.lru_cache(maxsize=None)
def _jparams():
    jcfg = j_smoke_config(ARCH)
    ctx = jmodel.make_ctx(jcfg, _jrun(), SIZES)
    with jax.threefry_partitionable(False):
        params, specs = jmodel.init(jax.random.PRNGKey(0), jcfg, ctx, SIZES, _jrun())
    return {k: np.array(v) for k, v in params.items()}, specs


def _tparams(requires_grad=False):
    return {k: v.requires_grad_(requires_grad)
            for k, v in convert.tree_to_torch(_jparams()[0]).items()}


# ------------------------------------------------------------ configs, init

@pytest.mark.parametrize("which", ["smoke", "full"])
def test_param_shapes_match_reference(which):
    jcfg = j_smoke_config(ARCH) if which == "smoke" else j_get_config(ARCH)
    cfg = smoke_config(ARCH) if which == "smoke" else get_config(ARCH)
    assert convert.arch_config(jcfg) == cfg
    shapes, specs = param_shapes(cfg)
    ctx = jmodel.make_ctx(jcfg, _jrun(), SIZES, dtype=jnp.float32)
    jparams, jspecs = jmodel.init(jax.random.PRNGKey(0), jcfg, ctx, SIZES, _jrun(),
                                  abstract=True)
    assert list(shapes) == list(jparams)                      # the reference's leaf order
    assert shapes == {k: tuple(v.shape) for k, v in jparams.items()}
    assert specs == {k: tuple(v) for k, v in jspecs.items()}
    assert "layers.norm2" not in shapes and not any(".attn." in k for k in shapes)
    if which == "full":
        assert sum(int(np.prod(s)) for s in shapes.values()) == 128_940_480


def test_init_is_seeded_and_has_the_shapes():
    params = tmodel.init(0, CFG, device="cpu")
    shapes, _ = param_shapes(CFG)
    assert list(params) == list(shapes)
    assert {k: tuple(v.shape) for k, v in params.items()} == shapes
    assert all(v.dtype == torch.float32 for v in params.values())
    assert torch.equal(params["layers.ssm.norm"], torch.ones_like(params["layers.ssm.norm"]))
    again = tmodel.init(0, CFG, device="cpu")
    assert all(torch.equal(params[k], again[k]) for k in params)


def test_run_config_matches_reference():
    want = convert.run_config(j_get_run_config(ARCH, "train_4k"))
    got = get_run_config(ARCH, "train_4k")
    assert got == want
    assert (got.model_parallel, got.seq_shard, got.microbatches, got.remat) == (
        False, False, 1, True)
    assert got.compression == compression_preset("fixed_k_1bit", axes=("data",))
    cfg, run, shape = synthetic.ssm_train_path()
    assert cfg == get_config(ARCH) and cfg.num_layers == 24 and run == got
    assert (shape.seq_len, shape.global_batch) == (4096, synthetic.N)


# ---------------------------------------------------------------- training

@functools.lru_cache(maxsize=None)
def _reference_loss_and_grads(dtype):
    jcfg = j_smoke_config(ARCH)
    params, specs = _jparams()
    run = _jrun()
    ctx = jmodel.make_ctx(jcfg, run, SIZES, dtype=getattr(jnp, dtype))
    batch = JSyntheticLM(jcfg, JSHAPE).host_batch(0)
    with jax.threefry_partitionable(False):
        (loss, metrics), grads = jax.value_and_grad(
            lambda p: jmodel.train_loss(ctx, p, specs, jcfg, run, batch, float(TB * TS)),
            has_aux=True)(params)
    return float(loss), float(metrics["aux"]), {k: np.asarray(v) for k, v in grads.items()}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_train_loss_and_grads_match_reference(dtype):
    want_loss, want_aux, want = _reference_loss_and_grads(dtype)
    run = RunConfig(remat=False, compute_dtype=dtype)
    params = _tparams(requires_grad=True)
    batch = SyntheticLM(CFG, SHAPE).batch(0, "cpu")
    loss, metrics = tmodel.train_loss(tmodel.make_ctx(CFG, run), params, CFG, run, batch,
                                      float(TB * TS))
    names = sorted(params)
    grads = dict(zip(names, torch.autograd.grad(loss, [params[k] for k in names])))
    np.testing.assert_allclose(float(loss.detach()), want_loss, rtol=LOSS_TOL[dtype])
    assert float(metrics["aux"]) == want_aux == 0.0
    assert sorted(want) == names
    errs = {k: _rel(grads[k].numpy(), want[k]) for k in names}
    assert max(errs.values()) <= GRAD_TOL[dtype], errs
    if dtype == "bfloat16":       # within the reference's own bf16 noise
        want32 = _reference_loss_and_grads("float32")[2]
        noise = {k: _rel(want[k], want32[k]) for k in names}
        assert all(errs[k] <= noise[k] for k in names), (errs, noise)


def test_remat_changes_nothing():
    """Recomputing each layer in the backward gives the same loss and
    gradients, bit for bit (the same ops in the same order on the CPU)."""
    batch = SyntheticLM(CFG, SHAPE).batch(0, "cpu")
    out = []
    for remat in (False, True):
        run = RunConfig(remat=remat)
        params = _tparams(requires_grad=True)
        loss, _ = tmodel.train_loss(tmodel.make_ctx(CFG, run), params, CFG, run, batch,
                                    float(TB * TS))
        out.append((loss.detach(), *torch.autograd.grad(loss, list(params.values()))))
    assert all(torch.equal(a, b) for a, b in zip(*out))


NONE = dict(mode="none")


@functools.lru_cache(maxsize=None)
def _reference_two_steps():
    jcfg = j_smoke_config(ARCH)
    run = _jrun(compression=jtypes.CompressionConfig(**NONE))
    mesh = jax.make_mesh((1, 1), ("data", "model"))
    with jax.threefry_partitionable(False):
        step_fn, _, _, bspecs, _ = jts.build_train_step(mesh, jcfg, run, JSHAPE)
        params = {k: jnp.asarray(v) for k, v in _jparams()[0].items()}
        opt = jopt.adamw_init(params)
        ef = jax.tree.map(lambda p: jnp.zeros((), jnp.float32), params)
        data = JSyntheticLM(jcfg, JSHAPE)
        metrics = []
        for step in range(2):
            params, opt, ef, m = step_fn(params, opt, ef, data.device_batch(step, mesh, bspecs),
                                         jnp.int32(step))
            metrics.append({k: float(v) for k, v in m.items()})
    return ({k: np.asarray(v) for k, v in params.items()},
            {k: np.asarray(v) for k, v in opt.m.items()},
            {k: np.asarray(v) for k, v in opt.v.items()}, metrics)


@pytest.mark.parametrize("bucketed", [True, False])
def test_two_steps_match_reference(bucketed):
    want_p, want_m, want_v, want_metrics = _reference_two_steps()
    cmp = dataclasses.replace(compression_preset("fixed_k_1bit", axes=("data",)), **NONE)
    cmp = dataclasses.replace(cmp, bucket=dataclasses.replace(cmp.bucket, enabled=bucketed))
    run = RunConfig(remat=False, compression=cmp)
    step_fn, _, plan = tts.build_train_step(CFG, run, SHAPE, 1, device="cpu")
    assert (plan is not None) == bucketed
    params = _tparams()
    opt = topt.adamw_init(params)
    data = SyntheticLM(CFG, SHAPE)
    lrs = []
    for step in range(2):
        params, opt, _, m = step_fn(params, opt, {}, data.batch(step, "cpu"), step)
        np.testing.assert_allclose(float(m["loss"]), want_metrics[step]["loss"],
                                   rtol=LOSS_TOL["bfloat16"])
        np.testing.assert_allclose(float(m["grad_norm"]), want_metrics[step]["grad_norm"],
                                   rtol=GRAD_TOL["bfloat16"])
        np.testing.assert_allclose(float(m["lr"]), want_metrics[step]["lr"], rtol=1e-6)
        assert "aux" not in m
        lrs.append(float(m["lr"]))
    assert int(opt.step) == 2
    for k in sorted(want_p):
        np.testing.assert_allclose(params[k].numpy(), want_p[k], rtol=0, atol=2 * sum(lrs),
                                   err_msg=k)
        assert _rel(opt.m[k].numpy(), want_m[k]) <= GRAD_TOL["bfloat16"], k
        assert _rel(opt.v[k].numpy(), want_v[k]) <= 2 * GRAD_TOL["bfloat16"], k


# ----------------------------------------------------------------- serving

def _tokens():
    return np.random.default_rng(9).integers(0, CFG.vocab_size, (B, S0 + STEPS)).astype(np.int32)


@functools.lru_cache(maxsize=None)
def _reference_serve():
    """The reference's engine: prefill of S0 tokens, then STEPS decode steps
    fed the known tokens: (prefill logits, [cache after prefill and after
    each step], [next token of each step]) as numpy."""
    jcfg = j_smoke_config(ARCH)
    mesh = jax.make_mesh((1, 1), ("data", "model"))
    run = JRunConfig(microbatches=1, model_parallel=False, seq_shard=False, remat=False,
                     compression=jtypes.CompressionConfig(mode="none"))
    shape = JShapeSpec("serve", "decode", S0 + STEPS, B)
    toks = _tokens()
    params = {k: jnp.asarray(v) for k, v in _jparams()[0].items()}
    with jax.threefry_partitionable(False):
        prefill_fn, decode_fn, _, _ = jengine.build_serve_fns(mesh, jcfg, run, shape)
        cache, logits = prefill_fn(params, {"tokens": toks[:, :S0]})
        caches = [{k: np.asarray(v, np.float32) for k, v in cache.items()}]
        nexts = []
        for i in range(STEPS):
            nxt, cache = decode_fn(params, cache, toks[:, S0 + i:S0 + i + 1], jnp.int32(S0 + i))
            caches.append({k: np.asarray(v, np.float32) for k, v in cache.items()})
            nexts.append(np.asarray(nxt))
    return np.asarray(logits, np.float32), caches, nexts


def test_prefill_and_decode_match_reference_engine():
    want_logits, want_caches, want_next = _reference_serve()
    run = RunConfig(model_parallel=False, seq_shard=False, remat=False)
    prefill_fn, decode_fn = tengine.build_serve_fns(
        CFG, run, ShapeSpec("serve", "decode", S0 + STEPS, B), device="cpu")
    params = _tparams()
    toks = torch.from_numpy(_tokens())
    backend.reset_launches()
    cache, logits = prefill_fn(params, {"tokens": toks[:, :S0]})
    assert logits.shape == (B, 1, CFG.vocab_size) and logits.dtype == torch.float32
    np.testing.assert_allclose(logits.numpy(), want_logits, atol=LOGIT_TOL, rtol=0)
    ctx = tmodel.make_ctx(CFG, run)
    got = [{k: v.clone() for k, v in cache.items()}]
    step_logits = []
    for i in range(STEPS):
        pos = S0 + i
        nxt, lg, cache = tmodel.decode_step(ctx, params, CFG, run, cache, toks[:, pos:pos + 1],
                                            pos)
        got.append({k: v.clone() for k, v in cache.items()})
        step_logits.append(lg)
        # decode_fn is decode_step's next token
        assert torch.equal(nxt, decode_fn(params, {k: v.clone() for k, v in got[-2].items()},
                                          toks[:, pos:pos + 1], pos)[0])
    assert not backend.launches
    for step, (g, w) in enumerate(zip(got, want_caches)):
        assert sorted(g) == sorted(w) == ["conv_B", "conv_C", "conv_x", "state"]
        for k in ("conv_x", "conv_B", "conv_C"):
            assert g[k].dtype == torch.bfloat16 and g[k].shape == w[k].shape
            _close(g[k].float().numpy(), w[k], CACHE_TOL, f"step {step} {k}")
        assert g["state"].dtype == torch.float32
        assert _rel(g["state"].numpy(), w["state"]) <= STATE_TOL, step
    # greedy tokens equal wherever the port's top-2 margin exceeds the tolerance
    for lg, want in zip(step_logits, want_next):
        top2 = torch.topk(lg[:, 0], 2, dim=-1).values
        decided = (top2[:, 0] - top2[:, 1]).numpy() > 2 * LOGIT_TOL
        np.testing.assert_array_equal(torch.argmax(lg[:, 0], -1).numpy()[decided],
                                      want[:, 0][decided])


def test_cache_does_not_grow_with_the_prompt():
    """The SSM cache's shapes and bytes are the same for any prompt length
    and any ``s_max``."""
    run = RunConfig(remat=False)
    ctx = tmodel.make_ctx(CFG, run)
    params = tmodel.init(0, CFG, device="cpu")
    sizes = set()
    for s, s_max in ((16, None), (64, 4096)):
        toks = torch.from_numpy(np.random.default_rng(s).integers(0, CFG.vocab_size, (B, s)))
        cache, _ = tmodel.prefill(ctx, params, CFG, run, {"tokens": toks}, s_max=s_max)
        sizes.add(tuple((k, tuple(v.shape), v.dtype) for k, v in sorted(cache.items())))
        zero = tmodel.make_cache(ctx, CFG, B, s_max or s, device="cpu")
        assert {k: (v.shape, v.dtype) for k, v in zero.items()} == {
            k: (v.shape, v.dtype) for k, v in cache.items()}
    assert len(sizes) == 1


def test_decode_consistent_with_forward():
    """f32 compute and an f32 cache (the forward's own windows and states;
    ``prefill`` rounds the windows to bf16, the reference's cache): the
    teacher-forced decode gives the logits of one forward over the whole
    sequence (within 1e-4: the chunked scan against the recurrence)."""
    run = RunConfig(remat=False, compute_dtype="float32")
    ctx = tmodel.make_ctx(CFG, run)
    params = _tparams()
    toks = torch.from_numpy(np.random.default_rng(10).integers(0, CFG.vocab_size, (B, 48)))
    x = tmodel.embed_inputs(ctx, params, CFG, {"tokens": toks[:, :S0]})
    h, _, (conv, st) = ttfm.forward(ctx, params, CFG, run, x, torch.arange(S0), want_cache=True)
    cache = {"conv_x": conv["x"], "conv_B": conv["B"], "conv_C": conv["C"], "state": st}
    bf16, logits = tmodel.prefill(ctx, params, CFG, run, {"tokens": toks[:, :S0]})
    assert all(torch.equal(bf16[k], cache[k].to(bf16[k].dtype)) for k in cache)
    assert torch.equal(logits, ttfm.lm_head_logits(ctx, params, CFG, h[:, -1:]))
    got = [logits]
    for i in range(S0, 48):
        _, logits, cache = tmodel.decode_step(ctx, params, CFG, run, cache, toks[:, i:i + 1], i)
        got.append(logits)
    x = tmodel.embed_inputs(ctx, params, CFG, {"tokens": toks})
    h, aux, _ = ttfm.forward(ctx, params, CFG, run, x, torch.arange(48))
    want = ttfm.lm_head_logits(ctx, params, CFG, h[:, S0 - 1:])
    np.testing.assert_allclose(torch.cat(got, 1).numpy(), want.numpy(), atol=1e-4, rtol=0)
    assert float(aux) == 0.0


# ------------------------------------------------------------- the port alone

def _fixed_k():
    return dataclasses.replace(compression_preset("fixed_k_1bit", axes=("data",)),
                               min_compress_size=1024)


def _rank_grads(run, params, batch):
    ctx = tmodel.make_ctx(CFG, run)
    leaves = {k: v.detach().requires_grad_() for k, v in params.items()}
    loss, _ = tmodel.train_loss(ctx, leaves, CFG, run, batch, float(TB * TS))
    names = sorted(leaves)
    return dict(zip(names, torch.autograd.grad(loss, [leaves[k] for k in names])))


def test_stacked_step_n4_fixed_k():
    """n = 4 stacked ranks under ``fixed_k_1bit``: row r of each stack is
    rank r's own gradient, the synced gradient is the sync of the stacks,
    compressed, and the two issue schedules give the same bits."""
    n = 4
    run = RunConfig(remat=False, compression=_fixed_k())
    out = {}
    for overlap in (True, False):
        cmp = dataclasses.replace(run.compression, bucket=dataclasses.replace(
            run.compression.bucket, overlap=overlap))
        seen = {}
        step_fn, init_fn, plan = tts.build_train_step(
            CFG, dataclasses.replace(run, compression=cmp), SHAPE, n, device="cpu",
            on_phase=lambda name, **st: seen.setdefault(name, st))
        params, opt, ef = init_fn(0)
        batch = SyntheticLM(CFG, SHAPE).batch(0, "cpu")
        new_params, _, _, m = step_fn(params, opt, ef, batch, 0)
        assert seen["sync"]["schedule"] == ("backward-pipelined" if overlap else "post-backward")
        out[overlap] = (new_params, float(m["loss"]))
    stacks, synced, key = seen["sync"]["grads"], seen["sync"]["synced"], seen["sync"]["key"]
    for r in range(n):
        own = _rank_grads(run, params, {k: v[r:r + 1] for k, v in batch.items()})
        assert all(torch.equal(stacks[k][r], own[k]) for k in own), r
    assert any(b.kind == "compressed" for b in plan.buckets)
    want, _ = bucketing.sync_grads_bucketed(stacks, plan, run.compression, key,
                                            StackedComm(n, "cpu"))
    assert all(torch.equal(synced[k], want[k]) for k in want)
    assert any(not torch.equal(synced[k], stacks[k].mean(0)) for k in synced)
    assert out[True][1] == out[False][1]
    assert all(torch.equal(out[True][0][k], out[False][0][k]) for k in out[True][0])


def test_trainer_fit_two_steps():
    run = RunConfig(compression=_fixed_k())
    trainer = Trainer(CFG, run, SHAPE, TrainerConfig(steps=2, log_every=1), n=2, device="cpu")
    params, opt, hist = trainer.fit()
    assert [h["step"] for h in hist] == [0, 1] and int(opt.step) == 2
    assert all(np.isfinite(h["loss"]) and np.isfinite(h["grad_norm"]) for h in hist)
    assert "aux" not in hist[0]
    assert all(bool(torch.isfinite(v).all()) for v in params.values())


STEP_LINE = re.compile(r"^step +(\d+)  loss (\S+)  gnorm (\S+)  lr (\S+)$")


def test_cli_smoke_run(capsys):
    assert train_cli.main(["--arch", ARCH, "--smoke", "--devices", "4", "--steps", "2",
                           "--device", "cpu"]) == 0
    rows = [STEP_LINE.match(line) for line in capsys.readouterr().out.strip().splitlines()]
    assert rows and all(rows) and [int(m[1]) for m in rows] == [0, 1]
    assert all(np.isfinite(float(m[2])) for m in rows)
