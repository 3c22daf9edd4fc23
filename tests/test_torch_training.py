"""The port's training step against the JAX package, at
``smoke_config("qwen3-4b")`` (2 layers, d 64, 4/2 heads of 16, vocab 512,
qk-norm, tied embeddings): the synthetic batches, the cross-entropy, the
train loss and its per-leaf gradients, the schedule and AdamW, and two
whole steps; then the port's own stacked-rank step (n = 4 under fixed-k,
microbatches) and ``Trainer.fit``.

The reference runs at ``tp = 1`` outside any mesh except for its whole
step (``jax.make_mesh((1, 1), ("data", "model"))``); its parameters come
from ``model.init`` inside ``jax.threefry_partitionable(False)``; its loss
and gradients are jitted (the comparisons hold tolerances).  Its train step
computes in bf16 whatever ``RunConfig.compute_dtype`` says (``make_ctx``'s
default), so the whole-step comparison runs in bf16.  On the CPU the
reference's flash attention is its chunked XLA path, the port's the plain
blockwise forward and backward: the same function.

Tolerances, each with its reason:
* loss: 1e-5 relative at f32 compute, 1e-3 at bf16 (every activation
  rounded to bf16, in another order; observed 8e-8 and 6e-5);
* gradients, per leaf, relative Frobenius error ‖Δg‖/‖g‖: 1e-4 at f32 (sums
  in another order; observed ≤ 1.7e-6), 5e-2 at bf16 (bf16 activations and
  products, the tied head's gradient summed over chunks in bf16 by XLA and
  in f32 here; observed ≤ 1.7e-2, on ``layers.attn.wq``);
* AdamW on the same gradients and state: 1e-6 relative (f32 ulps);
* two whole steps: AdamW's first steps move each coordinate by about ±lr
  whatever the gradient's size, so a coordinate whose bf16 gradient changes
  sign between the two computations moves by up to 2·lr the other way:
  parameters within 2·(lr₀ + lr₁) = 1.8e-5 absolute (observed 1.66e-5);
  m within the bf16 gradient tolerance (observed 2.2e-2), v, a square,
  within twice it (observed 2.4e-2).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import RunConfig as JRunConfig
from repro.configs.base import ShapeSpec as JShapeSpec
from repro.configs.registry import smoke_config as j_smoke_config
from repro.core import types as jtypes
from repro.data.pipeline import SyntheticLM as JSyntheticLM
from repro.models import model as jmodel
from repro.models import transformer as jtfm
from repro.optim import optimizers as jopt
from repro.train import train_step as jts
from repro_torch import convert
from repro_torch.configs.base import RunConfig, ShapeSpec
from repro_torch.configs.registry import compression_preset, smoke_config
from repro_torch.core.collectives import StackedComm
from repro_torch.core.wire.base import NotPortedError
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.kernels import backend
from repro_torch.models import model as tmodel
from repro_torch.models import transformer as ttfm
from repro_torch.optim import optimizers as topt
from repro_torch.train import bucketing
from repro_torch.train import train_step as tts
from repro_torch.train.trainer import Trainer, TrainerConfig

# one intra-op thread: beside other test workers on a loaded machine, torch's
# thread pool stalls for tens of seconds
torch.set_num_threads(1)

JCFG = j_smoke_config("qwen3-4b")
CFG = smoke_config("qwen3-4b")
B, S = 4, 32
JSHAPE = JShapeSpec("train_smoke", "train", S, B)
SHAPE = ShapeSpec("train_smoke", "train", S, B)
SIZES = {"data": 1, "model": 1}
LOSS_TOL = {"float32": 1e-5, "bfloat16": 1e-3}
GRAD_TOL = {"float32": 1e-4, "bfloat16": 5e-2}


def _jrun(**kw):
    return JRunConfig(attn_chunk_q=16, attn_chunk_k=16, **kw)


def _rel(got, want) -> float:
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(np.asarray(got, np.float64) - want) / np.linalg.norm(want))


@functools.lru_cache(maxsize=None)
def _jparams():
    ctx = jmodel.make_ctx(JCFG, _jrun(), SIZES)
    with jax.threefry_partitionable(False):
        params, specs = jmodel.init(jax.random.PRNGKey(0), JCFG, ctx, SIZES, _jrun())
    return {k: np.array(v) for k, v in params.items()}, specs


def _tparams(requires_grad=False):
    params = convert.tree_to_torch(_jparams()[0])
    return {k: v.requires_grad_(requires_grad) for k, v in params.items()}


# ----------------------------------------------------------------- pieces

@pytest.mark.parametrize("seed,step", [(0, 0), (0, 7), (3, 1)])
def test_synthetic_batches_bit_equal(seed, step):
    want = JSyntheticLM(JCFG, JSHAPE, seed=seed).host_batch(step)
    data = SyntheticLM(CFG, SHAPE, seed=seed)
    got = data.host_batch(step)
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])
    on_dev = data.batch(step, "cpu")
    for k in want:
        np.testing.assert_array_equal(on_dev[k].numpy(), want[k])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_vocab_parallel_ce_value_and_grad(dtype):
    rng = np.random.default_rng(0)
    h = rng.standard_normal((2, 64, JCFG.d_model), np.float32)
    labels = rng.integers(0, JCFG.vocab_size, (2, 64)).astype(np.int32)
    mask = (rng.random((2, 64)) > 0.2).astype(np.float32)
    embed = _jparams()[0]["embed"]
    jctx = jmodel.make_ctx(JCFG, _jrun(), SIZES, dtype=getattr(jnp, dtype))
    jd = getattr(jnp, dtype)

    def jce(h_, e_):
        return jtfm.vocab_parallel_ce(jctx, {"embed": e_}, JCFG, h_.astype(jd), labels, mask,
                                      chunk=16)

    (jsum, jcnt), jvjp = jax.vjp(jce, jnp.asarray(h), jnp.asarray(embed))
    jgh, jge = jvjp((jnp.float32(1.0), jnp.float32(0.0)))
    tctx = tmodel.make_ctx(CFG, RunConfig(compute_dtype=dtype))
    th = torch.from_numpy(h).requires_grad_()
    te = torch.from_numpy(embed.copy()).requires_grad_()
    tsum, tcnt = ttfm.vocab_parallel_ce(tctx, {"embed": te}, CFG, th.to(getattr(torch, dtype)),
                                        torch.from_numpy(labels), torch.from_numpy(mask),
                                        chunk=16)
    assert tsum.dtype == torch.float32 and float(tcnt) == float(jcnt) == mask.sum()
    np.testing.assert_allclose(float(tsum.detach()), float(jsum), rtol=LOSS_TOL[dtype])
    gh, ge = torch.autograd.grad(tsum, (th, te))
    assert _rel(gh.numpy(), jgh) <= GRAD_TOL[dtype]
    assert _rel(ge.numpy(), jge) <= GRAD_TOL[dtype]


@functools.lru_cache(maxsize=None)
def _reference_loss_and_grads(dtype, remat):
    params, specs = _jparams()
    run = _jrun(remat=remat)
    ctx = jmodel.make_ctx(JCFG, run, SIZES, dtype=getattr(jnp, dtype))
    batch = JSyntheticLM(JCFG, JSHAPE).host_batch(0)
    fn = jax.jit(jax.value_and_grad(
        lambda p: jmodel.train_loss(ctx, p, specs, JCFG, run, batch, float(B * S))[0]))
    loss, grads = fn(params)
    return float(loss), {k: np.asarray(v) for k, v in grads.items()}


@pytest.mark.parametrize("remat", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_train_loss_and_grads_match_reference(dtype, remat):
    want_loss, want = _reference_loss_and_grads(dtype, remat)
    run = RunConfig(attn_chunk_q=16, attn_chunk_k=16, remat=remat, compute_dtype=dtype)
    ctx = tmodel.make_ctx(CFG, run)
    params = _tparams(requires_grad=True)
    batch = SyntheticLM(CFG, SHAPE).batch(0, "cpu")
    backend.reset_launches()
    loss, metrics = tmodel.train_loss(ctx, params, CFG, run, batch, float(B * S))
    names = sorted(params)
    grads = dict(zip(names, torch.autograd.grad(loss, [params[k] for k in names])))
    assert not backend.launches                   # CPU: the plain versions
    assert float(metrics["count"]) == B * S
    np.testing.assert_allclose(float(loss.detach()), want_loss, rtol=LOSS_TOL[dtype])
    assert sorted(want) == names
    errs = {k: _rel(grads[k].numpy(), want[k]) for k in names}
    assert max(errs.values()) <= GRAD_TOL[dtype], errs


def test_remat_changes_nothing():
    """Recomputing each layer in the backward gives the same gradients, bit
    for bit (the same ops in the same order on the CPU)."""
    batch = SyntheticLM(CFG, SHAPE).batch(0, "cpu")
    out = []
    for remat in (False, True):
        run = RunConfig(attn_chunk_q=16, attn_chunk_k=16, remat=remat, remat_attention=remat)
        params = _tparams(requires_grad=True)
        loss, _ = tmodel.train_loss(tmodel.make_ctx(CFG, run), params, CFG, run, batch,
                                    float(B * S))
        out.append(torch.autograd.grad(loss, list(params.values())))
    assert all(torch.equal(a, b) for a, b in zip(*out))


def test_lr_schedule_matches_reference():
    cfg = jopt.AdamWConfig(warmup_steps=10, total_steps=100)
    steps = np.array([0, 1, 5, 9, 10, 11, 37, 99, 100, 250], np.int32)
    want = np.array([jopt.lr_at(cfg, jnp.int32(s)) for s in steps])
    got = np.array([float(topt.lr_at(topt.AdamWConfig(warmup_steps=10, total_steps=100),
                                     torch.tensor(int(s), dtype=torch.int32))) for s in steps])
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=0)


def test_adamw_update_matches_reference():
    rng = np.random.default_rng(4)
    shapes = {"w": (8, 16), "stack": (2, 16), "norm": (16,)}
    params = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    grads = {k: rng.standard_normal(s).astype(np.float32) * 0.1 for k, s in shapes.items()}
    m = {k: rng.standard_normal(s).astype(np.float32) * 0.01 for k, s in shapes.items()}
    v = {k: rng.random(s).astype(np.float32) * 1e-3 for k, s in shapes.items()}
    state = jopt.AdamWState(step=jnp.int32(3), m=m, v=v)
    cfg = jopt.AdamWConfig(warmup_steps=4)
    for gnorm in (0.5, 3.0):           # no clip, clip
        want_p, want_s = jopt.adamw_update(cfg, grads, state, params, grad_norm=jnp.float32(gnorm))
        got_p, got_s = topt.adamw_update(
            topt.AdamWConfig(warmup_steps=4), convert.tree_to_torch(grads),
            convert.adamw_state(state), convert.tree_to_torch(params),
            grad_norm=torch.tensor(gnorm, dtype=torch.float32))
        assert int(got_s.step) == int(want_s.step) == 4
        for k in shapes:
            np.testing.assert_allclose(got_p[k].numpy(), np.asarray(want_p[k]), rtol=1e-6,
                                       atol=1e-7)
            np.testing.assert_allclose(got_s.m[k].numpy(), np.asarray(want_s.m[k]), rtol=1e-6)
            np.testing.assert_allclose(got_s.v[k].numpy(), np.asarray(want_s.v[k]), rtol=1e-6)


# ------------------------------------------------------- whole steps, n = 1

NONE = dict(mode="none")


@functools.lru_cache(maxsize=None)
def _reference_two_steps():
    run = _jrun(compression=jtypes.CompressionConfig(**NONE))
    mesh = jax.make_mesh((1, 1), ("data", "model"))
    step_fn, _, _, bspecs, _ = jts.build_train_step(mesh, JCFG, run, JSHAPE)
    params = {k: jnp.asarray(v) for k, v in _jparams()[0].items()}
    opt = jopt.adamw_init(params)
    ef = jax.tree.map(lambda p: jnp.zeros((), jnp.float32), params)
    data = JSyntheticLM(JCFG, JSHAPE)
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
    run = RunConfig(attn_chunk_q=16, attn_chunk_k=16, compression=cmp)
    step_fn, _, plan = tts.build_train_step(CFG, run, SHAPE, 1, device="cpu")
    assert (plan is not None) == bucketed
    params = _tparams()
    opt = topt.adamw_init(params)
    data = SyntheticLM(CFG, SHAPE)
    lrs = []
    for step in range(2):
        params, opt, ef, m = step_fn(params, opt, {}, data.batch(step, "cpu"), step)
        assert ef == {}
        np.testing.assert_allclose(float(m["loss"]), want_metrics[step]["loss"],
                                   rtol=LOSS_TOL["bfloat16"])
        np.testing.assert_allclose(float(m["grad_norm"]), want_metrics[step]["grad_norm"],
                                   rtol=GRAD_TOL["bfloat16"])
        np.testing.assert_allclose(float(m["lr"]), want_metrics[step]["lr"], rtol=1e-6)
        lrs.append(float(m["lr"]))
    assert int(opt.step) == 2
    for k in sorted(want_p):
        np.testing.assert_allclose(params[k].numpy(), want_p[k], rtol=0, atol=2 * sum(lrs),
                                   err_msg=k)
        assert _rel(opt.m[k].numpy(), want_m[k]) <= GRAD_TOL["bfloat16"], k
        assert _rel(opt.v[k].numpy(), want_v[k]) <= 2 * GRAD_TOL["bfloat16"], k


# ------------------------------------------------ the port's stacked ranks

def _fixed_k(**bucket):
    cmp = dataclasses.replace(compression_preset("fixed_k_1bit", axes=("data",)),
                              min_compress_size=1024)
    return dataclasses.replace(cmp, bucket=dataclasses.replace(cmp.bucket, **bucket))


def _rank_grads(run, params, batch):
    ctx = tmodel.make_ctx(CFG, run)
    leaves = {k: v.detach().requires_grad_() for k, v in params.items()}
    loss, _ = tmodel.train_loss(ctx, leaves, CFG, run, batch, float(B * S))
    names = sorted(leaves)
    return dict(zip(names, torch.autograd.grad(loss, [leaves[k] for k in names])))


@pytest.mark.parametrize("bucketed", [True, False])
def test_stacked_ranks_and_sync_n4(bucketed):
    """Row r of each stack is rank r's own train-loss gradient on its rows of
    the batch, and the synced gradient is the sync of those stacks."""
    n = 4
    run = RunConfig(attn_chunk_q=16, attn_chunk_k=16, compression=_fixed_k(enabled=bucketed))
    seen = {}
    step_fn, init_fn, plan = tts.build_train_step(
        CFG, run, SHAPE, n, device="cpu",
        on_phase=lambda name, **st: seen.setdefault(name, {k: v for k, v in st.items()}))
    params, opt, ef = init_fn(0)
    assert ef == {}
    batch = SyntheticLM(CFG, SHAPE).batch(0, "cpu")
    step_fn(params, opt, ef, batch, 0)
    stacks, synced, key = seen["sync"]["grads"], seen["sync"]["synced"], seen["sync"]["key"]
    for r in range(n):
        own = _rank_grads(run, params, {k: v[r:r + 1] for k, v in batch.items()})
        assert all(torch.equal(stacks[k][r], own[k]) for k in own), r
    comm = StackedComm(n, "cpu")
    if bucketed:
        assert any(b.kind == "compressed" for b in plan.buckets)
        want, _ = bucketing.sync_grads_bucketed(stacks, plan, run.compression, key, comm)
    else:
        _, specs = tts.param_shapes(CFG)
        want, _ = tts.sync_grads(stacks, specs, ("data",), run.compression, key, comm)
    assert sorted(want) == sorted(synced)
    assert all(torch.equal(synced[k], want[k]) for k in want)
    exact = {k: v.mean(0) for k, v in stacks.items()}
    assert any(not torch.equal(synced[k], exact[k]) for k in exact)   # compressed, not exact


def test_microbatches_accumulate_the_sum():
    n, mbs = 2, 2
    run = RunConfig(attn_chunk_q=16, attn_chunk_k=16, microbatches=mbs,
                    compression=_fixed_k())
    seen = {}
    step_fn, init_fn, _ = tts.build_train_step(
        CFG, run, SHAPE, n, device="cpu",
        on_phase=lambda name, **st: seen.setdefault(name, st))
    params, opt, ef = init_fn(1)
    batch = SyntheticLM(CFG, SHAPE).batch(3, "cpu")
    _, _, _, metrics = step_fn(params, opt, ef, batch, 3)
    stacks = seen["backward"]["grads"]
    rows = B // n // mbs
    for r in range(n):
        parts = [_rank_grads(run, params, {k: v[(r * mbs + j) * rows:(r * mbs + j + 1) * rows]
                                           for k, v in batch.items()}) for j in range(mbs)]
        for k in parts[0]:
            assert torch.equal(stacks[k][r], parts[0][k] + parts[1][k]), (r, k)
    assert bool(torch.isfinite(metrics["loss"]))


def test_trainer_fit_three_steps():
    run = RunConfig(attn_chunk_q=16, attn_chunk_k=16, compression=_fixed_k())
    trainer = Trainer(CFG, run, SHAPE, TrainerConfig(steps=3, log_every=1), n=2, device="cpu")
    params, opt, hist = trainer.fit()
    assert [h["step"] for h in hist] == [0, 1, 2] and int(opt.step) == 3
    assert all(np.isfinite(h["loss"]) and np.isfinite(h["grad_norm"]) for h in hist)
    assert hist[0]["lr"] < hist[1]["lr"] < hist[2]["lr"]          # warm-up
    assert all(bool(torch.isfinite(v).all()) for v in params.values())


def test_unported_options_raise():
    # FSDP is accepted and converts; on a mesh with a pod axis its per-leaf
    # sync (bucketing off) raises
    assert RunConfig(fsdp=True).fsdp and convert.run_config(_jrun(fsdp=True)).fsdp
    per_leaf = RunConfig(fsdp=True, compression=dataclasses.replace(
        RunConfig().compression, bucket=dataclasses.replace(RunConfig().compression.bucket,
                                                            enabled=False)))
    with pytest.raises(NotPortedError, match="pod axis"):
        tts.build_train_step(CFG, per_leaf, SHAPE, mesh={"pod": 2, "data": 2}, device="cpu")
    with pytest.raises(NotPortedError, match="tensor parallelism"):
        tts.build_train_step(CFG, RunConfig(), SHAPE, mesh={"data": 2, "model": 2},
                             device="cpu")
    with pytest.raises(NotPortedError):
        tts.build_train_step(CFG, RunConfig(), ShapeSpec("odd", "train", S, 3), 2, device="cpu")
