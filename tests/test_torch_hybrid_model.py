"""The port's hybrid family at the model level against the JAX package, at
the reference's hybrid smoke config run at two periods (``smoke_config
("jamba-v0.1-52b")`` with ``num_layers=8``: attention at position 1 of
each 4-layer period, MoE FFNs at positions 1 and 3, Mamba-2 mixers
elsewhere): the run configuration and its FSDP refusal, the train loss
with its aux term and its per-leaf gradients, two whole training steps
against the reference's ``build_train_step`` on a (1, 1) mesh, prefill and
three decode steps against the reference's ``engine.build_serve_fns``
cache by cache; then the port alone: the stacked n = 4 step under
``fixed_k_1bit``, ``Trainer.fit`` and the training CLI.

One shape throughout: two periods (a wrong ``pi·(period − 1) + mi`` row
shows only there), training batches of 4 × 32 tokens, prompts of 2 × 32
tokens and 3 decode steps.  The reference's parameters come from
``model.init`` inside ``jax.threefry_partitionable(False)``; its loss and
gradients run op by op, its whole step and its serving functions jitted as
it builds them (both compute in bf16).  Its routes are recorded call by
call (``jax.debug.callback``, which also fires per period inside its scan
and inside its ``shard_map`` step) and the port runs on them, its own
routes allowed to differ only where the reference's k-th against
(k+1)-th probability margin is at most ``TIE`` (1e-5 in f32, 2e-3 in
bf16), as the MoE family's tests do.

Tolerances are the earlier families': loss 1e-5 (f32) and 1e-3 (bf16)
relative; per-leaf gradients 1e-4 relative Frobenius (f32, the dense
family's); two whole bf16 steps: parameters within 2·(lr₀ + lr₁)
absolute, m within 1e-1 and v within 2e-1 relative (the SSM family's)
or, where the reference's own bf16 moments lie farther than that from the
exact ones, within 1.5 times their distance (``test_two_steps_match_
reference``); the serving
logits 5e-2 absolute, the caches the SSM slice's ``CACHE_TOL`` (windows
and K/V within 2e-2 of their largest |value|) and ``STATE_TOL`` (states
within 2e-2 relative Frobenius), or the reference's own bf16 distance from
the exact values where that is larger
(``test_prefill_and_decode_match_reference_engine``).
"""
import contextlib
import dataclasses
import functools
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import NamedSharding
from jax.sharding import PartitionSpec as P

from repro.configs.base import RunConfig as JRunConfig
from repro.configs.base import ShapeSpec as JShapeSpec
from repro.configs.registry import get_run_config as j_get_run_config
from repro.configs.registry import smoke_config as j_smoke_config
from repro.core import types as jtypes
from repro.data.pipeline import SyntheticLM as JSyntheticLM
from repro.models import model as jmodel
from repro.models import moe as jmoe
from repro.optim import optimizers as jopt
from repro.serving import engine as jengine
from repro.train import train_step as jts
from repro_torch import convert
from repro_torch.checkpoint import checkpointing as ckpt
from repro_torch.configs.base import RunConfig, ShapeSpec
from repro_torch.configs.registry import (compression_preset, get_run_config, param_shapes,
                                          smoke_config)
from repro_torch.core.collectives import StackedComm
from repro_torch.core.wire.base import NotPortedError
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.kernels import backend
from repro_torch.launch import train as train_cli
from repro_torch.models import model as tmodel
from repro_torch.models import moe as tmoe
from repro_torch.optim import optimizers as topt
from repro_torch.serving import engine as tengine
from repro_torch.train import bucketing
from repro_torch.train import train_step as tts
from repro_torch.train.trainer import Trainer, TrainerConfig

# one intra-op thread: beside other test workers on a loaded machine, torch's
# thread pool stalls for tens of seconds
torch.set_num_threads(1)

ARCH = "jamba-v0.1-52b"
L = 8                              # two periods of 4 layers
SIZES = {"data": 1, "model": 1}
B, S0, STEPS = 2, 32, 3            # prompt of S0 tokens, then STEPS decode steps
TB, TS = 4, 32                     # training batch
TIE = {"float32": 1e-5, "bfloat16": 2e-3}
LOSS_TOL = {"float32": 1e-5, "bfloat16": 1e-3}
GRAD_TOL = {"float32": 1e-4, "bfloat16": 1e-1}
LOGIT_TOL, CACHE_TOL, STATE_TOL = 5e-2, 2e-2, 2e-2
CFG = dataclasses.replace(smoke_config(ARCH), num_layers=L)
JCFG = dataclasses.replace(j_smoke_config(ARCH), num_layers=L)
SHAPE = ShapeSpec("t", "train", TS, TB)
JSHAPE = JShapeSpec("t", "train", TS, TB)
NONE = dict(mode="none")


def _jrun(**kw):
    return JRunConfig(attn_chunk_q=16, attn_chunk_k=16, remat=False, **kw)


def _run(**kw):
    return RunConfig(attn_chunk_q=16, attn_chunk_k=16, remat=False, **kw)


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
    ctx = jmodel.make_ctx(JCFG, _jrun(), SIZES)
    with jax.threefry_partitionable(False):
        params, specs = jmodel.init(jax.random.PRNGKey(0), JCFG, ctx, SIZES, _jrun())
    return {k: np.array(v) for k, v in params.items()}, specs


def _tparams(requires_grad=False):
    return {k: v.requires_grad_(requires_grad)
            for k, v in convert.tree_to_torch(_jparams()[0]).items()}


def _margin(probs, k):
    top = -np.sort(-probs, axis=-1)
    return top[:, k - 1] - top[:, k]


@contextlib.contextmanager
def _reference_routes(log):
    """Within the span every reference ``moe_block`` / ``moe_decode`` call
    appends (probs, expert ids) of its tokens to ``log`` at run time."""
    block, decode = jmoe.moe_block, jmoe.moe_decode

    def record(p, x, cfg):
        t = x.shape[0] * x.shape[1]
        logits = jnp.einsum("td,de->te", x.reshape(t, -1).astype(jnp.float32),
                            p["router"].astype(jnp.float32))
        probs = jax.nn.softmax(logits, axis=-1)
        ids = jax.lax.top_k(probs, cfg.top_k)[1]
        jax.debug.callback(lambda pr, i: log.append((np.asarray(pr), np.asarray(i))),
                           probs, ids, ordered=True)

    def rec_block(ctx, p, x, cfg):
        record(p, x, cfg)
        return block(ctx, p, x, cfg)

    def rec_decode(ctx, p, x, cfg):
        record(p, x, cfg)
        return decode(ctx, p, x, cfg)

    jmoe.moe_block, jmoe.moe_decode = rec_block, rec_decode
    try:
        yield log
    finally:
        jmoe.moe_block, jmoe.moe_decode = block, decode
        jax.effects_barrier()


@contextlib.contextmanager
def _forced(routes, tie: float):
    """Within the span the port's ``moe.route`` takes the expert ids of
    ``routes`` call by call, gated by its own probabilities; its own ids
    may differ from them only where the reference's margin ≤ ``tie``.
    Yields a dict counting the calls and the near-tie tokens whose own
    ids differed."""
    route = tmoe.route
    calls = iter(routes)
    seen = {"calls": 0, "moved": 0}

    def forced(router, x, cfg):
        probs, _, ids = route(router, x, cfg)
        wp, wi = next(calls)
        want = torch.from_numpy(np.array(wi)).to(ids)
        differ = (torch.sort(ids, -1).values != torch.sort(want, -1).values).any(-1).numpy()
        assert not np.any(differ & (_margin(wp, cfg.top_k) > tie)), \
            "the port routes a token away from a near-tie differently"
        seen["calls"] += 1
        seen["moved"] += int(differ.sum())
        gates = probs.gather(1, want)
        return probs, gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9), want

    tmoe.route = forced
    try:
        yield seen
    finally:
        tmoe.route = route


# ------------------------------------------------------------------ configs

def test_run_config_raises_for_fsdp_as_the_reference_sets_it():
    """The reference trains jamba with FSDP and 8 microbatches; the port's
    run config is the reference's, FSDP on, as the converted one, and the
    CLI without ``--smoke`` trains under it (too large to run here: the
    config it builds is checked); on a (pod, data) mesh the multi-pod run
    config builds, its FSDP leaves in buckets synced over pod alone, and a
    model axis still raises."""
    jrun = j_get_run_config(ARCH, "train_4k")
    assert jrun.fsdp and jrun.microbatches == 8 and jrun.model_parallel
    run = get_run_config(ARCH, "train_4k")
    assert run.fsdp and run == convert.run_config(jrun)
    _, cli_run, _ = train_cli.build_config(
        train_cli._parse(["--arch", ARCH, "--steps", "1", "--device", "cpu"]), 1, 1)
    assert cli_run == run
    pod_run = dataclasses.replace(get_run_config(ARCH, "train_4k", multi_pod=True),
                                  microbatches=1)
    _, _, plan = tts.build_train_step(CFG, pod_run, ShapeSpec("t", "train", 32, 4),
                                      mesh={"pod": 2, "data": 2}, device="cpu")
    dims = tts.fsdp_leaf_dims(param_shapes(CFG, fsdp="data")[1])
    assert {s.name for b in plan.buckets if b.caxes + b.eaxes == ("pod",)
            for s in b.slots} == set(dims)
    with pytest.raises(NotPortedError, match="tensor parallelism"):
        tts.build_train_step(CFG, dataclasses.replace(run, microbatches=1),
                             ShapeSpec("t", "train", 32, 4), mesh={"data": 2, "model": 2},
                             device="cpu")
    assert convert.arch_config(JCFG) == CFG


# ---------------------------------------------------------------- training

@functools.lru_cache(maxsize=None)
def _reference_loss_and_grads():
    params, specs = _jparams()
    run = _jrun()
    ctx = jmodel.make_ctx(JCFG, run, SIZES, dtype=jnp.float32)
    batch = JSyntheticLM(JCFG, JSHAPE).host_batch(0)
    routes = []
    with jax.threefry_partitionable(False), _reference_routes(routes):
        (loss, metrics), grads = jax.value_and_grad(
            lambda p: jmodel.train_loss(ctx, p, specs, JCFG, run, batch, float(TB * TS)),
            has_aux=True)(params)
        loss, aux = float(loss), float(metrics["aux"])
    return loss, aux, {k: np.asarray(v) for k, v in grads.items()}, routes


def test_train_loss_and_grads_match_reference():
    """f32, op by op: the loss (its aux term over all 8 layers), the aux
    sum over the 4 MoE sublayers and every leaf's gradient."""
    want_loss, want_aux, want, routes = _reference_loss_and_grads()
    assert len(routes) == 4
    run = _run(compute_dtype="float32")
    params = _tparams(requires_grad=True)
    batch = SyntheticLM(CFG, SHAPE).batch(0, "cpu")
    with _forced(routes, TIE["float32"]) as seen:
        loss, metrics = tmodel.train_loss(tmodel.make_ctx(CFG, run), params, CFG, run, batch,
                                          float(TB * TS))
    assert seen["calls"] == 4
    names = sorted(params)
    grads = dict(zip(names, torch.autograd.grad(loss, [params[k] for k in names])))
    np.testing.assert_allclose(float(loss.detach()), want_loss, rtol=LOSS_TOL["float32"])
    np.testing.assert_allclose(float(metrics["aux"].detach()), want_aux,
                               rtol=LOSS_TOL["float32"])
    assert want_aux > 0
    assert sorted(want) == names
    errs = {k: _rel(grads[k].numpy(), want[k]) for k in names}
    assert max(errs.values()) <= GRAD_TOL["float32"], errs


@functools.lru_cache(maxsize=None)
def _reference_two_steps():
    run = _jrun(compression=jtypes.CompressionConfig(**NONE))
    mesh = jax.make_mesh((1, 1), ("data", "model"))
    routes = []
    with jax.threefry_partitionable(False), _reference_routes(routes):
        step_fn, _, specs, bspecs, _ = jts.build_train_step(mesh, JCFG, run, JSHAPE)

        def put(x, spec):        # the step's own shardings: step 1 reuses step 0's compile
            return jax.device_put(x, NamedSharding(mesh, spec))

        ps = {k: jts.spec_to_pspec(s) for k, s in specs.items()}
        params = {k: put(v, ps[k]) for k, v in _jparams()[0].items()}
        opt = jopt.adamw_init(params)
        opt = jopt.AdamWState(step=put(opt.step, P()),
                              m={k: put(v, ps[k]) for k, v in opt.m.items()},
                              v={k: put(v, ps[k]) for k, v in opt.v.items()})
        ef = {k: put(jnp.zeros((), jnp.float32), P()) for k in params}
        data = JSyntheticLM(JCFG, JSHAPE)
        metrics = []
        for step in range(2):
            params, opt, ef, m = step_fn(params, opt, ef, data.device_batch(step, mesh, bspecs),
                                         jnp.int32(step))
            metrics.append({k: float(v) for k, v in m.items()})
    return ({k: np.asarray(v) for k, v in params.items()},
            {k: np.asarray(v) for k, v in opt.m.items()},
            {k: np.asarray(v) for k, v in opt.v.items()}, metrics, routes)


def _port_two_steps(routes, dtype: str, tie: float):
    cmp = dataclasses.replace(compression_preset("fixed_k_1bit", axes=("data",)), **NONE)
    step_fn, _, plan = tts.build_train_step(CFG, _run(compression=cmp, compute_dtype=dtype),
                                            SHAPE, 1, device="cpu")
    assert plan is not None
    params = _tparams()
    opt = topt.adamw_init(params)
    data = SyntheticLM(CFG, SHAPE)
    metrics = []
    for step in range(2):
        with _forced(routes[4 * step:4 * (step + 1)], tie):
            params, opt, _, m = step_fn(params, opt, {}, data.batch(step, "cpu"), step)
        metrics.append({k: float(v) for k, v in m.items()})
    assert int(opt.step) == 2
    return params, opt, metrics


def test_two_steps_match_reference():
    """Two whole bf16 steps on the reference's routes.  The moments of the
    Mamba mixers' small leaves (``A_log``, ``D``, ``dt_bias``) carry the
    reference's own bf16 noise: its bf16 moments sit up to 14% (m) and 22%
    (v) from the port's exact f32 ones, which the f32 gradient test holds
    to 1e-4.  So each leaf's m and v are held to the larger of the
    earlier families' limits and 1.5 times that distance of the leaf
    (readings: m 0.166 for ``A_log`` against its 0.145, v 0.202 for
    ``dt_bias`` against its 0.205)."""
    want_p, want_m, want_v, want_metrics, routes = _reference_two_steps()
    assert len(routes) == 2 * 4
    params, opt, metrics = _port_two_steps(routes, "bfloat16", TIE["bfloat16"])
    _, exact, _ = _port_two_steps(routes, "float32", 1.0)     # f32 on bf16 routes
    lrs = []
    for got, want in zip(metrics, want_metrics):
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=LOSS_TOL["bfloat16"])
        np.testing.assert_allclose(got["grad_norm"], want["grad_norm"],
                                   rtol=GRAD_TOL["bfloat16"])
        np.testing.assert_allclose(got["lr"], want["lr"], rtol=1e-6)
        assert np.isfinite(got["aux"]) and got["aux"] > 0
        lrs.append(got["lr"])
    for k in sorted(want_p):
        np.testing.assert_allclose(params[k].numpy(), want_p[k], rtol=0, atol=2 * sum(lrs),
                                   err_msg=k)
        for name, got, ex, want, tol in (("m", opt.m, exact.m, want_m, GRAD_TOL["bfloat16"]),
                                         ("v", opt.v, exact.v, want_v,
                                          2 * GRAD_TOL["bfloat16"])):
            noise = _rel(ex[k].numpy(), want[k])
            assert _rel(got[k].numpy(), want[k]) <= max(tol, 1.5 * noise), (name, k, noise)


# ----------------------------------------------------------------- serving

def _tokens():
    return np.random.default_rng(9).integers(0, CFG.vocab_size, (B, S0 + STEPS)).astype(np.int32)


@functools.lru_cache(maxsize=None)
def _reference_serve():
    """The reference's engine: prefill of S0 tokens, then STEPS decode steps
    fed the known tokens: (prefill logits, [cache after prefill and after
    each step], [next token of each step], routes) as numpy."""
    mesh = jax.make_mesh((1, 1), ("data", "model"))
    run = JRunConfig(microbatches=1, remat=False,
                     compression=jtypes.CompressionConfig(mode="none"))
    shape = JShapeSpec("serve", "decode", S0 + STEPS, B)
    toks = _tokens()
    params = {k: jnp.asarray(v) for k, v in _jparams()[0].items()}
    routes = []
    flat = lambda c: {f"{part}.{k}": np.asarray(v, np.float32)
                      for part, d in c.items() for k, v in d.items()}
    with jax.threefry_partitionable(False), _reference_routes(routes):
        prefill_fn, decode_fn, _, _ = jengine.build_serve_fns(mesh, JCFG, run, shape)
        cache, logits = prefill_fn(params, {"tokens": toks[:, :S0]})
        caches = [flat(cache)]
        nexts = []
        for i in range(STEPS):
            nxt, cache = decode_fn(params, cache, toks[:, S0 + i:S0 + i + 1], jnp.int32(S0 + i))
            caches.append(flat(cache))
            nexts.append(np.asarray(nxt))
        logits = np.asarray(logits, np.float32)
    return logits, caches, nexts, routes


def _port_serve(routes, dtype: str, tie: float):
    """The port's engine on the reference's routes: (prefill logits,
    [cache after prefill and after each step, flattened], [logits of each
    step], (prefill_fn, decode_fn, params))."""
    run = _run(compute_dtype=dtype)
    prefill_fn, decode_fn = tengine.build_serve_fns(
        CFG, run, ShapeSpec("serve", "decode", S0 + STEPS, B), device="cpu")
    params = _tparams()
    toks = torch.from_numpy(_tokens())
    flat = lambda c: {f"{part}.{k}": v.clone() for part, d in c.items() for k, v in d.items()}
    with _forced(routes[:4], tie):
        cache, logits = prefill_fn(params, {"tokens": toks[:, :S0]})
    ctx = tmodel.make_ctx(CFG, run)
    caches, step_logits = [flat(cache)], []
    for i in range(STEPS):
        pos = S0 + i
        with _forced(routes[4 * (1 + i):4 * (2 + i)], tie):
            _, lg, cache = tmodel.decode_step(ctx, params, CFG, run, cache,
                                              toks[:, pos:pos + 1], pos)
        caches.append(flat(cache))
        step_logits.append(lg)
    return logits, caches, step_logits, (prefill_fn, decode_fn, params)


def test_prefill_and_decode_match_reference_engine():
    """bf16, on the reference's routes.  With 6 Mamba mixers and 4 MoE
    FFNs in 8 layers the reference's own bf16 rounding moves its prefill
    logits by up to 0.108 and its caches by up to 6.7% from the exact (f32)
    values, more than the earlier families' limits; each reading is held to
    the larger of its limit and that distance (the port's f32 engine on the
    same routes, which the f32 tests hold to 1e-4 of the reference).
    Readings: logits 0.060 against 0.108; caches 1.7–3.4% against
    2.4–6.7%."""
    want_logits, want_caches, want_next, routes = _reference_serve()
    assert len(routes) == 4 * (1 + STEPS)
    backend.reset_launches()
    logits, got, step_logits, (prefill_fn, decode_fn, params) = _port_serve(
        routes, "bfloat16", TIE["bfloat16"])
    exact_logits, exact, _, _ = _port_serve(routes, "float32", 1.0)
    assert not backend.launches
    assert logits.shape == (B, 1, CFG.vocab_size) and logits.dtype == torch.float32
    noise = float(np.abs(exact_logits.numpy() - want_logits).max())
    np.testing.assert_allclose(logits.numpy(), want_logits, atol=max(LOGIT_TOL, noise), rtol=0)
    max_rel = lambda g, w: float(np.abs(g - w).max()) / float(np.abs(w).max())
    for step, (g, e, w) in enumerate(zip(got, exact, want_caches)):
        assert sorted(g) == sorted(w) == ["attn.k", "attn.v", "ssm.conv_B", "ssm.conv_C",
                                          "ssm.conv_x", "ssm.state"]
        for k in ("attn.k", "attn.v", "ssm.conv_x", "ssm.conv_B", "ssm.conv_C"):
            assert g[k].dtype == torch.bfloat16 and g[k].shape == w[k].shape, k
            tol = max(CACHE_TOL, max_rel(e[k].float().numpy(), w[k]))
            _close(g[k].float().numpy(), w[k], tol, f"step {step} {k}")
        assert g["ssm.state"].dtype == torch.float32
        tol = max(STATE_TOL, _rel(e["ssm.state"].numpy(), w["ssm.state"]))
        assert _rel(g["ssm.state"].numpy(), w["ssm.state"]) <= tol, step
    # each decode step writes its K/V slot; the slots after the last stay zero
    assert not bool(got[-1]["attn.k"][:, :, S0 + STEPS:].any())
    assert all(bool(got[i + 1]["attn.k"][:, :, S0 + i].any()) for i in range(STEPS))
    for lg, want in zip(step_logits, want_next):
        top2 = torch.topk(lg[:, 0], 2, dim=-1).values
        decided = (top2[:, 0] - top2[:, 1]).numpy() > 2 * max(LOGIT_TOL, noise)
        np.testing.assert_array_equal(torch.argmax(lg[:, 0], -1).numpy()[decided],
                                      want[:, 0][decided])
    # the engine's decode step is decode_step's next token
    toks = torch.from_numpy(_tokens())
    with _forced(routes[:8], TIE["bfloat16"]):
        cache, _ = prefill_fn(params, {"tokens": toks[:, :S0]})
        first, _ = decode_fn(params, cache, toks[:, S0:S0 + 1], S0)
    assert torch.equal(first, torch.argmax(step_logits[0], -1))


# ------------------------------------------------------------- the port alone

def _fixed_k():
    return dataclasses.replace(compression_preset("fixed_k_1bit", axes=("data",)),
                               min_compress_size=1024)


def test_stacked_step_n4_fixed_k():
    """n = 4 stacked ranks under ``fixed_k_1bit``: row r of each stack is
    rank r's own gradient, the synced gradient is the compressed sync of
    the stacks, the two issue schedules give the same bits, and ``aux`` is
    the mean of the ranks' MoE aux sums."""
    n = 4
    run = _run(compression=_fixed_k())
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
        out[overlap] = (new_params, float(m["loss"]), float(m["aux"]))
    stacks, synced, key = seen["sync"]["grads"], seen["sync"]["synced"], seen["sync"]["key"]
    ctx = tmodel.make_ctx(CFG, run)
    auxes = []
    for r in range(n):
        leaves = {k: v.detach().requires_grad_() for k, v in params.items()}
        loss, lm = tmodel.train_loss(ctx, leaves, CFG, run,
                                     {k: v[r:r + 1] for k, v in batch.items()}, float(TB * TS))
        names = sorted(leaves)
        own = dict(zip(names, torch.autograd.grad(loss, [leaves[k] for k in names])))
        assert all(torch.equal(stacks[k][r], own[k]) for k in own), r
        auxes.append(float(lm["aux"]))
    np.testing.assert_allclose(out[False][2], sum(auxes) / n, rtol=1e-6)
    assert any(b.kind == "compressed" for b in plan.buckets)
    want, _ = bucketing.sync_grads_bucketed(stacks, plan, run.compression, key,
                                            StackedComm(n, "cpu"))
    assert all(torch.equal(synced[k], want[k]) for k in want)
    assert any(not torch.equal(synced[k], stacks[k].mean(0)) for k in synced)
    assert out[True][1:] == out[False][1:]
    assert all(torch.equal(out[True][0][k], out[False][0][k]) for k in out[True][0])


def test_trainer_fit_two_steps():
    run = RunConfig(attn_chunk_q=16, attn_chunk_k=16, compression=_fixed_k())
    trainer = Trainer(CFG, run, SHAPE, TrainerConfig(steps=2, log_every=1), n=2, device="cpu")
    params, opt, hist = trainer.fit()
    assert [h["step"] for h in hist] == [0, 1] and int(opt.step) == 2
    assert all(np.isfinite(h["loss"]) and np.isfinite(h["grad_norm"]) for h in hist)
    assert all(h["aux"] > 0 for h in hist)
    assert sorted(params) == sorted(param_shapes(CFG)[0])
    assert all(bool(torch.isfinite(v).all()) for v in params.values())


STEP_LINE = re.compile(r"^step +(\d+)  loss (\S+)  gnorm (\S+)  lr (\S+)$")


def test_cli_smoke_run_and_resume(tmp_path, capsys):
    """``--arch jamba-v0.1-52b --smoke``: the one-period smoke config, 4
    ranks, 2 steps that save, then resumed to 3 from the checkpoint, whose
    leaves are the ``periods.*`` stacks."""
    d = str(tmp_path / "ckpt")
    args = ["--arch", ARCH, "--smoke", "--devices", "4", "--seq", "32", "--batch", "8",
            "--ckpt-every", "2", "--ckpt-dir", d, "--device", "cpu"]
    for steps, want in ((2, [0, 1]), (3, [2])):
        assert train_cli.main(args + ["--steps", str(steps)]) == 0
        rows = [STEP_LINE.match(line) for line in capsys.readouterr().out.strip().splitlines()]
        assert rows and all(rows) and [int(m[1]) for m in rows] == want
        assert all(np.isfinite(float(m[2])) for m in rows)
        assert ckpt.latest_step(d) == steps
