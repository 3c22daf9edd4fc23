"""The port's MoE family against the JAX package at the reference's smoke
MoE configs (``smoke_config("olmoe-1b-7b")``: 2 layers, d 64, 4/2 heads of
16, 4 experts, top-2, expert ff 64; ``smoke_config("qwen2-moe-a2.7b")``:
the same with 2 shared experts of ff 64): init names, shapes and specs,
prefill and teacher-forced decode on the reference's own parameters, the
train loss with its aux term and its gradients, two whole training steps
bucketed and not, the gradient buckets of the expert leaves; then the
port alone: decode against one forward without drops, the stacked step's
aux metric, the training CLI and the serving example.

The reference runs at ``tp = 1`` outside any mesh except for its whole
step (``jax.make_mesh((1, 1), ("data", "model"))``); its parameters come
from ``model.init`` inside ``jax.threefry_partitionable(False)``; its
prefill, decode step, loss and gradients are jitted (the comparisons hold
tolerances).  One shape per test kind: prompts of 2 × 32 tokens and 16
decode steps; training batches of 4 × 32 tokens.

Routing.  A token whose k-th against (k+1)-th router probability margin is
small can route differently on the two sides (f32: sums in another order;
bf16: activations rounded in another order) and move its outputs by O(1).
Both sides' routes are recorded (each package's ``moe_block`` and
``moe_decode`` wrapped in the test process, the reference's through
``jax.debug.callback``; its routing recomputed with its own operations)
and compared call by call: a route may first differ only where the
reference's margin is at most ``TIE[dtype]``, and a keep mask only after
a route has.  A sequence whose routes differ anywhere is left out of the
logit comparison (the near-ties and the rows left out are printed); the
training comparisons cannot leave a token out: where the routes differ
they run the port on the reference's routes (``_forced``: its expert ids,
gated by the port's own probabilities), and the two-step comparison always
does, with ``remat`` off on both sides so that each MoE call is recorded
once.

Tolerances are the dense family's, with their reasons in
``tests/test_torch_serving.py`` and ``tests/test_torch_training.py``:
logits 1e-3 (f32) and 5e-2 (bf16) absolute; loss 1e-5 and 1e-3 relative;
per-leaf gradients 1e-4 and 5e-2 relative Frobenius error; two whole bf16
steps: parameters within 2·(lr₀ + lr₁) absolute, m within 5e-2 and v
within 1e-1 relative.
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

from repro.configs.base import RunConfig as JRunConfig
from repro.configs.base import ShapeSpec as JShapeSpec
from repro.configs.registry import compression_preset as j_compression_preset
from repro.configs.registry import get_run_config as j_get_run_config
from repro.configs.registry import smoke_config as j_smoke_config
from repro.core import types as jtypes
from repro.data.pipeline import SyntheticLM as JSyntheticLM
from repro.models import model as jmodel
from repro.models import moe as jmoe
from repro.optim import optimizers as jopt
from repro.train import bucketing as jbucketing
from repro.train import train_step as jts
from repro_torch import convert
from repro_torch.configs import registry
from repro_torch.configs.base import ArchConfig, RunConfig, ShapeSpec
from repro_torch.configs.registry import (compression_preset, get_run_config, param_shapes,
                                          smoke_config)
from repro_torch.core.wire.base import NotPortedError
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.examples import serve_lm
from repro_torch.kernels import backend
from repro_torch.launch import train as train_cli
from repro_torch.models import model as tmodel
from repro_torch.models import moe as tmoe
from repro_torch.models import transformer as ttfm
from repro_torch.optim import optimizers as topt
from repro_torch.train import bucketing
from repro_torch.train import train_step as tts

# one intra-op thread: beside other test workers on a loaded machine, torch's
# thread pool stalls for tens of seconds
torch.set_num_threads(1)

ARCHS = ("olmoe-1b-7b", "qwen2-moe-a2.7b")
SIZES = {"data": 1, "model": 1}
B, S0, S = 2, 32, 48            # prompt of S0 tokens, then S - S0 teacher-forced decode steps
TB, TS = 4, 32                  # training batch
TIE = {"float32": 1e-5, "bfloat16": 2e-3}
LOGIT_TOL = {"float32": 1e-3, "bfloat16": 5e-2}
LOSS_TOL = {"float32": 1e-5, "bfloat16": 1e-3}
GRAD_TOL = {"float32": 1e-4, "bfloat16": 5e-2}


def _jrun(**kw):
    return JRunConfig(attn_chunk_q=16, attn_chunk_k=16, remat=False, **kw)


def _run(**kw):
    return RunConfig(attn_chunk_q=16, attn_chunk_k=16, remat=False, **kw)


def _rel(got, want) -> float:
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(np.asarray(got, np.float64) - want) / np.linalg.norm(want))


@functools.lru_cache(maxsize=None)
def _jparams(arch):
    jcfg = j_smoke_config(arch)
    ctx = jmodel.make_ctx(jcfg, _jrun(), SIZES)
    with jax.threefry_partitionable(False):
        params, specs = jmodel.init(jax.random.PRNGKey(0), jcfg, ctx, SIZES, _jrun())
    return {k: np.array(v) for k, v in params.items()}, specs


def _tparams(arch, requires_grad=False):
    return {k: v.requires_grad_(requires_grad)
            for k, v in convert.tree_to_torch(_jparams(arch)[0]).items()}


def _port_routing(p, x, cfg, block):
    """(probs, expert ids, keep or None) of one port MoE call's input."""
    t = x.shape[0] * x.shape[1]
    probs, _, ids = tmoe.route(p["router"], x.reshape(t, -1), cfg)
    if not block:
        return probs, ids, None
    ep = cfg.padded(1)
    cap = max(1, int(cfg.capacity_factor * t * cfg.top_k / ep))
    return probs, ids, tmoe.capacity_slots(ids.reshape(-1), ep, cap)[1].reshape(ids.shape)


def _reference_routing(p, x, cfg, block):
    """The same of one reference MoE call, by the reference's own operations
    (``src/repro/models/moe.py`` lines 72–92)."""
    t = x.shape[0] * x.shape[1]
    logits = jnp.einsum("td,de->te", x.reshape(t, -1).astype(jnp.float32),
                        p["router"].astype(jnp.float32))
    probs = jax.nn.softmax(logits, axis=-1)
    ids = jax.lax.top_k(probs, cfg.top_k)[1]
    if not block:
        return probs, ids, None
    ep = cfg.padded(1)
    cap = max(1, int(cfg.capacity_factor * t * cfg.top_k / ep))
    onehot = jax.nn.one_hot(ids.reshape(-1), ep, dtype=jnp.int32)
    slot = jnp.sum((jnp.cumsum(onehot, axis=0) - 1) * onehot, axis=-1)
    return probs, ids, (slot < cap).reshape(ids.shape)


def _append_numpy(log, probs, ids, keep):
    log.append(tuple(None if a is None else np.asarray(a.detach() if hasattr(a, "detach") else a)
                     for a in (probs, ids, keep)))


def _reference_callback(log):
    def record(probs, ids, keep):
        args = (probs, ids) if keep is None else (probs, ids, keep)
        jax.debug.callback(lambda *a: _append_numpy(log, *(a + (None,) * (3 - len(a)))),
                           *args, ordered=True)
    return record


@contextlib.contextmanager
def _recorded(mod, routing, record):
    """Within the span, every ``moe_block`` / ``moe_decode`` call of ``mod``
    first hands its routing (``routing``) to ``record``."""
    block, decode = mod.moe_block, mod.moe_decode

    def rec_block(ctx, p, x, cfg):
        record(*routing(p, x, cfg, True))
        return block(ctx, p, x, cfg)

    def rec_decode(ctx, p, x, cfg):
        record(*routing(p, x, cfg, False))
        return decode(ctx, p, x, cfg)

    mod.moe_block, mod.moe_decode = rec_block, rec_decode
    try:
        yield
    finally:
        mod.moe_block, mod.moe_decode = block, decode


def _margin(probs, k):
    top = -np.sort(-probs, axis=-1)
    return top[:, k - 1] - top[:, k]


def _route_divergence(got, want, k, tie, passes):
    """Compare the port's and the reference's routes, call by call.
    ``passes`` lists each pass's (number of calls, tokens a row).  Returns
    the rows whose routes ever differ (expert ids or keep), after checking
    that a divergence starts only at a near-tie: in a row that has not
    diverged yet, differing ids need the reference's k-th against (k+1)-th
    margin ≤ ``tie``, and a differing keep mask needs differing ids earlier
    in the pass (the capacity count it moves)."""
    assert len(got) == len(want) == sum(n for n, _ in passes)
    diverged = set()
    ties = 0
    c = 0
    for calls, per_row in passes:
        moved = False
        for _ in range(calls):
            (_, gi, gk), (wp, wi, wk) = got[c], want[c]
            c += 1
            # the k choices as a set: their order moves only the aux loss's first choice
            ids_diff = np.any(np.sort(gi, axis=-1) != np.sort(wi, axis=-1), axis=-1)
            keep_diff = np.zeros_like(ids_diff) if gk is None else np.any(gk != wk, axis=-1)
            fresh = np.array([i // per_row not in diverged for i in range(len(ids_diff))])
            near = _margin(wp, k) <= tie
            ties += int(near.sum())
            assert not np.any(ids_diff & fresh & ~near), "routes differ away from a near-tie"
            moved = moved or bool(ids_diff.any())
            assert moved or not keep_diff.any(), "keep masks differ with equal routes"
            diverged |= {int(i) // per_row for i in np.flatnonzero(ids_diff | keep_diff)}
    return diverged, ties


@contextlib.contextmanager
def _forced(routes):
    """Within the span the port's ``moe.route`` takes the expert ids of
    ``routes`` (the reference's, call by call, in its order) and gates them
    with its own probabilities: the same discrete decisions on both sides."""
    route = tmoe.route
    calls = iter(routes)

    def forced(router, x, cfg):
        probs, _, ids = route(router, x, cfg)
        ids = torch.from_numpy(np.array(next(calls)[1])).to(ids)
        gates = probs.gather(1, ids)
        return probs, gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9), ids

    tmoe.route = forced
    try:
        yield
    finally:
        tmoe.route = route


# ------------------------------------------------------------------- init

@pytest.mark.parametrize("arch", ARCHS)
def test_init_matches_param_shapes_and_reference(arch):
    cfg = smoke_config(arch)
    jcfg = j_smoke_config(arch)
    assert convert.arch_config(jcfg) == cfg
    params = tmodel.init(0, cfg, device="cpu")
    shapes, specs = param_shapes(cfg)
    assert {k: tuple(v.shape) for k, v in params.items()} == shapes
    assert all(v.dtype == torch.float32 for v in params.values())
    ctx = jmodel.make_ctx(jcfg, _jrun(), SIZES, dtype=jnp.float32)
    jparams, jspecs = jmodel.init(jax.random.PRNGKey(0), jcfg, ctx, SIZES, _jrun(),
                                  abstract=True)
    assert shapes == {k: tuple(v.shape) for k, v in jparams.items()}
    assert specs == {k: tuple(v) for k, v in jspecs.items()}
    assert ("layers.moe.shared.w_up" in shapes) == (arch == "qwen2-moe-a2.7b")
    again = tmodel.init(0, cfg, device="cpu")
    assert all(torch.equal(params[k], again[k]) for k in params)


# ------------------------------------------------ prefill / decode vs reference

def _tokens(cfg):
    return np.random.default_rng(9).integers(0, cfg.vocab_size, (B, S)).astype(np.int32)


@functools.lru_cache(maxsize=None)
def _reference_serve(arch, dtype):
    """The reference's prefill of S0 tokens and teacher-forced decode to S:
    ([prefill logits, decode logits...], the routes of its MoE calls)
    (numpy)."""
    jcfg = j_smoke_config(arch)
    params, specs = _jparams(arch)
    ctx = jmodel.make_ctx(jcfg, _jrun(), SIZES, dtype=getattr(jnp, dtype))
    run = _jrun()
    toks = _tokens(jcfg)
    routes = []
    with jax.threefry_partitionable(False), _recorded(jmoe, _reference_routing,
                                                      _reference_callback(routes)):
        prefill = jax.jit(lambda p, t: jmodel.prefill(ctx, p, specs, jcfg, run, {"tokens": t},
                                                      s_max=S))
        decode = jax.jit(lambda p, c, t, pos: jmodel.decode_step(ctx, p, specs, jcfg, run, c,
                                                                 t, pos))
        cache, logits = prefill(params, toks[:, :S0])
        out = [np.asarray(logits)]
        for i in range(S0, S):
            _, logits, cache = decode(params, cache, toks[:, i:i + 1], jnp.int32(i))
            out.append(np.asarray(logits))
        jax.effects_barrier()
    return out, routes


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_prefill_and_decode_match_reference(arch, dtype):
    want, want_routes = _reference_serve(arch, dtype)
    cfg, run = smoke_config(arch), _run(compute_dtype=dtype)
    ctx = tmodel.make_ctx(cfg, run)
    params = _tparams(arch)
    toks = torch.from_numpy(_tokens(cfg))
    backend.reset_launches()
    routes = []
    with _recorded(tmoe, _port_routing, lambda *a: _append_numpy(routes, *a)):
        cache, logits = tmodel.prefill(ctx, params, cfg, run, {"tokens": toks[:, :S0]}, s_max=S)
        got = [logits]
        for i in range(S0, S):
            _, logits, cache = tmodel.decode_step(ctx, params, cfg, run, cache,
                                                  toks[:, i:i + 1], i)
            got.append(logits)
    assert not backend.launches
    L = cfg.num_layers
    diverged, ties = _route_divergence(routes, want_routes, cfg.moe.top_k, TIE[dtype],
                                       [(L, S0)] + [(L, 1)] * (S - S0))
    rows = np.array([r not in diverged for r in range(B)])
    print(f"{arch} {dtype}: {ties} near-tie tokens; rows with routes that differ: "
          f"{sorted(diverged)}; rows compared {int(rows.sum())} of {B}")
    assert rows.any()
    got_all = torch.cat(got, dim=1).float().numpy()
    want_all = np.concatenate(want, axis=1)
    assert got_all.shape == want_all.shape == (B, 1 + S - S0, cfg.vocab_size)
    np.testing.assert_allclose(got_all[rows], want_all[rows], atol=LOGIT_TOL[dtype], rtol=0)


@pytest.mark.parametrize("arch", ARCHS)
def test_decode_consistent_with_forward_without_drops(arch, monkeypatch):
    """With capacity for every pair (factor E/k: cap = t) the teacher-forced
    decode after a prefill gives the logits of one forward over the whole
    sequence, f32 compute and an f32 cache (``make_cache``'s dtype patched):
    within 1e-4 (readings 4.3e-6; through the bf16 cache 3.4e-2 on logits up
    to 4.8, the bf16 rounding of k and v amplified by the experts' large
    activations at this init).  At the configured factor the forward drops
    pairs and the two differ by design."""
    monkeypatch.setattr(tmodel, "make_cache",
                        functools.partial(tmodel.make_cache, dtype=torch.float32))
    cfg = smoke_config(arch)
    cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
        cfg.moe, capacity_factor=cfg.moe.num_experts / cfg.moe.top_k))
    run = _run(compute_dtype="float32")
    ctx = tmodel.make_ctx(cfg, run)
    params = _tparams(arch)
    toks = torch.from_numpy(_tokens(cfg))
    cache, logits = tmodel.prefill(ctx, params, cfg, run, {"tokens": toks[:, :S0]}, s_max=S)
    got = [logits]
    for i in range(S0, S):
        _, logits, cache = tmodel.decode_step(ctx, params, cfg, run, cache, toks[:, i:i + 1], i)
        got.append(logits)
    x = tmodel.embed_inputs(ctx, params, cfg, {"tokens": toks})
    h, aux, _ = ttfm.forward(ctx, params, cfg, run, x, torch.arange(S))
    want = ttfm.lm_head_logits(ctx, params, cfg, h[:, S0 - 1:])
    np.testing.assert_allclose(torch.cat(got, 1).numpy(), want.numpy(), atol=1e-4, rtol=0)
    assert float(aux) > 0


# ---------------------------------------------------------------- training

@functools.lru_cache(maxsize=None)
def _reference_loss_and_grads(arch, dtype):
    jcfg = j_smoke_config(arch)
    params, specs = _jparams(arch)
    run = _jrun()
    ctx = jmodel.make_ctx(jcfg, run, SIZES, dtype=getattr(jnp, dtype))
    batch = JSyntheticLM(jcfg, JShapeSpec("t", "train", TS, TB)).host_batch(0)
    routes = []
    with jax.threefry_partitionable(False), _recorded(jmoe, _reference_routing,
                                                      _reference_callback(routes)):
        fn = jax.jit(jax.value_and_grad(
            lambda p: jmodel.train_loss(ctx, p, specs, jcfg, run, batch, float(TB * TS)),
            has_aux=True))
        (loss, metrics), grads = fn(params)
        jax.effects_barrier()
    return (float(loss), float(metrics["aux"]), {k: np.asarray(v) for k, v in grads.items()},
            routes)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_train_loss_and_grads_match_reference(arch, dtype):
    want_loss, want_aux, want, want_routes = _reference_loss_and_grads(arch, dtype)
    cfg, run = smoke_config(arch), _run(compute_dtype=dtype)
    params = _tparams(arch, requires_grad=True)
    batch = SyntheticLM(cfg, ShapeSpec("t", "train", TS, TB)).batch(0, "cpu")
    routes = []
    ctx = tmodel.make_ctx(cfg, run)
    with _recorded(tmoe, _port_routing, lambda *a: _append_numpy(routes, *a)):
        loss, metrics = tmodel.train_loss(ctx, params, cfg, run, batch, float(TB * TS))
    diverged, ties = _route_divergence(routes, want_routes, cfg.moe.top_k, TIE[dtype],
                                       [(cfg.num_layers, TS)])
    print(f"{arch} {dtype}: {ties} near-tie tokens over {cfg.num_layers} layers; rows with "
          f"routes that differ: {sorted(diverged)}"
          f"{'; the reference routes forced' if diverged else ''}")
    if diverged:
        with _forced(want_routes):
            loss, metrics = tmodel.train_loss(ctx, params, cfg, run, batch, float(TB * TS))
    names = sorted(params)
    grads = dict(zip(names, torch.autograd.grad(loss, [params[k] for k in names])))
    np.testing.assert_allclose(float(loss.detach()), want_loss, rtol=LOSS_TOL[dtype])
    np.testing.assert_allclose(float(metrics["aux"].detach()), want_aux, rtol=LOSS_TOL[dtype])
    assert float(metrics["aux"].detach()) > 0
    assert sorted(want) == names
    errs = {k: _rel(grads[k].numpy(), want[k]) for k in names}
    assert max(errs.values()) <= GRAD_TOL[dtype], errs


@pytest.mark.parametrize("arch", ARCHS)
def test_remat_changes_nothing(arch):
    """Recomputing each layer in the backward gives the same loss and
    gradients, bit for bit (the same ops in the same order on the CPU)."""
    cfg = smoke_config(arch)
    batch = SyntheticLM(cfg, ShapeSpec("t", "train", TS, TB)).batch(0, "cpu")
    out = []
    for remat in (False, True):
        run = RunConfig(attn_chunk_q=16, attn_chunk_k=16, remat=remat)
        params = _tparams(arch, requires_grad=True)
        loss, _ = tmodel.train_loss(tmodel.make_ctx(cfg, run), params, cfg, run, batch,
                                    float(TB * TS))
        out.append((loss.detach(), *torch.autograd.grad(loss, list(params.values()))))
    assert all(torch.equal(a, b) for a, b in zip(*out))


NONE = dict(mode="none")


@functools.lru_cache(maxsize=None)
def _reference_two_steps(arch):
    jcfg = j_smoke_config(arch)
    jshape = JShapeSpec("t", "train", TS, TB)
    run = _jrun(compression=jtypes.CompressionConfig(**NONE))
    mesh = jax.make_mesh((1, 1), ("data", "model"))
    routes = []
    with jax.threefry_partitionable(False), _recorded(jmoe, _reference_routing,
                                                      _reference_callback(routes)):
        step_fn, _, _, bspecs, _ = jts.build_train_step(mesh, jcfg, run, jshape)
        params = {k: jnp.asarray(v) for k, v in _jparams(arch)[0].items()}
        opt = jopt.adamw_init(params)
        ef = jax.tree.map(lambda p: jnp.zeros((), jnp.float32), params)
        data = JSyntheticLM(jcfg, jshape)
        metrics = []
        for step in range(2):
            params, opt, ef, m = step_fn(params, opt, ef, data.device_batch(step, mesh, bspecs),
                                         jnp.int32(step))
            metrics.append({k: float(v) for k, v in m.items()})
        jax.effects_barrier()
    return ({k: np.asarray(v) for k, v in params.items()},
            {k: np.asarray(v) for k, v in opt.m.items()},
            {k: np.asarray(v) for k, v in opt.v.items()}, metrics, routes)


@pytest.mark.parametrize("bucketed", [True, False])
@pytest.mark.parametrize("arch", ARCHS)
def test_two_steps_match_reference(arch, bucketed):
    want_p, want_m, want_v, want_metrics, want_routes = _reference_two_steps(arch)
    cfg = smoke_config(arch)
    assert len(want_routes) == 2 * cfg.num_layers
    cmp = dataclasses.replace(compression_preset("fixed_k_1bit", axes=("data",)), **NONE)
    cmp = dataclasses.replace(cmp, bucket=dataclasses.replace(cmp.bucket, enabled=bucketed))
    run = _run(compression=cmp)
    shape = ShapeSpec("t", "train", TS, TB)
    step_fn, _, plan = tts.build_train_step(cfg, run, shape, 1, device="cpu")
    assert (plan is not None) == bucketed
    params = _tparams(arch)
    opt = topt.adamw_init(params)
    data = SyntheticLM(cfg, shape)
    lrs = []
    for step in range(2):
        with _forced(want_routes[step * cfg.num_layers:(step + 1) * cfg.num_layers]):
            params, opt, _, m = step_fn(params, opt, {}, data.batch(step, "cpu"), step)
        np.testing.assert_allclose(float(m["loss"]), want_metrics[step]["loss"],
                                   rtol=LOSS_TOL["bfloat16"])
        np.testing.assert_allclose(float(m["grad_norm"]), want_metrics[step]["grad_norm"],
                                   rtol=GRAD_TOL["bfloat16"])
        np.testing.assert_allclose(float(m["lr"]), want_metrics[step]["lr"], rtol=1e-6)
        assert np.isfinite(float(m["aux"])) and float(m["aux"]) > 0
        lrs.append(float(m["lr"]))
    assert int(opt.step) == 2
    for k in sorted(want_p):
        np.testing.assert_allclose(params[k].numpy(), want_p[k], rtol=0, atol=2 * sum(lrs),
                                   err_msg=k)
        assert _rel(opt.m[k].numpy(), want_m[k]) <= GRAD_TOL["bfloat16"], k
        assert _rel(opt.v[k].numpy(), want_v[k]) <= 2 * GRAD_TOL["bfloat16"], k


@pytest.mark.parametrize("mesh", [{"data": 8}, {"pod": 2, "data": 4}])
@pytest.mark.parametrize("arch", ARCHS)
def test_expert_leaves_get_the_reference_buckets(arch, mesh):
    """The plan over the MoE tree equals the reference's: an expert leaf's
    "model" spec entry reads as size 1 on a mesh without a model axis, so
    it syncs over every mesh axis like a dense leaf."""
    cfg = smoke_config(arch)
    shapes, specs = param_shapes(cfg)
    jcmp = dataclasses.replace(j_compression_preset(
        "fixed_k_1bit", axes=("pod",) if "pod" in mesh else ("data",)), min_compress_size=1024)
    got = bucketing.build_plan(shapes, specs, tuple(mesh), mesh, convert.compression_config(jcmp))
    want = jbucketing.build_plan(shapes, specs, tuple(mesh), mesh, jcmp)
    as_tuple = lambda plan: [(b.bid, b.kind, b.caxes, b.eaxes, b.size, b.ready,
                              [(s.name, s.offset, s.size, tuple(s.shape)) for s in b.slots])
                             for b in plan.buckets]
    assert as_tuple(got) == as_tuple(want) and got.passthrough == tuple(want.passthrough)
    expert = [b for b in got.buckets for s in b.slots if s.name == "layers.moe.w_up"]
    assert len(expert) == 1 and expert[0].kind == "compressed"
    assert bucketing.leaf_sync_axes(specs["layers.moe.w_up"], tuple(mesh)) == tuple(mesh)


# ------------------------------------------------------------- the port alone

@pytest.mark.parametrize("arch", ARCHS)
def test_stacked_step_reports_the_mean_aux(arch):
    """n = 2 stacked ranks under fixed-k: ``metrics["aux"]`` is the mean of
    the ranks' layer-summed aux losses."""
    n = 2
    cfg = smoke_config(arch)
    cmp = dataclasses.replace(compression_preset("fixed_k_1bit", axes=("data",)),
                              min_compress_size=1024)
    run = RunConfig(attn_chunk_q=16, attn_chunk_k=16, compression=cmp)
    shape = ShapeSpec("t", "train", TS, TB)
    step_fn, init_fn, plan = tts.build_train_step(cfg, run, shape, n, device="cpu")
    assert any(b.kind == "compressed" for b in plan.buckets)
    params, opt, ef = init_fn(0)
    batch = SyntheticLM(cfg, shape).batch(0, "cpu")
    _, _, _, m = step_fn(params, opt, ef, batch, 0)
    ctx = tmodel.make_ctx(cfg, run)
    with torch.no_grad():
        auxes = [tmodel.train_loss(ctx, params, cfg, run,
                                   {k: v[r * TB // n:(r + 1) * TB // n] for k, v in batch.items()},
                                   float(TB * TS))[1]["aux"] for r in range(n)]
    np.testing.assert_allclose(float(m["aux"]), float(sum(auxes)) / n, rtol=1e-6)
    assert bool(torch.isfinite(m["loss"])) and float(m["aux"]) > 0


STEP_LINE = re.compile(r"^step +(\d+)  loss (\S+)  gnorm (\S+)  lr (\S+)$")


@pytest.mark.parametrize("arch", ARCHS)
def test_cli_smoke_run(arch, capsys):
    assert train_cli.main(["--arch", arch, "--smoke", "--devices", "2", "--steps", "2",
                           "--seq", "32", "--batch", "4", "--device", "cpu"]) == 0
    rows = [STEP_LINE.match(line) for line in capsys.readouterr().out.strip().splitlines()]
    assert rows and all(rows) and [int(m[1]) for m in rows] == [0, 1]
    assert all(np.isfinite(float(m[2])) for m in rows)


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_example_core(arch):
    cfg = smoke_config(arch)
    params = tmodel.init(0, cfg, device="cpu")
    prompt = torch.from_numpy(_tokens(cfg)[:, :serve_lm.PROMPT_LEN])
    out = serve_lm.serve(params, prompt, "cpu", cfg=cfg)
    assert out.shape == (B, 1 + serve_lm.STEPS) and out.dtype == torch.int32
    assert bool(((out >= 0) & (out < cfg.vocab_size)).all())


def test_other_families_still_raise(monkeypatch):
    # jamba's config converts (its MoE and SSM sub-configs are the port's)
    # and, the hybrid family being ported, runs; so do whisper's, the
    # encoder-decoder family, and llava's, the VLM family; a family that
    # neither package has does not: the model, its parameter shapes, its
    # smoke config and its batches raise
    jamba = convert.arch_config(j_smoke_config("jamba-v0.1-52b"))
    assert jamba.family == "hybrid" and jamba.moe is not None and jamba.ssm is not None
    ttfm.check_family(jamba)
    assert "periods.moe.w_up" in param_shapes(jamba)[0]
    whisper = convert.arch_config(j_smoke_config("whisper-medium"))
    assert whisper.family == "encdec" and whisper.encoder_layers == 2
    ttfm.check_family(whisper)
    assert "dec.xattn.wq" in param_shapes(whisper)[0]
    llava = convert.arch_config(j_smoke_config("llava-next-34b"))
    assert llava.family == "vlm" and llava.num_patches == 8
    ttfm.check_family(llava)
    assert "patch_proj" in param_shapes(llava)[0]
    for family in ("no-such-family",):
        other = ArchConfig(name="x", family=family, num_layers=1, d_model=8, num_heads=1,
                           num_kv_heads=1, d_ff=8, vocab_size=8, num_patches=4)
        with pytest.raises(NotPortedError):
            ttfm.check_family(other)
        with pytest.raises(NotPortedError):
            param_shapes(other)
        monkeypatch.setitem(registry._ARCHS, "x", other)
        with pytest.raises(NotPortedError):
            smoke_config("x")
        with pytest.raises(NotPortedError):
            SyntheticLM(other, ShapeSpec("t", "train", 8, 2)).host_batch(0)
    # qwen2-moe is in the reference's FSDP set: FSDP on, as the reference's
    assert get_run_config("qwen2-moe-a2.7b", "train_4k") == convert.run_config(
        j_get_run_config("qwen2-moe-a2.7b", "train_4k"))
    assert get_run_config("qwen2-moe-a2.7b", "train_4k").fsdp
    assert not get_run_config("olmoe-1b-7b", "train_4k").fsdp
