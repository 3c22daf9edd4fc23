"""The port's VLM family (llava-next-34b) against the JAX package, at the
reference's smoke config (``smoke_config("llava-next-34b")``: 2 layers, d
64, 4/2 heads of 16, ff 128, vocab 512, 8 patches, θ 5e6, untied head):
the config, the run configuration and parameter shapes, the synthetic
batches with their patches, ``init_lm``'s leaves with ``patch_proj``,
``embed_inputs`` and ``_labels_local``, the train loss and its per-leaf
gradients on the reference's own parameters, prefill and 4 decode steps
against the reference's ``engine.build_serve_fns`` driven at the total
length (patches and tokens), ``generate`` against that loop, and the
reference's own ``generate``, which starts decoding at the text length (a
hazard of the reference, recorded here, not a fault of the port); then the
port alone: the decode against one forward, the stacked n = 4 step (its
ranks' rows of patches) and the training CLI.

One shape throughout: sequences of ``P`` = 8 patches and ``T`` = 24 tokens
(32 positions; the training batch 4 of them, the prompts 2) and 4 decode
steps.  The reference's parameters come from ``model.init`` inside
``jax.threefry_partitionable(False)``; its loss and gradients and its
serving functions are each compiled once (``jax.jit``: the comparisons
hold tolerances, so XLA's fused multiply-adds do not matter).

Tolerances are the earlier families': loss 1e-5 (f32) and 1e-3 (bf16)
relative; per-leaf gradients 1e-4 relative Frobenius in f32; in bf16 each
leaf within the larger of 5e-2 (the dense family's) and 1.5 times the
reference's own bf16 distance from the port's f32 gradient.  Embeddings
within one ulp of their dtype around values of a few units; the serving
logits within 5e-2, the caches within ``CACHE_TOL`` = 2e-2 of their largest
|value|, or the reference's own bf16 distance from the port's f32 engine
where that is larger.
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
from repro.serving import engine as jengine
from repro_torch import convert
from repro_torch.checkpoint import checkpointing as ckpt
from repro_torch.configs.base import RunConfig, ShapeSpec
from repro_torch.configs import registry
from repro_torch.configs.registry import (compression_preset, get_config, get_run_config,
                                          param_shapes, smoke_config)
from repro_torch.core.collectives import StackedComm
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.kernels import backend
from repro_torch.launch import profile_serve, profile_train
from repro_torch.launch import train as train_cli
from repro_torch.models import model as tmodel
from repro_torch.models import transformer as ttfm
from repro_torch.serving import engine as tengine
from repro_torch.train import bucketing
from repro_torch.train import synthetic
from repro_torch.train import train_step as tts

# one intra-op thread: beside other test workers on a loaded machine, torch's
# thread pool stalls for tens of seconds
torch.set_num_threads(1)

ARCH = "llava-next-34b"
SIZES = {"data": 1, "model": 1}
P, T = 8, 24                          # patches and tokens of a sequence
S0 = P + T                            # its positions
B, STEPS = 2, 4                       # prompts, decode steps
TB = 4                                # training batch
LOSS_TOL = {"float32": 1e-5, "bfloat16": 1e-3}
GRAD_TOL = {"float32": 1e-4, "bfloat16": 5e-2}
LOGIT_TOL, CACHE_TOL = 5e-2, 2e-2
CFG = smoke_config(ARCH)
JCFG = j_smoke_config(ARCH)
SHAPE = ShapeSpec("t", "train", S0, TB)
JSHAPE = JShapeSpec("t", "train", S0, TB)


def _jrun(**kw):
    return JRunConfig(attn_chunk_q=16, attn_chunk_k=16, remat=False, **kw)


def _run(**kw):
    return RunConfig(attn_chunk_q=16, attn_chunk_k=16, remat=False, **kw)


def _rel(got, want) -> float:
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(np.asarray(got, np.float64) - want) / np.linalg.norm(want))


def _max_rel(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert got.shape == want.shape, (got.shape, want.shape)
    return float(np.abs(got - want).max()) / float(np.abs(want).max())


@functools.lru_cache(maxsize=None)
def _jparams():
    ctx = jmodel.make_ctx(JCFG, _jrun(), SIZES)
    with jax.threefry_partitionable(False):
        params, specs = jmodel.init(jax.random.PRNGKey(0), JCFG, ctx, SIZES, _jrun())
    return {k: np.array(v) for k, v in params.items()}, specs


def _tparams(requires_grad=False):
    return {k: v.requires_grad_(requires_grad)
            for k, v in convert.tree_to_torch(_jparams()[0]).items()}


# ------------------------------------------------------------ configs, data

@pytest.mark.parametrize("which", ["smoke", "full"])
def test_config_and_param_shapes_match_reference(which):
    """The config field for field, and ``param_shapes`` and ``init_lm``
    against the reference's ``init_lm``: names, order, shapes and specs;
    ``patch_proj`` after the layer norms."""
    jcfg = JCFG if which == "smoke" else j_get_config(ARCH)
    cfg = CFG if which == "smoke" else get_config(ARCH)
    assert convert.arch_config(jcfg) == cfg
    assert cfg.family == "vlm" and cfg.num_patches == (P if which == "smoke" else 1152)
    shapes, specs = param_shapes(cfg)
    ctx = jmodel.make_ctx(jcfg, _jrun(), SIZES, dtype=jnp.float32)
    jparams, jspecs = jmodel.init(jax.random.PRNGKey(0), jcfg, ctx, SIZES, _jrun(),
                                  abstract=True)
    assert list(shapes) == list(jparams)
    assert shapes == {k: tuple(v.shape) for k, v in jparams.items()}
    assert specs == {k: tuple(v) for k, v in jspecs.items()}
    assert list(shapes)[-3:] == ["layers.norm1", "layers.norm2", "patch_proj"]
    d = cfg.d_model
    assert shapes["patch_proj"] == (d, d)
    if which == "full":
        assert (cfg.num_layers, d, cfg.num_heads, cfg.num_kv_heads, cfg.hd) == (60, 7168, 56,
                                                                                8, 128)
        assert (cfg.d_ff, cfg.vocab_size, cfg.rope_theta, cfg.tie_embeddings) == (
            20480, 64000, 5e6, False)
        assert sum(int(np.prod(s)) for s in shapes.values()) == 34_440_297_472
        cut = param_shapes(dataclasses.replace(cfg, num_layers=20))[0]
        assert sum(int(np.prod(s)) for s in cut.values()) == 12_126_026_752
        return
    params = tmodel.init(0, cfg, device="cpu")
    assert list(params) == list(shapes)
    assert {k: tuple(v.shape) for k, v in params.items()} == shapes
    assert all(v.dtype == torch.float32 for v in params.values())
    # drawn at the reference's scale d^-1/2 (64 × 64 draws: std within 10%)
    assert abs(float(params["patch_proj"].std()) * d ** 0.5 - 1.0) < 0.1
    converted = _tparams()
    assert list(converted) == list(shapes)
    assert all(converted[k].shape == params[k].shape and converted[k].dtype == torch.float32
               for k in shapes)


def test_host_batch_matches_reference():
    """Tokens, labels and mask over the T = S − P text positions and the
    patches, drawn after the tokens, bit-equal for two steps."""
    for step in (0, 1):
        want = JSyntheticLM(JCFG, JSHAPE, seed=3).host_batch(step)
        got = SyntheticLM(CFG, SHAPE, seed=3).host_batch(step)
        assert sorted(got) == sorted(want) == ["labels", "mask", "patches", "tokens"]
        for k in want:
            assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k
        assert got["tokens"].shape == (TB, T) and got["patches"].shape == (TB, P, 64)
    batch = SyntheticLM(CFG, SHAPE, seed=3).batch(1, "cpu")
    assert batch["patches"].dtype == torch.float32
    assert np.array_equal(batch["patches"].numpy(), want["patches"])


def test_run_config_matches_reference():
    """llava is in the reference's FSDP set: ``get_run_config`` is the
    reference's field for field, FSDP on; with FSDP off it is the
    reference's run otherwise (8 microbatches, remat, ``fixed_k_1bit`` over
    ``data``), and the training path takes that with one microbatch."""
    jrun = j_get_run_config(ARCH, "train_4k")
    assert jrun.fsdp and jrun.microbatches == 8
    fsdp = get_run_config(ARCH, "train_4k")
    assert fsdp.fsdp and fsdp == convert.run_config(jrun)
    want = convert.run_config(dataclasses.replace(jrun, fsdp=False))
    got = registry._run_config(ARCH, "train_4k", fsdp=False)
    assert got == want and got.remat and got.microbatches == 8
    assert got.compression == compression_preset("fixed_k_1bit", axes=("data",))
    cfg, run, shape = synthetic.vlm_train_path()
    assert cfg == dataclasses.replace(get_config(ARCH), num_layers=synthetic.VLM_LAYERS)
    assert run == dataclasses.replace(want, microbatches=1)
    assert (shape.seq_len, shape.global_batch) == (4096, synthetic.VLM_N)


# --------------------------------------------------------- embedding, labels

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_embed_inputs_and_labels_match_reference(dtype):
    """The patches projected in the compute dtype and prepended to the token
    embeddings; zero labels under a zero f32 mask over the patch
    positions."""
    host = JSyntheticLM(JCFG, JSHAPE).host_batch(0)
    jctx = jmodel.make_ctx(JCFG, _jrun(), SIZES, dtype=getattr(jnp, dtype))
    tctx = tmodel.make_ctx(CFG, _run(compute_dtype=dtype))
    want = jmodel.embed_inputs(jctx, _jparams()[0], JCFG, host)
    batch = SyntheticLM(CFG, SHAPE).batch(0, "cpu")
    got = tmodel.embed_inputs(tctx, _tparams(), CFG, batch)
    assert got.dtype == getattr(torch, dtype) and tuple(got.shape) == (TB, S0, 64)
    tol = dict(atol=1e-5, rtol=1e-5) if dtype == "float32" else dict(atol=2e-2, rtol=1e-2)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), **tol)
    # the token positions are the embedding table's rows, exactly
    assert torch.equal(got[:, P:], ttfm.embed_tokens(tctx, _tparams(), CFG, batch["tokens"]))
    want_lab, want_mask = jmodel._labels_local(jctx, JCFG, host, S0)
    lab, mask = tmodel._labels_local(CFG, batch)
    assert lab.dtype == torch.int32 and mask.dtype == torch.float32
    assert np.array_equal(lab.numpy(), np.asarray(want_lab))
    assert np.array_equal(mask.numpy(), np.asarray(want_mask))
    assert not bool(mask[:, :P].any()) and bool((mask[:, P:] == 1).all())


# ---------------------------------------------------------------- training

@functools.lru_cache(maxsize=None)
def _reference_loss_and_grads(dtype):
    params, specs = _jparams()
    run = _jrun()
    ctx = jmodel.make_ctx(JCFG, run, SIZES, dtype=getattr(jnp, dtype))
    batch = JSyntheticLM(JCFG, JSHAPE).host_batch(0)
    with jax.threefry_partitionable(False):
        (loss, metrics), grads = jax.jit(jax.value_and_grad(
            lambda p: jmodel.train_loss(ctx, p, specs, JCFG, run, batch, float(TB * S0)),
            has_aux=True))(params)
    return (float(loss), float(metrics["count"]),
            {k: np.asarray(v) for k, v in grads.items()})


@functools.lru_cache(maxsize=None)
def _port_loss_and_grads(dtype):
    run = _run(compute_dtype=dtype)
    params = _tparams(requires_grad=True)
    batch = SyntheticLM(CFG, SHAPE).batch(0, "cpu")
    loss, metrics = tmodel.train_loss(tmodel.make_ctx(CFG, run), params, CFG, run, batch,
                                      float(TB * S0))
    names = sorted(params)
    grads = dict(zip(names, torch.autograd.grad(loss, [params[k] for k in names])))
    return (float(loss.detach()), float(metrics["count"]),
            {k: v.numpy() for k, v in grads.items()})


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_train_loss_and_grads_match_reference(dtype):
    """The loss over the text positions alone (count TB·T), divided by the
    reference's global count TB·S (patch positions included), and every
    leaf's gradient, ``patch_proj``'s among them."""
    want_loss, want_count, want = _reference_loss_and_grads(dtype)
    loss, count, grads = _port_loss_and_grads(dtype)
    np.testing.assert_allclose(loss, want_loss, rtol=LOSS_TOL[dtype])
    assert count == want_count == TB * T
    assert sorted(want) == sorted(grads) and "patch_proj" in grads
    errs = {k: _rel(grads[k], want[k]) for k in want}
    assert float(np.abs(grads["patch_proj"]).max()) > 0
    if dtype == "float32":
        assert max(errs.values()) <= GRAD_TOL[dtype], errs
        return
    exact = _port_loss_and_grads("float32")[2]
    noise = {k: _rel(exact[k], want[k]) for k in want}
    assert all(errs[k] <= max(GRAD_TOL[dtype], 1.5 * noise[k]) for k in want), (errs, noise)


# ----------------------------------------------------------------- serving

def _inputs():
    rng = np.random.default_rng(9)
    toks = rng.integers(0, CFG.vocab_size, (B, T + STEPS)).astype(np.int32)
    return toks, rng.standard_normal((B, P, CFG.d_model)).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _reference_engine():
    """The reference's (prefill_fn, decode_fn) for prompts of S0 positions
    and STEPS decodes, and its parameters on the device."""
    mesh = jax.make_mesh((1, 1), ("data", "model"))
    run = JRunConfig(microbatches=1, remat=False,
                     compression=jtypes.CompressionConfig(mode="none"))
    shape = JShapeSpec("serve", "decode", S0 + STEPS, B)
    with jax.threefry_partitionable(False):
        prefill_fn, decode_fn, _, _ = jengine.build_serve_fns(mesh, JCFG, run, shape)
    return prefill_fn, decode_fn, {k: jnp.asarray(v) for k, v in _jparams()[0].items()}


def _flat(c):
    return {k: np.asarray(v, np.float32) for k, v in c.items()}


@functools.lru_cache(maxsize=None)
def _reference_serve():
    """The reference's engine driven at the total length: prefill of P
    patches and T tokens, then STEPS decode steps fed the known tokens at
    positions S0 + i: (prefill logits, [cache after prefill and after each
    step]) as numpy."""
    prefill_fn, decode_fn, params = _reference_engine()
    toks, patches = _inputs()
    with jax.threefry_partitionable(False):
        cache, logits = prefill_fn(params, {"tokens": toks[:, :T], "patches": patches})
        caches = [_flat(cache)]
        for i in range(STEPS):
            _, cache = decode_fn(params, cache, toks[:, T + i:T + i + 1], jnp.int32(S0 + i))
            caches.append(_flat(cache))
    return np.asarray(logits, np.float32), caches


def _port_serve(dtype: str):
    """The port's engine: (prefill logits, [cache after prefill and after
    each step], (prefill_fn, decode_fn, params))."""
    run = RunConfig(remat=False, compute_dtype=dtype)
    prefill_fn, decode_fn = tengine.build_serve_fns(
        CFG, run, ShapeSpec("serve", "decode", S0 + STEPS, B), device="cpu")
    params = _tparams()
    toks, patches = (torch.from_numpy(a) for a in _inputs())
    cache, logits = prefill_fn(params, {"tokens": toks[:, :T], "patches": patches})
    ctx = tmodel.make_ctx(CFG, run)
    caches = [{k: v.clone() for k, v in cache.items()}]
    for i in range(STEPS):
        _, _, cache = tmodel.decode_step(ctx, params, CFG, run, cache, toks[:, T + i:T + i + 1],
                                         S0 + i)
        caches.append({k: v.clone() for k, v in cache.items()})
    return logits, caches, (prefill_fn, decode_fn, params)


def test_prefill_and_decode_match_reference_engine():
    """bf16: the prefill logits, and the K/V cache after the prefill (the
    patches' and the tokens' positions) and after each of the 4 decode
    steps at positions S0 … S0 + 3, padded to S0 + STEPS, bf16."""
    want_logits, want_caches = _reference_serve()
    backend.reset_launches()
    logits, got, _ = _port_serve("bfloat16")
    exact_logits, exact, _ = _port_serve("float32")
    assert not backend.launches
    assert logits.shape == (B, 1, CFG.vocab_size) and logits.dtype == torch.float32
    noise = float(np.abs(exact_logits.numpy() - want_logits).max())
    np.testing.assert_allclose(logits.numpy(), want_logits, atol=max(LOGIT_TOL, noise), rtol=0)
    for step, (g, e, w) in enumerate(zip(got, exact, want_caches)):
        assert sorted(g) == sorted(w) == ["k", "v"]
        for k in g:
            assert g[k].dtype == torch.bfloat16 and tuple(g[k].shape) == w[k].shape, k
            assert w[k].shape == (2, B, S0 + STEPS, 2, 16), k
            tol = max(CACHE_TOL, _max_rel(e[k].float().numpy(), w[k]))
            assert _max_rel(g[k].float().numpy(), w[k]) <= tol, (step, k)
        # the patches' slots hold K/V; slots past the decoded ones stay zero
        assert bool(g["k"][:, :, :P].any())
        assert not bool(g["k"][:, :, S0 + step:].any())


def _reference_greedy(steps: int, start: int):
    """The reference's engine as a greedy loop from ``start``: its tokens,
    and the positions and K/V slot contents of each decode call."""
    prefill_fn, decode_fn, params = _reference_engine()
    toks, patches = _inputs()
    with jax.threefry_partitionable(False):
        cache, logits = prefill_fn(params, {"tokens": toks[:, :T], "patches": patches})
        prompt_k = np.asarray(cache["k"], np.float32)
        tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)
        out = []
        for i in range(steps):
            tok, cache = decode_fn(params, cache, tok, jnp.int32(start + i))
            out.append(np.asarray(tok))
    return np.concatenate(out, axis=1), prompt_k, np.asarray(cache["k"], np.float32)


def test_generate_matches_reference_decode_at_the_total_length():
    """``engine.generate`` (bf16) decodes from the prefill's length, S0 =
    patches + tokens: its tokens are those of the reference's prefill_fn
    and decode_fn driven at S0, S0 + 1, ...; its first token follows the
    prefill's argmax at position S0."""
    want, _, _ = _reference_greedy(STEPS, S0)
    prefill_fn, decode_fn, params = _port_serve("bfloat16")[2]
    toks, patches = (torch.from_numpy(a) for a in _inputs())
    prompt = {"tokens": toks[:, :T], "patches": patches}
    seen = []

    def recorded(p, cache, tok, pos):
        seen.append(pos)
        return decode_fn(p, cache, tok, pos)

    out = tengine.generate(prefill_fn, recorded, params, prompt, STEPS)
    assert seen == list(range(S0, S0 + STEPS))
    assert tuple(out.shape) == (B, STEPS)
    np.testing.assert_array_equal(out.numpy(), want)
    cache, logits = prefill_fn(params, prompt)
    first, _ = decode_fn(params, cache, torch.argmax(logits, -1), S0)
    assert torch.equal(first, out[:, :1])


def test_reference_generate_decodes_from_the_text_length():
    """A hazard of the reference, not a fault of the port: its
    ``engine.generate`` starts at ``batch["tokens"].shape[1]`` (T), not at
    the prefill's S0 = P + T positions, so its first decoded K/V lands on
    prompt slot T, over the K/V of a text token, and slot S0 stays empty."""
    prefill_fn, decode_fn, params = _reference_engine()
    toks, patches = _inputs()
    seen = []

    def recorded(p, cache, tok, pos):
        seen.append(int(pos))
        return decode_fn(p, cache, tok, pos)

    with jax.threefry_partitionable(False):
        out = jengine.generate(prefill_fn, recorded, params,
                               {"tokens": toks[:, :T], "patches": patches}, 2)
    assert np.asarray(out).shape == (B, 2)
    assert seen == [T, T + 1] and T < S0
    _, prompt_k, after = _reference_greedy(1, T)
    assert bool(np.any(prompt_k[:, :, T] != 0))                 # a prompt slot
    assert not np.array_equal(after[:, :, T], prompt_k[:, :, T])  # overwritten
    assert not np.any(after[:, :, S0])                           # never written


# ------------------------------------------------------------- the port alone

@pytest.mark.parametrize("cache_dtype", [torch.float32, torch.bfloat16])
def test_decode_consistent_with_forward(cache_dtype, monkeypatch):
    """f32 compute: the teacher-forced decode of the tokens after the
    patches and the prompt gives the logits of one forward over all
    positions: within 2e-3 through an f32 cache, and within 5e-2 through
    the serving path's bf16 cache, whose rounding of the patches' K/V (the
    projected patches are about 50 times the token embeddings at this
    init) the decode reads."""
    monkeypatch.setattr(tmodel, "make_cache",
                        functools.partial(tmodel.make_cache, dtype=cache_dtype))
    run = _run(compute_dtype="float32")
    ctx = tmodel.make_ctx(CFG, run)
    params = _tparams()
    toks, patches = (torch.from_numpy(a) for a in _inputs())
    cache, logits = tmodel.prefill(ctx, params, CFG, run,
                                   {"tokens": toks[:, :T], "patches": patches},
                                   s_max=S0 + STEPS)
    assert cache["k"].dtype == cache_dtype
    got = [logits]
    for i in range(STEPS - 1):
        _, logits, cache = tmodel.decode_step(ctx, params, CFG, run, cache,
                                              toks[:, T + i:T + i + 1], S0 + i)
        got.append(logits)
    full = {"tokens": toks, "patches": patches}
    x = tmodel.embed_inputs(ctx, params, CFG, full)
    blocks = dataclasses.replace(run, attn_chunk_q=4, attn_chunk_k=4)   # S0 + STEPS = 36
    h, _, _ = ttfm.forward(ctx, params, CFG, blocks, x,
                           torch.arange(tmodel.seq_total(full)))
    want = ttfm.lm_head_logits(ctx, params, CFG, h[:, S0 - 1:-1])
    atol = 2e-3 if cache_dtype == torch.float32 else 5e-2
    np.testing.assert_allclose(torch.cat(got, 1).numpy(), want.numpy(), atol=atol, rtol=0)


def test_stacked_step_n4_splits_the_patches():
    """n = 4 stacked ranks under ``fixed_k_1bit``: row r of each stack is
    rank r's own gradient, from its rows of tokens and patches, and the
    synced gradient is the compressed sync of the stacks."""
    n = 4
    run = _run(compression=dataclasses.replace(compression_preset("fixed_k_1bit",
                                                                  axes=("data",)),
                                               min_compress_size=1024))
    seen = {}
    step_fn, init_fn, plan = tts.build_train_step(
        CFG, run, SHAPE, n, device="cpu", on_phase=lambda name, **st: seen.setdefault(name, st))
    params, opt, ef = init_fn(0)
    batch = SyntheticLM(CFG, SHAPE).batch(0, "cpu")
    _, _, _, m = step_fn(params, opt, ef, batch, 0)
    assert np.isfinite(float(m["loss"]))
    stacks, synced, key = seen["sync"]["grads"], seen["sync"]["synced"], seen["sync"]["key"]
    ctx = tmodel.make_ctx(CFG, run)
    for r in range(n):
        leaves = {k: v.detach().requires_grad_() for k, v in params.items()}
        loss, _ = tmodel.train_loss(ctx, leaves, CFG, run,
                                    {k: v[r:r + 1] for k, v in batch.items()}, float(TB * S0))
        names = sorted(leaves)
        own = dict(zip(names, torch.autograd.grad(loss, [leaves[k] for k in names])))
        assert all(torch.equal(stacks[k][r], own[k]) for k in own), r
    assert not torch.equal(stacks["patch_proj"][0], stacks["patch_proj"][1])
    assert any(b.kind == "compressed" for b in plan.buckets)
    want, _ = bucketing.sync_grads_bucketed(stacks, plan, run.compression, key,
                                            StackedComm(n, "cpu"))
    assert all(torch.equal(synced[k], want[k]) for k in want)


STEP_LINE = re.compile(r"^step +(\d+)  loss (\S+)  gnorm (\S+)  lr (\S+)$")


def test_cli_smoke_run_and_resume(tmp_path, capsys):
    """``--arch llava-next-34b --smoke --devices 2``: 2 steps that save
    (``patch_proj`` in the checkpoint), then resumed for 1; without
    ``--smoke`` the CLI trains the FSDP arch under the reference's run
    config (too large to run here: the config it builds is checked)."""
    d = str(tmp_path / "ckpt")
    args = ["--arch", ARCH, "--smoke", "--devices", "2", "--seq", "32", "--batch", "4",
            "--ckpt-every", "2", "--ckpt-dir", d, "--device", "cpu"]
    for steps, want in ((2, [0, 1]), (3, [2])):
        assert train_cli.main(args + ["--steps", str(steps)]) == 0
        rows = [STEP_LINE.match(line) for line in capsys.readouterr().out.strip().splitlines()]
        assert rows and all(rows) and [int(m[1]) for m in rows] == want
        assert all(np.isfinite(float(m[2])) for m in rows)
        assert ckpt.latest_step(d) == steps
    arrays = np.load(tmp_path / "ckpt" / "step-00000003" / "arrays.npz")
    assert any("patch_proj" in k for k in arrays.files)
    cfg, run, _ = train_cli.build_config(
        train_cli._parse(["--arch", ARCH, "--steps", "1", "--device", "cpu"]), 1, 1)
    assert cfg == get_config(ARCH) and run.fsdp
    assert run == convert.run_config(j_get_run_config(ARCH, "train_4k"))


@pytest.mark.parametrize("script", [profile_serve, profile_train])
def test_profile_scripts_take_the_arch(script, monkeypatch):
    """Both profiles accept ``--arch llava-next-34b`` and then refuse to run
    without a card (an unknown arch would stop at the argument parser)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        script.main(["--arch", ARCH, "--layers", "20"] if script is profile_serve
                    else ["--arch", ARCH])

