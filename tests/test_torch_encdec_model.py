"""The port's encoder–decoder family at the model level against the JAX
package, at the reference's whisper smoke config (``smoke_config
("whisper-medium")``: 2 encoder and 2 decoder layers, d 64, 4/2 heads of
16, ff 128, vocab 512, 24 frames padded to 512 by the pipeline and to 96
by the decode cache, tied embeddings): parameter names, shapes and specs
against the reference's ``init_encdec``, the synthetic batches with their
frames, the run configuration, the train loss and its per-leaf gradients
on the reference's own parameters, prefill and 4 decode steps against the
reference's ``engine.build_serve_fns`` cache by cache; then the port
alone: the decode against one forward, remat, the stacked n = 4 step
under ``fixed_k_1bit`` and the training CLI.

One shape throughout: training batches of 4 × 32 tokens with 512 frames
each (the pipeline's), prompts of 2 × 32 tokens with 96 frames (the
cache's padding) and 4 decode steps.  The reference's parameters come from
``model.init`` inside ``jax.threefry_partitionable(False)``; its loss and
gradients and its serving functions each compiled once (``jax.jit``: the
comparisons hold tolerances, so XLA's fused multiply-adds do not matter).

Tolerances are the earlier families': loss 1e-5 (f32) and 1e-3 (bf16)
relative; per-leaf gradients 1e-4 relative Frobenius in f32; in bf16 each
leaf within the larger of 5e-2 (the dense family's) and 1.5 times the
reference's own bf16 distance from the port's f32 gradient (the SSM and
hybrid families' rule: ``ROADMAP.md`` queue 3; readings 0.6–1.4% against
distances of 0.5–1.4%, f32 readings at most 2e-6).  The serving logits within
5e-2, the caches within ``CACHE_TOL`` = 2e-2 of their largest |value|, or
the reference's own bf16 distance from the port's f32 engine where that is
larger.
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
from repro_torch.configs.registry import (compression_preset, get_config, get_run_config,
                                          param_shapes, smoke_config)
from repro_torch.core.collectives import StackedComm
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.kernels import backend
from repro_torch.launch import profile_serve, profile_train
from repro_torch.launch import train as train_cli
from repro_torch.models import encdec as tencdec
from repro_torch.models import model as tmodel
from repro_torch.models import transformer as ttfm
from repro_torch.serving import engine as tengine
from repro_torch.train import bucketing
from repro_torch.train import synthetic
from repro_torch.train import train_step as tts

# one intra-op thread: beside other test workers on a loaded machine, torch's
# thread pool stalls for tens of seconds
torch.set_num_threads(1)

ARCH = "whisper-medium"
SIZES = {"data": 1, "model": 1}
B, S0, STEPS, S_ENC = 2, 32, 4, 96    # prompt of S0 tokens and S_ENC frames, STEPS decodes
TB, TS = 4, 32                        # training batch
LOSS_TOL = {"float32": 1e-5, "bfloat16": 1e-3}
GRAD_TOL = {"float32": 1e-4, "bfloat16": 5e-2}
LOGIT_TOL, CACHE_TOL = 5e-2, 2e-2
CFG = smoke_config(ARCH)
JCFG = j_smoke_config(ARCH)
SHAPE = ShapeSpec("t", "train", TS, TB)
JSHAPE = JShapeSpec("t", "train", TS, TB)


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
def test_param_shapes_match_reference(which):
    jcfg = JCFG if which == "smoke" else j_get_config(ARCH)
    cfg = CFG if which == "smoke" else get_config(ARCH)
    assert convert.arch_config(jcfg) == cfg
    shapes, specs = param_shapes(cfg)
    ctx = jmodel.make_ctx(jcfg, _jrun(), SIZES, dtype=jnp.float32)
    jparams, jspecs = jmodel.init(jax.random.PRNGKey(0), jcfg, ctx, SIZES, _jrun(),
                                  abstract=True)
    assert list(shapes) == list(jparams)                      # init_encdec's leaf order
    assert shapes == {k: tuple(v.shape) for k, v in jparams.items()}
    assert specs == {k: tuple(v) for k, v in jspecs.items()}
    assert "enc.mlp.w_gate" not in shapes and "dec.xattn.wq" in shapes
    if which == "full":
        assert len(shapes) == 24
        assert sum(int(np.prod(s)) for s in shapes.values()) == 757_877_760
    else:
        params = tmodel.init(0, cfg, device="cpu")
        assert list(params) == list(shapes)
        assert {k: tuple(v.shape) for k, v in params.items()} == shapes
        assert all(v.dtype == torch.float32 for v in params.values())
        assert torch.equal(params["dec.norm3"], torch.ones(2, 64))


def test_host_batch_matches_reference():
    """Tokens, labels, mask and frames bit-equal for two steps; the frames
    are drawn after the tokens and padded to ``enc_seq_padded(cfg, 16)``."""
    for step in (0, 1):
        want = JSyntheticLM(JCFG, JSHAPE, seed=3).host_batch(step)
        got = SyntheticLM(CFG, SHAPE, seed=3).host_batch(step)
        assert sorted(got) == sorted(want) == ["frames", "labels", "mask", "tokens"]
        for k in want:
            assert got[k].dtype == want[k].dtype and np.array_equal(got[k], want[k]), k
        assert got["frames"].shape == (TB, 512, 64)
    batch = SyntheticLM(CFG, SHAPE, seed=3).batch(1, "cpu")
    assert batch["frames"].dtype == torch.float32
    assert np.array_equal(batch["frames"].numpy(), want["frames"])


def test_run_config_matches_reference():
    want = convert.run_config(j_get_run_config(ARCH, "train_4k"))
    got = get_run_config(ARCH, "train_4k")
    assert got == want
    assert (got.microbatches, got.fsdp, got.remat, got.model_parallel) == (1, False, True, True)
    assert got.compression == compression_preset("fixed_k_1bit", axes=("data",))
    cfg, run, shape = synthetic.encdec_train_path()
    assert cfg == get_config(ARCH) and (cfg.num_layers, cfg.encoder_layers) == (24, 24)
    assert run == got and (shape.seq_len, shape.global_batch) == (4096, synthetic.N)


# ---------------------------------------------------------------- training

@functools.lru_cache(maxsize=None)
def _reference_loss_and_grads(dtype):
    params, specs = _jparams()
    run = _jrun()
    ctx = jmodel.make_ctx(JCFG, run, SIZES, dtype=getattr(jnp, dtype))
    batch = JSyntheticLM(JCFG, JSHAPE).host_batch(0)
    with jax.threefry_partitionable(False):
        (loss, metrics), grads = jax.jit(jax.value_and_grad(
            lambda p: jmodel.train_loss(ctx, p, specs, JCFG, run, batch, float(TB * TS)),
            has_aux=True))(params)
    return float(loss), float(metrics["aux"]), {k: np.asarray(v) for k, v in grads.items()}


@functools.lru_cache(maxsize=None)
def _port_loss_and_grads(dtype):
    run = _run(compute_dtype=dtype)
    params = _tparams(requires_grad=True)
    batch = SyntheticLM(CFG, SHAPE).batch(0, "cpu")
    loss, metrics = tmodel.train_loss(tmodel.make_ctx(CFG, run), params, CFG, run, batch,
                                      float(TB * TS))
    names = sorted(params)
    grads = dict(zip(names, torch.autograd.grad(loss, [params[k] for k in names])))
    return float(loss.detach()), float(metrics["aux"]), {k: v.numpy() for k, v in grads.items()}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_train_loss_and_grads_match_reference(dtype):
    want_loss, want_aux, want = _reference_loss_and_grads(dtype)
    loss, aux, grads = _port_loss_and_grads(dtype)
    np.testing.assert_allclose(loss, want_loss, rtol=LOSS_TOL[dtype])
    assert aux == want_aux == 0.0
    assert sorted(want) == sorted(grads)
    errs = {k: _rel(grads[k], want[k]) for k in want}
    if dtype == "float32":
        assert max(errs.values()) <= GRAD_TOL[dtype], errs
        return
    exact = _port_loss_and_grads("float32")[2]
    noise = {k: _rel(exact[k], want[k]) for k in want}
    assert all(errs[k] <= max(GRAD_TOL[dtype], 1.5 * noise[k]) for k in want), (errs, noise)


def test_remat_changes_nothing():
    """Recomputing each encoder and decoder layer in the backward gives the
    same loss and gradients, bit for bit."""
    batch = SyntheticLM(CFG, SHAPE).batch(0, "cpu")
    out = []
    for remat in (False, True):
        run = RunConfig(attn_chunk_q=16, attn_chunk_k=16, remat=remat)
        params = _tparams(requires_grad=True)
        loss, _ = tmodel.train_loss(tmodel.make_ctx(CFG, run), params, CFG, run, batch,
                                    float(TB * TS))
        out.append((loss.detach(), *torch.autograd.grad(loss, list(params.values()))))
    assert all(torch.equal(a, b) for a, b in zip(*out))


# ----------------------------------------------------------------- serving

def _inputs():
    rng = np.random.default_rng(9)
    toks = rng.integers(0, CFG.vocab_size, (B, S0 + STEPS)).astype(np.int32)
    return toks, rng.standard_normal((B, S_ENC, CFG.d_model)).astype(np.float32)


@functools.lru_cache(maxsize=None)
def _reference_serve():
    """The reference's engine: prefill of S0 tokens with S_ENC frames, then
    STEPS decode steps fed the known tokens: (prefill logits, [cache after
    prefill and after each step]) as numpy."""
    mesh = jax.make_mesh((1, 1), ("data", "model"))
    run = JRunConfig(microbatches=1, remat=False,
                     compression=jtypes.CompressionConfig(mode="none"))
    shape = JShapeSpec("serve", "decode", S0 + STEPS, B)
    toks, frames = _inputs()
    params = {k: jnp.asarray(v) for k, v in _jparams()[0].items()}
    flat = lambda c: {k: np.asarray(v, np.float32) for k, v in c.items()}
    with jax.threefry_partitionable(False):
        prefill_fn, decode_fn, _, _ = jengine.build_serve_fns(mesh, JCFG, run, shape)
        cache, logits = prefill_fn(params, {"tokens": toks[:, :S0], "frames": frames})
        caches = [flat(cache)]
        for i in range(STEPS):
            _, cache = decode_fn(params, cache, toks[:, S0 + i:S0 + i + 1], jnp.int32(S0 + i))
            caches.append(flat(cache))
        logits = np.asarray(logits, np.float32)
    return logits, caches


def _port_serve(dtype: str):
    """The port's engine: (prefill logits, [cache after prefill and after
    each step], [logits of each step], (prefill_fn, decode_fn, params))."""
    run = RunConfig(remat=False, compute_dtype=dtype)
    prefill_fn, decode_fn = tengine.build_serve_fns(
        CFG, run, ShapeSpec("serve", "decode", S0 + STEPS, B), device="cpu")
    params = _tparams()
    toks, frames = (torch.from_numpy(a) for a in _inputs())
    cache, logits = prefill_fn(params, {"tokens": toks[:, :S0], "frames": frames})
    ctx = tmodel.make_ctx(CFG, run)
    caches, step_logits = [{k: v.clone() for k, v in cache.items()}], []
    for i in range(STEPS):
        pos = S0 + i
        _, lg, cache = tmodel.decode_step(ctx, params, CFG, run, cache, toks[:, pos:pos + 1], pos)
        caches.append({k: v.clone() for k, v in cache.items()})
        step_logits.append(lg)
    return logits, caches, step_logits, (prefill_fn, decode_fn, params)


def test_prefill_and_decode_match_reference_engine():
    """bf16: the prefill logits, and every cache after the prefill and
    after each of the 4 decode steps: the self K/V padded to S0 + STEPS,
    the cross K/V as long as the frames, all bf16."""
    want_logits, want_caches = _reference_serve()
    backend.reset_launches()
    logits, got, step_logits, (prefill_fn, decode_fn, params) = _port_serve("bfloat16")
    exact_logits, exact, _, _ = _port_serve("float32")
    assert not backend.launches
    assert logits.shape == (B, 1, CFG.vocab_size) and logits.dtype == torch.float32
    noise = float(np.abs(exact_logits.numpy() - want_logits).max())
    np.testing.assert_allclose(logits.numpy(), want_logits, atol=max(LOGIT_TOL, noise), rtol=0)
    shapes = {"k": (2, B, S0 + STEPS, 2, 16), "xk": (2, B, S_ENC, 2, 16)}
    for step, (g, e, w) in enumerate(zip(got, exact, want_caches)):
        assert sorted(g) == sorted(w) == ["k", "v", "xk", "xv"]
        for k in g:
            assert g[k].dtype == torch.bfloat16 and tuple(g[k].shape) == w[k].shape, k
            assert w[k].shape == shapes[k.replace("v", "k")], k
            tol = max(CACHE_TOL, _max_rel(e[k].float().numpy(), w[k]))
            assert _max_rel(g[k].float().numpy(), w[k]) <= tol, (step, k)
        # slots past the decoded ones stay zero; the cross K/V never change
        assert not bool(g["k"][:, :, S0 + step:].any())
        assert torch.equal(g["xk"], got[0]["xk"]) and torch.equal(g["xv"], got[0]["xv"])
    # the engine's decode step is decode_step's next token
    toks, frames = (torch.from_numpy(a) for a in _inputs())
    cache, _ = prefill_fn(params, {"tokens": toks[:, :S0], "frames": frames})
    first, _ = decode_fn(params, cache, toks[:, S0:S0 + 1], S0)
    assert torch.equal(first, torch.argmax(step_logits[0], -1))
    out = tengine.generate(prefill_fn, decode_fn, params,
                           {"tokens": toks[:, :S0], "frames": frames}, STEPS)
    assert tuple(out.shape) == (B, STEPS) and bool(((out >= 0) & (out < 512)).all())


def test_decode_consistent_with_forward():
    """f32 compute: the teacher-forced decode of positions S0 … S0 + 15
    after a prefill gives the logits of one forward over all the tokens
    (within 2e-3: the decode reads K/V through the bf16 cache)."""
    run = _run(compute_dtype="float32")
    ctx = tmodel.make_ctx(CFG, run)
    params = _tparams()
    rng = np.random.default_rng(10)
    toks = torch.from_numpy(rng.integers(0, CFG.vocab_size, (B, S0 + 16)))
    frames = torch.from_numpy(rng.standard_normal((B, S_ENC, 64)).astype(np.float32))
    cache, logits = tmodel.prefill(ctx, params, CFG, run, {"tokens": toks[:, :S0],
                                                           "frames": frames}, s_max=S0 + 16)
    got = [logits]
    for i in range(S0, S0 + 15):
        _, logits, cache = tmodel.decode_step(ctx, params, CFG, run, cache, toks[:, i:i + 1], i)
        got.append(logits)
    enc = tencdec.encode(ctx, params, CFG, run, frames)
    h, _ = tencdec._decoder_forward(ctx, params, CFG, run,
                                    tencdec.embed_decoder(ctx, params, CFG, toks), enc, False)
    want = ttfm.lm_head_logits(ctx, params, CFG, h[:, S0 - 1:-1])
    np.testing.assert_allclose(torch.cat(got, 1).numpy(), want.numpy(), atol=2e-3, rtol=0)


def test_make_cache_is_the_prefill_layout():
    run = RunConfig(remat=False)
    ctx = tmodel.make_ctx(CFG, run)
    zero = tmodel.make_cache(ctx, CFG, B, S0 + STEPS, device="cpu")
    toks, frames = (torch.from_numpy(a) for a in _inputs())
    cache, _ = tmodel.prefill(ctx, _tparams(), CFG, run, {"tokens": toks[:, :S0],
                                                          "frames": frames}, s_max=S0 + STEPS)
    assert {k: (v.shape, v.dtype) for k, v in zero.items()} == {
        k: (v.shape, v.dtype) for k, v in cache.items()}
    assert not any(bool(v.any()) for v in zero.values())


# ------------------------------------------------------------- the port alone

def test_stacked_step_n4_fixed_k():
    """n = 4 stacked ranks under ``fixed_k_1bit``: row r of each stack is
    rank r's own gradient (its rows of tokens and frames), the synced
    gradient is the compressed sync of the stacks, and the two issue
    schedules give the same bits."""
    n = 4
    run = _run(compression=dataclasses.replace(compression_preset("fixed_k_1bit",
                                                                  axes=("data",)),
                                               min_compress_size=1024))
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
        out[overlap] = (new_params, float(m["loss"]), float(m["grad_norm"]))
    stacks, synced, key = seen["sync"]["grads"], seen["sync"]["synced"], seen["sync"]["key"]
    ctx = tmodel.make_ctx(CFG, run)
    for r in range(n):
        leaves = {k: v.detach().requires_grad_() for k, v in params.items()}
        loss, _ = tmodel.train_loss(ctx, leaves, CFG, run,
                                    {k: v[r:r + 1] for k, v in batch.items()}, float(TB * TS))
        names = sorted(leaves)
        own = dict(zip(names, torch.autograd.grad(loss, [leaves[k] for k in names])))
        assert all(torch.equal(stacks[k][r], own[k]) for k in own), r
    assert any(b.kind == "compressed" for b in plan.buckets)
    want, _ = bucketing.sync_grads_bucketed(stacks, plan, run.compression, key,
                                            StackedComm(n, "cpu"))
    assert all(torch.equal(synced[k], want[k]) for k in want)
    assert any(not torch.equal(synced[k], stacks[k].mean(0)) for k in synced)
    assert out[True][1:] == out[False][1:] and np.isfinite(out[True][1])
    assert all(torch.equal(out[True][0][k], out[False][0][k]) for k in out[True][0])


STEP_LINE = re.compile(r"^step +(\d+)  loss (\S+)  gnorm (\S+)  lr (\S+)$")


def test_cli_smoke_run_and_resume(tmp_path, capsys):
    """``--arch whisper-medium --smoke --devices 2``: 2 steps that save,
    then resumed to 3 from the checkpoint, whose leaves are the ``enc.*``
    and ``dec.*`` stacks."""
    d = str(tmp_path / "ckpt")
    args = ["--arch", ARCH, "--smoke", "--devices", "2", "--seq", "32", "--batch", "4",
            "--ckpt-every", "2", "--ckpt-dir", d, "--device", "cpu"]
    for steps, want in ((2, [0, 1]), (3, [2])):
        assert train_cli.main(args + ["--steps", str(steps)]) == 0
        rows = [STEP_LINE.match(line) for line in capsys.readouterr().out.strip().splitlines()]
        assert rows and all(rows) and [int(m[1]) for m in rows] == want
        assert all(np.isfinite(float(m[2])) for m in rows)
        assert ckpt.latest_step(d) == steps


@pytest.mark.parametrize("script", [profile_serve, profile_train])
def test_profile_scripts_take_the_arch(script, monkeypatch):
    """Both profiles accept ``--arch whisper-medium`` and then refuse to run
    without a card (an unknown arch would stop at the argument parser)."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(SystemExit, match="no CUDA device"):
        script.main(["--arch", ARCH])
