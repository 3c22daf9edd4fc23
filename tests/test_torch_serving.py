"""The port's serving path against the JAX package: the model modules
(RMSNorm, RoPE, the q/k/v projection, the MLP, decode attention, the chunked
attention), then ``prefill`` and ``decode_step`` on the reference's own
parameters at ``smoke_config("qwen3-4b")`` and at a narrow config with
head dim 128 and a GQA group of 4; then the port's own prefill/decode
consistency and ``generate``.

The reference runs with ``tp = 1`` outside any mesh, its parameters from
``model.init`` inside ``jax.threefry_partitionable(False)``, its prefill and
decode step each compiled once with ``jax.jit`` (the comparisons hold a
tolerance, so XLA's fused multiply-adds do not matter).  Inputs come from
numpy seeds.

Tolerances on logits (values up to about 1.5): 1e-3 absolute at f32
compute — the KV cache is bf16 on both sides and decode rounds p to bf16
before P·V, so an f32-level difference can move a value across a bf16
rounding boundary (observed up to 3.7e-4) — and 5e-2 at bf16 compute
(every activation rounded to bf16 in another order; observed up to 1.4e-2).
Greedy tokens must agree wherever the reference's top-2 margin exceeds
the tolerance (the observed errors are below half of it, so no flip is
possible there).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import ArchConfig as JArchConfig
from repro.configs.base import RunConfig as JRunConfig
from repro.configs.registry import smoke_config as j_smoke_config
from repro.models import attention as jattn
from repro.models import common as jcommon
from repro.models import mlp as jmlp
from repro.models import model as jmodel
from repro_torch import convert
from repro_torch.configs.base import RunConfig, ShapeSpec
from repro_torch.configs.registry import get_config, list_archs, param_shapes, smoke_config
from repro_torch.core.wire.base import NotPortedError
from repro_torch.kernels import backend
from repro_torch.models import attention as tattn
from repro_torch.models import common as tcommon
from repro_torch.models import mlp as tmlp
from repro_torch.models import model as tmodel
from repro_torch.models import transformer as ttfm
from repro_torch.serving import engine

# one intra-op thread: beside other test workers on a loaded machine, torch's
# thread pool stalls for tens of seconds
torch.set_num_threads(1)

LOGIT_TOL = {"float32": 1e-3, "bfloat16": 5e-2}
CACHE_TOL = 2e-2
NARROW = JArchConfig(name="narrow-hd128", family="dense", num_layers=2, d_model=256,
                     num_heads=8, num_kv_heads=2, head_dim=128, d_ff=512, vocab_size=512,
                     qk_norm=True, rope_theta=1e6, tie_embeddings=True)
CONFIGS = {"qwen3-4b-smoke": j_smoke_config("qwen3-4b"), NARROW.name: NARROW}
B, S0, S = 2, 32, 48          # prompt of S0 tokens, then S - S0 teacher-forced decode steps
RUN = JRunConfig(attn_chunk_q=16, attn_chunk_k=16, remat=False)


def _rng(seed):
    return np.random.default_rng(seed)


def _t(x, dtype="float32"):
    return torch.from_numpy(np.asarray(x, np.float32)).to(getattr(torch, dtype))


def _close(got, want, dtype):
    """One ulp of the dtype around values up to a few units."""
    tol = dict(atol=1e-5, rtol=1e-5) if dtype == "float32" else dict(atol=2e-2, rtol=1e-2)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32), **tol)


def _ctxs(dtype):
    return (jcommon.ShardCtx(tp=1, compute_dtype=getattr(jnp, dtype)),
            tcommon.ShardCtx(compute_dtype=getattr(torch, dtype)))


# ------------------------------------------------------------------ modules

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_rms_norm_matches_reference(dtype):
    x = _rng(0).standard_normal((2, 8, 64), np.float32) * 3
    scale = _rng(1).standard_normal(64, np.float32)
    want = jcommon.rms_norm(jnp.asarray(x, getattr(jnp, dtype)), jnp.asarray(scale))
    _close(tcommon.rms_norm(_t(x, dtype), _t(scale)), want.astype(jnp.float32), dtype)


@pytest.mark.parametrize("theta", [1e4, 1e6])
@pytest.mark.parametrize("batched", [False, True])
def test_apply_rope_matches_reference(theta, batched):
    x = _rng(2).standard_normal((2, 24, 4, 16), np.float32)
    pos = np.arange(24) + 1000
    if batched:
        pos = np.stack([pos, pos[::-1]])
    want = jcommon.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta)
    got = tcommon.apply_rope(_t(x), torch.from_numpy(pos), theta)
    # cos/sin of angles up to ~1e3 rad: the two libraries' ulps
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=1e-5)


ROPE_CASES = sorted({(get_config(a).rope_theta, get_config(a).hd) for a in list_archs()}
                    | {(get_config(a).rope_theta, 16) for a in list_archs()})


@pytest.mark.parametrize("theta,hd", ROPE_CASES)
def test_rope_frequencies_bit_equal_to_reference(theta, hd):
    """The inverse-frequency table at every registered arch's (θ, head dim)
    and at the smoke configs' head dim 16, bit for bit: at position 2080 an
    ulp of a frequency moves the angle by up to 1.5e-5."""
    want = np.asarray(jcommon.rope_frequencies(hd, theta))
    got = tcommon.rope_frequencies(hd, theta).numpy()
    assert got.dtype == want.dtype == np.float32 and got.shape == (hd // 2,)
    assert np.array_equal(got.view(np.int32), want.view(np.int32))


def _attn_params(d, hq, hkv, hd, seed):
    r = _rng(seed)
    return {"wq": r.standard_normal((d, hq, hd), np.float32) * d ** -0.5,
            "wk": r.standard_normal((d, hkv, hd), np.float32) * d ** -0.5,
            "wv": r.standard_normal((d, hkv, hd), np.float32) * d ** -0.5,
            "wo": r.standard_normal((hq, hd, d), np.float32) * (hq * hd) ** -0.5,
            "q_norm": 1 + 0.1 * r.standard_normal(hd, np.float32),
            "k_norm": 1 + 0.1 * r.standard_normal(hd, np.float32)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_project_qkv_and_output_proj_match_reference(dtype):
    d, hq, hkv, hd = 64, 4, 2, 16
    p = _attn_params(d, hq, hkv, hd, 3)
    x = _rng(4).standard_normal((2, 12, d), np.float32)
    jctx, tctx = _ctxs(dtype)
    dims = jattn.attn_dims(hq, hkv, hd, 1)
    jx = jnp.asarray(x, getattr(jnp, dtype))
    want = jattn.project_qkv(jctx, {k: jnp.asarray(v) for k, v in p.items()}, jx, dims, True,
                             jnp.arange(12), 1e6)
    tp = {k: _t(v) for k, v in p.items()}
    got = tattn.project_qkv(tctx, tp, _t(x, dtype), tattn.attn_dims(hq, hkv, hd, 1), True,
                            torch.arange(12), 1e6)
    for g, w in zip(got, want):
        _close(g, w.astype(jnp.float32), dtype)
    o = _rng(5).standard_normal((2, 12, hq, hd), np.float32)
    want_o = jattn.output_proj(jctx, {"wo": jnp.asarray(p["wo"])},
                               jnp.asarray(o, getattr(jnp, dtype)))
    _close(tattn.output_proj(tctx, tp, _t(o, dtype)), want_o.astype(jnp.float32), dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mlp_matches_reference(dtype):
    d, f = 64, 128
    r = _rng(6)
    p = {"w_up": r.standard_normal((d, f), np.float32) * d ** -0.5,
         "w_gate": r.standard_normal((d, f), np.float32) * d ** -0.5,
         "w_down": r.standard_normal((f, d), np.float32) * f ** -0.5}
    x = r.standard_normal((2, 12, d), np.float32)
    jctx, tctx = _ctxs(dtype)
    want = jmlp.mlp(jctx, {k: jnp.asarray(v) for k, v in p.items()},
                    jnp.asarray(x, getattr(jnp, dtype)))
    got = tmlp.mlp(tctx, {k: _t(v) for k, v in p.items()}, _t(x, dtype))
    _close(got, want.astype(jnp.float32), dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("window", [None, 8])
def test_decode_attention_matches_reference(dtype, window):
    r = _rng(7)
    q = r.standard_normal((2, 1, 8, 16), np.float32)
    kc = r.standard_normal((2, 32, 2, 16), np.float32)
    vc = r.standard_normal((2, 32, 2, 16), np.float32)
    jd = getattr(jnp, dtype)
    want = jattn.decode_attention(jnp.asarray(q, jd), jnp.asarray(kc, jnp.bfloat16),
                                  jnp.asarray(vc, jnp.bfloat16), jnp.int32(21), window=window)
    got = tattn.decode_attention(_t(q, dtype), _t(kc, "bfloat16"), _t(vc, "bfloat16"), 21,
                                 window=window)
    assert got.dtype == getattr(torch, dtype)
    _close(got, want.astype(jnp.float32), dtype)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal,window,q_offset,sk", [(True, None, 0, 64), (True, 24, 0, 64),
                                                       (False, None, 0, 64),
                                                       (True, None, 32, 96)])
def test_chunked_attention_matches_reference(dtype, causal, window, q_offset, sk):
    r = _rng(8)
    q = r.standard_normal((2, 64, 4, 16), np.float32)
    k = r.standard_normal((2, sk, 2, 16), np.float32)
    v = r.standard_normal((2, sk, 2, 16), np.float32)
    jd = getattr(jnp, dtype)
    want = jattn.chunked_attention(*(jnp.asarray(a, jd) for a in (q, k, v)), causal=causal,
                                   window=window, q_offset=q_offset, chunk_q=16, chunk_k=32)
    got = tattn.chunked_attention(*(_t(a, dtype) for a in (q, k, v)), causal=causal,
                                  window=window, q_offset=q_offset, chunk_q=16, chunk_k=32)
    tol = dict(atol=1e-5, rtol=1e-5) if dtype == "float32" else dict(atol=3e-2, rtol=0)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)), **tol)


# ---------------------------------------------- prefill / decode vs reference

def _tokens(cfg):
    return _rng(9).integers(0, cfg.vocab_size, (B, S)).astype(np.int32)


@functools.lru_cache(maxsize=None)
def _reference_run(name, dtype):
    """The reference's params (numpy), prefill of S0 tokens and teacher-forced
    decode to S: (params, [prefill logits, decode logits...], decode tokens,
    prefill cache k)."""
    cfg = CONFIGS[name]
    sizes = {"data": 1, "model": 1}
    ctx = jmodel.make_ctx(cfg, RUN, sizes, dtype=getattr(jnp, dtype))
    with jax.threefry_partitionable(False):
        params, specs = jmodel.init(jax.random.PRNGKey(0), cfg, ctx, sizes, RUN)
    prefill = jax.jit(lambda p, t: jmodel.prefill(ctx, p, specs, cfg, RUN, {"tokens": t},
                                                  s_max=S))
    decode = jax.jit(lambda p, c, t, pos: jmodel.decode_step(ctx, p, specs, cfg, RUN, c, t, pos))
    toks = _tokens(cfg)
    cache, logits = prefill(params, toks[:, :S0])
    cache_k = np.asarray(cache["k"].astype(jnp.float32))
    out, nxts = [np.asarray(logits)], []
    for i in range(S0, S):
        nxt, logits, cache = decode(params, cache, toks[:, i:i + 1], jnp.int32(i))
        out.append(np.asarray(logits))
        nxts.append(np.asarray(nxt))
    return ({k: np.array(v) for k, v in params.items()}, out, np.concatenate(nxts, 1),
            cache_k)


def _port_run(cfg, run, params, toks, dtype):
    ctx = tmodel.make_ctx(cfg, run, dtype=getattr(torch, dtype))
    prompt = {"tokens": torch.from_numpy(toks[:, :S0])}
    cache, logits = tmodel.prefill(ctx, params, cfg, run, prompt, s_max=S)
    cache_k = cache["k"].float().clone()
    out, nxts = [logits], []
    for i in range(S0, S):
        nxt, logits, cache = tmodel.decode_step(ctx, params, cfg, run, cache,
                                                torch.from_numpy(toks[:, i:i + 1]), i)
        out.append(logits)
        nxts.append(nxt)
    return out, torch.cat(nxts, 1), cache_k


def _check_tokens(got_logits, want_logits, tol):
    """Greedy tokens agree wherever the reference's top-2 margin exceeds tol;
    returns how many positions were compared."""
    top2 = np.sort(want_logits, axis=-1)[..., -2:]
    decided = top2[..., 1] - top2[..., 0] > tol
    got = np.argmax(got_logits, axis=-1)
    want = np.argmax(want_logits, axis=-1)
    np.testing.assert_array_equal(got[decided], want[decided])
    return int(decided.sum())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("name", list(CONFIGS))
def test_prefill_and_decode_match_reference(name, dtype):
    params, want, want_next, want_k = _reference_run(name, dtype)
    cfg, run = convert.arch_config(CONFIGS[name]), convert.run_config(RUN)
    tparams = convert.tree_to_torch(params)
    backend.reset_launches()
    got, got_next, got_k = _port_run(cfg, run, tparams, _tokens(cfg), dtype)
    assert not backend.launches
    tol = LOGIT_TOL[dtype]
    want_all = np.concatenate(want, axis=1)                 # (B, 1 + S - S0, V)
    got_all = torch.cat(got, dim=1).numpy()
    assert got_all.shape == want_all.shape == (B, 1 + S - S0, cfg.vocab_size)
    np.testing.assert_allclose(got_all, want_all, atol=tol, rtol=0)
    np.testing.assert_allclose(got_k.numpy(), want_k, atol=4 * tol, rtol=1e-2)
    compared = _check_tokens(got_all, want_all, tol)
    positions = want_all.shape[0] * want_all.shape[1]
    print(f"{name} {dtype}: greedy tokens equal at {compared} of {positions} positions "
          "(top-2 margin > tol)")
    if dtype == "float32":    # the check is not vacuous: most margins exceed 1e-3
        assert compared >= positions // 2
    decided = np.diff(np.sort(want_all[:, 1:], axis=-1)[..., -2:], axis=-1)[..., 0] > tol
    np.testing.assert_array_equal(got_next.numpy()[decided], want_next[decided])


# ------------------------------------------------------------ the port alone

def _smoke(dtype="float32"):
    cfg = smoke_config("qwen3-4b")
    run = RunConfig(attn_chunk_q=16, attn_chunk_k=16, remat=False, compute_dtype=dtype)
    return cfg, run, tmodel.init(0, cfg, device="cpu")


def test_init_matches_param_shapes_and_reference_names():
    cfg, _, params = _smoke()
    shapes, _ = param_shapes(cfg)
    assert {k: tuple(v.shape) for k, v in params.items()} == shapes
    assert all(v.dtype == torch.float32 for v in params.values())
    jcfg = CONFIGS["qwen3-4b-smoke"]
    ctx = jmodel.make_ctx(jcfg, RUN, {"data": 1, "model": 1}, dtype=jnp.float32)
    jparams, _ = jmodel.init(jax.random.PRNGKey(0), jcfg, ctx, {"data": 1, "model": 1}, RUN,
                             abstract=True)
    assert shapes == {k: tuple(v.shape) for k, v in jparams.items()}
    again = tmodel.init(0, cfg, device="cpu")
    assert all(torch.equal(params[k], again[k]) for k in params)


def test_decode_consistent_with_prefill():
    """Teacher-forced decode after a prefill gives the logits of one forward
    over the whole sequence, position by position (f32 compute), within
    CACHE_TOL: decode reads k and v through the bf16 cache, the forward uses
    them unrounded (2^-9 relative; observed up to 5e-3).  Greedy tokens
    agree wherever the top-2 margin exceeds CACHE_TOL."""
    cfg, run, params = _smoke()
    toks = torch.from_numpy(_tokens(cfg))
    got, _, _ = _port_run(cfg, run, params, toks.numpy(), "float32")
    ctx = tmodel.make_ctx(cfg, run)
    x = tmodel.embed_inputs(ctx, params, cfg, {"tokens": toks})
    h, _, _ = ttfm.forward(ctx, params, cfg, run, x, torch.arange(S))
    want = ttfm.lm_head_logits(ctx, params, cfg, h[:, S0 - 1:])
    got = torch.cat(got, 1).numpy()
    np.testing.assert_allclose(got, want.numpy(), atol=CACHE_TOL, rtol=0)
    assert _check_tokens(got, want.numpy(), CACHE_TOL) > 0


def test_flash_and_xla_prefill_agree():
    cfg, run, params = _smoke()
    toks = {"tokens": torch.from_numpy(_tokens(cfg))}
    ctx = tmodel.make_ctx(cfg, run)
    _, flash = tmodel.prefill(ctx, params, cfg, run, toks)
    xla = RunConfig(attn_chunk_q=16, attn_chunk_k=16, remat=False, attn_impl="xla",
                    compute_dtype="float32")
    _, chunked = tmodel.prefill(ctx, params, cfg, xla, toks)
    np.testing.assert_allclose(flash.numpy(), chunked.numpy(), atol=1e-5, rtol=0)


def test_generate_shape_and_greedy_start():
    cfg, run, params = _smoke("bfloat16")
    prefill_fn, decode_fn = engine.build_serve_fns(cfg, run, ShapeSpec("serve", "decode", 64, 4),
                                                   device="cpu")
    prompt = torch.from_numpy(_rng(10).integers(0, cfg.vocab_size, (4, 16)))
    toks = engine.generate(prefill_fn, decode_fn, params, {"tokens": prompt}, steps=5)
    assert toks.shape == (4, 5) and toks.dtype == torch.int64
    assert bool(((toks >= 0) & (toks < cfg.vocab_size)).all())
    # the first decoded token follows the prefill's argmax
    cache, logits = prefill_fn(params, {"tokens": prompt})
    first, _ = decode_fn(params, cache, torch.argmax(logits, -1), 16)
    assert torch.equal(first, toks[:, :1])


def test_unported_options_raise():
    cfg, run, params = _smoke()
    with pytest.raises(NotPortedError):
        tmodel.make_ctx(cfg, run, {"data": 1, "model": 2})
    with pytest.raises(NotPortedError):
        tcommon.ShardCtx(tp=2)
    # FSDP converts; serving under it on one device is a data axis of 1,
    # where the gather is the cast: the same logits
    frun = convert.run_config(JRunConfig(fsdp=True, attn_chunk_q=16, attn_chunk_k=16,
                                         remat=False, compute_dtype="float32"))
    ctx = tmodel.make_ctx(cfg, frun)
    assert frun.fsdp and ctx.fsdp and ctx.comm is None
    prompt = {"tokens": torch.arange(32, dtype=torch.int64).reshape(2, 16)}
    got = tmodel.prefill(ctx, params, cfg, frun, prompt)[1]
    want = tmodel.prefill(tmodel.make_ctx(cfg, run), params, cfg, run, prompt)[1]
    assert torch.equal(got, want)
