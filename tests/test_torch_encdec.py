"""The port's encoder–decoder family at the module level against the JAX
package, at the reference's whisper smoke config (``smoke_config
("whisper-medium")``: d 64, 4/2 heads of 16, ff 128, vocab 512, tied
embeddings) cut to one encoder and one decoder layer: the sinusoidal
positions, the GELU MLP, one encoder layer (``encode``), one decoder layer
with its cross-attention (``_decoder_forward`` with its caches) and the
decode step's self- and cross-attention against a cache.

The reference runs op by op at ``tp = 1`` outside any mesh, its
parameters from ``model.init`` inside ``jax.threefry_partitionable(False)``
and handed to the port as numpy; every other input comes from a numpy seed
and goes to both sides as the same arrays.  One shape throughout: batch 2,
32 decoder tokens, 96 frames (the decode cache's padding of the smoke
config's 24: ``enc_seq_padded(cfg, 1)``), the decoder's chunks 16, the
encoder's ``min(768, 96)``.

Tolerances: the sinusoids within 1.2e-7 absolute (sin and cos an ulp
apart; the frequencies are bit-equal, the port taking the f32 exponents'
power in f64 as XLA's correctly rounded ``pow`` gives it); the GELU MLP in
f32 within 1e-5 relative on pre-activations of order 3, where torch's
default erf form is 4.7e-4 from ``jax.nn.gelu``'s tanh form; the layers
at the dense family's limits (``tests/test_torch_serving.py``): f32
within 1e-5 absolute and relative, bf16 within 2e-2 absolute plus 1e-2
relative; the decode step's logits within its ``LOGIT_TOL`` (1e-3 in f32,
whose K/V pass through the bf16 cache on both sides; 5e-2 in bf16).
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro.configs.base import RunConfig as JRunConfig
from repro.configs.registry import get_config as j_get_config
from repro.configs.registry import smoke_config as j_smoke_config
from repro.models import common as jcommon
from repro.models import encdec as jencdec
from repro.models import mlp as jmlp
from repro.models import model as jmodel
from repro_torch import convert
from repro_torch.configs.base import RunConfig
from repro_torch.configs.registry import get_config, smoke_config
from repro_torch.kernels import backend
from repro_torch.models import common as tcommon
from repro_torch.models import encdec as tencdec
from repro_torch.models import mlp as tmlp
from repro_torch.models import model as tmodel

# one intra-op thread: beside other test workers on a loaded machine, torch's
# thread pool stalls for tens of seconds
torch.set_num_threads(1)

ARCH = "whisper-medium"
SIZES = {"data": 1, "model": 1}
B, S, S_ENC = 2, 32, 96
POS = 20                         # the decode step's position: 20 valid cache slots before it
LOGIT_TOL = {"float32": 1e-3, "bfloat16": 5e-2}
JCFG = dataclasses.replace(j_smoke_config(ARCH), num_layers=1, encoder_layers=1)
CFG = dataclasses.replace(smoke_config(ARCH), num_layers=1, encoder_layers=1)
DTYPES = ["float32", "bfloat16"]


def _jrun():
    return JRunConfig(attn_chunk_q=16, attn_chunk_k=16, remat=False)


def _run(dtype):
    return RunConfig(attn_chunk_q=16, attn_chunk_k=16, remat=False, compute_dtype=dtype)


def _ctxs(dtype):
    return (jcommon.ShardCtx(tp=1, compute_dtype=getattr(jnp, dtype)),
            tmodel.make_ctx(CFG, _run(dtype)))


def _close(got, want, dtype):
    tol = dict(atol=1e-5, rtol=1e-5) if dtype == "float32" else dict(atol=2e-2, rtol=1e-2)
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(jnp.asarray(want).astype(jnp.float32)), **tol)


@functools.lru_cache(maxsize=None)
def _jparams():
    ctx = jmodel.make_ctx(JCFG, _jrun(), SIZES)
    with jax.threefry_partitionable(False):
        params, specs = jmodel.init(jax.random.PRNGKey(0), JCFG, ctx, SIZES, _jrun())
    return {k: np.array(v) for k, v in params.items()}, specs


def _normal(seed, *shape, scale=1.0):
    return (np.random.default_rng(seed).standard_normal(shape) * scale).astype(np.float32)


def _t(x, dtype="float32"):
    return torch.from_numpy(np.array(x, np.float32)).to(getattr(torch, dtype))


def test_config_converts_and_pads_as_the_reference():
    """The configs convert field for field; frames pad as the reference's:
    the pipeline's tp = 16 and the cache's tp = 1 both give whisper 1536,
    the smoke config 512 and 96."""
    assert convert.arch_config(JCFG) == CFG
    for jcfg, cfg in ((j_smoke_config(ARCH), smoke_config(ARCH)),
                      (j_get_config(ARCH), get_config(ARCH))):
        assert convert.arch_config(jcfg) == cfg
        for tp in (1, 2, 16):
            assert tencdec.enc_seq_padded(cfg, tp) == jencdec.enc_seq_padded(jcfg, tp)
    assert tencdec.enc_seq_padded(get_config(ARCH), 16) == 1536
    assert tencdec.enc_seq_padded(get_config(ARCH), 1) == 1536
    assert tencdec.enc_seq_padded(smoke_config(ARCH), 16) == 512
    assert tencdec.enc_seq_padded(smoke_config(ARCH), 1) == S_ENC


@pytest.mark.parametrize("length,d_model,offset", [(48, 64, 0), (48, 64, 37), (1536, 1024, 0),
                                                   (1, 1024, 2079)])
def test_sinusoidal_positions_match_reference(length, d_model, offset):
    want = np.asarray(jcommon.sinusoidal_positions(length, d_model, offset=offset))
    got = tcommon.sinusoidal_positions(length, d_model, offset=offset)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.numpy(), want, atol=1.2e-7, rtol=0)
    if offset:           # the offset shifts positions: row 0 is the plain table's row `offset`
        plain = tcommon.sinusoidal_positions(offset + length, d_model)
        np.testing.assert_allclose(got.numpy(), plain[offset:].numpy(), atol=1.2e-7, rtol=0)


@pytest.mark.parametrize("dtype", DTYPES)
def test_gelu_mlp_matches_reference(dtype):
    """The GELU MLP on pre-activations of order 3 (unit inputs, ``w_up`` at
    3 / sqrt(d), ``w_down`` at the init's 1 / sqrt(ff)): the tanh form, as
    ``jax.nn.gelu``; the erf form is farther from the reference than the
    f32 limit there."""
    x = _normal(1, B, S, 64)
    p = {"w_up": _normal(2, 64, 128, scale=64 ** -0.5 * 3),
         "w_down": _normal(3, 128, 64, scale=128 ** -0.5)}
    jctx, tctx = _ctxs(dtype)
    cd = getattr(jnp, dtype)
    want = jmlp.mlp(jctx, {k: jnp.asarray(v) for k, v in p.items()},
                    jnp.asarray(x).astype(cd), gated=False)
    got = tmlp.mlp(tctx, {k: _t(v) for k, v in p.items()}, _t(x, dtype), gated=False)
    assert got.dtype == getattr(torch, dtype)
    if dtype == "float32":
        w = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), w, rtol=1e-5, atol=1e-5 * np.abs(w).max())
        up = torch.einsum("bsd,df->bsf", _t(x), _t(p["w_up"]))
        assert float(up.abs().max()) > 3
        erf = torch.einsum("bsf,fd->bsd", F.gelu(up), _t(p["w_down"])).numpy()
        assert np.abs(erf - w).max() > 1e-5 * np.abs(w).max()
    else:
        _close(got, want, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_encoder_layer_matches_reference(dtype):
    params, specs = _jparams()
    frames = _normal(4, B, S_ENC, 64)
    jctx, tctx = _ctxs(dtype)
    want = jencdec.encode(jctx, {k: jnp.asarray(v) for k, v in params.items()}, specs, JCFG,
                          _jrun(), jnp.asarray(frames))
    got = tencdec.encode(tctx, convert.tree_to_torch(params), CFG, _run(dtype), _t(frames))
    assert got.dtype == getattr(torch, dtype) and tuple(got.shape) == (B, S_ENC, 64)
    _close(got, want, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
def test_decoder_layer_with_cross_attention_matches_reference(dtype):
    """One decoder layer (causal self-attention, cross-attention over 96
    encoder positions, the GELU MLP) on the same inputs: the final-normed
    output and the four caches."""
    params, specs = _jparams()
    x, enc = _normal(5, B, S, 64), _normal(6, B, S_ENC, 64)
    jctx, tctx = _ctxs(dtype)
    cd = getattr(jnp, dtype)
    want_h, want_c = jencdec._decoder_forward(
        jctx, {k: jnp.asarray(v) for k, v in params.items()}, specs, JCFG, _jrun(),
        jnp.asarray(x).astype(cd), jnp.asarray(enc).astype(cd), jnp.arange(S), True)
    got_h, got_c = tencdec._decoder_forward(tctx, convert.tree_to_torch(params), CFG,
                                            _run(dtype), _t(x, dtype), _t(enc, dtype), True)
    _close(got_h, want_h, dtype)
    assert len(got_c) == len(want_c) == 4
    for got, want, s in zip(got_c, want_c, (S, S, S_ENC, S_ENC)):
        assert tuple(got.shape) == (1, B, s, 2, 16) and got.dtype == getattr(torch, dtype)
        _close(got, want, dtype)


@functools.lru_cache(maxsize=None)
def _cache_arrays():
    """bf16-representable K/V: the self cache's first POS slots filled, the
    rest zero; the cross cache whole."""
    def bf16(a):
        return np.asarray(jnp.asarray(a).astype(jnp.bfloat16).astype(jnp.float32))

    k, v = _normal(7, 1, B, S, 2, 16), _normal(8, 1, B, S, 2, 16)
    k[:, :, POS:] = 0
    v[:, :, POS:] = 0
    return {"k": bf16(k), "v": bf16(v), "xk": bf16(_normal(9, 1, B, S_ENC, 2, 16)),
            "xv": bf16(_normal(10, 1, B, S_ENC, 2, 16))}


@pytest.mark.parametrize("dtype", DTYPES)
def test_decode_step_matches_reference(dtype):
    """One decode step at position POS against a given cache: the new K/V
    slot, the untouched cross cache, the logits and the next token."""
    params, specs = _jparams()
    arrays = _cache_arrays()
    tok = np.random.default_rng(11).integers(0, 512, (B, 1)).astype(np.int32)
    jctx, tctx = _ctxs(dtype)
    jcache = {k: jnp.asarray(v).astype(jnp.bfloat16) for k, v in arrays.items()}
    want_next, want_logits, want_cache = jencdec.decode_step(
        jctx, {k: jnp.asarray(v) for k, v in params.items()}, specs, JCFG, _jrun(), jcache,
        jnp.asarray(tok), jnp.int32(POS))
    cache = {k: _t(v, "bfloat16") for k, v in arrays.items()}
    backend.reset_launches()
    got_next, got_logits, got_cache = tencdec.decode_step(
        tctx, convert.tree_to_torch(params), CFG, _run(dtype), cache, torch.from_numpy(tok), POS)
    assert not backend.launches
    assert got_cache is cache and got_logits.dtype == torch.float32
    np.testing.assert_allclose(got_logits.numpy(), np.asarray(want_logits),
                               atol=LOGIT_TOL[dtype], rtol=0)
    w = np.asarray(want_logits)[:, 0]
    top2 = np.sort(w, -1)[:, -2:]
    decided = top2[:, 1] - top2[:, 0] > 2 * LOGIT_TOL[dtype]
    np.testing.assert_array_equal(got_next.numpy()[decided], np.asarray(want_next)[decided])
    for name in ("k", "v"):
        got, want = got_cache[name].float(), np.asarray(want_cache[name].astype(jnp.float32))
        np.testing.assert_array_equal(got[:, :, :POS].numpy(), arrays[name][:, :, :POS])
        np.testing.assert_array_equal(got[:, :, POS + 1:].numpy(), 0 * want[:, :, POS + 1:])
        _close(got[:, :, POS], want[:, :, POS], dtype)
    for name in ("xk", "xv"):
        np.testing.assert_array_equal(got_cache[name].float().numpy(), arrays[name])
