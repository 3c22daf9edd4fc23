"""The reference's last three dense configs in the port — minitron-4b,
h2o-danube-3-4b and mistral-large-123b — against the JAX package: the
configs, run configs and parameter shapes; then h2o-danube-3-4b's sliding
window through ``prefill`` and ``decode_step`` (its smoke config, window 16,
and a narrow config at its head dim 120), the plain flash forward and both
backward sweeps at hd 120 with the window, and the reference's decode, which
attends every slot of the cache it is given, past the window too.

Reference calls run inside ``jax.threefry_partitionable(False)``; its
prefill and decode step are jitted once per config and dtype (the
comparisons hold the tolerances of ``test_torch_serving.py``, so XLA's fused
multiply-adds do not matter).  Inputs come from numpy seeds.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jregistry
from repro.configs.base import ArchConfig as JArchConfig
from repro.configs.base import RunConfig as JRunConfig
from repro.kernels.flash_attention import flash_attention as jfa
from repro.kernels.flash_attention import ref as jref
from repro.models import attention as jattn
from repro.models import common as jcommon
from repro.models import model as jmodel
from repro_torch import convert
from repro_torch.configs import registry
from repro_torch.kernels import backend
from repro_torch.kernels.flash_attention import ref as tref
from repro_torch.models import attention as tattn
from repro_torch.models import model as tmodel

# one intra-op thread: beside other test workers on a loaded machine, torch's
# thread pool stalls for tens of seconds
torch.set_num_threads(1)

ARCHS = ("minitron-4b", "h2o-danube-3-4b", "mistral-large-123b")
DANUBE = "h2o-danube-3-4b"
# test_torch_serving.py's limits: logits 1e-3 at f32 compute (the bf16 cache
# and decode's bf16 p move an f32-level difference across a rounding
# boundary), 5e-2 at bf16 compute
LOGIT_TOL = {"float32": 1e-3, "bfloat16": 5e-2}
# h2o-danube-3-4b's head dim at a narrow width: 2 layers, d 240, 2/1 heads
NARROW = JArchConfig(name="narrow-hd120", family="dense", num_layers=2, d_model=240,
                     num_heads=2, num_kv_heads=1, head_dim=120, d_ff=480, vocab_size=512,
                     window=16, rope_theta=1e4, sub_quadratic=True)
CONFIGS = {"danube-smoke": jregistry.smoke_config(DANUBE), NARROW.name: NARROW}
# a prompt of S0 tokens, twice the window, in a cache of S slots, then
# S - S0 teacher-forced decode steps
B, S0, S = 2, 32, 48
RUN = JRunConfig(attn_chunk_q=16, attn_chunk_k=16, remat=False)


def _rng(seed):
    return np.random.default_rng(seed)


# ------------------------------------------------------- configs and shapes

@pytest.mark.parametrize("arch", ARCHS)
def test_config_equals_reference_field_for_field(arch):
    want, got = jregistry.get_config(arch), registry.get_config(arch)
    assert [f.name for f in dataclasses.fields(got)] == [f.name for f in dataclasses.fields(want)]
    for f in dataclasses.fields(want):
        assert getattr(got, f.name) == getattr(want, f.name), f.name
    assert got.hd == want.hd and arch in registry.list_archs()


@pytest.mark.parametrize("shape", ["train_4k", "prefill_32k", "decode_32k"])
@pytest.mark.parametrize("arch", ARCHS)
def test_run_config_equals_reference(arch, shape):
    """The reference's run config field for field (4 microbatches for
    minitron's and danube's train_4k, 16 for mistral's, 2048-key chunks for
    prefill_32k); mistral is in the reference's FSDP set, and so FSDP is on
    in the port's too."""
    want = jregistry.get_run_config(arch, shape)
    got = registry.get_run_config(arch, shape)
    assert got == convert.run_config(want)
    assert got.fsdp == want.fsdp == (arch == "mistral-large-123b")


@pytest.mark.parametrize("size", ["smoke", "full"])
@pytest.mark.parametrize("arch", ARCHS)
def test_param_shapes_match_reference_init(arch, size):
    """The reference's leaf names and shapes, from its abstract init: at the
    smoke size and at full size (hd 120's (24, 3840, 32, 120) ``wq``,
    minitron's untied 256,000-row head)."""
    jcfg = (jregistry.smoke_config if size == "smoke" else jregistry.get_config)(arch)
    cfg = (registry.smoke_config if size == "smoke" else registry.get_config)(arch)
    sizes = {"data": 1, "model": 1}
    ctx = jmodel.make_ctx(jcfg, RUN, sizes, dtype=jnp.float32)
    with jax.threefry_partitionable(False):
        jparams, _ = jmodel.init(jax.random.PRNGKey(0), jcfg, ctx, sizes, RUN, abstract=True)
    shapes, _ = registry.param_shapes(cfg)
    assert shapes == {k: tuple(v.shape) for k, v in jparams.items()}
    if size == "full" and arch == DANUBE:
        assert shapes["layers.attn.wq"] == (24, 3840, 32, 120)
    if size == "smoke":
        assert {k: tuple(v.shape) for k, v in tmodel.init(0, cfg, device="cpu").items()} == shapes


# ------------------------------------------- the sliding window end to end

def _tokens(cfg):
    return _rng(9).integers(0, cfg.vocab_size, (B, S)).astype(np.int32)


@functools.lru_cache(maxsize=None)
def _reference_run(name, dtype):
    """The reference's params (numpy), prefill of S0 tokens into S slots and
    teacher-forced decode to S: (params, [prefill logits, decode logits...],
    the prefill's cache k)."""
    cfg = CONFIGS[name]
    sizes = {"data": 1, "model": 1}
    ctx = jmodel.make_ctx(cfg, RUN, sizes, dtype=getattr(jnp, dtype))
    with jax.threefry_partitionable(False):
        params, specs = jmodel.init(jax.random.PRNGKey(0), cfg, ctx, sizes, RUN)
        prefill = jax.jit(lambda p, t: jmodel.prefill(ctx, p, specs, cfg, RUN, {"tokens": t},
                                                      s_max=S))
        decode = jax.jit(lambda p, c, t, pos: jmodel.decode_step(ctx, p, specs, cfg, RUN, c, t,
                                                                 pos))
        toks = _tokens(cfg)
        cache, logits = prefill(params, toks[:, :S0])
        cache_k = np.asarray(cache["k"].astype(jnp.float32))
        out = [np.asarray(logits)]
        for i in range(S0, S):
            _, logits, cache = decode(params, cache, toks[:, i:i + 1], jnp.int32(i))
            out.append(np.asarray(logits))
    return {k: np.array(v) for k, v in params.items()}, out, cache_k


@pytest.mark.parametrize("name,dtype", [("danube-smoke", "float32"),
                                        ("danube-smoke", "bfloat16"),
                                        ("narrow-hd120", "float32")])
def test_windowed_prefill_and_decode_match_reference(name, dtype):
    """A prompt of twice the window: the prefill keeps every prompt slot and
    pads to s_max (48), as the reference's ``pad_to`` (the port used to cut
    its cache to the window and refuse the prompt); the teacher-forced
    decode then writes slots 32-47 and attends them all, as the
    reference's."""
    params, want, want_k = _reference_run(name, dtype)
    cfg, run = convert.arch_config(CONFIGS[name]), convert.run_config(RUN)
    ctx = tmodel.make_ctx(cfg, run, dtype=getattr(torch, dtype))
    tparams = convert.tree_to_torch(params)
    toks = _tokens(cfg)
    backend.reset_launches()
    cache, logits = tmodel.prefill(ctx, tparams, cfg, run, {"tokens": torch.from_numpy(toks[:, :S0])},
                                   s_max=S)
    assert cache["k"].shape == (cfg.num_layers, B, S, cfg.num_kv_heads, cfg.hd)
    assert cache["k"].dtype == cache["v"].dtype == torch.bfloat16
    assert not cache["k"][:, :, S0:].any() and not cache["v"][:, :, S0:].any()
    got_k = cache["k"].float().clone()
    got = [logits]
    for i in range(S0, S):
        _, logits, cache = tmodel.decode_step(ctx, tparams, cfg, run, cache,
                                              torch.from_numpy(toks[:, i:i + 1]), i)
        got.append(logits)
    assert not backend.launches
    tol = LOGIT_TOL[dtype]
    got_all, want_all = torch.cat(got, dim=1).numpy(), np.concatenate(want, axis=1)
    assert got_all.shape == want_all.shape == (B, 1 + S - S0, cfg.vocab_size)
    np.testing.assert_allclose(got_all, want_all, atol=tol, rtol=0)
    np.testing.assert_allclose(got_k.numpy(), want_k, atol=4 * tol, rtol=1e-2)


def test_reference_decode_attends_every_cache_slot_past_the_window(monkeypatch):
    """A hazard of the reference, followed: its decode passes no window to
    ``decode_attention`` and attends every valid slot of its cache.  After a
    32-token prompt served as the engine serves it (s_max = min(seq_len,
    window) = 16, so the prefill keeps a cache as long as the prompt), the
    step at position 32 writes ring slot 0 and attends all 32 slots, twice
    the window of 16, in both packages, with the same logits."""
    jcfg = CONFIGS["danube-smoke"]
    s_max = min(S, jcfg.window)
    seen = {"ref": [], "port": []}
    sizes = {"data": 1, "model": 1}
    ctx = jmodel.make_ctx(jcfg, RUN, sizes, dtype=jnp.float32)

    def jrecord(q, k_cache, v_cache, pos, **kw):
        jax.debug.callback(lambda n: seen["ref"].append((int(n), k_cache.shape[1],
                                                        kw.get("window"))), pos)
        return jdecode_attention(q, k_cache, v_cache, pos, **kw)

    def trecord(q, k_cache, v_cache, pos, **kw):
        seen["port"].append((int(pos), k_cache.shape[1], kw.get("window")))
        return tdecode_attention(q, k_cache, v_cache, pos, **kw)

    jdecode_attention, tdecode_attention = jattn.decode_attention, tattn.decode_attention
    monkeypatch.setattr(jattn, "decode_attention", jrecord)
    monkeypatch.setattr(tattn, "decode_attention", trecord)
    toks = _tokens(jcfg)
    with jax.threefry_partitionable(False):
        params, specs = jmodel.init(jax.random.PRNGKey(0), jcfg, ctx, sizes, RUN)
        cache, _ = jmodel.prefill(ctx, params, specs, jcfg, RUN, {"tokens": toks[:, :S0]},
                                  s_max=s_max)
        _, want, _ = jmodel.decode_step(ctx, params, specs, jcfg, RUN, cache,
                                        toks[:, S0:S0 + 1], jnp.int32(S0))
        want = np.asarray(want)
    cfg, run = convert.arch_config(jcfg), convert.run_config(RUN)
    tctx = tmodel.make_ctx(cfg, run, dtype=torch.float32)
    tparams = convert.tree_to_torch({k: np.array(v) for k, v in params.items()})
    tcache, _ = tmodel.prefill(tctx, tparams, cfg, run, {"tokens": torch.from_numpy(toks[:, :S0])},
                               s_max=s_max)
    assert tcache["k"].shape[2] == cache["k"].shape[2] == S0 == 2 * cfg.window
    _, got, _ = tmodel.decode_step(tctx, tparams, cfg, run, tcache,
                                   torch.from_numpy(toks[:, S0:S0 + 1]), S0)
    # every layer attends all 32 slots (valid = min(pos + 1, slots)), with no window
    assert seen["ref"] == seen["port"] == [(S0, S0, None)] * cfg.num_layers
    np.testing.assert_allclose(got.numpy(), want, atol=LOGIT_TOL["float32"], rtol=0)


# ---------------------------------------------- the plain flash at hd 120

# (b, s, hq, hkv, hd) with the window across the blocks of 16
FLASH = (1, 64, 2, 1, 120)
FLASH_TOL = dict(atol=1e-5, rtol=1e-5)


def _flash_inputs(seed=0):
    b, s, hq, hkv, hd = FLASH
    r = _rng(seed)
    return (r.standard_normal((b, s, hq, hd), np.float32),
            r.standard_normal((b, s, hkv, hd), np.float32),
            r.standard_normal((b, s, hkv, hd), np.float32),
            r.standard_normal((b, s, hq, hd), np.float32))


@pytest.mark.parametrize("window,q_offset", [(16, 0), (None, 0), (24, 16)])
def test_plain_flash_at_hd120_matches_reference_oracle_and_grad(window, q_offset):
    """The plain blockwise forward (o) and both backward sweeps (dq, dk, dv,
    from the forward's lse and delta = rowsum(do · o)) at hd 120 against the
    reference's full-softmax oracle (``kernels/flash_attention/ref.py``) and
    ``jax.vjp`` of it, in f32: one online softmax against one full softmax
    (observed ≤ 2e-6)."""
    q, k, v, do = _flash_inputs()
    mask = dict(causal=True, window=window, q_offset=q_offset)
    blocks = dict(block_q=16, block_k=16)
    want_o, vjp = jax.vjp(lambda a, b_, c: jref.attention(a, b_, c, **mask),
                          *(jnp.asarray(x) for x in (q, k, v)))
    want = vjp(jnp.asarray(do))
    tq, tk, tv, tdo = (torch.from_numpy(x) for x in (q, k, v, do))
    o, lse = tref.flash_attention_fwd(tq, tk, tv, **mask, **blocks)
    np.testing.assert_allclose(o.numpy(), np.asarray(want_o), **FLASH_TOL)
    delta = torch.sum(tdo * o, -1).transpose(1, 2).contiguous()
    got = tref.flash_attention_bwd(tq, tk, tv, tdo, lse, delta, **mask, **blocks)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **FLASH_TOL, err_msg=name)


def test_plain_flash_forward_at_hd120_matches_pallas_interpret():
    """Once, at the smallest shape: the plain forward against the
    reference's Pallas kernel in interpret mode, o and lse, window 16."""
    q, k, v, _ = _flash_inputs(1)
    mask = dict(causal=True, window=16, q_offset=0)
    blocks = dict(block_q=16, block_k=16)
    jo, jlse = jfa.flash_attention_fwd(*(jnp.asarray(x).transpose(0, 2, 1, 3) for x in (q, k, v)),
                                       interpret=True, **mask, **blocks)
    o, lse = tref.flash_attention_fwd(*(torch.from_numpy(x) for x in (q, k, v)), **mask,
                                      **blocks)
    np.testing.assert_allclose(o.numpy(), np.asarray(jo).transpose(0, 2, 1, 3), **FLASH_TOL)
    np.testing.assert_allclose(lse.numpy(), np.asarray(jlse).reshape(lse.shape), **FLASH_TOL)


def test_rope_at_hd120_matches_reference():
    """RoPE's 60 frequencies at hd 120 and θ 1e4, applied at positions up to
    4111 (the ring-wrap run's last), against the reference."""
    from repro_torch.models import common as tcommon

    x = _rng(3).standard_normal((1, 8, 2, 120), np.float32)
    pos = np.arange(8) + 4104
    want = jcommon.apply_rope(jnp.asarray(x), jnp.asarray(pos), 1e4)
    got = tcommon.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), 1e4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=1e-5)
