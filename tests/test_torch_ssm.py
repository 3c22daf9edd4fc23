"""The port's Mamba-2 (SSD) layers against the JAX package, function by
function, at the reference's SSM smoke config (``smoke_config
("mamba2-130m")``: d_model 64, d_inner 128 in 8 heads of 16, d_state 16,
conv width 4, chunk 16): ``_causal_conv`` with and without a state,
``ssd_chunked`` at s = 64 (4 chunks: the carry), at s = 16 (one chunk) and
from an ``init_state``, its gradients, ``ssd_decode_step``,
``mamba_block`` and ``mamba_decode`` in f32 and bf16, and the length that
is not a multiple of the chunk, which raises on both sides; then the port
alone: the chunked scan against its own token-by-token recurrence, and the
block against its own decode.

Inputs are drawn from numpy seeds; the reference runs op by op (no
``jax.jit``: XLA's CPU fusions move its own last bits), inside
``jax.threefry_partitionable(False)``.  Tolerances: f32 values within
``F32_TOL`` = 1e-5 relative to the largest |value| of the compared
tensor (readings up to 6.3e-7: the port sums the chunk products in
another order, torch's sigmoid and softplus against XLA's); bf16 values
within ``BF16_TOL`` = 2e-2 of the same scale (5 of bf16's 2⁻⁸ ulps: each
side rounds the conv's products and sums, the gate and the projections to
bf16 in its own fused or unfused order; readings up to 9.0e-3); gradients
within 1e-5 relative Frobenius error (readings up to 4.0e-6).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import smoke_config as j_smoke_config
from repro.models import common as jcommon
from repro.models import ssm as jssm
from repro_torch import convert
from repro_torch.configs.registry import smoke_config
from repro_torch.models import common as tcommon
from repro_torch.models import ssm as tssm

# one intra-op thread: beside other test workers on a loaded machine, torch's
# thread pool stalls for tens of seconds
torch.set_num_threads(1)

CFG = smoke_config("mamba2-130m")
SCFG = CFG.ssm
D = CFG.d_model
DIN, NH, HD, N, W = SCFG.d_inner(D), SCFG.nheads(D), SCFG.head_dim, SCFG.d_state, SCFG.conv_width
B, S = 2, 64
F32_TOL, BF16_TOL, GRAD_TOL = 1e-5, 2e-2, 1e-5


def _close(got, want, tol, what=""):
    got = np.asarray(got.detach().float().numpy() if isinstance(got, torch.Tensor) else got,
                     np.float64)
    want = np.asarray(np.asarray(want, np.float32), np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = max(float(np.abs(want).max()), 1e-30)
    err = float(np.abs(got - want).max()) / scale
    assert err <= tol, f"{what}: max |Δ| / max |ref| = {err:.3g} > {tol}"
    return err


def _rel(got, want) -> float:
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(np.asarray(got, np.float64) - want) / np.linalg.norm(want))


def _t(x, dtype="float32"):
    return torch.from_numpy(np.asarray(x, np.float32)).to(getattr(torch, dtype))


def _j(x, dtype="float32"):
    return jnp.asarray(np.asarray(x, np.float32)).astype(getattr(jnp, dtype))


def _scan_inputs(seed, s, decay=1.0):
    """(X, B, C, dt, log_a) numpy f32: dt = softplus(normal), log a = dt·A
    with A = −exp(normal)·decay."""
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((B, s, NH, HD)).astype(np.float32)
    Bm = rng.standard_normal((B, s, N)).astype(np.float32)
    Cm = rng.standard_normal((B, s, N)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((B, s, NH)))).astype(np.float32)
    A = (-np.exp(rng.standard_normal(NH)) * decay).astype(np.float32)
    return X, Bm, Cm, dt, (dt * A).astype(np.float32)


def _layer_params(seed):
    """One layer's SSM leaves (numpy f32) at the reference's scales."""
    rng = np.random.default_rng(seed)
    shapes = {"w_z": (D, DIN), "w_x": (D, DIN), "w_B": (D, N), "w_C": (D, N),
              "w_dt": (D, NH), "conv_x": (W, DIN), "conv_B": (W, N), "conv_C": (W, N),
              "A_log": (NH,), "D": (NH,), "dt_bias": (NH,), "norm": (DIN,),
              "w_out": (DIN, D)}
    scale = {"conv_x": W ** -0.5, "conv_B": W ** -0.5, "conv_C": W ** -0.5, "A_log": 1.0,
             "D": 1.0, "dt_bias": 1.0, "w_out": DIN ** -0.5}
    out = {k: (rng.standard_normal(v) * scale.get(k, v[0] ** -0.5)).astype(np.float32)
           for k, v in shapes.items()}
    out["norm"] = (1.0 + 0.1 * rng.standard_normal(DIN)).astype(np.float32)
    return out


def _ctxs(dtype):
    return (jcommon.ShardCtx(tp=1, compute_dtype=getattr(jnp, dtype)),
            tcommon.ShardCtx(compute_dtype=getattr(torch, dtype)))


def test_smoke_config_is_the_reference_s():
    assert convert.arch_config(j_smoke_config("mamba2-130m")) == CFG
    assert (DIN, NH, HD, N, W, SCFG.chunk) == (128, 8, 16, 16, 4, 16)


# ------------------------------------------------------------- causal conv

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("with_state", [False, True])
def test_causal_conv(with_state, dtype):
    rng = np.random.default_rng(1)
    x = rng.standard_normal((B, S, DIN)).astype(np.float32)
    w = (rng.standard_normal((W, DIN)) * W ** -0.5).astype(np.float32)
    st = rng.standard_normal((B, W - 1, DIN)).astype(np.float32) if with_state else None
    with jax.threefry_partitionable(False):
        want_y, want_st = jssm._causal_conv(_j(x, dtype), _j(w, dtype),
                                            None if st is None else _j(st, "bfloat16"))
    got_y, got_st = tssm._causal_conv(_t(x, dtype), _t(w, dtype),
                                      None if st is None else _t(st, "bfloat16"))
    assert got_y.dtype == getattr(torch, dtype) and got_st.dtype == getattr(torch, dtype)
    _close(got_y, want_y, F32_TOL if dtype == "float32" else BF16_TOL, "conv")
    # the window holds the last W − 1 inputs, exactly
    np.testing.assert_array_equal(got_st.float().numpy(), np.asarray(want_st, np.float32))
    np.testing.assert_array_equal(got_st.float().numpy(),
                                  _t(x, dtype)[:, -(W - 1):].float().numpy())


# --------------------------------------------------------------- the scan

@functools.lru_cache(maxsize=None)
def _reference_scan(s, with_init, decay=1.0):
    X, Bm, Cm, dt, la = _scan_inputs(2, s, decay)
    init = np.random.default_rng(3).standard_normal((B, NH, HD, N)).astype(np.float32)
    with jax.threefry_partitionable(False):
        Y, final = jssm.ssd_chunked(_j(X), _j(Bm), _j(Cm), _j(dt), _j(la), SCFG,
                                    init_state=_j(init) if with_init else None)
    return (X, Bm, Cm, dt, la, init if with_init else None), np.asarray(Y), np.asarray(final)


@pytest.mark.parametrize("s,with_init", [(S, False), (16, False), (S, True)])
def test_ssd_chunked(s, with_init):
    (X, Bm, Cm, dt, la, init), want_y, want_final = _reference_scan(s, with_init)
    got_y, got_final = tssm.ssd_chunked(_t(X), _t(Bm), _t(Cm), _t(dt), _t(la), SCFG,
                                        init_state=None if init is None else _t(init))
    assert got_y.dtype == torch.float32 and got_final.dtype == torch.float32
    _close(got_y, want_y, F32_TOL, "Y")
    _close(got_final, want_final, F32_TOL, "final state")


def test_ssd_chunked_bf16_x():
    """X in bf16: the scan computes in f32 and casts Y back to bf16."""
    X, Bm, Cm, dt, la = _scan_inputs(4, S)
    with jax.threefry_partitionable(False):
        want_y, want_final = jssm.ssd_chunked(_j(X, "bfloat16"), _j(Bm), _j(Cm), _j(dt),
                                              _j(la), SCFG)
    got_y, got_final = tssm.ssd_chunked(_t(X, "bfloat16"), _t(Bm), _t(Cm), _t(dt), _t(la),
                                        SCFG)
    assert got_y.dtype == torch.bfloat16
    _close(got_y, want_y, BF16_TOL, "Y")
    _close(got_final, want_final, F32_TOL, "final state")


@pytest.mark.parametrize("decay", [1.0, 100.0])
def test_ssd_chunked_gradients(decay):
    """Gradients of Σ Y·G + Σ final·H against ``jax.grad`` of the
    reference's scan.  At decay 100 the masked log differences above the
    diagonal reach thousands: a mask applied after the ``exp`` would give
    inf·0 = NaN, in the forward or in the backward."""
    X, Bm, Cm, dt, la = _scan_inputs(5, S, decay)
    rng = np.random.default_rng(6)
    G = rng.standard_normal((B, S, NH, HD)).astype(np.float32)
    H = rng.standard_normal((B, NH, HD, N)).astype(np.float32)

    def jloss(*args):
        Y, final = jssm.ssd_chunked(*args, SCFG)
        return jnp.sum(Y * G) + jnp.sum(final * H)

    with jax.threefry_partitionable(False):
        want = jax.grad(jloss, argnums=(0, 1, 2, 3, 4))(*(_j(a) for a in (X, Bm, Cm, dt, la)))
    args = [_t(a).requires_grad_() for a in (X, Bm, Cm, dt, la)]
    Y, final = tssm.ssd_chunked(*args, SCFG)
    assert bool(torch.isfinite(Y).all()) and bool(torch.isfinite(final).all())
    got = torch.autograd.grad((Y * _t(G)).sum() + (final * _t(H)).sum(), args)
    for name, g, w in zip(("X", "B", "C", "dt", "log_a"), got, want):
        assert bool(torch.isfinite(g).all()), name
        assert np.isfinite(np.asarray(w)).all(), name
        assert _rel(g.numpy(), w) <= GRAD_TOL, (name, _rel(g.numpy(), w))


def test_ssd_decode_step():
    rng = np.random.default_rng(7)
    st = rng.standard_normal((B, NH, HD, N)).astype(np.float32)
    x = rng.standard_normal((B, NH, HD)).astype(np.float32)
    Bv, Cv = (rng.standard_normal((B, N)).astype(np.float32) for _ in range(2))
    dt = np.log1p(np.exp(rng.standard_normal((B, NH)))).astype(np.float32)
    la = (dt * -np.exp(rng.standard_normal(NH))).astype(np.float32)
    with jax.threefry_partitionable(False):
        want_y, want_st = jssm.ssd_decode_step(*(_j(a) for a in (st, x, Bv, Cv, dt, la)))
    got_y, got_st = tssm.ssd_decode_step(*(_t(a) for a in (st, x, Bv, Cv, dt, la)))
    _close(got_y, want_y, F32_TOL, "y")
    _close(got_st, want_st, F32_TOL, "state")


def test_non_multiple_length_raises():
    """s = 24 with a chunk of 16: the reference asserts, the port raises
    (never pads: padding would move the carried state)."""
    X, Bm, Cm, dt, la = _scan_inputs(8, 24)
    with pytest.raises(AssertionError):
        jssm.ssd_chunked(_j(X), _j(Bm), _j(Cm), _j(dt), _j(la), SCFG)
    with pytest.raises(ValueError, match="multiple of the SSD chunk"):
        tssm.ssd_chunked(_t(X), _t(Bm), _t(Cm), _t(dt), _t(la), SCFG)
    _, tctx = _ctxs("float32")
    p = {k: _t(v) for k, v in _layer_params(9).items()}
    with pytest.raises(ValueError, match="multiple of the SSD chunk"):
        tssm.mamba_block(tctx, p, torch.zeros((B, 24, D)), SCFG)


# --------------------------------------------------------------- the block

def _cast(p, dtype):
    """The layer's leaves cast to the compute dtype, as ``take_layer`` and
    the reference's ``gather_fsdp`` cast them."""
    return ({k: _j(v, dtype) for k, v in p.items()}, {k: _t(v, dtype) for k, v in p.items()})


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba_block(dtype):
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    jp, tp = _cast(_layer_params(10), dtype)
    rng = np.random.default_rng(11)
    x = rng.standard_normal((B, S, D)).astype(np.float32)
    jctx, tctx = _ctxs(dtype)
    with jax.threefry_partitionable(False):
        want, (wconv, wfinal) = jssm.mamba_block(jctx, jp, _j(x, dtype), SCFG,
                                                 return_state=True)
    got, (gconv, gfinal) = tssm.mamba_block(tctx, tp, _t(x, dtype), SCFG, return_state=True)
    assert got.dtype == getattr(torch, dtype) and gfinal.dtype == torch.float32
    _close(got, want, tol, "out")
    for k in ("x", "B", "C"):
        _close(gconv[k], wconv[k], tol, f"conv window {k}")
    _close(gfinal, wfinal, tol, "final state")
    assert torch.equal(tssm.mamba_block(tctx, tp, _t(x, dtype), SCFG), got)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba_decode(dtype):
    tol = F32_TOL if dtype == "float32" else BF16_TOL
    jp, tp = _cast(_layer_params(12), dtype)
    rng = np.random.default_rng(13)
    x = rng.standard_normal((B, 1, D)).astype(np.float32)
    conv = {k: rng.standard_normal((B, W - 1, c)).astype(np.float32)
            for k, c in (("x", DIN), ("B", N), ("C", N))}
    st = rng.standard_normal((B, NH, HD, N)).astype(np.float32)
    jctx, tctx = _ctxs(dtype)
    with jax.threefry_partitionable(False):
        want, (wconv, wst) = jssm.mamba_decode(
            jctx, jp, _j(x, dtype), SCFG, {k: _j(v, "bfloat16") for k, v in conv.items()},
            _j(st))
    got, (gconv, gst) = tssm.mamba_decode(
        tctx, tp, _t(x, dtype), SCFG, {k: _t(v, "bfloat16") for k, v in conv.items()}, _t(st))
    assert got.shape == (B, 1, D) and got.dtype == getattr(torch, dtype)
    _close(got, want, tol, "out")
    for k in ("x", "B", "C"):
        # the window shifts by one: its older W − 2 rows are the state's last
        # ones, exactly; the newest is the token's projection
        np.testing.assert_array_equal(gconv[k][:, :W - 2].float().numpy(),
                                      _t(conv[k], "bfloat16")[:, 1:].float().numpy(), err_msg=k)
        _close(gconv[k], wconv[k], tol, f"conv window {k}")
    _close(gst, wst, tol, "state")


# ---------------------------------------------------------- the port alone

def test_chunked_scan_equals_the_recurrence():
    """The chunked scan's outputs and final state against the port's own
    token-by-token ``ssd_decode_step`` from the same initial state."""
    (X, Bm, Cm, dt, la, init), _, _ = _reference_scan(S, True)
    Y, final = tssm.ssd_chunked(_t(X), _t(Bm), _t(Cm), _t(dt), _t(la), SCFG,
                                init_state=_t(init))
    st, ys = _t(init), []
    for t in range(S):
        y, st = tssm.ssd_decode_step(st, _t(X[:, t]), _t(Bm[:, t]), _t(Cm[:, t]),
                                     _t(dt[:, t]), _t(la[:, t]))
        ys.append(y)
    _close(Y, torch.stack(ys, 1), F32_TOL, "Y")
    _close(final, st, F32_TOL, "final state")


def test_block_equals_its_decode():
    """``mamba_block`` over a prefix, then ``mamba_decode`` token by token
    from its windows and state, gives the block's outputs over the whole
    sequence (f32)."""
    _, tctx = _ctxs("float32")
    _, p = _cast(_layer_params(14), "float32")
    x = _t(np.random.default_rng(15).standard_normal((B, S, D)))
    full = tssm.mamba_block(tctx, p, x, SCFG)
    out, (conv, st) = tssm.mamba_block(tctx, p, x[:, :48], SCFG, return_state=True)
    outs = [out]
    for t in range(48, S):
        o, (conv, st) = tssm.mamba_decode(tctx, p, x[:, t:t + 1], SCFG, conv, st)
        outs.append(o)
    _close(torch.cat(outs, 1), full, F32_TOL, "decode vs block")
