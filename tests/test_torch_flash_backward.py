"""The port's flash-attention backward against the JAX package: the plain
blockwise backward against the Pallas sweeps (``flash_attention_bwd`` in
interpret mode) on the same inputs, the ``autograd.Function`` on the CPU
against ``jax.grad`` through the reference's ``custom_vjp``
(``ops.flash_attention(force_pallas=True, interpret=True)``), and the
result's independence of the block sizes.

Tolerances: the plain backward takes the Pallas bodies' steps in f32 from
the same inputs (bf16 inputs are cast to f32 exactly on both sides), only
the products' summation order differs: 1e-5 absolute and relative (observed
≤ 5e-7 on values up to 5).  Through the ``autograd.Function`` the forward
runs too: at f32 the same 1e-5; at bf16 o is rounded to bf16 on both sides
(delta sums the rounded o) and a forward value at a rounding boundary can
round the other way, and dq, dk, dv are rounded to bf16 at the end: 2e-2
absolute on gradients up to ~5 (under one bf16 ulp there; observed ≤ 1e-3).  Inputs come from
numpy seeds; the port takes the model's (B, S, H, hd) layout, the Pallas
kernels (B, H, S, hd).
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention as jfa
from repro.kernels.flash_attention import ops as jops
from repro_torch.kernels import backend
from repro_torch.kernels.flash_attention import ops as tops
from repro_torch.kernels.flash_attention import ref as tref

# one intra-op thread: beside other test workers on a loaded machine, torch's
# thread pool stalls for tens of seconds
torch.set_num_threads(1)

TOL = dict(atol=1e-5, rtol=1e-5)
GRAD_TOL = {"float32": dict(atol=1e-5, rtol=1e-5), "bfloat16": dict(atol=2e-2, rtol=0)}

# (b, sq, sk, hq, hkv, hd, causal, window, q_offset, block)
CASES = [
    (1, 256, 256, 4, 2, 64, True, None, 0, 64),
    (1, 256, 256, 4, 2, 64, False, None, 0, 128),
    (1, 256, 256, 2, 1, 64, True, 96, 0, 64),
    (1, 128, 512, 4, 2, 64, True, None, 256, 128),
    (2, 64, 64, 4, 2, 16, True, None, 0, 32),       # hd 16: the smoke configs' heads
]


def _inputs(case, seed=0):
    b, sq, sk, hq, hkv, hd = case[:6]
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, sq, hq, hd), np.float32),
            rng.standard_normal((b, sk, hkv, hd), np.float32),
            rng.standard_normal((b, sk, hkv, hd), np.float32),
            rng.standard_normal((b, sq, hq, hd), np.float32))


def _bhsd(x, dtype):
    return jnp.asarray(x, getattr(jnp, dtype)).transpose(0, 2, 1, 3)


def _np(x):
    return np.asarray(x.astype(jnp.float32)).transpose(0, 2, 1, 3)


def _case_id(c):
    return "b{}-sq{}-sk{}-h{}kv{}-hd{}-causal{}-w{}-off{}-blk{}".format(*c)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_plain_backward_matches_pallas(case, dtype):
    q, k, v, do = _inputs(case)
    causal, window, q_offset, block = case[6:]
    kw = dict(causal=causal, window=window, q_offset=q_offset, block_q=block, block_k=block)
    jq, jk, jv, jdo = (_bhsd(x, dtype) for x in (q, k, v, do))
    o, lse = jfa.flash_attention_fwd(jq, jk, jv, interpret=True, **kw)
    delta = jnp.sum(jdo.astype(jnp.float32) * o.astype(jnp.float32), axis=-1)
    want = jfa.flash_attention_bwd(jq, jk, jv, jdo, lse, delta, interpret=True, **kw)
    td = getattr(torch, dtype)
    got = tref.flash_attention_bwd(*(torch.from_numpy(x).to(td) for x in (q, k, v, do)),
                                   torch.from_numpy(np.array(lse)),
                                   torch.from_numpy(np.array(delta)), **kw)
    for name, g, w in zip(("dq", "dk", "dv"), got, want):
        assert g.dtype == torch.float32 and g.shape == _np(w).shape, name
        np.testing.assert_allclose(g.numpy(), _np(w), err_msg=name, **TOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", [CASES[0], CASES[2], CASES[3], CASES[4]], ids=_case_id)
def test_autograd_function_matches_jax_grad(case, dtype):
    q, k, v, do = _inputs(case, seed=1)
    causal, window, q_offset, block = case[6:]
    kw = dict(causal=causal, window=window, q_offset=q_offset, block_q=block, block_k=block)
    jd = getattr(jnp, dtype)

    def loss(q_, k_, v_):
        o = jops.flash_attention(q_, k_, v_, force_pallas=True, interpret=True, **kw)
        return jnp.sum(o.astype(jnp.float32) * do)

    want = jax.grad(loss, argnums=(0, 1, 2))(*(jnp.asarray(x, jd) for x in (q, k, v)))
    td = getattr(torch, dtype)
    tq, tk, tv = (torch.from_numpy(x).to(td).requires_grad_() for x in (q, k, v))
    backend.reset_launches()             # CPU tensors take the plain versions
    o = tops.flash_attention(tq, tk, tv, **kw)
    (o.float() * torch.from_numpy(do)).sum().backward()
    assert not backend.launches
    for name, t, w in zip(("dq", "dk", "dv"), (tq, tk, tv), want):
        assert t.grad.dtype == td, name
        np.testing.assert_allclose(t.grad.float().numpy(), np.asarray(w.astype(jnp.float32)),
                                   err_msg=name, **GRAD_TOL[dtype])


def test_plain_backward_is_independent_of_block_sizes():
    """Dead blocks hold p = 0 exactly and every live entry is visited once
    whatever the tiling, so the blockwise backward does not depend on the
    block sizes (the kernels tile by 64, the reference by 512): only the
    order of the f32 sums moves."""
    case = (1, 256, 256, 4, 2, 64, True, 48, 0, 0)
    q, k, v, do = (torch.from_numpy(x) for x in _inputs(case, seed=2))
    o, lse = tref.flash_attention_fwd(q, k, v, causal=True, window=48, block_q=256, block_k=256)
    delta = torch.sum(do * o, -1).transpose(1, 2).contiguous()
    outs = [tref.flash_attention_bwd(q, k, v, do, lse, delta, causal=True, window=48,
                                     block_q=bq, block_k=bk)
            for bq, bk in ((256, 256), (64, 64), (32, 128))]
    for got in outs[1:]:
        for g, w in zip(got, outs[0]):
            np.testing.assert_allclose(g.numpy(), w.numpy(), atol=1e-6, rtol=1e-5)
