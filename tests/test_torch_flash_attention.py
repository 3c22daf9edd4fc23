"""The port's plain flash-attention forward and its full-softmax oracle
against the JAX package's Pallas forward (``flash_attention_fwd`` in
interpret mode), ``o`` and ``lse`` together.

Tolerances are the reference's own for its kernel
(``tests/test_kernel_flash.py``): f32 atol = rtol = 2e-3 on ``o`` and 1e-3
absolute on ``lse``; bf16 atol 3e-2 on ``o`` (p is rounded to bf16 before
P·V, so a p at a rounding boundary may round the other way).  The plain
blockwise version follows the Pallas body step for step and, in f32, agrees
with it to a few f32 ulps; the oracle normalises before P·V, as the
reference's oracle does.  Inputs come from numpy seeds; the port takes the
model's (B, S, H, hd) layout, the Pallas forward (B, H, S, hd).
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention as jfa
from repro_torch.kernels import backend
from repro_torch.kernels.flash_attention import ops as tops
from repro_torch.kernels.flash_attention import ref as tref

# one intra-op thread: beside other test workers on a loaded machine, torch's
# thread pool stalls for tens of seconds
torch.set_num_threads(1)

TOL = {"float32": dict(atol=2e-3, rtol=2e-3), "bfloat16": dict(atol=3e-2, rtol=0)}
LSE_ATOL = 1e-3

# (b, sq, sk, hq, hkv, hd, causal, window, q_offset, block)
CASES = [
    (1, 256, 256, 4, 2, 64, True, None, 0, 128),
    (1, 256, 256, 4, 2, 128, False, None, 0, 128),
    (1, 256, 256, 2, 1, 64, True, 96, 0, 64),
    (1, 128, 512, 2, 2, 64, True, None, 256, 128),
    (2, 128, 128, 8, 2, 128, True, None, 0, 64),
    (2, 64, 64, 4, 2, 16, True, None, 0, 32),       # hd 16: the smoke configs' heads
]


def _qkv(case, seed=0):
    b, sq, sk, hq, hkv, hd = case[:6]
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, sq, hq, hd), np.float32),
            rng.standard_normal((b, sk, hkv, hd), np.float32),
            rng.standard_normal((b, sk, hkv, hd), np.float32))


def _reference(q, k, v, dtype, causal, window, q_offset, block):
    jd = getattr(jnp, dtype)
    o, lse = jfa.flash_attention_fwd(
        *(jnp.asarray(x, jd).transpose(0, 2, 1, 3) for x in (q, k, v)),
        causal=causal, window=window, q_offset=q_offset, block_q=block, block_k=block,
        interpret=True)
    return np.asarray(o.astype(jnp.float32)).transpose(0, 2, 1, 3), np.asarray(lse)


def _case_id(c):
    return "b{}-sq{}-sk{}-h{}kv{}-hd{}-causal{}-w{}-off{}".format(*c[:9])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("case", CASES, ids=_case_id)
def test_plain_flash_forward_matches_pallas(case, dtype):
    q, k, v = _qkv(case)
    causal, window, q_offset, block = case[6:]
    want_o, want_lse = _reference(q, k, v, dtype, causal, window, q_offset, block)
    td = getattr(torch, dtype)
    tq, tk, tv = (torch.from_numpy(x).to(td) for x in (q, k, v))
    o, lse = tref.flash_attention_fwd(tq, tk, tv, causal=causal, window=window,
                                      q_offset=q_offset, block_q=block, block_k=block)
    assert o.dtype == td and o.shape == tq.shape and lse.shape == want_lse.shape
    backend.reset_launches()             # a CPU tensor takes the plain version
    dispatched = tops.flash_attention(tq, tk, tv, causal=causal, window=window,
                                      q_offset=q_offset, block_q=block, block_k=block)
    assert torch.equal(dispatched, o) and not backend.launches
    np.testing.assert_allclose(o.float().numpy(), want_o, **TOL[dtype])
    np.testing.assert_allclose(lse.numpy(), want_lse, atol=LSE_ATOL, rtol=0)
    oracle = tref.attention(tq, tk, tv, causal=causal, window=window, q_offset=q_offset)
    np.testing.assert_allclose(oracle.float().numpy(), want_o, **TOL[dtype])
    if dtype == "float32":    # same steps as the Pallas body: a few f32 ulps
        np.testing.assert_allclose(o.numpy(), want_o, atol=1e-5, rtol=1e-5)
        np.testing.assert_allclose(lse.numpy(), want_lse, atol=1e-5, rtol=0)


# (b, sq, sk, hq, hkv, hd, window, q_offset), causal
BLOCK_CASES = [
    (1, 256, 256, 4, 2, 64, 48, 0),        # a window narrower than a tile
    (1, 256, 512, 4, 2, 64, None, 200),    # a q offset that is no multiple of 128
    (1, 200, 200, 2, 1, 64, None, 0),      # a ragged length
]


@pytest.mark.parametrize("case", BLOCK_CASES, ids=lambda c: "sq{}-sk{}-w{}-off{}".format(
    c[1], c[2], c[6], c[7]))
def test_plain_flash_is_independent_of_block_sizes(case):
    """The finite sentinel wipes a fully masked block's weights at the first
    real key, so the blockwise result does not depend on the tiling: the
    bf16 kernel tiles by 128 × 128, the f32 kernel and the backward by 64,
    the reference by 512, all against the whole sequence as one block.  A
    ragged length is tiled on inputs zero-padded to a multiple of 128, as
    the kernel's TMA loads pad them: the padded keys lie after every row's
    first real key and take weight exp(-1e30 - m) = 0 exactly, as the
    kernel's -inf past Sk does; the padded rows are dropped."""
    b, sq, sk, hq, hkv, hd, window, q_offset = case
    q, k, v = (torch.from_numpy(x) for x in _qkv(case, seed=1))
    mask = dict(causal=True, window=window, q_offset=q_offset)
    o_whole, lse_whole = tref.flash_attention_fwd(q, k, v, **mask, block_q=sq, block_k=sk)
    q = torch.nn.functional.pad(q, (0, 0, 0, 0, 0, -sq % 128))
    k, v = (torch.nn.functional.pad(x, (0, 0, 0, 0, 0, -sk % 128)) for x in (k, v))
    for bq, bk in ((128, 128), (64, 64), (32, 128)):
        o, lse = tref.flash_attention_fwd(q, k, v, **mask, block_q=bq, block_k=bk)
        np.testing.assert_allclose(o[:, :sq].numpy(), o_whole.numpy(), atol=1e-6, rtol=1e-6)
        np.testing.assert_allclose(lse[..., :sq].numpy(), lse_whole.numpy(), atol=1e-6, rtol=0)
