"""The port's MoE block and MoE decode against the JAX package's, at the
reference's smoke MoE configs (d 64, 4 experts, top-2, expert ff 64;
qwen2-moe's with 2 shared experts of ff 64), one shape: 2 sequences of 24
tokens for the block (t = 48 token, cap = int(1.25·48·2/4) = 30 slots an
expert), 4 tokens for the decode.  Inputs and parameters come from numpy
seeds; the reference runs op by op at ``tp = 1`` outside any mesh.

Routing.  The reference's ``moe_block`` returns no routing, so its routing
is recomputed here with its own operations (``src/repro/models/moe.py``
lines 72–92: the f32 router product, softmax, ``jax.lax.top_k``, the
renormalized gates, the token-major cumulative count).  The port's
``route`` and ``capacity_slots`` give the same expert ids, slots and keep
mask wherever the reference's k-th against (k+1)-th probability margin
exceeds ``TIE``; tokens inside it are near-ties, counted and left out (and
every slot from the first near-tie on, whose count a flip would move).

Tolerances on outputs, each with its reason:
* f32 compute: 1e-5 absolute + 1e-5 relative on the block and decode
  outputs (products summed in another order), 1e-6 relative on aux;
* bf16 compute: 2e-2 absolute + 1e-2 relative (a bf16 ulp, 2⁻⁸ relative,
  on values up to a few units: the expert products round in another
  order), aux as at f32 (the router and aux are f32 on both sides).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import smoke_config as j_smoke_config
from repro.models import common as jcommon
from repro.models import moe as jmoe
from repro_torch import convert
from repro_torch.models import common as tcommon
from repro_torch.models import moe as tmoe

# one intra-op thread: beside other test workers on a loaded machine, torch's
# thread pool stalls for tens of seconds
torch.set_num_threads(1)

ARCHS = ("olmoe-1b-7b", "qwen2-moe-a2.7b")
B, S, D = 2, 24, 64
T_DECODE = 4
TIE = 1e-5
TOL = {"float32": dict(atol=1e-5, rtol=1e-5), "bfloat16": dict(atol=2e-2, rtol=1e-2)}
AUX_RTOL = 1e-6


def _cfgs(arch, capacity_factor=1.25):
    jcfg = j_smoke_config(arch).moe
    jcfg = dataclasses.replace(jcfg, capacity_factor=capacity_factor)
    return jcfg, convert.arch_config(dataclasses.replace(j_smoke_config(arch), moe=jcfg)).moe


def _params(cfg, seed):
    """One layer's leaves at the reference's scales for d 64, with the
    router at 0.1 so that its logits spread over about one unit."""
    r = np.random.default_rng(seed)
    e, f = cfg.num_experts, cfg.d_ff_expert
    p = {"router": r.standard_normal((D, e), np.float32) * 0.1,
         "w_up": r.standard_normal((e, D, f), np.float32) * D ** -0.5,
         "w_gate": r.standard_normal((e, D, f), np.float32) * D ** -0.5,
         "w_down": r.standard_normal((e, f, D), np.float32) * f ** -0.5}
    if cfg.num_shared:
        fs = cfg.d_ff_shared
        p.update({"shared.w_up": r.standard_normal((D, fs), np.float32) * D ** -0.5,
                  "shared.w_gate": r.standard_normal((D, fs), np.float32) * D ** -0.5,
                  "shared.w_down": r.standard_normal((fs, D), np.float32) * fs ** -0.5})
    return p


def _ctxs(dtype):
    return (jcommon.ShardCtx(tp=1, compute_dtype=getattr(jnp, dtype)),
            tcommon.ShardCtx(compute_dtype=getattr(torch, dtype)))


def _inputs(shape, dtype, seed):
    x = np.random.default_rng(seed).standard_normal(shape, np.float32)
    # the same values on both sides: rounded to the compute dtype once
    x = np.array(jnp.asarray(x, getattr(jnp, dtype)).astype(jnp.float32))
    return jnp.asarray(x, getattr(jnp, dtype)), torch.from_numpy(x).to(getattr(torch, dtype))


def _reference_routing(p, x, cfg):
    """The reference's routing of ``moe_block``, by its own operations:
    (probs, gates, expert ids, slot, keep, margin of the k-th choice over
    the (k+1)-th)."""
    t = x.shape[0] * x.shape[1]
    x = x.reshape(t, -1)
    logits = jnp.einsum("td,de->te", x.astype(jnp.float32), jnp.asarray(p["router"]))
    probs = jax.nn.softmax(logits, axis=-1)
    gates, ids = jax.lax.top_k(probs, cfg.top_k)
    gates = gates / jnp.maximum(jnp.sum(gates, axis=-1, keepdims=True), 1e-9)
    top = jax.lax.top_k(probs, cfg.top_k + 1)[0]
    margin = top[:, -2] - top[:, -1]
    ep = cfg.padded(1)
    cap = max(1, int(cfg.capacity_factor * t * cfg.top_k / ep))
    onehot = jax.nn.one_hot(ids.reshape(-1), ep, dtype=jnp.int32)
    slot = jnp.sum((jnp.cumsum(onehot, axis=0) - 1) * onehot, axis=-1)
    return tuple(np.asarray(a) for a in (probs, gates, ids, slot, slot < cap, margin))


def _near_ties(margin):
    tied = margin <= TIE
    print(f"near-ties (margin <= {TIE}): {int(tied.sum())} of {tied.size} tokens")
    return tied


@pytest.mark.parametrize("capacity_factor", [1.25, 0.5])
@pytest.mark.parametrize("arch", ARCHS)
def test_routing_matches_reference(arch, capacity_factor):
    jcfg, tcfg = _cfgs(arch, capacity_factor)
    p = _params(jcfg, 0)
    jx, tx = _inputs((B, S, D), "float32", 1)
    probs, gates, ids, slot, keep, margin = _reference_routing(p, jx, jcfg)
    tprobs, tgates, tids = tmoe.route(torch.from_numpy(p["router"]), tx.reshape(B * S, D), tcfg)
    tslot, tkeep = tmoe.capacity_slots(tids.reshape(-1), tcfg.padded(1),
                                       max(1, int(capacity_factor * B * S * tcfg.top_k
                                                  / tcfg.padded(1))))
    ok = ~_near_ties(margin)
    np.testing.assert_allclose(tprobs.numpy(), probs, atol=1e-7, rtol=1e-6)
    np.testing.assert_array_equal(tids.numpy()[ok], ids[ok])
    np.testing.assert_allclose(tgates.numpy()[ok], gates[ok], atol=1e-7, rtol=1e-6)
    # slots count earlier pairs: compare up to the first near-tie
    first = int(np.argmin(ok)) if not ok.all() else B * S
    pairs = first * jcfg.top_k
    np.testing.assert_array_equal(tslot.numpy()[:pairs], slot[:pairs])
    np.testing.assert_array_equal(tkeep.numpy()[:pairs], keep[:pairs])
    if capacity_factor < 1:          # the case drops pairs: the keep mask is exercised
        assert not keep.all()


def test_top_k_ties_go_to_the_lower_index():
    """Exactly equal probabilities: ``jax.lax.top_k``'s order (the lower
    expert index first), which the port's stable sort keeps."""
    _, tcfg = _cfgs("olmoe-1b-7b")
    router = np.zeros((D, 4), np.float32)
    router[:, 2] = router[:, 3] = 0.05          # experts 2 and 3 tie above 0 and 1
    x = np.random.default_rng(3).standard_normal((5, D), np.float32)
    x[0] = 0.0                                  # every expert ties
    want = np.asarray(jax.lax.top_k(jax.nn.softmax(jnp.asarray(x) @ jnp.asarray(router)), 2)[1])
    _, _, got = tmoe.route(torch.from_numpy(router), torch.from_numpy(x), tcfg)
    np.testing.assert_array_equal(got.numpy(), want)
    assert got[0].tolist() == [0, 1]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("capacity_factor", [1.25, 0.5])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_block_matches_reference(arch, capacity_factor, dtype):
    jcfg, tcfg = _cfgs(arch, capacity_factor)
    p = _params(jcfg, 0)
    jx, tx = _inputs((B, S, D), dtype, 1)
    jctx, tctx = _ctxs(dtype)
    margin = _reference_routing(p, jx, jcfg)[-1]
    assert not _near_ties(margin).any(), "a near-tie would move the outputs by O(1)"
    with jax.threefry_partitionable(False):
        want, want_aux = jmoe.moe_block(jctx, {k: jnp.asarray(v) for k, v in p.items()}, jx,
                                        jcfg)
    got, got_aux = tmoe.moe_block(tctx, {k: torch.from_numpy(v) for k, v in p.items()}, tx,
                                  tcfg)
    assert got.dtype == getattr(torch, dtype) and got.shape == (B, S, D)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)),
                               **TOL[dtype])
    np.testing.assert_allclose(float(got_aux), float(want_aux), rtol=AUX_RTOL)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_moe_decode_matches_reference(arch, dtype):
    jcfg, tcfg = _cfgs(arch)
    p = _params(jcfg, 0)
    jx, tx = _inputs((T_DECODE, 1, D), dtype, 2)
    jctx, tctx = _ctxs(dtype)
    assert not _near_ties(_reference_routing(p, jx, jcfg)[-1]).any()
    with jax.threefry_partitionable(False):
        want = jmoe.moe_decode(jctx, {k: jnp.asarray(v) for k, v in p.items()}, jx, jcfg)
    got = tmoe.moe_decode(tctx, {k: torch.from_numpy(v) for k, v in p.items()}, tx, tcfg)
    assert got.dtype == getattr(torch, dtype) and got.shape == (T_DECODE, 1, D)
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want.astype(jnp.float32)),
                               **TOL[dtype])


@pytest.mark.parametrize("arch", ARCHS)
def test_block_without_drops_equals_decode(arch):
    """With capacity for every pair (factor E/k: cap = t) the block and the
    dense decode compute the same function of each token (f32)."""
    _, tcfg = _cfgs(arch)
    tcfg = dataclasses.replace(tcfg, capacity_factor=tcfg.num_experts / tcfg.top_k)
    p = {k: torch.from_numpy(v) for k, v in _params(tcfg, 0).items()}
    _, tx = _inputs((B, S, D), "float32", 1)
    ctx = tcommon.ShardCtx(compute_dtype=torch.float32)
    block, _ = tmoe.moe_block(ctx, p, tx, tcfg)
    dec = tmoe.moe_decode(ctx, p, tx.reshape(B * S, 1, D), tcfg)
    np.testing.assert_allclose(block.reshape(B * S, 1, D).numpy(), dec.numpy(), **TOL["float32"])


@pytest.mark.parametrize("arch", ARCHS)
def test_moe_backward_is_reproducible(arch):
    """Two backward passes of the block give the same bits (f32 and bf16),
    the gradient reaching every leaf; dropped pairs get none."""
    _, tcfg = _cfgs(arch, 0.5)
    for dtype in ("float32", "bfloat16"):
        ctx = tcommon.ShardCtx(compute_dtype=getattr(torch, dtype))
        _, tx = _inputs((B, S, D), dtype, 1)
        grads = []
        for _ in range(2):
            p = {k: torch.from_numpy(v).requires_grad_() for k, v in _params(tcfg, 0).items()}
            x = tx.clone().requires_grad_()
            y, aux = tmoe.moe_block(ctx, p, x, tcfg)
            (y.float().square().sum() + aux).backward()
            grads.append([x.grad] + [p[k].grad for k in sorted(p)])
        assert all(g is not None and bool(torch.isfinite(g).all()) for g in grads[0])
        assert all(torch.equal(a, b) for a, b in zip(*grads))
