"""The port's robust decode (``core/wire/robust.py`` and the decode hooks of
``core/wire/base.py``) against the JAX package's, inside
``jax.threefry_partitionable(False)``, op by op but for the rotation's
butterfly (tests/test_torch_rotation.py::jit_butterfly).

* ``reduce_rows`` for every kind and f, masked and not, bit for bit, on
  stacks with columns of ±0.0 ties, NaN of both signs and ±Inf.  A NaN
  result's sign and payload are the platform's (x86 keeps one operand's,
  the card returns its canonical NaN): NaN is held to NaN there, every
  other value to its bits;
* for each of the 13 gather presets, ``decode_rows_reduce`` under
  trim(1), median, mean_trim(1) and the masked mean, and the port's whole
  robust or masked round (``compressed_mean`` on ``StackedComm``, the
  preset's scatter decode included), equal to the reference's decode of
  the same wire rows, on a 2⁻⁶ grid (the mean centers agree).  The rotated
  presets too: the rotated twins, elsewhere within 1e-6 of the reference
  (tests/test_torch_ef_wire.py), agree in every bit on these inputs;
* trim(0) equal to the fused mean; the trimmed scatter windows equal to
  the flat decode at d = 5000 and 4999 over 4 and 3 shards; the masked mean
  equal to the survivors-only loop; the masked psum of ``fixed_k_1bit``
  and the masked exact mean against the reference's formulas; the payload
  unchanged by the policy; the §14 ``mse_trimmed`` forms;
* the Byzantine matrix of the reference's
  ``distributed_checks/robust_decode_check.py`` over
  :class:`~repro_torch.distributed.fault_tolerance.ByzantineComm`: trim(1)
  within 2× the clean ceiling under nan, inf and boost and 4× under
  sign_flip, the plain mean past 10× under nan, inf and boost; the masked
  output bit for bit the same when the dropped peers' inputs are poisoned;
* the ``DistComm`` robust rounds over gloo at n = 3 and 4 equal to
  ``StackedComm``'s; the hierarchical robust round (``inner_axes``: an
  n_eff-entry mask over the cross-host peers) against the reference's;
  a policy on the training compression reaching each bucket's and each
  leaf's round.
"""
import collections
import dataclasses
import json
import pathlib
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import COMPRESSION_PRESETS as JPRESETS
from repro.configs.registry import robust_preset as jrobust_preset
from repro.core import mse as jmse
from repro.core import wire as jwire
from repro.core.wire import robust as jrobust
from repro_torch import convert
from repro_torch import random as R
from repro_torch.configs.registry import COMPRESSION_PRESETS, robust_preset
from repro_torch.core import collectives as tcoll
from repro_torch.core import comm_cost, mse, rotation
from repro_torch.core import types as t
from repro_torch.core import wire as twire
from repro_torch.core.wire import base as tbase
from repro_torch.core.wire import ef as tef
from repro_torch.core.wire import robust
from repro_torch.core.wire import rotated as trotated
from repro_torch.distributed import fault_tolerance as ft
from repro_torch.train import bucketing, train_step
from test_torch_collective import GLOO_INIT_TIMEOUT_S, GlooWorld
from test_torch_rotation import jit_butterfly  # noqa: F401  (fixture)

# one intra-op thread: beside other test workers on a loaded machine, torch's
# thread pool stalls for tens of seconds
torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent
N, D = 8, 5000
KEY_SEED = 3
MASK = (1.0, 1.0, 1.0, 0.0, 1.0, 1.0, 1.0, 1.0)
# policy name -> (decode_policy, drop mask)
POLICIES = {"trim1": ("trim(1)", None), "median": ("median", None),
            "mean_trim1": ("mean_trim(1)", None), "masked_mean": ("mean", MASK)}
KINDS = (("mean", 0), ("trim", 1), ("trim", 2), ("median", 0), ("mean_trim", 1),
         ("mean_trim", 0))
GATHER = sorted(p for p in COMPRESSION_PRESETS if p != "fixed_k_1bit")


def _cfg(name, policy, **kw):
    return dataclasses.replace(robust_preset(name, policy, axes=("data",)),
                               min_compress_size=1, **kw)


def _jcfg(name, policy, **kw):
    return dataclasses.replace(jrobust_preset(name, policy, axes=("data",)),
                               min_compress_size=1, **kw)


def _grid(n=N, d=D, seed=1):
    rng = np.random.default_rng(seed)
    x = np.round(rng.standard_normal((n, d)) * 32) / 64
    return (x + (np.arange(n)[:, None] - n / 2) / 64).astype(np.float32)


def _gauss(n=N, d=D, seed=1):
    return np.random.default_rng(seed).standard_normal((n, d)).astype(np.float32)


def _to_torch(a):
    a = np.array(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    if a.dtype == np.uint32:
        return torch.from_numpy(a.view(np.int32))
    return torch.from_numpy(a)


def _mask(mask, lib):
    if mask is None:
        return None
    return jnp.asarray(mask, jnp.float32) if lib == "jax" else torch.tensor(mask)


def assert_same(got, want):
    """Bits equal; NaN where the other is NaN (module docstring)."""
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    nan = np.isnan(want)
    np.testing.assert_array_equal(np.isnan(got), nan)
    np.testing.assert_array_equal(got[~nan].view(np.uint32), want[~nan].view(np.uint32))


def _crafted(n, d, seed):
    """An (n, d) stack with ±0.0 ties, NaN of both signs and ±Inf columns."""
    s = _gauss(n, d, seed)
    s[:, 0] = 0.0
    s[1::2, 0] = -0.0
    s[:, 1] = -0.0
    s[0, 1] = 0.0
    s[0, 2], s[1, 2] = np.nan, -np.nan
    s[:, 3] = np.nan
    s[n - 1, 3] = -np.float32(np.nan)
    s[0, 4], s[1, 4] = np.inf, -np.inf
    s[:, 5] = 1.0
    s[0, 6], s[1, 6], s[2, 6] = -np.nan, -0.0, 0.0
    s[:, 7] = -0.0
    s[n // 2, 7] = np.nan
    s[:, 8:16] = np.round(s[:, 8:16])            # ties of ±1, ±0
    return s


# --------------------------------------------------------------------------- #
# reduce_rows
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("n", (3, N))
@pytest.mark.parametrize("kind,f", KINDS)
def test_reduce_rows_equals_reference(kind, f, n):
    stack = _crafted(n, 97, seed=n)
    masks = (None, [1.0, 0.0, 1.0] + [1.0, 0.0, 1.0, 1.0, 1.0][:n - 3],
             [1.0, 1.0] + [0.0] * (n - 2), [0.0] * n)
    for mask in masks:
        want = jrobust.reduce_rows(jnp.asarray(stack), kind, f, _mask(mask, "jax"))
        got = robust.reduce_rows(torch.from_numpy(stack), kind, f, _mask(mask, "torch"))
        assert_same(got, want)


def test_reduce_rows_chunks_change_no_bit(monkeypatch):
    stack = torch.from_numpy(_crafted(N, 97, seed=4))
    whole = {kf: robust.reduce_rows(stack, *kf, torch.tensor(MASK)) for kf in KINDS}
    monkeypatch.setattr(robust, "CHUNK", 7)
    for kf in KINDS:
        assert_same(robust.reduce_rows(stack, *kf, torch.tensor(MASK)), whole[kf])


def test_sort_key_ties_signed_zeros_and_nans():
    v = torch.tensor([0.0, -0.0, float("nan"), -float("nan"), float("inf"), -float("inf"),
                      1.0, -1.0, 1e-45, -1e-45])
    k = robust.sort_key(v).tolist()
    assert k[0] == k[1] and k[2] == k[3] == 2 ** 31 - 2
    assert k[5] < k[7] < k[9] < k[0] < k[8] < k[6] < k[4] < k[2]


def test_parse_and_resolve_rules():
    assert robust.parse_policy("trim(0)") == ("mean", 0)
    assert robust.parse_policy("mean_trim(0)") == ("mean_trim", 0)
    assert robust.is_mean(_cfg("binary_packed", "trim(0)"))
    assert not robust.is_mean(_cfg("binary_packed", "median"))
    with pytest.raises(ValueError, match="unknown robust reduction"):
        robust.reduce_rows(torch.zeros(2, 3), "max", 0)
    with pytest.raises(ValueError, match="per-peer wire rows"):
        twire.resolve(_cfg("fixed_k_1bit", "trim(1)"))
    twire.resolve(_cfg("fixed_k_1bit", "trim(0)"))
    for name in COMPRESSION_PRESETS:
        for policy in ("trim(1)", "median"):
            assert robust_preset(name, policy) == convert.compression_config(
                jrobust_preset(name, policy))


# --------------------------------------------------------------------------- #
# Every gather preset against the reference.
# --------------------------------------------------------------------------- #

def _to_jax(rows):
    a = rows.numpy() if rows.dtype != torch.bfloat16 else rows.view(torch.int16).numpy()
    if rows.dtype == torch.bfloat16:
        return jnp.asarray(a.view(jnp.bfloat16))
    return jnp.asarray(a.view(np.uint32) if rows.dtype == torch.int32 else a)


@pytest.mark.parametrize("name", GATHER)
def test_preset_robust_decode_and_round_equal_reference(name, jit_butterfly):
    """The port's whole round (its packs, its scatter decode) and its
    decode_rows_reduce under each policy, against the reference's
    decode_rows_reduce of the same wire rows.  The rows are the port's
    packs, which are the reference's byte for byte
    (tests/test_torch_golden_wire.py, tests/test_torch_ef_wire.py): the
    reference's own packs would add seconds of per-op compiles each."""
    key = R.PRNGKey(KEY_SEED)
    codec = twire.resolve(_cfg(name, "mean"))
    x = torch.from_numpy(_grid())
    rows = torch.stack([codec.pack(x[i], key, i, _cfg(name, "mean")) for i in range(N)])
    with jax.threefry_partitionable(False):
        jkey, jrows = jax.random.PRNGKey(KEY_SEED), _to_jax(rows)
        jc = jwire.resolve(_jcfg(name, "mean"))
        want = {label: np.asarray(jc.decode_rows_reduce(jrows, jkey, _jcfg(name, policy), D, N,
                                                        _mask(mask, "jax")))
                for label, (policy, mask) in POLICIES.items()}
    for label, (policy, mask) in POLICIES.items():
        cfg = _cfg(name, policy)
        assert_same(codec.decode_rows_reduce(rows, key, cfg, D, N, _mask(mask, "torch")),
                    want[label])
        assert_same(tcoll.compressed_mean(x, key, cfg, tcoll.StackedComm(N, "cpu"),
                                          drop_mask=_mask(mask, "torch")), want[label])


@pytest.mark.parametrize("name", GATHER)
def test_trim0_is_the_fused_mean(name):
    cfg = _cfg(name, "trim(0)")
    codec = twire.resolve(cfg)
    key = R.PRNGKey(KEY_SEED)
    x = torch.from_numpy(_gauss())
    rows = torch.stack([codec.pack(x[i], key, i, cfg) for i in range(N)])
    assert_same(codec.decode_rows_reduce(rows, key, cfg, D, N),
                codec.decode_gathered(rows, key, cfg, D, N))


def _unwrap_rotated(codec):
    c = codec.inner if isinstance(codec, tef.EFCodec) else codec
    return (c.inner, True) if isinstance(c, trotated.RotatedCodec) else (c, False)


@pytest.mark.parametrize("name", GATHER)
def test_trim_scatter_windows_equal_flat(name):
    """Per-shard reductions over the word-aligned windows, concatenated and
    truncated (rotated: in rotated space, one unrotate), equal the flat
    trimmed decode, at d = 5000 and 4999 over 4 and 3 shards."""
    cfg = _cfg(name, "trim(1)")
    codec = twire.resolve(cfg)
    key = R.PRNGKey(KEY_SEED)
    shard_codec, rot = _unwrap_rotated(codec)
    for d in (D, D - 1):
        x = torch.from_numpy(_gauss(d=d))
        rows = torch.stack([codec.pack(x[i], key, i, cfg) for i in range(N)])
        flat = codec.decode_rows_reduce(rows, key, cfg, d, N)
        dsp = rotation.padded_dim(d) if rot else d
        for nshards in (4, 3):
            ds = tbase.scatter_shard_len(dsp, nshards, shard_codec.scatter_align(cfg))
            parts = [robust.reduce_rows(shard_codec.decode_rows_shard(
                rows, key, cfg, dsp, N, s * ds, ds, nshards), "trim", 1)
                for s in range(nshards)]
            full = torch.cat(parts)[:dsp]
            if rot:
                full = rotation.unrotate(rotation.rotation_key(key), full, d)
            assert_same(full, flat)


@pytest.mark.parametrize("name", GATHER)
def test_masked_mean_is_the_survivor_loop_and_ignores_poisoned_peers(name):
    """The masked mean equals an ascending loop over the survivors' rows
    under their own peer indices (rotated: in rotated space, one unrotate),
    and the round's output keeps its bits when the dropped peers' inputs
    are poisoned."""
    cfg = _cfg(name, "mean")
    codec = twire.resolve(cfg)
    key = R.PRNGKey(KEY_SEED)
    x = torch.from_numpy(_gauss(seed=23))
    rows = torch.stack([codec.pack(x[i], key, i, cfg) for i in range(N)])
    mask = torch.tensor(MASK)
    got = codec.decode_rows_reduce(rows, key, cfg, D, N, mask)
    inner, rot = _unwrap_rotated(codec)
    dim = rotation.padded_dim(D) if rot else D
    stack = (inner if rot else codec).decode_rows(rows, key, cfg, dim, N)
    acc = torch.zeros(dim)
    for i in range(N):
        if MASK[i] > 0:
            acc = acc + stack[i]
    want = tbase.divide(acc, int(sum(MASK)))
    if rot:
        want = rotation.unrotate(rotation.rotation_key(key), want, D)
    assert_same(got, want)
    comm = tcoll.StackedComm(N, "cpu")
    out = tcoll.compressed_mean(x, key, cfg, comm, drop_mask=mask)
    poisoned = x.clone()
    poisoned[3] = 1e9 + torch.arange(D, dtype=torch.float32)
    assert_same(tcoll.compressed_mean(poisoned, key, cfg, comm, drop_mask=mask), out)


@pytest.mark.parametrize("name", ("fixed_k_1bit", "ef_fixed_k_1bit", "exact"))
def test_masked_psum_and_exact_mean_equal_reference(name):
    """The psum codec with a mask: Σ keep_i·buf_i in f32 in rank order over
    Σ keep_i, rounded once to the wire dtype, then ``decode_reduced`` (the
    reference's masked psum, meshless); its EF twin; the exact mean over
    the survivors (``partial_mean``), NaN when all are dropped."""
    xs = _grid()
    mask = torch.tensor(MASK)
    comm = tcoll.StackedComm(N, "cpu")
    if name == "exact":
        cfg = t.CompressionConfig(mode="none", axes=("data",))
        got = tcoll.compressed_mean(torch.from_numpy(xs), R.PRNGKey(0), cfg, comm, mask)
        acc = np.zeros(D, np.float32)
        for i in range(N):
            acc = acc + xs[i] * np.float32(MASK[i])
        assert_same(got, acc / np.float32(sum(MASK)))
        dead = tcoll.compressed_mean(torch.from_numpy(xs), R.PRNGKey(0), cfg, comm, torch.zeros(N))
        assert torch.isnan(dead).all()
        y, st = tcoll.compressed_mean_stateful(torch.from_numpy(xs), torch.ones(N, D),
                                               R.PRNGKey(0), cfg, comm, mask)
        assert_same(y, got)
        assert torch.equal(st, torch.ones(N, D))
        return
    ef = name.startswith("ef_")
    jcfg = _jcfg("fixed_k_1bit", "mean", error_feedback=ef)
    with jax.threefry_partitionable(False):
        jkey = jax.random.PRNGKey(KEY_SEED)
        jc = jwire.resolve(jcfg)
        bufs = [jc.pack(jnp.asarray(xs[i]), jkey, i, jcfg) for i in range(N)]
        num = jnp.zeros(bufs[0].shape, jnp.float32)
        for i, b in enumerate(bufs):
            num = num + b.astype(jnp.float32) * MASK[i]
        wire = (num / jnp.float32(sum(MASK))).astype(bufs[0].dtype)
        want = np.asarray(jc.decode_reduced(wire, jkey, jcfg, D))
    cfg = _cfg("fixed_k_1bit", "mean", error_feedback=ef)
    x = torch.from_numpy(xs)
    if ef:
        got, _ = tcoll.compressed_mean_stateful(x, torch.zeros(N, D), R.PRNGKey(KEY_SEED), cfg,
                                                comm, mask)
    else:
        got = tcoll.compressed_mean(x, R.PRNGKey(KEY_SEED), cfg, comm, mask)
    assert_same(got, want)


def test_policy_never_changes_the_payload():
    """Wire geometry and accounting are policy-blind, and a round hands the
    communicator the same wire rows under every policy."""
    x = torch.from_numpy(_gauss(n=4, d=1000))
    for name in GATHER:
        base, trim = _cfg(name, "mean"), _cfg(name, "trim(1)")
        codec = twire.resolve(base)
        assert codec is twire.resolve(trim)
        assert comm_cost.cost_config(base, n=N, d=D) == comm_cost.cost_config(trim, n=N, d=D)
        assert codec.wire_slots(D, base) == codec.wire_slots(D, trim)
        first = []
        for cfg in (base, trim, _cfg(name, "median")):
            comm = _FirstGather(tcoll.StackedComm(4, "cpu"))
            tcoll.compressed_mean(x, R.PRNGKey(1), cfg, comm)
            first.append(comm.first)
        assert first[0] == first[1] == first[2] == codec.wire_bits(4, 1000, base) / 8


class _FirstGather:
    """Records the bytes of a communicator's first all_gather (the wire)."""

    def __init__(self, comm):
        self.comm, self.size, self.local_ranks = comm, comm.size, comm.local_ranks
        self.first = None

    def all_gather(self, local):
        if self.first is None:
            self.first = local.numel() * local.element_size()
        return self.comm.all_gather(local)

    def psum(self, local):
        return self.comm.psum(local)


def test_inner_axes_still_raise_with_a_mask_or_without():
    """The hierarchical robust round (``hier_bernoulli`` on a stacked (pod
    4, data 2) mesh) under trim(1) and under the masked mean with an
    (n_eff,) mask over the cross-host peers: equal to the reference's
    ``decode_rows_reduce`` of the same codec rows (the packs of the in-pod
    means, the port's bytes); a dropped cross-host peer equals a rerun over
    the survivors' pods only; the exact path's mask drops whole pods.  (The
    name is the one this test had while the schedule raised.)"""
    mesh, n_eff = {"pod": 4, "data": 2}, 4
    mask = (1.0, 0.0, 1.0, 1.0)
    key = R.PRNGKey(KEY_SEED)
    x = torch.from_numpy(_grid())
    comm = tcoll.StackedComm(device="cpu", mesh=mesh)
    v = comm.mean_over(x, ("data",))
    jbase = jrobust_preset("hier_bernoulli", "mean")
    codec = twire.resolve(convert.compression_config(jbase))
    rows = torch.stack([codec.pack(v[r], key, r, convert.compression_config(jbase))
                        for r in range(n_eff)])
    for policy, m in (("trim(1)", None), ("mean", mask)):
        jcfg = dataclasses.replace(jrobust_preset("hier_bernoulli", policy), min_compress_size=1)
        with jax.threefry_partitionable(False):
            want = np.asarray(jwire.resolve(jcfg).decode_rows_reduce(
                _to_jax(rows), jax.random.PRNGKey(KEY_SEED), jcfg, D, n_eff, _mask(m, "jax")))
        cfg = convert.compression_config(jcfg)
        for c in (cfg, dataclasses.replace(cfg, scatter_decode=False)):
            assert_same(tcoll.compressed_mean(x, key, c, tcoll.StackedComm(device="cpu",
                                                                            mesh=mesh),
                                              _mask(m, "torch")), want)
    cfg = convert.compression_config(dataclasses.replace(
        jrobust_preset("hier_bernoulli", "mean"), min_compress_size=1))
    got = tcoll.compressed_mean(x, key, cfg, tcoll.StackedComm(device="cpu", mesh=mesh),
                                torch.tensor(mask))
    flat = dataclasses.replace(cfg, inner_axes=(), scatter_decode=False)
    # the survivors' rows alone, under their own peer indices (the decode
    # regenerates each support from fold_in(key, peer)), from +0.0 in order
    acc = torch.zeros(D)
    for r in (r for r in range(n_eff) if mask[r]):
        acc = acc + codec.unpack(rows[r], r, key, flat, D)
    assert_same(got, tbase.divide(acc, int(sum(mask))))
    exact = dataclasses.replace(cfg, mode="none")
    y = tcoll.compressed_mean(x, key, exact, tcoll.StackedComm(device="cpu", mesh=mesh),
                              torch.tensor(mask))
    alive = [r for r in range(N) if mask[r // 2]]
    acc = torch.zeros(D)
    for r in alive:
        acc += x[r]
    assert_same(y, acc / len(alive))


def test_decode_policy_reaches_every_bucket_and_leaf():
    """A policy on the training compression reaches each bucket's round of
    ``sync_grads_bucketed`` and each leaf's of the per-leaf sync, with the
    error-feedback state too."""
    shapes = {"a": (30, 40), "b": (500,), "c": (7, 11)}
    specs = {k: (None,) * len(v) for k, v in shapes.items()}
    cmp = _cfg("binary_packed", "trim(1)")
    plan = bucketing.build_plan(shapes, specs, ("data",), {"data": N}, cmp)
    rng = np.random.default_rng(0)
    grads = {k: torch.from_numpy(rng.standard_normal((N,) + v).astype(np.float32))
             for k, v in shapes.items()}
    key, comm = R.PRNGKey(5), tcoll.StackedComm(N, "cpu")
    got, _ = bucketing.sync_grads_bucketed(grads, plan, cmp, key, comm)
    plain, _ = bucketing.sync_grads_bucketed(grads, plan, _cfg("binary_packed", "mean"), key, comm)
    ef = bucketing.init_ef_state(plan, cmp, N)
    got_ef, new_ef = bucketing.sync_grads_bucketed(grads, plan, cmp, key, comm, ef)
    comp = [(j, b) for j, b in enumerate(plan.buckets) if b.kind == "compressed"]
    assert comp
    for j, b in comp:
        lcfg = bucketing._bucket_cfg(b, cmp, error_feedback=False)
        want = tcoll.compressed_mean(bucketing.pack_bucket(grads, b), R.fold_in(key, j), lcfg,
                                     comm)
        y = torch.cat([got[s.name].reshape(-1) for s in b.slots])
        assert_same(y, want)
        assert not torch.equal(y, torch.cat([plain[s.name].reshape(-1) for s in b.slots]))
        want, _ = tcoll.compressed_mean_stateful(
            bucketing.pack_bucket(grads, b), torch.zeros(N, b.size), R.fold_in(key, j),
            dataclasses.replace(lcfg, error_feedback=True), comm)
        assert_same(torch.cat([got_ef[s.name].reshape(-1) for s in b.slots]), want)
    leaves, _ = train_step.sync_grads(grads, specs, ("data",), cmp, key, comm)
    for i, name in enumerate(sorted(grads)):
        assert_same(leaves[name], tcoll.compressed_mean(grads[name], R.fold_in(key, i), cmp, comm))


# --------------------------------------------------------------------------- #
# The §14 closed forms.
# --------------------------------------------------------------------------- #

def test_mse_trimmed_forms_equal_reference():
    xs = _gauss(d=512, seed=29)
    jx, x = jnp.asarray(xs), torch.from_numpy(xs)
    base = mse.mse_binary(x)
    assert mse.mse_trimmed(base, x, 0) is base
    with pytest.raises(ValueError):
        mse.mse_trimmed(1.0, x[:4], 2)
    for f in (1, 2):
        assert float(mse.mse_trimmed_binary(x, f)) == pytest.approx(
            float(jmse.mse_trimmed_binary(jx, f)), rel=1e-5)
        assert float(mse.mse_trimmed_bernoulli(x, 1 / 16, x.mean(1), f)) == pytest.approx(
            float(jmse.mse_trimmed_bernoulli(jx, 1 / 16, jnp.mean(jx, axis=-1), f)), rel=1e-5)


@pytest.mark.parametrize("name", ("bernoulli_seed_1bit", "binary_packed"))
def test_trimmed_error_within_closed_form_bound(name):
    cfg = _cfg(name, "trim(1)")
    x = torch.from_numpy(_gauss(seed=31))
    xbar = x.mean(0)
    if name == "binary_packed":
        bound = float(mse.mse_trimmed_binary(x, 1))
    else:
        bound = float(mse.mse_trimmed_bernoulli(x, cfg.encoder.fraction, x.mean(1), 1))
    errs = [float(torch.sum((tcoll.compressed_mean(x, R.PRNGKey(100 + r), cfg,
                                                   tcoll.StackedComm(N, "cpu")) - xbar) ** 2))
            for r in range(6)]
    assert np.mean(errs) <= bound


# --------------------------------------------------------------------------- #
# The Byzantine matrix (the reference's robust_decode_check, meshless).
# --------------------------------------------------------------------------- #

ROUNDS = 1


def _err(bufs, xbar, cfg, key, adv=None, mode=None):
    """One round's decode of the packed ``bufs`` over a communicator that
    corrupts rank ``adv``'s gathered row (the policy never changes the
    packs, so every policy decodes the same bufs)."""
    comm = tcoll.StackedComm(N, "cpu")
    if adv is not None:
        comm = ft.ByzantineComm(comm, adv, mode)
    y = twire.resolve(cfg).gather_decode(bufs, key, cfg, D, comm)
    return float(torch.sum((y - xbar) ** 2, dtype=torch.float64))


@pytest.mark.parametrize("name", GATHER)
def test_byzantine_row_contained_by_trim(name):
    """One peer of 8 sends a corrupted wire row: trim(1) stays within 2× the
    clean ceiling (the largest of the mean's, trim(1)'s and trim(2)'s clean
    errors: a peer past the honest extremes takes one trim slot) under
    nan, inf and boost, and 4× under sign_flip (the flipped row lies inside
    the honest hull); the plain mean goes past 10× under nan, inf and boost
    and stays finite and bounded under sign_flip."""
    x = torch.from_numpy(_gauss())
    xbar = x.mean(0)
    cfgs = {p: _cfg(name, p, wire_dtype="float32") for p in ("mean", "trim(1)", "trim(2)")}
    codec = twire.resolve(cfgs["mean"])
    errs = collections.defaultdict(list)
    for r in range(ROUNDS):
        key = R.PRNGKey(100 + r)
        bufs = torch.stack([codec.pack(x[i], key, i, cfgs["mean"]) for i in range(N)])
        for p, cfg in cfgs.items():
            errs[p].append(_err(bufs, xbar, cfg, key))
        for mode in ft.CORRUPTION_MODES:
            for p in ("mean", "trim(1)"):
                errs[p, mode].append(_err(bufs, xbar, cfgs[p], key, 3, mode))
    clean = {p: np.mean(errs[p]) for p in cfgs}
    ceiling = max(clean.values())
    for mode in ft.CORRUPTION_MODES:
        err_t, err_m = np.mean(errs["trim(1)", mode]), np.mean(errs["mean", mode])
        fac = 4.0 if mode == "sign_flip" else 2.0
        assert np.isfinite(err_t) and err_t <= fac * ceiling, (mode, err_t, clean)
        if mode == "sign_flip":
            assert np.isfinite(err_m) and err_m <= 4.0 * ceiling, (mode, err_m, clean)
        else:
            assert not np.isfinite(err_m) or err_m > 10.0 * clean["mean"], (mode, err_m, clean)


# --------------------------------------------------------------------------- #
# DistComm over gloo.
# --------------------------------------------------------------------------- #

_WORKER = r"""
import json, sys, numpy as np, torch, torch.distributed as dist
sys.path.insert(0, sys.argv[1])
from repro_torch import random as R
from repro_torch.configs.registry import robust_preset
from repro_torch.core.collectives import DistComm, compressed_mean
import dataclasses
import datetime
rank, port, out, world = int(sys.argv[2]), sys.argv[3], sys.argv[4], int(sys.argv[5])
dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", world_size=world,
                        rank=rank, timeout=datetime.timedelta(seconds=float(sys.argv[6])))
xs = torch.from_numpy(np.load(out + "/xs.npy"))
for name, (preset, policy, mask) in json.load(open(out + "/cfgs.json")).items():
    cfg = dataclasses.replace(robust_preset(preset, policy, axes=("data",)),
                              min_compress_size=1)
    y = compressed_mean(xs[rank:rank + 1], R.PRNGKey(7), cfg, DistComm(device="cpu"),
                        drop_mask=None if mask is None else torch.tensor(mask))
    np.save(f"{out}/{name}.{rank}.npy", y.numpy())
dist.destroy_process_group()
"""

# name -> (preset, policy, mask or None; the mask's length is the world's)
GLOO_ROUNDS = {"bernoulli_trim_scatter": ("bernoulli_seed_1bit", "trim(1)", None),
               "binary_median_scatter": ("binary_packed", "median", None),
               "ternary_masked_scatter": ("ternary_packed", "mean", "drop1"),
               "rotated_binary_mean_trim": ("rotated_binary", "mean_trim(1)", None),
               "fixed_k_1bit_masked": ("fixed_k_1bit", "mean", "drop1")}


def test_distcomm_gloo_robust_rounds_equal_stacked(tmp_path):
    """World sizes 3 and 4, their processes started together."""
    worlds, rounds = {}, {}
    for n in (3, 4):
        out = tmp_path / f"n{n}"
        out.mkdir()
        np.save(out / "xs.npy", _gauss(n, 20_000, 11))
        mask = [1.0] * n
        mask[1] = 0.0
        rounds[n] = {k: (p, pol, mask if m else None) for k, (p, pol, m) in GLOO_ROUNDS.items()}
        (out / "cfgs.json").write_text(json.dumps(rounds[n]))
        worlds[n] = GlooWorld(lambda port, n=n, out=out: [
            [sys.executable, "-c", _WORKER, str(ROOT / "src"), str(r), port, str(out), str(n),
             str(GLOO_INIT_TIMEOUT_S)] for r in range(n)])
    for n, world in worlds.items():
        world.wait()
        xs = np.load(tmp_path / f"n{n}" / "xs.npy")
        for name, (preset, policy, m) in rounds[n].items():
            want = tcoll.compressed_mean(torch.from_numpy(xs), R.PRNGKey(7), _cfg(preset, policy),
                                         tcoll.StackedComm(n, "cpu"),
                                         drop_mask=None if m is None else torch.tensor(m))
            for r in range(n):
                assert_same(np.load(tmp_path / f"n{n}" / f"{name}.{r}.npy"), want)
