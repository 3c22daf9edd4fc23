"""The port's fault tolerance (``distributed/fault_tolerance.py``) against the
JAX package's ``repro.distributed.fault_tolerance``, inside
``jax.threefry_partitionable(False)``:

* ``survivor_index``'s tie rule (the first of the maxima);
* ``FailurePlan``: ``alive_mask`` and ``drop_mask`` equal the reference's
  over a grid of rates, steps and sizes (rate 1.0 keeps exactly the
  survivor), ``local_alive`` the entries of the local ranks;
* ``robust_mean`` and ``robust_compressed_mean``: the survivors' exact mean
  and the round under the plan's mask; ``partial_mean``'s contract (NaN
  when all are dead, exact with one survivor);
* ``replay_support``: the Bernoulli support bit for bit against the
  reference's (and its per-coordinate Threefry ``uniform_at``), the slot
  map lifting a real buffer back to the dense message, the capacity
  overflow drops, the fixed-k supports of ``rotated_fixed_k``,
  ``ef_fixed_k`` and ``fixed_k_1bit``; bit-plane wires refused;
* ``corrupt_wire_row``: every mode on bf16, f32 and plane-word rows equal
  to the reference's bytes, and ``ByzantineComm`` corrupting exactly the
  first gathered row set.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import robust_preset as jrobust_preset
from repro.distributed import fault_tolerance as jft
from repro.kernels.threefry import ref as jtf_ref
from repro_torch import random as R
from repro_torch.configs.registry import robust_preset
from repro_torch.core import collectives as tcoll
from repro_torch.core import rotation
from repro_torch.core import wire as twire
from repro_torch.core.wire import codecs as tcodecs
from repro_torch.distributed import fault_tolerance as ft
from repro_torch.kernels.bernoulli_wire import ops as bw_ops

# one intra-op thread: beside other test workers on a loaded machine, torch's
# thread pool stalls for tens of seconds
torch.set_num_threads(1)

N, D = 8, 5000
KEY_SEED = 11


def _cfg(name, policy="mean"):
    return robust_preset(name, policy, axes=("data",))


def _jkey():
    return jax.random.PRNGKey(KEY_SEED)


def _xs(n=N, d=D, seed=1):
    return np.random.default_rng(seed).standard_normal((n, d)).astype(np.float32)


# --------------------------------------------------------------------------- #
# survivor_index and FailurePlan
# --------------------------------------------------------------------------- #

@pytest.mark.parametrize("u", ([1.0, 3.0, 3.0, 2.0], [3.0, 1.0, 3.0, 3.0], [0.0] * 5,
                               [-1.0, -1.0, -2.0], [0.0, 0.0, 7.0]))
def test_survivor_index_tie_rule(u):
    assert int(ft.survivor_index(torch.tensor(u))) == int(jft.survivor_index(jnp.asarray(u)))


@pytest.mark.parametrize("rate", (0.0, 0.25, 0.5, 0.9, 1.0))
def test_failure_plan_masks_equal_reference(rate):
    plan, jplan = ft.FailurePlan(rate=rate, seed=7), jft.FailurePlan(rate=rate, seed=7)
    for step in (0, 1, 5, 17):
        for n in (2, 8):
            with jax.threefry_partitionable(False):
                want = np.asarray(jplan.alive_mask(step, n))
            alive = plan.alive_mask(step, n, "cpu")
            dm = plan.drop_mask(step, n, "cpu")
            np.testing.assert_array_equal(alive.numpy(), want)
            assert dm.dtype == torch.float32 and torch.equal(dm, alive.to(torch.float32))
            assert int(dm.sum()) >= 1
            if rate == 0.0:
                assert int(dm.sum()) == n
            if rate == 1.0:
                u = R.uniform(R.fold_in(R.PRNGKey(7), step), (n,))
                want_one = torch.zeros(n)
                want_one[int(ft.survivor_index(u))] = 1.0
                assert torch.equal(dm, want_one)
            comm = tcoll.StackedComm(n, "cpu")
            assert torch.equal(plan.local_alive(step, comm, "cpu"), dm)


def test_robust_means_follow_the_plan():
    plan = ft.FailurePlan(rate=0.5, seed=4)
    x = torch.from_numpy(_xs(d=1000))
    comm = tcoll.StackedComm(N, "cpu")
    for step in range(3):
        alive = plan.alive_mask(step, N, "cpu")
        want = tcoll.partial_mean(x * alive[:, None].float(), alive.float(), comm)
        assert torch.equal(ft.robust_mean(x, step, comm, plan), want)
        cfg = dataclasses.replace(_cfg("bernoulli_seed_1bit", "trim(1)"), min_compress_size=1)
        got = ft.robust_compressed_mean(x, R.PRNGKey(step), cfg, step, plan, comm)
        want = tcoll.compressed_mean(x, R.PRNGKey(step), cfg, comm,
                                     drop_mask=plan.drop_mask(step, N, "cpu"))
        assert torch.equal(got, want) or bool(torch.isnan(want).all())


def test_partial_mean_contract():
    x = torch.tensor([[1.5, -2.0, 0.25, 3.0]])
    comm = tcoll.StackedComm(1, "cpu")
    assert torch.isnan(tcoll.partial_mean(x, torch.zeros(1), comm)).all()
    assert torch.equal(tcoll.partial_mean(x, torch.ones(1), comm), x[0])


# --------------------------------------------------------------------------- #
# replay_support
# --------------------------------------------------------------------------- #

def _replay_pair(name, peer, d):
    with jax.threefry_partitionable(False):
        want = jft.replay_support(jrobust_preset(name, "mean", axes=("data",)), _jkey(), peer, d)
        want = {k: np.asarray(getattr(want, k)) for k in ("support", "kept", "slot")} | {
            "dim": want.dim}
    return ft.replay_support(_cfg(name), R.PRNGKey(KEY_SEED), peer, d, "cpu"), want


@pytest.mark.parametrize("peer", (0, 7))
@pytest.mark.parametrize("name", ("bernoulli_seed_1bit", "ef_bernoulli", "rotated_fixed_k",
                                  "ef_fixed_k", "fixed_k_1bit"))
def test_replay_support_equals_reference(name, peer):
    got, want = _replay_pair(name, peer, D)
    assert got.dim == want["dim"]
    for k in ("support", "kept", "slot"):
        np.testing.assert_array_equal(getattr(got, k).numpy(), want[k])
    assert torch.equal(got.slot[~got.kept], torch.full_like(got.slot[~got.kept], -1))
    if name.startswith(("bernoulli", "ef_bernoulli")):
        p = float(_cfg(name).encoder.fraction)
        with jax.threefry_partitionable(False):
            u = np.asarray(jtf_ref.uniform_at(jax.random.fold_in(_jkey(), peer), jnp.arange(D), D))
        np.testing.assert_array_equal(got.support.numpy(), u < np.float32(p))


def test_replay_slots_lift_the_real_buffer():
    cfg = _cfg("bernoulli_seed_1bit")
    codec = twire.resolve(cfg)
    key, peer = R.PRNGKey(KEY_SEED), 5
    x = torch.from_numpy(_xs(n=1)[0])
    row = codec.pack(x, key, peer, cfg)
    dense = codec.unpack(row, peer, key, cfg, D)
    rs = ft.replay_support(cfg, key, peer, D, "cpu")
    buf = row.to(torch.float32)
    lifted = torch.where(rs.kept, buf[rs.slot.clamp(0, buf.numel() - 1).long()], buf[-1])
    assert torch.equal(lifted, dense)
    used = torch.sort(rs.slot[rs.kept]).values
    assert torch.equal(used, torch.arange(int(rs.kept.sum()), dtype=torch.int32))


def test_replay_follows_the_capacity_overflow(monkeypatch):
    """A forced-small capacity: support ranks ≥ cap are dropped by the
    encoder, and the replay drops the same ones, bit for bit as the
    reference's replay does under the same capacity; its slots lift the
    real buffer to the dense message."""
    d, p, cap = 1024, 0.25, 16
    key = R.fold_in(R.PRNGKey(KEY_SEED), 2)
    x = torch.from_numpy(_xs(n=1, d=d)[0])
    mu = x.mean()
    buf = bw_ops.encode(x, key, p, cap, mu)
    dense = bw_ops.unpack(buf, mu.reshape(1), key, p, cap, d)
    monkeypatch.setattr(ft.comm_cost, "bernoulli_capacity", lambda dim, q: cap)
    monkeypatch.setattr(jft.comm_cost, "bernoulli_capacity", lambda dim, q: cap)
    base = _cfg("bernoulli_seed_1bit")
    cfg = dataclasses.replace(base, encoder=dataclasses.replace(base.encoder, fraction=p))
    rs = ft._bernoulli_replay(cfg, key, d, "cpu")
    assert int(rs.support.sum()) > cap and int(rs.kept.sum()) == cap
    lifted = torch.where(rs.kept, buf[rs.slot.clamp(0, cap - 1).long()], mu)
    assert torch.equal(lifted, dense)
    jbase = jrobust_preset("bernoulli_seed_1bit", "mean", axes=("data",))
    jcfg = dataclasses.replace(jbase, encoder=dataclasses.replace(jbase.encoder, fraction=p))
    with jax.threefry_partitionable(False):
        want = jft._bernoulli_replay(jcfg, jax.random.fold_in(_jkey(), 2), d)
    for k in ("support", "kept", "slot"):
        np.testing.assert_array_equal(getattr(rs, k).numpy(), np.asarray(getattr(want, k)))


def test_replay_support_fixed_k_slots_read_the_unpack():
    """A buffer of slot indices unpacks to each supported coordinate's slot."""
    for name, folded in (("rotated_fixed_k", True), ("fixed_k_1bit", False)):
        cfg = _cfg(name)
        rs = ft.replay_support(cfg, R.PRNGKey(KEY_SEED), 4, D, "cpu")
        dim = rotation.padded_dim(D) if cfg.encoder.rotation else D
        assert rs.dim == dim and torch.equal(rs.kept, rs.support)
        inner = tcodecs.FixedKGatherCodec() if folded else tcodecs.FixedKSharedCodec()
        slots = inner.wire_slots(dim, cfg)
        probe = torch.cat([torch.arange(slots - 1, dtype=torch.float32), torch.zeros(1)])
        dense = inner.unpack(probe, 4, R.PRNGKey(KEY_SEED), cfg, dim)
        assert torch.equal(dense[rs.support], rs.slot[rs.support].float())


def test_replay_rejects_data_dependent_wires_and_is_frozen():
    for name in ("binary_packed", "ternary_packed", "ef_rotated_binary"):
        with pytest.raises(ValueError, match="no seed-derivable support"):
            ft.replay_support(_cfg(name), R.PRNGKey(0), 0, D, "cpu")
    rs = ft.replay_support(_cfg("bernoulli_seed_1bit"), R.PRNGKey(0), 0, 257, "cpu")
    with pytest.raises(dataclasses.FrozenInstanceError):
        rs.dim = 1


# --------------------------------------------------------------------------- #
# corrupt_wire_row and ByzantineComm
# --------------------------------------------------------------------------- #

def _rows():
    """A bf16 row, an f32 row and plane words whose f32 views include NaN,
    Inf, denormal and zero patterns."""
    rng = np.random.default_rng(5)
    f32 = rng.standard_normal(4099).astype(np.float32)
    words = rng.integers(0, 2 ** 32, 4099, dtype=np.uint64).astype(np.uint32)
    words[:8] = [0x7F800001, 0xFFC00001, 0x7F800000, 0x00000001, 0x80000001, 0, 0x80000000,
                 0x7FC00000]
    return {"bfloat16": jnp.asarray(f32, jnp.bfloat16), "float32": jnp.asarray(f32),
            "uint32": jnp.asarray(words)}


def _torch_row(a):
    a = np.array(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16)).view(torch.bfloat16)
    return torch.from_numpy(a.view(np.int32) if a.dtype == np.uint32 else a)


@pytest.mark.parametrize("mode", ft.CORRUPTION_MODES)
def test_corrupt_wire_row_equals_reference(mode):
    for dtype, row in _rows().items():
        want = np.array(jft.corrupt_wire_row(row, mode)).view(np.uint8)
        got = ft.corrupt_wire_row(_torch_row(row), mode)
        assert got.dtype == _torch_row(row).dtype and got.shape == (row.shape[0],)
        np.testing.assert_array_equal(got.contiguous().view(torch.uint8).numpy(), want,
                                      err_msg=f"{mode} {dtype}")
    with pytest.raises(ValueError, match="unknown corruption mode"):
        ft.corrupt_wire_row(torch.zeros(3), "zero")


def test_byzantine_comm_corrupts_one_row_of_the_first_gather():
    comm = ft.ByzantineComm(tcoll.StackedComm(3, "cpu"), 1, "sign_flip")
    rows = torch.arange(12, dtype=torch.float32).reshape(3, 4) + 1
    first = comm.all_gather(rows)
    assert torch.equal(first[0], rows[0]) and torch.equal(first[2], rows[2])
    assert torch.equal(first[1], -rows[1])
    assert torch.equal(comm.all_gather(rows), rows)
    assert torch.equal(comm.psum(rows), rows.sum(0))
    assert comm.comm.bytes_gathered == 2 * rows.numel() * 4
