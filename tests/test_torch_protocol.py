"""The port's single-host stack against the JAX package: ``random.split``,
the §6 solvers, the Lemma 3.2 / Thm 6.1 forms, every cost model and
``measure_bits``, the decoders, ``MeanEstimator`` on the seven protocols of
the quickstart and ``empirical_mse``; then the two examples and the encode
benchmark at small sizes.  One shape, (16, 512), the quickstart's.

Tolerances, each with its reason:
* keys, bit counts, supports and the binary and identity estimates: exact;
* ``optimal_probs``: atol 1e-6 on p ≤ 1 (read: 6e-8).  The bisection's f32
  sums add in another order than XLA's, so θ agrees to a few ulps;
* ``alternating_minimization``: one step as ``optimal_probs``; at 20 steps
  each step re-solves from the other's centers and the ulps compound
  (read: 3.3e-5 on p, 2.0e-4 on μ, 2.3e-5 relative on the trace), so p
  within 5e-4, μ within 2e-3 and the trace within 2e-4 relative;
* closed forms and costs summed over probabilities: rtol 1e-5 (f32 sums
  in another order; read ≤ 1.3e-7);
* estimates: rtol = atol = 1e-5 (read ≤ 9.5e-7).  The node center μ =
  mean(x) is not bit-reproducible across the frameworks (jnp multiplies
  the sum by f32(1/d) and sums in another order), and the encoders carry
  it into every sent value;
* ``empirical_mse``: rtol 1e-5 (read 2.0e-7); the identity's is exactly 0
  in the port (its estimate and the true mean are one computation) and
  2e-13 in the reference, so it gets atol 1e-9.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import compression_preset as jpreset
from repro.core import comm_cost as jcost
from repro.core import decoders as jdec
from repro.core import encoders as jenc
from repro.core import mse as jmse
from repro.core import optimal as jopt
from repro.core import protocol as jproto
from repro.core import types as jt
from repro_torch import convert
from repro_torch import random as R
from repro_torch.core import comm_cost as tcost
from repro_torch.core import decoders as tdec
from repro_torch.core import encoders as tenc
from repro_torch.core import mse as tmse
from repro_torch.core import optimal as topt
from repro_torch.core import protocol as tproto
from repro_torch.core import types as tt
from repro_torch.examples import federated_mean, quickstart
from repro_torch.launch import bench_encode_speed

# one intra-op thread: beside other test workers on a loaded machine, torch's
# thread pool stalls for tens of seconds
torch.set_num_threads(1)

N, D = 16, 512
RNG = np.random.default_rng(0)
XS = RNG.standard_normal((N, D)).astype(np.float32)
MUS = XS.mean(axis=1).astype(np.float32)
# the quickstart's seven protocols: (kind, encoder fields, cost model)
CONFIGS = {
    "identity": ("identity", {}, "naive"),
    "bernoulli_log": ("bernoulli", {"fraction": 1 / math.log(D)}, "sparse_seed"),
    "bernoulli_1bit": ("bernoulli", {"fraction": 1 / 16}, "sparse_seed"),
    "bernoulli_1_over_d": ("bernoulli", {"fraction": 1 / D}, "sparse_seed"),
    "binary": ("binary", {}, "binary"),
    "fixed_k": ("fixed_k", {"fraction": 1 / 16}, "sparse_seed"),
    "optimal": ("bernoulli", {"fraction": 1 / 16, "probs": "optimal"}, "sparse"),
}


@pytest.fixture(autouse=True)
def _golden_threefry_layout():
    with jax.threefry_partitionable(False):
        yield


def _both(a):
    a = np.asarray(a)
    return jnp.asarray(a), torch.from_numpy(a.copy())


def _estimators(name, budget=float(D)):
    kind, kw, proto = CONFIGS[name]
    return (jproto.MeanEstimator(jt.EncoderSpec(kind=kind, **kw), jt.CommSpec(proto), budget),
            tproto.MeanEstimator(tt.EncoderSpec(kind=kind, **kw), tt.CommSpec(proto), budget))


def _key(seed):
    return jax.random.PRNGKey(seed), convert.key_to_torch(jax.random.PRNGKey(seed))


# --------------------------- keys ------------------------------------------ #

@pytest.mark.parametrize("num", (2, 3, 8))
@pytest.mark.parametrize("seed", (0, 5, 2**31 - 1))
def test_split_equals_jax(seed, num):
    jk = jax.random.fold_in(jax.random.PRNGKey(seed), 3)
    want = np.asarray(jax.random.split(jk, num))
    got = R.split(convert.key_to_torch(jk), num)
    assert got.shape == (num, 2) and got.dtype == torch.int64
    np.testing.assert_array_equal(got.numpy().astype(np.uint32), want)


# --------------------------- §6 solvers ------------------------------------ #

@pytest.mark.parametrize("budget", (0.5, 100.0, float(D), float(N * D)))
def test_optimal_probs_close_to_reference(budget):
    (jx, tx), (jm, tm) = _both(XS), _both(MUS)
    want = np.asarray(jopt.optimal_probs(jx, jm, budget))
    got = topt.optimal_probs(tx, tm, budget)
    assert got.dtype == torch.float32 and got.shape == (N, D)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    assert float(got.max()) <= 1.0 and float(got.min()) >= 0.0
    assert float(got.sum()) <= min(budget, N * D) * 1.001


def test_optimal_probs_per_node_close_to_reference():
    (jx, tx), (jm, tm) = _both(XS), _both(MUS)
    budgets = np.linspace(5.0, 40.0, N).astype(np.float32)
    want = np.asarray(jopt.optimal_probs_per_node(jx, jm, jnp.asarray(budgets)))
    got = topt.optimal_probs_per_node(tx, tm, torch.from_numpy(budgets))
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    assert bool((got.sum(1) <= torch.from_numpy(budgets) * 1.01).all())


def test_alternating_minimization_close_to_reference_and_monotone():
    jx, tx = _both(XS)
    jp, jm, _ = jopt.alternating_minimization(jx, float(D), iters=1)
    tp, tm, _ = topt.alternating_minimization(tx, float(D), iters=1)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=0, atol=1e-6)
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), rtol=1e-5, atol=1e-6)
    jp, jm, jtr = jopt.alternating_minimization(jx, float(D))
    tp, tm, ttr = topt.alternating_minimization(tx, float(D))
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=0, atol=5e-4)
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), rtol=0, atol=2e-3)
    np.testing.assert_allclose(ttr.numpy(), np.asarray(jtr), rtol=2e-4)
    tr = ttr.numpy()
    assert tr.shape == (20,) and np.all(tr[1:] <= tr[:-1] * 1.0001), tr


# --------------------------- closed forms ---------------------------------- #

def test_mse_bernoulli_per_coordinate_and_thm61_forms():
    xs = XS.copy()
    xs[:, :7] = MUS[:, None]             # a = 0: p = 0 there, no error (Remark 1)
    (jx, tx), (jm, tm) = _both(xs), _both(MUS)
    p = topt.optimal_probs(tx, tm, 100.0)
    assert bool((p[:, :7] == 0).all())
    jp = jnp.asarray(p.numpy())
    want = float(jmse.mse_bernoulli(jx, jp, jm))
    assert float(tmse.mse_bernoulli(tx, p, tm)) == pytest.approx(want, rel=1e-5)
    assert float(tmse.mse_bernoulli(tx, 0.3, tm)) == pytest.approx(
        float(jmse.mse_bernoulli(jx, 0.3, jm)), rel=1e-5)
    p0 = p.clone()
    p0[0, 10] = 0.0                       # p = 0 where X ≠ μ: infinite error
    assert math.isinf(float(tmse.mse_bernoulli(tx, p0, tm)))
    assert math.isinf(float(jmse.mse_bernoulli(jx, jnp.asarray(p0.numpy()), jm)))
    assert float(tmse.r_factor(tx, tm)) == pytest.approx(float(jmse.r_factor(jx, jm)), rel=1e-5)
    assert float(tmse.heterogeneity(tx)) == pytest.approx(float(jmse.heterogeneity(jx)),
                                                          rel=1e-5)
    for got, want in zip(tmse.thm61_bounds(tx, tm, 100.0), jmse.thm61_bounds(jx, jm, 100.0)):
        assert float(got) == pytest.approx(float(want), rel=1e-5)
    assert float(tmse.thm61_exact_low_budget(tx, tm, 0.5)) == pytest.approx(
        float(jmse.thm61_exact_low_budget(jx, jm, 0.5)), rel=1e-5)
    lo, hi = tmse.thm61_bounds(tx, tm, 100.0)
    assert float(lo) <= float(tmse.mse_bernoulli(tx, p, tm)) <= float(hi)


# --------------------------- costs ----------------------------------------- #

def test_every_cost_branch_equals_reference():
    jp, tp = _both(np.clip(RNG.random((N, D)), 0.01, 1.0).astype(np.float32))
    for proto in ("naive", "varying", "sparse", "sparse_seed", "binary", "ternary"):
        for r in (16, 32):
            js, ts = jt.CommSpec(proto, r_bits=r), tt.CommSpec(proto, r_bits=r)
            kwargs = [{}]
            if proto in ("varying", "sparse"):
                kwargs = [{"probs": (jp, tp)}]
            elif proto == "sparse_seed":
                kwargs = [{"cap": 70}, {"k": 32}, {"p": 1 / 16}]
            elif proto == "binary":
                kwargs = [{}, {"packed": True}]
            elif proto == "ternary":
                kwargs = [{"p": 1 / 16}, {"packed": True, "cap": 70}]
            for kw in kwargs:
                jkw = {k: v[0] if isinstance(v, tuple) else v for k, v in kw.items()}
                tkw = {k: v[1] if isinstance(v, tuple) else v for k, v in kw.items()}
                want = jcost.cost(js, n=N, d=D, **jkw)
                got = tcost.cost(ts, n=N, d=D, **tkw)
                assert got == pytest.approx(want, rel=1e-6), (proto, r, kw)
    assert tcost.ceil_log2(D) == jcost.ceil_log2(D) and tcost.ceil_log2(1) == 1
    with pytest.raises(ValueError, match="needs probs"):
        tcost.cost(tt.CommSpec("sparse"), n=N, d=D)


@pytest.mark.parametrize("kind", ("identity", "bernoulli", "fixed_k", "binary", "ternary"))
@pytest.mark.parametrize("proto", ("naive", "varying", "sparse", "sparse_seed", "binary",
                                   "ternary"))
def test_measure_bits_equals_reference(kind, proto):
    jx, tx = _both(XS[:4])
    jk, tk = _key(3)
    je = jenc.encode_batch(jk, jx, jt.EncoderSpec(kind=kind, fraction=0.25))
    te = tenc.encode_batch(tk, tx, tt.EncoderSpec(kind=kind, fraction=0.25))
    np.testing.assert_array_equal(te.nsent.numpy(), np.asarray(je.nsent))
    assert (tcost.measure_bits(te, tt.CommSpec(proto), D)
            == jcost.measure_bits(je, jt.CommSpec(proto), D))


@pytest.mark.parametrize("name", ("fixed_k_1bit", "bernoulli_seed_1bit", "binary_packed",
                                  "ternary_packed", "ternary_opt", "rotated_binary",
                                  "rotated_fixed_k", "hier_bernoulli"))
def test_cost_config_equals_reference_for_flat_configs(name):
    jcfg = jpreset(name, axes=("data",))     # flat: a hierarchical preset flattens
    cfg = convert.compression_config(jcfg)
    for n, d in ((2, 70_001), (8, 1 << 20)):
        assert tcost.cost_config(cfg, n=n, d=d) == jcost.cost_config(jcfg, n=n, d=d)


def test_cost_config_raises_for_hierarchical_configs():
    """A hierarchical config's cost at its effective node count equals the
    reference's, and needs the mesh sizes as the reference's does.  (The
    name is the one this test had while the port raised here.)"""
    jcfg = jpreset("hier_fixed_k")
    cfg = convert.compression_config(jcfg)
    assert cfg.inner_axes
    for mesh in ({"pod": 4, "data": 2}, {"pod": 2, "data": 3}):
        n = mesh["pod"] * mesh["data"]
        for d in (4096, 70_001):
            assert (tcost.cost_config(cfg, n=n, d=d, mesh_sizes=mesh)
                    == jcost.cost_config(jcfg, n=n, d=d, mesh_sizes=mesh))
    with pytest.raises(ValueError, match="mesh_sizes"):
        tcost.cost_config(cfg, n=8, d=4096)


# --------------------------- decoders -------------------------------------- #

@pytest.mark.parametrize("n", (3, 5, 16))
def test_decoders_equal_reference(n):
    jy, ty = _both(XS[:n])
    got = tdec.averaging_decoder(ty).numpy()
    np.testing.assert_array_equal(got.view(np.int32),
                                  np.asarray(jdec.averaging_decoder(jy)).view(np.int32))
    jm, tm = _both(MUS[:n])
    assert float(tdec.averaging_decoder(tm)) == float(jnp.mean(jm))
    alive = np.arange(n) % 3 != 1
    want = np.asarray(jdec.weighted_partial_decoder(jy, jnp.asarray(alive)))
    got = tdec.weighted_partial_decoder(ty, torch.from_numpy(alive))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-7)
    dead = tdec.weighted_partial_decoder(ty, torch.zeros(n, dtype=torch.bool))
    assert bool((dead == 0).all())         # the denominator is clamped at 1


# --------------------------- MeanEstimator --------------------------------- #

@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_estimate_equals_reference(name):
    je, te = _estimators(name)
    jx, tx = _both(XS)
    jk, tk = _key(1)
    want = je.estimate(jk, jx)
    got = te.estimate(tk, tx)
    assert got.estimate.shape == (D,) and bool(torch.isfinite(got.estimate).all())
    np.testing.assert_allclose(got.estimate.numpy(), np.asarray(want.estimate),
                               rtol=1e-5, atol=1e-5)
    if name in ("identity", "binary"):
        np.testing.assert_array_equal(got.estimate.numpy(), np.asarray(want.estimate))
    assert got.bits == want.bits and got.nsent_total == want.nsent_total
    assert got.expected_bits == pytest.approx(want.expected_bits, rel=1e-6)
    assert got.expected_mse == pytest.approx(want.expected_mse, rel=1e-5, abs=1e-9)


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_empirical_mse_equals_reference(name):
    je, te = _estimators(name)
    jx, tx = _both(XS)
    jk, tk = _key(2)
    want = float(jproto.empirical_mse(jk, jx, je, trials=8))
    got = float(tproto.empirical_mse(tk, tx, te, trials=8))
    assert got == pytest.approx(want, rel=1e-5, abs=1e-9)
    if name == "identity":
        assert got == 0.0


def test_optimal_probs_need_the_sparse_protocol():
    with pytest.raises(ValueError, match="sparse"):
        tproto.MeanEstimator(tt.EncoderSpec(kind="bernoulli", probs="optimal"),
                             tt.CommSpec("sparse_seed"))


def test_optimal_centers_and_probs_policy_equals_reference():
    """center="optimal" with optimal probabilities runs the §6 alternating
    scheme inside ``parameters_for``."""
    spec = {"kind": "bernoulli", "fraction": 1 / 16, "probs": "optimal", "center": "optimal"}
    je = jproto.MeanEstimator(jt.EncoderSpec(**spec), jt.CommSpec("sparse"), float(D))
    te = tproto.MeanEstimator(tt.EncoderSpec(**spec), tt.CommSpec("sparse"), float(D))
    jx, tx = _both(XS)
    jp, jm = je.parameters_for(jx)
    tp, tm = te.parameters_for(tx)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), rtol=0, atol=5e-4)
    np.testing.assert_allclose(tm.numpy(), np.asarray(jm), rtol=0, atol=2e-3)


# --------------------------- entry points ---------------------------------- #

def test_quickstart_rows_on_cpu():
    xs = torch.from_numpy(XS[:4, :64].copy())
    rows = quickstart.run(xs, trials=2)
    assert [r["protocol"] for r in rows] == [c[0] for c in quickstart.configs()]
    for r in rows:
        assert math.isfinite(r["mse_closed"]) and math.isfinite(r["mse_emp"])
        if not r["protocol"].startswith(("log-MSE", "1-bit", "below", "optimal")):
            assert r["measured_bits"] == r["bits"]      # deterministic protocols
    assert rows[0]["mse_closed"] == rows[0]["mse_emp"] == 0.0


def test_federated_round_on_cpu():
    xs = federated_mean.make_data(8, 256, torch.device("cpu"))
    r = federated_mean.straggler_round(xs, R.PRNGKey(0))
    assert r["sum_p"] <= r["budget"] * 1.001
    assert r["elastic_bits"] == r["elastic_expected_bits"]
    assert all(math.isfinite(v) for v in r.values())
    assert federated_mean.main(["--device", "cpu"]) == 0


def test_bench_encode_speed_rows_on_cpu():
    rows = bench_encode_speed.rows(torch.device("cpu"), sizes=(4096, 70_001), reps=1)
    assert [r["name"] for r in rows] == ["encode_speed.d4096", "encode_speed.d70001"]
    assert all(r["check"] and set(r["ms"]) == {"bernoulli", "fixed_k", "binary", "hadamard"}
               for r in rows)
    x = torch.arange(3 * (1 << 20) + 5, dtype=torch.float32)
    assert bench_encode_speed.fwht_input(x).shape == (4, 1 << 20)
