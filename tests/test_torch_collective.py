"""The port's compressed-mean round on ``StackedComm`` against the JAX
package's meshless round, bit for bit, plus ``DistComm`` rounds over gloo.

Both sides get the same μ.  μ = mean(x) is not bit-reproducible across
frameworks: jnp's CPU mean multiplies the sum by the f32 reciprocal of d,
torch's divides, and their summation orders differ.  So the inputs lie on
a 2⁻⁶ grid (every partial sum exact in f32, hence the same sum on both
sides) and the port's center is computed here the reference's way, sum ×
(1/d); the test asserts that this equals jnp's μ exactly.  The port's own
μ is held to jnp's separately, within a stated tolerance
(:func:`test_port_mean_close_to_reference_mean`).

* gather codecs (``fixed_k``, ``bernoulli``), flat decode: equal to the
  reference's ``decode_gathered`` over the stacked packs
  (tests/conftest.py::simulate_wire_round);
* the same with the §12 scatter decode: fixed-k equal to the reference's
  ``decode_gathered_shard`` concatenated, Bernoulli equal to the
  reference's flat decode (its shard decode equals its flat decode);
* ``fixed_k_1bit`` (psum): equal to the reference's ``decode_reduced`` of
  the rank-order f32 mean of its pack buffers, rounded once to bf16.

``DistComm``'s psum gathers the buffers and sums them in f32 from 0 in
rank order, as ``StackedComm`` does, so the fixed-k round over gloo equals
the stacked one bit for bit at n = 2, 3 and 4
(:func:`test_distcomm_gloo_fixed_k_psum_equals_stacked`), and so do the f32
psums of an exact bucket and of the dense simulation on Gaussian inputs at
n = 3 and 4 (:func:`test_distcomm_gloo_f32_psum_equals_stacked`); the older bound
of a bf16 all-reduce's rounding still holds at 4
(:func:`test_distcomm_gloo_world_size_4_fixed_k_within_bf16_rounding`).
The gather rounds over gloo (Bernoulli, binary and ternary, the latter
with its pass-through count exchange) equal the stacked ones bit for bit.
"""
import dataclasses
import json
import pathlib
import socket
import subprocess
import sys
import tempfile
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import compression_preset as jpreset
from repro.core import wire as jwire
from repro_torch import convert
from repro_torch import random as R
from repro_torch.configs.registry import compression_preset as tpreset
from repro_torch.core import collectives as tcoll
from repro_torch.core.wire import base as tbase
from repro_torch.core.wire import registry as tregistry

# one intra-op thread: beside other test workers on a loaded machine, torch's
# thread pool stalls for tens of seconds
torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent
D = 20_011
KEY_SEED = 99


def _xs(n, d, seed):
    rng = np.random.default_rng(seed)
    x = np.round(rng.standard_normal((n, d)) * 32) / 64
    x += (np.arange(n)[:, None] - n / 2) / 64
    return x.astype(np.float32)


def _configs():
    # D sits below the presets' min_compress_size: compress every bucket
    bern = dataclasses.replace(jpreset("bernoulli_seed_1bit", axes=("data",)),
                               min_compress_size=1)
    fk = dataclasses.replace(jpreset("hier_fixed_k", axes=("data",)), min_compress_size=1)
    return {
        "fixed_k_gather_flat": dataclasses.replace(fk, scatter_decode=False),
        "fixed_k_gather_scatter": fk,
        "bernoulli_flat": dataclasses.replace(bern, scatter_decode=False),
        "bernoulli_scatter": bern,
        "fixed_k_1bit": dataclasses.replace(jpreset("fixed_k_1bit", axes=("data",)),
                                            min_compress_size=1),
    }


def reference_round(xs, key, jcfg):
    """The reference's meshless round over the (n, d) stack: pack per rank,
    then the rank-order f32 mean of the buffers rounded once to the wire
    dtype and ``decode_reduced`` (psum codecs), or the shard decodes
    concatenated (fixed-k scatter), or ``decode_gathered`` of the stacked
    rows (its scatter decode equals it).

    It runs op by op, as the golden wire bytes were made: under ``jit`` XLA
    on the CPU contracts array multiply-adds into FMAs and turns a division
    by a constant n into a multiplication, which moves last bits of the
    reference itself (ROADMAP.md queue 3)."""
    n, d = xs.shape
    codec = jwire.resolve(jcfg)
    bufs = [codec.pack(xs[r], key, r, jcfg) for r in range(n)]
    if codec.reduce == "psum":
        acc = jnp.zeros(bufs[0].shape, jnp.float32)
        for b in bufs:
            acc = acc + b.astype(jnp.float32)
        return codec.decode_reduced((acc / n).astype(bufs[0].dtype), key, jcfg, d)
    rows = jnp.stack(bufs)
    if jcfg.scatter_decode and codec.name == "fixed_k":
        parts = [codec.decode_gathered_shard(rows, key, jcfg, d, n, s, n) for s in range(n)]
        return jnp.concatenate(parts)[:d]
    return codec.decode_gathered(rows, key, jcfg, d, n)


def _jax_round(jcfg, xs):
    with jax.threefry_partitionable(False):
        mus = [float(jnp.mean(jnp.asarray(x))) for x in xs]
        out = reference_round(jnp.asarray(xs), jax.random.PRNGKey(KEY_SEED), jcfg)
        return np.asarray(out), mus


def _reference_style_center(x, policy):
    """μ as the reference's jnp.mean computes it on the CPU: sum × f32(1/d)."""
    assert policy == "mean"
    return torch.sum(x) * torch.tensor(np.float32(1.0) / np.float32(x.numel()))


@pytest.mark.parametrize("n", (2, 5, 8))
@pytest.mark.parametrize("name", sorted(_configs()))
def test_stacked_round_equals_reference(name, n, monkeypatch):
    jcfg = _configs()[name]
    xs = _xs(n, D, seed=n)
    want, jmus = _jax_round(jcfg, xs)
    x = torch.from_numpy(xs)
    tmus = [float(_reference_style_center(x[r], "mean")) for r in range(n)]
    assert tmus == jmus
    monkeypatch.setattr(tbase, "center", _reference_style_center)
    cfg = convert.compression_config(jcfg)
    comm = tcoll.StackedComm(n, "cpu")
    got = tcoll.compressed_mean(x, R.PRNGKey(KEY_SEED), cfg, comm).numpy()
    np.testing.assert_array_equal(got, want)
    assert np.isfinite(got).all()


@pytest.mark.parametrize("d", (4096, 70001, 1 << 20))
def test_port_mean_close_to_reference_mean(d):
    """The port's own μ (torch.mean) against jnp.mean: they may differ in
    the last bits; the difference stays within 4 f32 epsilons of mean|x|
    (measured at most 2.7 over 90 draws at these d)."""
    for seed, off in ((0, 0.0), (1, 0.5), (2, -3.0)):
        x = (np.random.default_rng(seed).standard_normal(d) + off).astype(np.float32)
        want = float(jnp.mean(jnp.asarray(x)))
        got = float(tbase.center(torch.from_numpy(x), "mean"))
        assert abs(got - want) <= 4 * 2.0 ** -23 * float(np.abs(x).mean())


@pytest.mark.parametrize("name", ("bernoulli_scatter", "fixed_k_1bit"))
def test_stacked_bytes_match_accounting(name):
    n = 8
    cfg = convert.compression_config(_configs()[name])
    comm = tcoll.StackedComm(n, "cpu")
    tcoll.compressed_mean(torch.from_numpy(_xs(n, D, 3)), R.PRNGKey(1), cfg, comm)
    from repro_torch.core import wire
    codec = wire.resolve(cfg)
    bits = codec.wire_bits(n, D, cfg) + codec.scatter_bits(n, D, cfg)
    sent = comm.bytes_gathered if codec.reduce == "all_gather" else comm.bytes_reduced
    assert sent * 8 == bits
    assert comm.bytes_gathered + comm.bytes_reduced == sent


def test_exact_and_partial_mean():
    xs = torch.from_numpy(_xs(4, 1000, 5))
    comm = tcoll.StackedComm(4, "cpu")
    cfg = convert.compression_config(jpreset("fixed_k_1bit", axes=("data",)))
    small = tcoll.compressed_mean(xs, R.PRNGKey(0), cfg, comm)   # below min_compress_size
    want = ((xs[0] + xs[1]) + xs[2] + xs[3]) / 4
    assert torch.equal(small, want)
    alive = torch.tensor([1.0, 0.0, 1.0, 1.0])
    part = tcoll.partial_mean(xs, alive, comm)
    assert torch.equal(part, ((xs[0] + xs[2]) + xs[3]) / 3)
    assert torch.isnan(tcoll.partial_mean(xs, torch.zeros(4), comm)).all()


_WORKER = r"""
import json, sys, numpy as np, torch, torch.distributed as dist
sys.path.insert(0, sys.argv[1])
from repro_torch import random as R
from repro_torch.configs.registry import compression_preset
from repro_torch.core.collectives import DistComm, compressed_mean
import dataclasses
import datetime
rank, port, out, world = int(sys.argv[2]), sys.argv[3], sys.argv[4], int(sys.argv[5])
dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", world_size=world,
                        rank=rank, timeout=datetime.timedelta(seconds=float(sys.argv[6])))
xs = torch.from_numpy(np.load(out + "/xs.npy"))
for name, (preset, scatter, *mode) in json.load(open(out + "/cfgs.json")).items():
    cfg = dataclasses.replace(compression_preset(preset, axes=("data",)),
                              scatter_decode=scatter, min_compress_size=1)
    if mode:
        cfg = dataclasses.replace(cfg, mode=mode[0])
    comm = DistComm(device="cpu")
    y = compressed_mean(xs[rank:rank + 1], R.PRNGKey(7), cfg, comm)
    np.save(f"{out}/{name}.{rank}.npy", y.numpy())
    np.save(f"{out}/{name}.{rank}.bytes.npy", np.array([comm.bytes_gathered, comm.bytes_reduced]))
dist.destroy_process_group()
"""


# the rounds the gloo workers run: name -> (preset, scatter_decode); the
# inputs sit below min_compress_size, which both sides set to 1
GLOO_ROUNDS = {"bernoulli_scatter": ("bernoulli_seed_1bit", True),
               "bernoulli_flat": ("bernoulli_seed_1bit", False),
               "fixed_k_1bit": ("fixed_k_1bit", False),
               "binary_scatter": ("binary_packed", True),
               "ternary_scatter": ("ternary_packed", True)}


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


# Each gloo worker passes GLOO_INIT_TIMEOUT_S to init_process_group: a
# rendezvous that cannot complete (the port taken, or another group's store
# reached on it) and any collective then fail within it, not after PyTorch's
# default 30 minutes.  Alone on an 8-core machine a world of these tests
# takes 6-15 s, start to end.
GLOO_INIT_TIMEOUT_S = 60
GLOO_WAIT_S = 90


class GlooWorld:
    """The processes of one gloo group, ``argv(port)`` their command lines
    (one a rank) and ``env`` their environment (or ``env(port, rank)``),
    started at once on a port from :func:`_free_port`.  That function
    closes its socket before rank 0's store binds the port, so another
    group of a parallel test run can take it in between: a world whose
    failed rank failed inside ``init_process_group`` (its traceback runs
    through it) is started once more on a fresh port.  Any other failure
    fails at once; a rank's failure kills the ranks still running, which
    would otherwise wait for it until their timeout."""

    def __init__(self, argv, env=None):
        self.argv, self.env, self.outputs = argv, env, []
        self._start()

    def _start(self):
        port = str(_free_port())
        env = self.env if callable(self.env) else lambda port, rank: self.env
        self.files = [(tempfile.TemporaryFile("w+"), tempfile.TemporaryFile("w+"))
                      for _ in range(len(self.argv(port)))]
        self.procs = [subprocess.Popen(a, stdout=o, stderr=e, text=True, env=env(port, r))
                      for r, (a, (o, e)) in enumerate(zip(self.argv(port), self.files))]

    def _wait(self, timeout):
        """Every rank's (stdout, stderr) once all have exited or one has
        failed; raises ``TimeoutExpired`` after ``timeout`` seconds."""
        end = time.monotonic() + timeout
        while (any(p.poll() is None for p in self.procs)
               and not any(p.returncode for p in self.procs)):
            if time.monotonic() > end:
                self._kill()
                raise subprocess.TimeoutExpired(self.procs[0].args, timeout)
            time.sleep(0.05)
        self._kill()
        outs = []
        for o, e in self.files:
            outs.append(tuple(f.seek(0) or f.read() for f in (o, e)))
            o.close()
            e.close()
        self.outputs.append(outs)
        return outs

    def _kill(self):
        for p in self.procs:
            if p.poll() is None:
                p.kill()
            p.wait()

    def wait(self, timeout: float = GLOO_WAIT_S):
        """Each rank's (stdout, stderr), once every rank has exited 0."""
        outs = self._wait(timeout)
        if any(p.returncode for p in self.procs) and any(
                "in init_process_group" in err for _, err in outs):
            self._start()
            outs = self._wait(timeout)
        assert not any(p.returncode for p in self.procs), "\n".join(
            f"attempt {i}, rank {r}:\n{o}{e}" for i, att in enumerate(self.outputs)
            for r, (o, e) in enumerate(att))
        return outs


# f32 psums on Gaussian inputs, where every partial sum rounds and the order
# of the adds shows: an exact bucket (mode "none") and the dense simulation
# (an f32 wire); name -> (preset, scatter_decode, mode)
F32_ROUNDS = {"exact": ("fixed_k_1bit", False, "none"),
              "dense_sim": ("bernoulli_seed_1bit", False, "dense_sim")}


def _round_cfg(preset, scatter, mode=None):
    cfg = dataclasses.replace(tpreset(preset, axes=("data",)), scatter_decode=scatter,
                              min_compress_size=1)
    return cfg if mode is None else dataclasses.replace(cfg, mode=mode)


def _gloo_rounds(tmp_path, world, rounds=GLOO_ROUNDS, gauss=False):
    """Runs the worker in ``world`` gloo processes over ``rounds`` (on
    2⁻⁶-grid inputs, or Gaussian ones); returns the inputs and, per config,
    the StackedComm round over the same stack."""
    xs = (np.random.default_rng(13).standard_normal((world, 20_000)).astype(np.float32)
          if gauss else _xs(world, 20_000, 11))
    np.save(tmp_path / "xs.npy", xs)
    (tmp_path / "cfgs.json").write_text(json.dumps(rounds))
    GlooWorld(lambda port: [[sys.executable, "-c", _WORKER, str(ROOT / "src"), str(r), port,
                             str(tmp_path), str(world), str(GLOO_INIT_TIMEOUT_S)]
                            for r in range(world)]).wait()
    stacked = {}
    for name, spec in rounds.items():
        cfg = _round_cfg(*spec)
        comm = tcoll.StackedComm(world, "cpu")
        want = tcoll.compressed_mean(torch.from_numpy(xs), R.PRNGKey(7), cfg, comm).numpy()
        stacked[name] = (cfg, want, comm)
        for r in range(world):
            g, red = np.load(tmp_path / f"{name}.{r}.bytes.npy")
            assert world * g == comm.bytes_gathered and world * red == comm.bytes_reduced
    return xs, stacked


def test_distcomm_gloo_world_size_2_equals_stacked(tmp_path):
    _, stacked = _gloo_rounds(tmp_path, 2)
    for name, (_, want, _) in stacked.items():
        for r in range(2):
            np.testing.assert_array_equal(np.load(tmp_path / f"{name}.{r}.npy"), want)


@pytest.mark.parametrize("n", [3, 4])
def test_distcomm_gloo_fixed_k_psum_equals_stacked(tmp_path, n):
    """The psum round (``fixed_k_1bit``) at n > 2: DistComm gathers the bf16
    buffers and sums them in f32 in rank order, as StackedComm does, so
    every rank holds StackedComm's result bit for bit (and hence the
    reference's, :func:`test_stacked_round_equals_reference`)."""
    _, stacked = _gloo_rounds(tmp_path, n, {"fixed_k_1bit": GLOO_ROUNDS["fixed_k_1bit"]})
    for r in range(n):
        np.testing.assert_array_equal(np.load(tmp_path / f"fixed_k_1bit.{r}.npy"),
                                      stacked["fixed_k_1bit"][1])


@pytest.fixture(scope="module", params=[3, 4], ids=lambda n: f"n{n}")
def f32_gloo(request, tmp_path_factory):
    tmp = tmp_path_factory.mktemp(f"f32_gloo_{request.param}")
    xs, stacked = _gloo_rounds(tmp, request.param, F32_ROUNDS, gauss=True)
    return request.param, tmp, xs, stacked


@pytest.mark.parametrize("name", sorted(F32_ROUNDS))
def test_distcomm_gloo_f32_psum_equals_stacked(f32_gloo, name):
    """An f32 psum over gloo (the exact mean of an exact bucket, the dense
    simulation's f32 wire) on Gaussian inputs: DistComm gathers the rows and
    sums them in rank order from +0.0, so every rank holds StackedComm's
    result bit for bit.  The inputs make the order matter: the reverse
    order's sum differs."""
    n, tmp, xs, stacked = f32_gloo
    want = stacked[name][1]
    for r in range(n):
        np.testing.assert_array_equal(np.load(tmp / f"{name}.{r}.npy"), want)
    if name == "exact":
        x = torch.from_numpy(xs)
        backwards = tcoll._rank_order_sum(x.flip(0))
        assert not torch.equal(backwards, tcoll._rank_order_sum(x))


def test_distcomm_gloo_world_size_4_fixed_k_within_bf16_rounding(tmp_path):
    """Gather rounds stay bit-equal at n = 4.  The psum round differs from
    StackedComm's only by the bf16 rounding of the backend's running sum:
    with S = Σ b_i and A = Σ |b_i| over the ranks' bf16 buffers and u =
    2⁻⁸, n − 1 bf16 adds put the reduced mean within (n − 1)·u·A/n of S/n,
    StackedComm's single rounding within u·|S|/n (plus f32 adds, below
    n·2⁻²⁴·A/n).  The decode adds the μ slot's bound to each value's, and
    each side rounds that add once (2⁻²³ of the result)."""
    n = 4
    xs, stacked = _gloo_rounds(tmp_path, n)
    for name in GLOO_ROUNDS:
        if name == "fixed_k_1bit":
            continue
        for r in range(n):
            np.testing.assert_array_equal(np.load(tmp_path / f"{name}.{r}.npy"),
                                          stacked[name][1])
    cfg, want, _ = stacked["fixed_k_1bit"]
    codec = tregistry.resolve(cfg)
    x = torch.from_numpy(xs)
    bufs = torch.stack([codec.pack(x[i], R.PRNGKey(7), i, cfg) for i in range(n)]).float()
    u = 2.0 ** -8
    a, s = bufs.abs().sum(0), bufs.sum(0)
    tol_wire = (u * ((n - 1) * a + s.abs()) + 2.0 ** -24 * n * a) / n
    tol = codec.decode_reduced(tol_wire, R.PRNGKey(7), cfg, xs.shape[1]).numpy()
    tol = tol + 2.0 ** -23 * np.abs(want)
    for r in range(n):
        got = np.load(tmp_path / f"fixed_k_1bit.{r}.npy")
        np.testing.assert_array_equal(got, np.load(tmp_path / "fixed_k_1bit.0.npy"))
        assert np.all(np.abs(got - want) <= tol)

