"""The port's bit accounting and closed-form MSE against the JAX package:
``bernoulli_capacity``, each ported codec's ``wire_slots`` / ``wire_bits`` /
``seed_bits`` / ``scatter_bits`` / ``comm_cost_bits`` (exact), and the
Lemma 3.2 and shared-support fixed-k closed forms (f32 rounding of the
sums: both sides sum in f32, in different orders)."""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.registry import compression_preset as jpreset
from repro.core import comm_cost as jcost
from repro.core import mse as jmse
from repro.core import wire as jwire
from repro_torch import convert
from repro_torch.core import comm_cost as tcost
from repro_torch.core import mse as tmse
from repro_torch.core import wire as twire

# one intra-op thread: beside other test workers on a loaded machine, torch's
# thread pool stalls for tens of seconds
torch.set_num_threads(1)

DS = (1, 1000, 4096, 70_001, 388_956_160)


def _configs():
    bern = jpreset("bernoulli_seed_1bit", axes=("data",))
    fk = jpreset("hier_fixed_k", axes=("data",))
    return [bern, dataclasses.replace(bern, scatter_decode=False), fk,
            dataclasses.replace(fk, scatter_decode=False),
            jpreset("fixed_k_1bit", axes=("data",)),
            dataclasses.replace(bern, wire_dtype="float32"),
            jpreset("binary_packed", axes=("data",)),
            dataclasses.replace(jpreset("binary_packed", axes=("data",)), wire_dtype="float32"),
            jpreset("ternary_packed", axes=("data",)),
            dataclasses.replace(jpreset("ternary_packed", axes=("data",)),
                                scatter_decode=False, wire_dtype="float32"),
            jpreset("ternary_opt", axes=("data",)),
            dataclasses.replace(bern, mode="dense_sim", scatter_decode=False)]


@pytest.mark.parametrize("p", (1 / 16, 0.3, 1.0))
def test_bernoulli_capacity_matches(p):
    for d in DS:
        assert tcost.bernoulli_capacity(d, p) == jcost.bernoulli_capacity(d, p)


@pytest.mark.parametrize("i", range(len(_configs())))
def test_codec_accounting_matches(i):
    jcfg = _configs()[i]
    cfg = convert.compression_config(jcfg)
    jc, tc = jwire.resolve(jcfg), twire.resolve(cfg)
    assert (tc.name, tc.reduce, tc.scatter_supported) == (jc.name, jc.reduce, jc.scatter_supported)
    assert twire.scatter_word_align(cfg) == tc.scatter_align(cfg) == jc.scatter_align(jcfg)
    for d in DS:
        for n in (2, 8):
            assert tc.wire_slots(d, cfg) == jc.wire_slots(d, jcfg)
            assert tc.wire_bits(n, d, cfg) == jc.wire_bits(n, d, jcfg)
            assert tc.seed_bits(n, cfg) == jc.seed_bits(n, jcfg)
            assert tc.scatter_bits(n, d, cfg) == jc.scatter_bits(n, d, jcfg)
            assert tc.comm_cost_bits(n, d, cfg) == jc.comm_cost_bits(n, d, jcfg)
            assert tc.comm_cost_bits(n, d, cfg) == tc.wire_bits(n, d, cfg) + tc.seed_bits(n, cfg)


def test_closed_forms_match():
    rng = np.random.default_rng(0)
    xs = (rng.standard_normal((8, 50_000)) * 0.1 + rng.standard_normal((1, 50_000)) * 0.2
          + np.arange(8)[:, None] * 1e-3).astype(np.float32)
    mus = xs.mean(axis=1)
    jx, tx = jnp.asarray(xs), torch.from_numpy(xs)
    want = float(jmse.mse_bernoulli(jx, 1 / 16, jnp.asarray(mus)))
    got = float(tmse.mse_bernoulli(tx, 1 / 16, torch.from_numpy(mus)))
    assert got == pytest.approx(want, rel=1e-5)
    want = float(jmse.mse_fixed_k_shared(jx, 3072, jnp.asarray(mus)))
    got = float(tmse.mse_fixed_k_shared(tx, 3072, torch.from_numpy(mus)))
    assert got == pytest.approx(want, rel=1e-5)
