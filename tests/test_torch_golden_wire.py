"""The port's packed wire bytes against the committed golden matrix
(``tests/golden/golden_wire.npz``), built from the inputs of
``tests/golden/regen_golden_wire.py::build_matrix`` (D = 4096, 2 ranks,
x seed 1234, key seed 99).

Every preset must match byte for byte with μ computed by the port itself
(the bf16 wire absorbs the last-bit differences of the mean on this input;
the binary and ternary planes center at min/max, exact on both sides).
The ``ef_*`` presets pack their contractive twin at zero residual; the
2-means centers and the ternary twin's mean are the port's fixed-order sums,
whose last-bit differences from ``jnp.sum`` the bf16 wire absorbs here too.
"""
import pathlib
import sys

import jax
import numpy as np
import pytest
import torch

from repro.configs import registry as jregistry
from repro_torch import convert
from repro_torch import random as R
from repro_torch.configs import registry as tregistry
from repro_torch.core import wire as twire

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent / "golden"))
import regen_golden_wire as regen  # noqa: E402

# one intra-op thread: beside other test workers on a loaded machine, torch's
# thread pool stalls for tens of seconds
torch.set_num_threads(1)

PORTED = ("fixed_k_1bit", "bernoulli_seed_1bit", "hier_fixed_k", "hier_bernoulli",
          "binary_packed", "ternary_packed", "ternary_opt", "rotated_binary",
          "rotated_fixed_k", "ef_fixed_k", "ef_bernoulli", "ef_binary", "ef_ternary",
          "ef_rotated_binary")
# the port's buffer dtype for each wire dtype the golden matrix records
# (packed planes are uint32 words, held as int32 bit patterns)
BUFFER_DTYPE = {"bfloat16": torch.bfloat16, "uint32": torch.int32}


@pytest.fixture(scope="module")
def golden():
    with np.load(regen.GOLDEN) as z:
        return {k: z[k] for k in z.files}


@pytest.fixture(scope="module")
def xs():
    with jax.threefry_partitionable(False):
        return np.asarray(jax.random.normal(
            jax.random.PRNGKey(regen.X_SEED), (regen.N_RANKS, regen.D)) * 0.5)


def test_preset_tables_agree():
    assert sorted(tregistry.COMPRESSION_PRESETS) == sorted(jregistry.COMPRESSION_PRESETS)
    assert sorted(PORTED) == sorted(jregistry.COMPRESSION_PRESETS)
    for name, cfg in jregistry.COMPRESSION_PRESETS.items():
        assert convert.compression_config(cfg) == tregistry.COMPRESSION_PRESETS[name]
        assert (convert.compression_config(jregistry.compression_preset(name, axes=("data",)))
                == tregistry.compression_preset(name, axes=("data",)))


@pytest.mark.parametrize("name", PORTED)
def test_ported_preset_bytes_match_golden(name, golden, xs):
    cfg = tregistry.compression_preset(name, axes=("data",))
    codec = twire.resolve(cfg)
    key = R.PRNGKey(regen.KEY_SEED)
    rows = []
    for r in range(regen.N_RANKS):
        buf = codec.pack(torch.from_numpy(np.array(xs[r])), key, r, cfg)
        rows.append(buf.contiguous().view(torch.uint8).numpy())
    dtype = BUFFER_DTYPE[str(golden[f"{name}.dtype"])]
    assert buf.dtype == dtype and cfg.wire_dtype == "bfloat16"
    assert (int(golden[f"{name}.slots"]) == codec.wire_slots(regen.D, cfg)
            == rows[0].size // dtype.itemsize)
    np.testing.assert_array_equal(np.stack(rows), golden[f"{name}.bytes"])


def _padded_tree_sum(x):
    """Σ x over 2^K zero-padded leaves, each level adding its upper half
    onto its lower half, a node whose partner is padding passing through; in
    numpy f32."""
    v = x.copy()
    while v.size > 1:
        h = 1 << ((v.size - 1).bit_length() - 1)
        v = np.concatenate([v[:v.size - h] + v[h:], v[v.size - h:h]])
    return v[0]


@pytest.mark.parametrize("d", (1, 2, 3, 4, 5, 6, 8, 11, 4097, 6145, 70_001, regen.D))
def test_mean_center_is_the_padded_pairwise_tree(d):
    """The wire's ``mean`` center: the tree sum of x zero-padded to a power
    of two, times f32(1/d); each step one IEEE f32 operation, so the card
    computes the same bits (``tests/test_torch_kernels_cuda.py -k gauss``)."""
    x = (np.random.default_rng(d).standard_normal(d) * 0.5 + 0.01).astype(np.float32)
    got = twire.base.center(torch.from_numpy(x), "mean")
    assert got.dtype == torch.float32 and got.dim() == 0
    want = _padded_tree_sum(x) * np.float32(1.0 / d)
    assert np.float32(got.item()).view(np.uint32) == np.float32(want).view(np.uint32)
