"""The port's plain bit-plane functions against the JAX package's
``kernels/bitplane`` Pallas kernels (interpret mode, ``force_pallas=True``)
and ``core/bitplane`` float↔word helpers, bit for bit.

Words are compared as bytes: the port holds the reference's uint32 words
as int32 bit patterns.  Symbols come from numpy seeds; random high bits
above the field width check the masking.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bitplane as jbp
from repro.kernels.bitplane import ops as jops
from repro_torch.core import bitplane as tbp
from repro_torch.kernels.bitplane import ops as tops
from repro_torch.kernels.bitplane import ref as tref

DS = (1, 31, 33, 4099, 70_001)

# the reference's float/word helpers, compiled once per shape and wire dtype
_to_words = jax.jit(jbp.floats_to_words, static_argnums=1)
_to_floats = jax.jit(jbp.words_to_floats, static_argnums=(1, 2))


def _symbols(seed, d, width, noise=False):
    rng = np.random.default_rng(seed)
    v = rng.integers(0, 1 << width, d, dtype=np.uint32)
    if noise:
        v |= rng.integers(0, 1 << 14, d, dtype=np.uint32) << np.uint32(width)
    return v


def _port_symbols(v, width):
    """The port's symbol tensor: uint8 up to 8 bits, else int32 bit patterns."""
    if width <= 8 and v.max(initial=0) < 256:
        return torch.from_numpy(v.astype(np.uint8))
    return torch.from_numpy(v.view(np.int32))


@pytest.mark.parametrize("d", DS)
@pytest.mark.parametrize("width", tref.WIDTHS)
def test_pack_matches_pallas(d, width):
    v = _symbols(d * 7 + width, d, width, noise=True)
    want = np.asarray(jops.pack_bits(jnp.asarray(v), width, force_pallas=True))
    got = tops.pack_bits(_port_symbols(v, width), width)
    assert got.dtype == torch.int32 and got.shape == (tops.num_words(d, width),)
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)
    clean = _symbols(d * 7 + width, d, width)
    np.testing.assert_array_equal(tops.pack_bits(_port_symbols(clean, width), width).numpy()
                                  .view(np.uint32), want)


@pytest.mark.parametrize("d", DS)
@pytest.mark.parametrize("width", tref.WIDTHS)
def test_unpack_matches_pallas(d, width):
    nw = tops.num_words(d, width)
    words = np.random.default_rng(d + width).integers(0, 1 << 32, nw + 3, dtype=np.uint32)
    want = np.asarray(jops.unpack_bits(jnp.asarray(words), width, d, force_pallas=True))
    got = tops.unpack_bits(torch.from_numpy(words.view(np.int32)), width, d)
    assert got.dtype == tref.symbol_dtype(width) and got.shape == (d,)
    np.testing.assert_array_equal(got.numpy().astype(np.uint32), want)


def test_pack_bool_symbols_equal_uint8():
    bits = np.random.default_rng(5).integers(0, 2, 1000).astype(bool)
    a = tops.pack_bits(torch.from_numpy(bits), 1)
    b = tops.pack_bits(torch.from_numpy(bits.astype(np.uint8)), 1)
    assert torch.equal(a, b)
    assert torch.equal(tops.unpack_bits(a, 1, 1000), torch.from_numpy(bits.astype(np.uint8)))


@pytest.mark.parametrize("n", (1, 3, 8))
@pytest.mark.parametrize("d", (33, 4099))
def test_binary_accum_matches_pallas(n, d):
    rng = np.random.default_rng(100 * n + d)
    nw = tops.num_words(d, 1)
    words = rng.integers(0, 1 << 32, (n, nw), dtype=np.uint32)
    c = (rng.standard_normal((n, 2)) * 0.3).astype(np.float32)
    c[:, 1] = np.abs(c[:, 1]) + c[:, 0]
    want = np.asarray(jops.binary_accum(jnp.asarray(words), jnp.asarray(c[:, 0]),
                                        jnp.asarray(c[:, 1]), d, force_pallas=True))
    got = tops.binary_accum(torch.from_numpy(words.view(np.int32)),
                            torch.from_numpy(c[:, 0]), torch.from_numpy(c[:, 1]), d)
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want.view(np.uint32))


def test_binary_accum_of_a_strided_window():
    """A word window of the gathered rows (a view, rows strided) decodes as
    its contiguous copy does."""
    rng = np.random.default_rng(9)
    rows = torch.from_numpy(rng.integers(0, 1 << 32, (4, 200), dtype=np.uint32).view(np.int32))
    lo, hi = torch.tensor([0.1, -0.2, 0.3, 0.0]), torch.tensor([0.5, 0.25, 1.0, 2.0])
    win = rows[:, 40:90]
    assert not win.is_contiguous()
    assert torch.equal(tops.binary_accum(win, lo, hi, 1600),
                       tops.binary_accum(win.contiguous(), lo, hi, 1600))


@pytest.mark.parametrize("wire", ("float32", "bfloat16", "float16"))
@pytest.mark.parametrize("m", (1, 2, 7, 1000))
def test_float_words_round_trip_match(wire, m):
    v = (np.random.default_rng(m).standard_normal(m) * 10.0).astype(np.float32)
    want = np.asarray(_to_words(jnp.asarray(v), jnp.dtype(wire)))
    got = tbp.floats_to_words(torch.from_numpy(v), wire)
    assert tbp.float_words(m, wire) == jbp.float_words(m, jnp.dtype(wire)) == got.shape[0]
    np.testing.assert_array_equal(got.numpy().view(np.uint32), want)
    back_want = np.asarray(_to_floats(jnp.asarray(want), m, jnp.dtype(wire)))
    back = tbp.words_to_floats(got, m, wire)
    np.testing.assert_array_equal(back.numpy().view(np.uint32), back_want.view(np.uint32))
    if wire == "float32":
        np.testing.assert_array_equal(back.numpy(), v)


def test_wire_word_counts_match():
    for d in (1, 33, 4099, 388_956_160):
        for wire in ("float32", "bfloat16"):
            cap = d // 10 + 1
            assert tbp.binary_wire_words(d, wire) == jbp.binary_wire_words(d, jnp.dtype(wire))
            assert (tbp.ternary_wire_words(d, cap, wire)
                    == jbp.ternary_wire_words(d, cap, jnp.dtype(wire)))
    assert (tbp.BINARY_ALIGN, tbp.TERNARY_ALIGN) == (jbp.BINARY_ALIGN, jbp.TERNARY_ALIGN)
