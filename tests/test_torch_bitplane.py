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

# one intra-op thread: beside other test workers on a loaded machine, torch's
# thread pool stalls for tens of seconds
torch.set_num_threads(1)

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


# The card's unpack and binary accumulate (csrc/bitplane.cu) take blocks of
# UNPACK_TILE 16-byte items and of ACC_TILE words (32 coordinates each),
# peers staged ACC_PEERS at a time; the sizes below sit on those edges.
UNPACK_TILE = 256 * 4
ACC_TILE = 256
ACC_PEERS = 8


def _unpack_edges(width):
    """d at one unpack block's symbols, ± 1, ± 32/w, and two blocks + 17."""
    blk = UNPACK_TILE * 16 // tref.symbol_dtype(width).itemsize
    per = 32 // width
    return (blk, blk - 1, blk + 1, blk - per, blk + per, 2 * blk + 17)


def _spread4(n, width):
    """The kernel's spread of four w-bit symbols (the low 4w bits of n) into
    the four bytes of a word, in uint32 arithmetic."""
    if width == 1:
        return ((n & np.uint32(0xF)) * np.uint32(0x00204081)) & np.uint32(0x01010101)
    if width == 2:
        x = n & np.uint32(0xFF)
        x |= x << np.uint32(6)
        x |= x << np.uint32(12)
        return x & np.uint32(0x03030303)
    if width == 4:
        x = (n & np.uint32(0xFF)) | ((n & np.uint32(0xFF00)) << np.uint32(8))
        return (x | (x << np.uint32(4))) & np.uint32(0x0F0F0F0F)
    return n


def _item_unpack_model(words, width, d):
    """A numpy model of the card's unpack: item i is the 16 bytes of symbols
    [i·s, (i + 1)·s) (s = 16 uint8 or 4 int32 symbols) from the words at bit
    i·s·w on; the last, partial item symbol by symbol."""
    dt = np.uint8 if width <= 8 else np.int32
    s = 16 // np.dtype(dt).itemsize
    full = d // s
    i = np.arange(full, dtype=np.int64)
    first = (i * s * width) >> 5
    u = [words[np.minimum(first + q, words.size - 1)] for q in range(-(-s * width // 32))]
    sh = np.uint32
    if width == 16:
        lanes = [u[0] & sh(0xFFFF), u[0] >> sh(16), u[1] & sh(0xFFFF), u[1] >> sh(16)]
    elif width == 1:
        h = u[0] >> (sh(16) * (i & 1).astype(np.uint32))
        lanes = [_spread4(h >> sh(4 * q), 1) for q in range(4)]
    elif width == 2:
        lanes = [_spread4(u[0] >> sh(8 * q), 2) for q in range(4)]
    elif width == 4:
        lanes = [_spread4(u[0], 4), _spread4(u[0] >> sh(16), 4), _spread4(u[1], 4),
                 _spread4(u[1] >> sh(16), 4)]
    else:
        lanes = u
    body = np.stack(lanes, axis=1).astype(np.uint32).reshape(-1).view(dt)
    per = 32 // width
    j = np.arange(full * s, d)
    tail = (words[j // per] >> ((j % per) * width).astype(np.uint32)) & sh((1 << width) - 1)
    return np.concatenate([body, tail.astype(dt)])


def _tile_accum_model(words, c_lo, c_hi, d):
    """A numpy model of the card's binary accumulate: tiles of ACC_TILE
    words, peers in chunks of ACC_PEERS, thread t's group g (the float4 at
    coordinate 32·w0 + 4(t + 256g)) read from word (t >> 3) + 32g at nibble
    t & 7; f32 adds peer by peer from 0."""
    n = words.shape[0]
    nwd = -(-d // 32)
    out = np.full(d, np.nan, np.float32)
    t = np.arange(256)[:, None]
    g = np.arange(ACC_TILE * 8 // 256)[None, :]
    for w0 in range(0, nwd, ACC_TILE):
        word = w0 + (t >> 3) + 32 * g
        coord = 32 * w0 + 4 * (t + 256 * g)
        acc = np.zeros((256, g.size, 4), np.float32)
        for c0 in range(0, n, ACC_PEERS):
            for k in range(c0, min(n, c0 + ACC_PEERS)):
                wk = np.where(word < nwd, words[k, np.minimum(word, nwd - 1)], 0)
                nib = wk >> (4 * (t & 7)).astype(np.uint32)
                for b in range(4):
                    bit = (nib >> np.uint32(b)) & np.uint32(1)
                    acc[:, :, b] = acc[:, :, b] + np.where(bit > 0, c_hi[k], c_lo[k])
        for b in range(4):
            c = (coord + b).reshape(-1)
            keep = c < d
            out[c[keep]] = acc[:, :, b].reshape(-1)[keep]
    assert not np.isnan(out).any()
    return out


@pytest.mark.parametrize("case", range(6))
@pytest.mark.parametrize("width", tref.WIDTHS)
def test_unpack_at_kernel_tile_edges_matches_pallas(width, case):
    """The plain unpack against the Pallas kernel, and the model of the
    card's 16-byte items against both, at the card's block edges, from
    4-byte-aligned starts words[1:] and words[3:]."""
    d = _unpack_edges(width)[case]
    nw = tops.num_words(d, width)
    words = np.random.default_rng(d * 5 + width).integers(0, 1 << 32, nw + 3, dtype=np.uint32)
    for off in (0, 1, 3):
        win = words[off:off + nw]
        want = np.asarray(jops.unpack_bits(jnp.asarray(win), width, d, force_pallas=True))
        got = tops.unpack_bits(torch.from_numpy(words.view(np.int32))[off:], width, d)
        np.testing.assert_array_equal(got.numpy().astype(np.uint32), want)
        model = _item_unpack_model(win, width, d)
        assert model.dtype == got.numpy().dtype
        np.testing.assert_array_equal(model, got.numpy())


@pytest.mark.parametrize("n,ds", [(1, 32), (2, 4096), (5, 32 * ACC_TILE - 32),
                                  (8, 32 * ACC_TILE + 32), (17, 3 * 32 * ACC_TILE + 96),
                                  (17, 4099)])
def test_binary_accum_at_kernel_tile_edges_matches_pallas(n, ds):
    """The plain accumulate against the Pallas kernel on a strided word
    window (rows of odd length, offsets 1, 2 and 3 mod 4), and the model of
    the card's tiles and peer chunks against both; n = 17 takes three
    chunks."""
    rng = np.random.default_rng(n * 1000 + ds)
    nw = tops.num_words(ds, 1)
    ld = nw + 5 if nw % 2 == 0 else nw + 4       # odd: rows 4-byte aligned only
    rows = rng.integers(0, 1 << 32, (n, ld), dtype=np.uint32)
    c = (rng.standard_normal((n, 2)) * 0.3).astype(np.float32)
    c[:, 1] = np.abs(c[:, 1]) + c[:, 0]
    for off in (1, 2, 3):
        win = np.ascontiguousarray(rows[:, off:off + nw])
        want = np.asarray(jops.binary_accum(jnp.asarray(win), jnp.asarray(c[:, 0]),
                                            jnp.asarray(c[:, 1]), ds, force_pallas=True))
        view = torch.from_numpy(rows.view(np.int32))[:, off:off + nw]
        assert view.stride(0) == ld
        got = tops.binary_accum(view, torch.from_numpy(c[:, 0]), torch.from_numpy(c[:, 1]), ds)
        np.testing.assert_array_equal(got.numpy().view(np.uint32), want.view(np.uint32))
        model = _tile_accum_model(win, c[:, 0], c[:, 1], ds)
        np.testing.assert_array_equal(model.view(np.uint32), want.view(np.uint32))


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
