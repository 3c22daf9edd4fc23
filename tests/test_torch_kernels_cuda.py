"""The port's CUDA kernels against their plain versions, on a card.

Marked ``cuda``; every test skips, with its reason, where no CUDA device is
present (decided in a fixture, never at import).  On a card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_kernels_cuda.py

``chip_smoke.py`` runs the same comparisons at the main path's shapes.
"""
import dataclasses

import pytest
import torch

from repro_torch import random as R
from repro_torch.configs.base import ArchConfig, RunConfig, ShapeSpec
from repro_torch.configs.registry import (COMPRESSION_PRESETS, compression_preset, robust_preset,
                                          smoke_config)
from repro_torch.core import bitplane as cbp
from repro_torch.core import comm_cost
from repro_torch.core import rotation
from repro_torch.core import collectives as tcoll
from repro_torch.core import wire as twire
from repro_torch.core.wire import robust
from repro_torch.distributed import fault_tolerance as ft
from repro_torch.kernels.bernoulli_encode import bernoulli_encode as bek
from repro_torch.kernels.bernoulli_encode import ref as ber
from repro_torch.kernels.bernoulli_wire import kernel as bwk
from repro_torch.kernels.binary_quant import binary_quant as bqk
from repro_torch.kernels.binary_quant import ops as bqo
from repro_torch.kernels.binary_quant import ref as bqr
from repro_torch.kernels.bernoulli_wire import ref as bwr
from repro_torch.kernels.bitplane import bitplane as bpk
from repro_torch.kernels.bitplane import ref as bpr
from repro_torch.kernels.fixed_k_encode import fixed_k_encode as fkk
from repro_torch.kernels.fixed_k_encode import ref as fkr
from repro_torch.kernels import backend
from repro_torch.kernels.flash_attention import kernel as fak
from repro_torch.kernels.flash_attention import ops as fao
from repro_torch.kernels.flash_attention import ref as far
from repro_torch.kernels.hadamard import hadamard as hk
from repro_torch.kernels.hadamard import ref as hr
from repro_torch.kernels.rotated_encode import kernel as rek
from repro_torch.kernels.rotated_encode import ops as reo
from repro_torch.kernels.rotated_encode import ref as rer
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.models import common as mcommon
from repro_torch.models import moe as tmoe
from repro_torch.models import ssm as tssm
from repro_torch.train.train_step import build_train_step

# one intra-op thread: beside other test workers on a loaded machine, torch's
# thread pool stalls for tens of seconds
torch.set_num_threads(1)

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _same(a, b):
    return torch.equal(a.view(torch.int32), b.view(torch.int32))


@pytest.mark.parametrize("d,p,cap", [(1, 0.5, None), (70001, 1 / 16, None),
                                     (70001, 1 / 16, 100), (4103, 0.3, None),
                                     # pair chunks at ragged halves: one pair, a
                                     # partial low chunk, a high chunk of one
                                     (2, 1 / 16, None), (2047, 0.5, None),
                                     (2049, 0.5, None), ((1 << 21) + 3, 1 / 16, None),
                                     ((1 << 21) + 3, 1 / 16, 5000)])
def test_encode_kernel_equals_plain(dev, d, p, cap):
    cap = cap or comm_cost.bernoulli_capacity(d, p)
    x = torch.randn(d, device=dev, generator=torch.Generator(dev).manual_seed(d))
    key = R.fold_in(R.PRNGKey(1), 2)
    mu = x.mean()
    assert _same(bwk.encode(x, key, mu, p=p, cap=cap), bwr.encode(x, key, p, cap, mu))


@pytest.mark.parametrize("d,p,cap", [(1, 0.5, None), (70001, 1 / 16, None),
                                     (70001, 1 / 16, 100), (4103, 0.3, None), (2, 1 / 16, None),
                                     (2047, 0.5, None), (2049, 0.5, None),
                                     ((1 << 21) + 3, 1 / 16, 5000)])
def test_unscaled_encode_kernel_equals_plain(dev, d, p, cap):
    """Kernel 1's unscaled variant (the error-feedback twin) writes x itself,
    −0.0 kept, whatever μ (here < 0, where 0·μ would be −0.0)."""
    cap = cap or comm_cost.bernoulli_capacity(d, p)
    x = torch.randn(d, device=dev, generator=torch.Generator(dev).manual_seed(d + 3))
    x[1::3] = -0.0
    key = R.fold_in(R.PRNGKey(1), 5)
    mu = torch.tensor(-0.25, device=dev)
    got = bwk.encode(x, key, mu, p=p, cap=cap, scaled=False)
    assert _same(got, bwr.encode(x, key, p, cap, mu, scaled=False))
    assert d < 8 or bool((got.view(torch.int32) == -2 ** 31).any())
    assert _same(bwk.encode(x, key, mu, p=p, cap=cap), bwr.encode(x, key, p, cap, mu))


@pytest.mark.parametrize("d,p", [(1, 0.5), (2049, 0.5), (70001, 1 / 16), ((1 << 21) + 3, 1 / 16)])
def test_unpack_kernel_from_negative_zero_equals_decode_one(dev, d, p):
    """Kernel 2 at n = 1 from a −0.0 accumulator is one peer's
    reconstruction bit for bit, −0.0 values and a −0.0 center included."""
    cap = comm_cost.bernoulli_capacity(d, p)
    g = torch.Generator(dev).manual_seed(d)
    buf = torch.randn(cap, device=dev, generator=g)
    buf[::2] = -0.0
    key = R.fold_in(R.PRNGKey(d), 4)
    for mu in (-0.0, 0.5):
        mus = torch.tensor([mu], device=dev)
        got = bwk.decode_sum(buf[None], mus, key[None], p=p, cap=cap, d=d, acc0=-0.0)
        want = bwr.decode_one(buf, key, p, cap, mus, d)
        assert _same(got, want)
        assert _same(got, bwr.decode_sum_sequential(buf[None], mus, key[None], p, cap, d,
                                                    acc0=-0.0))
        assert d < 8 or bool((got.view(torch.int32) == -2 ** 31).any())


@pytest.mark.parametrize("d,n,cap", [(33, 2, None), (70001, 8, None), (5000, 4, 1500),
                                     # the flat decode's pair chunks at ragged halves:
                                     # odd d, a partial last low chunk, a high chunk
                                     # of one coordinate, n = 1, 3, 8, cap overflow
                                     (1, 1, None), (2, 3, None), (2047, 8, None),
                                     (2049, 3, None), ((1 << 21) + 3, 8, None),
                                     ((1 << 21) + 3, 3, 20_000), (70001, 1, 1000)])
def test_decode_kernels_equal_plain(dev, d, n, cap):
    p = 1 / 16 if cap is None or d > 5000 else 0.5
    cap = cap or comm_cost.bernoulli_capacity(d, p)
    g = torch.Generator(dev).manual_seed(d)
    bufs = torch.randn(n, cap, device=dev, generator=g)
    mus = torch.randn(n, device=dev, generator=g)
    keys = torch.stack([R.fold_in(R.PRNGKey(d), i) for i in range(n)])
    want = bwr.decode_sum_sequential(bufs, mus, keys, p, cap, d)
    got = bwk.decode_sum(bufs, mus, keys, p=p, cap=cap, d=d)
    assert _same(got, want) and _same(got, bwr.decode_sum(bufs, mus, keys, p, cap, d))
    ds = -(-d // n)
    sups = [bwk.support_counts(keys, p=p, d=d, start=s * ds, ds=ds, device=dev) for s in range(n)]
    allc = torch.stack([s.counts.sum(1, dtype=torch.int32) for s in sups])
    prior = torch.cumsum(allc, 0, dtype=torch.int32) - allc
    parts = []
    for s, sup in enumerate(sups):
        plain = bwr.support_counts(keys, p, d, s * ds, ds, dev)
        assert torch.equal(sup.counts, plain.counts) and torch.equal(sup.mask, plain.mask)
        parts.append(bwk.decode_sum_shard(bufs, mus, sup, prior[s].contiguous(), cap=cap))
    assert _same(torch.cat(parts)[:d], want)


@pytest.mark.parametrize("d", (1024, 70001))
def test_fixed_k_gather_equals_plain(dev, d):
    x = torch.randn(d, device=dev, generator=torch.Generator(dev).manual_seed(d))
    nb = -(-d // 1024)
    kb = max(1, round(nb / 16))
    ids = fkr.sample_blocks(R.PRNGKey(3), nb, kb, dev)
    mu = x.mean()
    want = fkr.fixed_k_encode(torch.nn.functional.pad(x, (0, nb * 1024 - d)), ids, mu)
    assert _same(fkk.fixed_k_gather(x, ids, nb / kb, mu), want)


@pytest.mark.parametrize("d", (1, 31, 33, 4099, 70001))
@pytest.mark.parametrize("width", bpr.WIDTHS)
def test_bitplane_pack_unpack_equal_plain(dev, d, width):
    g = torch.Generator(dev).manual_seed(d * 31 + width)
    sym32 = torch.randint(-(1 << 31), 1 << 31, (d,), generator=g, device=dev, dtype=torch.int64)
    sym32 = sym32.to(torch.int32)                # high bits above the field: masked
    words = bpk.pack_bits(sym32, width)
    assert torch.equal(words, bpr.pack_bits(sym32, width))
    sym8 = (sym32 & 0xFF).to(torch.uint8)
    assert torch.equal(bpk.pack_bits(sym8, width), bpr.pack_bits(sym8, width))
    assert torch.equal(bpk.unpack_bits(words, width, d), bpr.unpack_bits(words, width, d))
    off = words[1:] if words.numel() > 1 else words   # a 4-byte-aligned, not 16, start
    dd = min(d, off.numel() * (32 // width))
    assert torch.equal(bpk.unpack_bits(off, width, dd), bpr.unpack_bits(off, width, dd))
    if d > 1:                                    # symbols not 4-byte aligned
        assert torch.equal(bpk.pack_bits(sym8[1:], width), bpr.pack_bits(sym8[1:], width))


@pytest.mark.parametrize("n,d", [(1, 33), (3, 4099), (8, 70001)])
def test_binary_accum_equals_plain(dev, n, d):
    g = torch.Generator(dev).manual_seed(n * d)
    nw = bpr.num_words(d, 1)
    rows = torch.randint(-(1 << 31), 1 << 31, (n, nw + 5), generator=g, device=dev,
                         dtype=torch.int64).to(torch.int32)
    lo = torch.randn(n, generator=g, device=dev)
    hi = lo + torch.rand(n, generator=g, device=dev)
    for win in (rows[:, :nw].contiguous(), rows[:, 3:3 + nw]):
        want = bpr.binary_accum(win, lo, hi, d)
        assert _same(bpk.binary_accum(win, lo, hi, d), want)


# csrc/bitplane.cu: the unpack takes blocks of UNPACK_TILE 16-byte items, the
# binary accumulate tiles of ACC_TILE words with peers staged ACC_PEERS at a
# time; the cases below sit on those edges.
UNPACK_TILE = 256 * 4
ACC_TILE = 256
ACC_PEERS = 8


def _unpack_edges(width):
    """d at one unpack block's symbols, ± 1, ± 32/w, and two blocks + 17."""
    blk = UNPACK_TILE * 16 // bpr.symbol_dtype(width).itemsize
    per = 32 // width
    return (blk, blk - 1, blk + 1, blk - per, blk + per, 2 * blk + 17)


@pytest.mark.parametrize("case", range(6))
@pytest.mark.parametrize("width", bpr.WIDTHS)
def test_unpack_kernel_at_block_edges_equals_plain(dev, width, case):
    d = _unpack_edges(width)[case]
    nw = bpr.num_words(d, width)
    g = torch.Generator(dev).manual_seed(d * 5 + width)
    words = torch.randint(-(1 << 31), 1 << 31, (nw + 3,), generator=g, device=dev,
                          dtype=torch.int64).to(torch.int32)
    for off in (0, 1, 3):                         # 4-byte-aligned, not 16, starts
        win = words[off:]
        assert torch.equal(bpk.unpack_bits(win, width, d), bpr.unpack_bits(win, width, d))


@pytest.mark.parametrize("n", (1, 2, 5, ACC_PEERS, 2 * ACC_PEERS + 1))
@pytest.mark.parametrize("ds", (32, 4096, 32 * ACC_TILE - 32, 32 * ACC_TILE + 32,
                                3 * 32 * ACC_TILE + 96, 70001))
def test_binary_accum_kernel_at_tile_edges_equals_plain(dev, n, ds):
    """Windows at word offsets 0, 1, 2 and 3 of rows of odd length (4-byte
    aligned only), ds below one tile, a multiple of 32 but not of the tile,
    and ragged; n up to three peer chunks."""
    g = torch.Generator(dev).manual_seed(n * 1000 + ds)
    nw = bpr.num_words(ds, 1)
    ld = nw + 5 if nw % 2 == 0 else nw + 4
    rows = torch.randint(-(1 << 31), 1 << 31, (n, ld), generator=g, device=dev,
                         dtype=torch.int64).to(torch.int32)
    lo = torch.randn(n, generator=g, device=dev)
    hi = lo + torch.rand(n, generator=g, device=dev)
    for off in (0, 1, 2, 3):
        win = rows[:, off:off + nw]
        assert win.stride(0) == ld
        assert _same(bpk.binary_accum(win, lo, hi, ds), bpr.binary_accum(win, lo, hi, ds))


@pytest.mark.parametrize("b,m", [(1, 0), (3, 1), (2, 5), (3, 8), (2, 13), (3, 14), (2, 17),
                                 (1, 18), (9, 18), (1, 19), (9, 19), (1, 20), (9, 20)])
def test_fwht_and_rotate_minmax_equal_plain(dev, b, m):
    """One pass up to 2^13, two beyond; odd m, where sqrt(c) is not a power
    of two, included; 9 rows of 2^20 (36 MiB) outrun the L2."""
    c = 1 << m
    x = torch.randn(b, c, device=dev, generator=torch.Generator(dev).manual_seed(b * c))
    assert _same(hk.fwht(x), hr.fwht(x))
    signs = R.rademacher(R.PRNGKey(m), (b, c), dev)
    scale = float(rotation.chunk_scale(c, "cpu"))
    z, mm = rek.rotate_minmax(x, signs, scale)
    zp, mmp = rer.rotate_minmax(x, signs, scale)
    assert _same(z, zp) and _same(mm, mmp)


@pytest.mark.parametrize("b,m", [(3, 12), (2, 17), (5, 20)])
def test_fwht_in_place_and_repeated_equal_plain(dev, b, m):
    """out == x, and two calls back to back: each call's ticket and row
    counters are its own."""
    x = torch.randn(b, 1 << m, device=dev, generator=torch.Generator(dev).manual_seed(b + m))
    want = hr.fwht(x)
    first, second = hk.fwht(x), hk.fwht(x)
    assert _same(first, want) and _same(second, want)
    y = x.clone()
    assert hk.fwht(y, out=y).data_ptr() == y.data_ptr()
    assert _same(y, want)


def test_fwht_on_two_streams_equal_plain(dev):
    g = torch.Generator(dev).manual_seed(5)
    xs = [torch.randn(4, 1 << 20, device=dev, generator=g) for _ in range(2)]
    want = [hr.fwht(x) for x in xs]
    streams = [torch.cuda.Stream(dev) for _ in xs]
    torch.cuda.synchronize(dev)
    got = []
    for x, st in zip(xs, streams):
        with torch.cuda.stream(st):
            got.append(hk.fwht(x))
    torch.cuda.synchronize(dev)
    assert all(_same(a, b) for a, b in zip(got, want))


@pytest.mark.parametrize("dp", (1, 2, 33, 65, 70001, 131072, 2 * ((1 << 16) + 5) + 1,
                                371 << 15))
def test_encode_pack_equals_plain(dev, dp):
    """Pairs (j, j + ⌈dp/2⌉) at half % 32 ∈ {1, 17, 25, 0, 6}: high ballots
    split across words, edge and seam words met by atomicOr."""
    z = torch.randn(dp, device=dev, generator=torch.Generator(dev).manual_seed(dp))
    key = R.fold_in(R.PRNGKey(4), 1)
    for lo, hi in ((z.amin(), z.amax()), (z[0], z[0].clone())):   # delta = 0 last
        got = rek.encode_pack(z, key, lo, hi, dp)
        assert torch.equal(got, rer.binary_plane(z, key, lo, hi, dp))
    assert not bool(got.any())


@pytest.mark.parametrize("d", (100, 300, 5000, 70001))
def test_fused_pack_binary_equals_chain(dev, d):
    x = torch.randn(d, device=dev, generator=torch.Generator(dev).manual_seed(d))
    key = R.PRNGKey(9)
    chain = cbp.binary_pack(rotation.rotate(rotation.rotation_key(key), x),
                            R.fold_in(key, 2), "bfloat16")
    assert torch.equal(reo.pack_binary(x, key, 2, "bfloat16"), chain)


@pytest.mark.parametrize("d", (4096, 70001))
def test_rotation_on_card_equals_cpu(dev, d):
    """70,001 pads to 2^17: √c is not a power of two, so the card must divide
    as the CPU does (core/rotation.py::chunk_scale)."""
    x = torch.randn(d, generator=torch.Generator().manual_seed(d))
    krot = rotation.rotation_key(R.PRNGKey(6))
    z = rotation.rotate(krot, x.to(dev))
    assert _same(z.cpu(), rotation.rotate(krot, x))
    assert _same(rotation.unrotate(krot, z, d).cpu(), rotation.unrotate(krot, z.cpu(), d))
    assert torch.equal(reo.pack_binary(x.to(dev), R.PRNGKey(6), 3, "bfloat16").cpu(),
                       reo.pack_binary(x, R.PRNGKey(6), 3, "bfloat16"))


# flash attention: held within the reference's tolerances for its own kernel
# (tests/test_kernel_flash.py), not bit for bit (exp and sum orders differ)
FLASH_TOL = {torch.float32: 2e-3, torch.bfloat16: 3e-2}


def _qkv(dev, b, sq, sk, hq, hkv, hd, dtype):
    g = torch.Generator(dev).manual_seed(sq * hd + hq)
    return [torch.randn(b, s, h, hd, generator=g, device=dev).to(dtype)
            for s, h in ((sq, hq), (sk, hkv), (sk, hkv))]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,sq,sk,hq,hkv,hd,causal,window,q_offset", [
    (1, 256, 256, 4, 2, 64, True, None, 0),
    (2, 100, 100, 8, 2, 128, False, None, 0),     # ragged tiles, not causal
    (1, 128, 512, 4, 1, 128, True, 96, 256),      # window and q offset
    # the bf16 kernel's 128-row q tiles and 128-key tiles at their edges
    (1, 1000, 1000, 4, 1, 128, True, None, 0),    # ragged, causal, g = 4
    (1, 1000, 1000, 4, 4, 64, True, None, 0),     # ragged, causal, hd 64, g = 1
    (1, 100, 100, 2, 2, 64, True, None, 0),       # less than one tile
    (1, 512, 512, 4, 1, 128, True, 200, 0),       # a window straddling key tiles
    (1, 256, 512, 4, 2, 128, True, None, 200),    # q offset not a multiple of 128
    (1, 1000, 1000, 56, 8, 128, True, None, 0),   # llava-next-34b's heads, g = 7
    (2, 256, 256, 56, 8, 128, True, None, 0),
    # hd 32 (lm-8m) on the hd-64 tiles, columns 32-63 zero-filled by TMA
    (1, 1000, 1000, 4, 2, 32, True, None, 0),     # ragged, causal, g = 2
    (2, 100, 100, 8, 4, 32, False, None, 0),      # less than one tile, not causal
    (1, 512, 512, 4, 1, 32, True, 200, 0),        # a window straddling key tiles
    (1, 256, 512, 4, 2, 32, True, None, 200),     # q offset not a multiple of 128
    (4, 128, 128, 8, 4, 32, True, None, 0),       # one rank of the training example
    # hd 16 (the smoke configs) on the hd-64 tiles, columns 16-63 zero-filled
    (1, 1000, 1000, 4, 2, 16, True, None, 0),     # ragged, causal, g = 2
    (2, 100, 100, 4, 4, 16, False, None, 0),      # less than one tile, not causal
    (1, 512, 512, 4, 1, 16, True, 200, 0),        # a window straddling key tiles
    (1, 256, 512, 4, 2, 16, True, None, 200),     # q offset not a multiple of 128
    (4, 128, 128, 4, 2, 16, True, None, 0),       # one rank of the training CLI's smoke run
    (4, 16, 16, 4, 2, 16, True, None, 0),         # the serving example's prefill
    # hd 120 (h2o-danube-3-4b) on the hd-128 tiles, columns 120-127 zero-filled
    (1, 1024, 1024, 32, 8, 120, True, None, 0),
    (1, 1024, 1024, 32, 8, 120, True, 200, 0),    # a window straddling key tiles
    (1, 1000, 1200, 32, 8, 120, True, None, 200),  # ragged, q offset not a multiple of 128
    (2, 100, 100, 4, 2, 120, False, None, 0),     # less than one tile, not causal
    (1, 512, 512, 4, 1, 120, True, 64, 0),        # a window narrower than a tile
])
def test_flash_attention_kernel_within_tolerance_of_plain(dev, dtype, b, sq, sk, hq, hkv, hd,
                                                          causal, window, q_offset):
    q, k, v = _qkv(dev, b, sq, sk, hq, hkv, hd, dtype)
    o, lse = fak.flash_attention_fwd(q, k, v, causal=causal, window=window, q_offset=q_offset)
    op, lsep = far.flash_attention_fwd(q, k, v, causal=causal, window=window, q_offset=q_offset,
                                       block_q=sq, block_k=sk)
    torch.cuda.synchronize()
    tol = FLASH_TOL[dtype]
    rtol = tol if dtype == torch.float32 else 0.0
    torch.testing.assert_close(o.float(), op.float(), atol=tol, rtol=rtol)
    torch.testing.assert_close(lse, lsep, atol=1e-3, rtol=0)


def test_flash_attention_ops_launches_the_kernel_on_a_card(dev, monkeypatch):
    def plain(*args, **kwargs):
        raise AssertionError("a CUDA tensor reached the plain version")

    monkeypatch.setattr(far, "flash_attention_fwd", plain)
    q, k, v = _qkv(dev, 1, 128, 128, 4, 2, 128, torch.bfloat16)
    before = backend.launches["flash_attention_fwd"]
    out = fao.flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert backend.launches["flash_attention_fwd"] == before + 1
    assert out.shape == q.shape and out.dtype == q.dtype


# flash-attention backward: kernels 12 (dK/dV) and 13 (dQ) against the plain
# blockwise backward on the same inputs.  f32: |Δ| ≤ 2e-3 + 2e-3·|ref| (the
# forward's tolerance); bf16: relative Frobenius error of each of dq, dk, dv
# ≤ 2e-4.  p and ds enter the products as bf16 hi + lo pairs (2⁻¹⁶ relative)
# and the sums run in another order: chip_smoke.py read ≤ 1.1e-5 at small
# shapes on an H100, while rounding p and ds to bf16 once gives about 1e-3.
BWD_REL = 2e-4


def _bwd_inputs(dev, b, sq, sk, hq, hkv, hd, dtype, causal, window, q_offset):
    q, k, v = _qkv(dev, b, sq, sk, hq, hkv, hd, dtype)
    g = torch.Generator(dev).manual_seed(sq + hd)
    do = torch.randn(q.shape, generator=g, device=dev).to(dtype)
    o, lse = fak.flash_attention_fwd(q, k, v, causal=causal, window=window, q_offset=q_offset)
    delta = torch.sum(do.float() * o.float(), -1).transpose(1, 2).contiguous()
    return q, k, v, do, lse, delta


def _rel(got, want):
    return float(torch.linalg.vector_norm(got.double() - want.double())
                 / torch.linalg.vector_norm(want.double()))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,sq,sk,hq,hkv,hd,causal,window,q_offset", [
    (1, 256, 256, 4, 1, 64, True, None, 0),       # g = 4
    (2, 100, 100, 4, 4, 128, False, None, 0),     # ragged tiles, g = 1, not causal
    (1, 128, 512, 4, 2, 128, True, 96, 256),      # window and q offset
    # the bf16 kernels' 128-key / 128-row CTA tiles and 64-row / 64-key ring
    # tiles at their edges, at hd 64 and 128
    (1, 1000, 1000, 4, 4, 64, True, None, 0),     # ragged, g = 1
    (1, 1000, 1000, 4, 4, 128, True, None, 0),
    (1, 1024, 1024, 4, 1, 64, True, 200, 0),      # a window across key tiles
    (1, 1024, 1024, 4, 1, 128, True, 200, 0),
    (2, 100, 100, 8, 2, 64, True, None, 0),       # less than one tile
    (2, 100, 100, 8, 2, 128, True, None, 0),
    (1, 256, 512, 4, 2, 64, True, None, 200),     # q offset 200, Sk 512
    (1, 256, 512, 4, 2, 128, True, None, 200),
    (1, 1000, 1000, 56, 8, 128, True, None, 0),   # llava-next-34b's heads, g = 7
    (2, 256, 256, 56, 8, 128, True, None, 0),
    # hd 32 (lm-8m) on the hd-64 tiles
    (1, 1000, 1000, 4, 2, 32, True, None, 0),     # ragged, g = 2
    (1, 1024, 1024, 4, 1, 32, True, 200, 0),      # a window across key tiles
    (2, 100, 100, 8, 4, 32, False, None, 0),      # less than one tile, not causal
    (1, 256, 512, 4, 2, 32, True, None, 200),     # q offset 200, Sk 512
    (4, 128, 128, 8, 4, 32, True, None, 0),       # one rank of the training example
    # hd 16 (the smoke configs) on the hd-64 tiles
    (1, 1000, 1000, 4, 2, 16, True, None, 0),     # ragged, g = 2
    (1, 1024, 1024, 4, 1, 16, True, 200, 0),      # a window across key tiles
    (2, 100, 100, 4, 4, 16, False, None, 0),      # less than one tile, not causal
    (1, 256, 512, 4, 2, 16, True, None, 200),     # q offset 200, Sk 512
    (4, 128, 128, 4, 2, 16, True, None, 0),       # one rank of the training CLI's smoke run
    # hd 120 (h2o-danube-3-4b) on the hd-128 tiles: the f32 outputs' rows of
    # 120 columns must not reach the next head's
    (1, 1024, 1024, 32, 8, 120, True, None, 0),
    (1, 1024, 1024, 32, 8, 120, True, 200, 0),    # a window across key tiles
    (1, 1000, 1200, 32, 8, 120, True, None, 200),  # ragged, q offset 200
    (2, 100, 100, 4, 2, 120, False, None, 0),     # less than one tile, not causal
    (1, 512, 512, 4, 1, 120, True, 64, 0),        # a window narrower than a tile
])
def test_flash_attention_bwd_kernels_within_tolerance_of_plain(dev, dtype, b, sq, sk, hq, hkv,
                                                               hd, causal, window, q_offset):
    mask = dict(causal=causal, window=window, q_offset=q_offset)
    q, k, v, do, lse, delta = _bwd_inputs(dev, b, sq, sk, hq, hkv, hd, dtype, **mask)
    dk, dv = fak.flash_attention_bwd_dkv(q, k, v, do, lse, delta, **mask)
    dq = fak.flash_attention_bwd_dq(q, k, v, do, lse, delta, **mask)
    torch.cuda.synchronize()
    want = far.flash_attention_bwd(q, k, v, do, lse, delta, **mask, block_q=sq, block_k=sk)
    for name, got, w in zip(("dq", "dk", "dv"), (dq, dk, dv), want):
        assert got.dtype == torch.float32 and got.shape == w.shape, name
        if dtype == torch.float32:
            torch.testing.assert_close(got, w, atol=2e-3, rtol=2e-3, msg=name)
        else:
            assert _rel(got, w) <= BWD_REL, (name, _rel(got, w))


@pytest.mark.parametrize("hd,suffix", [(128, ""), (32, "_hd32"), (16, "_hd16"),
                                       (120, "_hd120")])
def test_flash_attention_backward_launches_the_kernels_on_a_card(dev, monkeypatch, hd, suffix):
    def plain(*args, **kwargs):
        raise AssertionError("a CUDA tensor reached the plain version")

    monkeypatch.setattr(far, "flash_attention_bwd", plain)
    q, k, v = (t.requires_grad_() for t in _qkv(dev, 1, 128, 128, 4, 2, hd, torch.bfloat16))
    backend.reset_launches()
    out = fao.flash_attention(q, k, v, causal=True)
    out.float().square().sum().backward()
    torch.cuda.synchronize()
    names = ("flash_attention_fwd", "flash_attention_bwd_dkv", "flash_attention_bwd_dq")
    assert dict(backend.launches) == {n + suffix: 1 for n in names}
    assert q.grad.dtype == torch.bfloat16 and k.grad.shape == k.shape
    assert all(bool(torch.isfinite(t.grad.float()).all()) for t in (q, k, v))


def test_async_checkpoint_on_a_card_writes_the_saved_values(dev, tmp_path):
    """The asynchronous save copies on a side stream into pinned buffers and
    marks the saved tensors as used by that stream: freeing them right after
    ``save`` and filling new tensors of their size (which may take their
    memory) does not reach the checkpoint."""
    from repro_torch.checkpoint import checkpointing as ckpt
    from repro_torch.optim import optimizers as topt

    g = torch.Generator(dev).manual_seed(5)
    params = {"w": torch.randn(1 << 22, generator=g, device=dev),
              "b": torch.randn(7, 3, generator=g, device=dev)}
    st = topt.adamw_init(params)
    want = {k: v.cpu() for k, v in params.items()}
    specs = {k: (None,) * v.dim() for k, v in params.items()}
    ac = ckpt.AsyncCheckpointer()
    ac.save(str(tmp_path), 1, params, st, specs)
    del params
    junk = [torch.full((1 << 22,), float("nan"), device=dev) for _ in range(4)]
    ac.wait()
    _, got, got_st, _ = ckpt.restore(str(tmp_path), specs, st, device=dev)
    assert all(torch.equal(got[k].cpu(), want[k]) and got[k].is_cuda for k in want)
    assert int(got_st.step) == 0 and ac.history[0]["copy_ms"] > 0
    del junk


def test_training_step_flash_matches_xla_on_a_card(dev):
    """One training step (2 ranks, fixed-k sync) with the flash kernels
    against attn_impl="xla": the same loss and synced gradients within the
    flash-vs-xla limits of chip_smoke.py (loss 1e-3 relative, per-leaf
    relative Frobenius error 5e-2), and the launches remat implies."""
    cfg = ArchConfig(name="narrow-hd128", family="dense", num_layers=2, d_model=256,
                     num_heads=8, num_kv_heads=2, head_dim=128, d_ff=512, vocab_size=1024,
                     qk_norm=True, rope_theta=1e6, tie_embeddings=True)
    shape = ShapeSpec("train", "train", 256, 2)
    cmp = dataclasses.replace(compression_preset("fixed_k_1bit", axes=("data",)),
                              min_compress_size=1024)
    out = {}
    for impl in ("flash", "xla"):
        seen = {}
        run = RunConfig(attn_chunk_q=128, attn_chunk_k=128, attn_impl=impl, compression=cmp)
        step_fn, init_fn, _ = build_train_step(
            cfg, run, shape, 2, device=dev,
            on_phase=lambda name, **st: seen.update(st) if name == "sync" else None)
        params, opt, ef = init_fn(0)
        backend.reset_launches()
        _, _, _, metrics = step_fn(params, opt, ef, SyntheticLM(cfg, shape).batch(0, dev), 0)
        torch.cuda.synchronize()
        out[impl] = (float(metrics["loss"]), seen["synced"], dict(backend.launches))
    (lf, gf, nf), (lx, gx, nx) = out["flash"], out["xla"]
    assert nf["flash_attention_fwd"] == 2 * 2 * 2          # remat: forward + recompute
    assert nf["flash_attention_bwd_dkv"] == nf["flash_attention_bwd_dq"] == 2 * 2
    assert not any(k.startswith("flash") for k in nx)
    assert abs(lf - lx) <= 1e-3 * abs(lx)
    for k in gx:
        assert _rel(gf[k], gx[k]) <= 5e-2, (k, _rel(gf[k], gx[k]))


# --------------------------------------------------------------------------- #
# The hash-PRNG encoders (kernels 14, 15): bit-equal to the plain versions.
# --------------------------------------------------------------------------- #

def _same_any(a, b):
    """Same dtype and shape, same bits (any float width)."""
    if a.dtype != b.dtype or a.shape != b.shape:
        return False
    if a.dtype.is_floating_point:
        w = torch.int32 if a.element_size() == 4 else torch.int16
        return torch.equal(a.view(w), b.view(w))
    return torch.equal(a, b)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d,p,mu,offset", [(1, 0.5, 0.0, 0), (65_536, 1 / 16, 0.0, 0),
                                           (70_001, 0.3, 0.1, 0), (70_001, 1 / 16, -0.2, 1),
                                           (1_048_583, 1.0, 0.5, 3)])
def test_bernoulli_encode_kernel_equals_plain(dev, dtype, d, p, mu, offset):
    g = torch.Generator(dev).manual_seed(d + offset)
    base = torch.randn(d + offset, generator=g, device=dev).to(dtype)
    x = base[offset:]                    # offset > 0: not 16-byte aligned
    got = bek.encode(x, p, mu, 0xDEADBEEF)
    assert _same_any(got, ber.bernoulli_encode(x, p, mu, 0xDEADBEEF))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d,offset", [(1, 0), (65_536, 0), (70_001, 0), (70_001, 1),
                                      (1_048_583, 3)])
def test_binary_encode_kernel_equals_plain(dev, dtype, d, offset):
    g = torch.Generator(dev).manual_seed(d * 3 + offset)
    x = torch.randn(d + offset, generator=g, device=dev).to(dtype)[offset:]
    got, vmin, vmax = bqo.binary_encode(x, 42)
    padded = got.numel() * 8
    flat = torch.cat([x, vmin.to(dtype).expand(padded - d)])
    want = bqr.pack_bytes(bqr.encode_bits(flat, vmin, vmax, 42))
    assert got.dtype == torch.uint8 and padded % bqo.TILE == 0
    assert torch.equal(got, want)
    tail = (padded - d) // 8             # whole bytes of vmin padding: no bit set
    assert tail == 0 or not bool(got[-tail:].any())
    zero = bqk.encode(x.contiguous(), vmax, vmax, 42, padded)     # Δ = 0: no bit set
    assert not bool(zero.any())


def test_hash_encoders_count_their_launches(dev):
    x = torch.randn(4096, device=dev)
    backend.reset_launches()
    bek.encode(x, 0.5, 0.0, 1)
    bqo.binary_encode(x, 1)
    assert dict(backend.launches) == {"bernoulli_encode_2d": 1, "binary_encode_2d": 1}


# --------------------------------------------------------------------------- #
# Decodes divide by n exactly: the card's round equals the CPU's, bit for bit,
# at rank counts that are not powers of two.
# --------------------------------------------------------------------------- #

def _grid_stack(n, d, seed):
    """Values on a 2^-6 grid, |x| small: every partial sum is exact in f32,
    and d = 2^16 makes the mean a power-of-two division, so the node centers
    are the same on both devices whatever the summation order."""
    g = torch.Generator().manual_seed(seed)
    return torch.round(torch.randn(n, d, generator=g) * 32) / 64


def _gauss_stack(n, d, seed):
    """Seeded Gaussian gradients-like values at a d that is no power of two:
    sums round, so the node centers agree only if both devices take the
    same adds (``core/wire/base.py::tree_mean``)."""
    g = torch.Generator().manual_seed(seed)
    return torch.randn(n, d, generator=g) * 0.5 + 0.01


ROUND_CASES = [(n, preset, mode, "grid", 1 << 16) for n in (3, 5, 6, 7)
               for preset, mode in (("fixed_k_1bit", None), ("bernoulli_seed_1bit", None),
                                    ("binary_packed", None), ("hier_fixed_k", None),
                                    ("bernoulli_seed_1bit", "dense_sim"),
                                    ("fixed_k_1bit", "none"))]
# the mean-center presets, whose wire bytes carry μ and values relative to
# it; the Bernoulli round's plain decode takes minutes on the CPU at 2^20 + 3
ROUND_CASES += [(n, preset, None, "gauss", d) for n in (3, 8)
                for preset, ds in (("fixed_k_1bit", (70_001, (1 << 20) + 3)),
                                   ("bernoulli_seed_1bit", (70_001,)),
                                   ("rotated_fixed_k", (70_001, (1 << 20) + 3)))
                for d in ds]


@pytest.mark.parametrize("n,preset,mode,data,d", ROUND_CASES)
def test_round_on_card_equals_cpu(dev, n, preset, mode, data, d):
    cfg = dataclasses.replace(compression_preset(preset, axes=("data",)), min_compress_size=1)
    if mode is not None:
        cfg = dataclasses.replace(cfg, mode=mode, scatter_decode=False)
    x = (_grid_stack if data == "grid" else _gauss_stack)(n, d, n)
    key = R.fold_in(R.PRNGKey(17), n)
    if data == "gauss":                           # every node's wire bytes
        codec = twire.resolve(cfg)
        for r in range(n):
            got = codec.pack(x[r].to(dev), key, r, cfg)
            want = codec.pack(x[r], key, r, cfg)
            assert torch.equal(got.cpu().view(torch.uint8), want.view(torch.uint8)), r
    got = tcoll.compressed_mean(x.to(dev), key, cfg, tcoll.StackedComm(n, dev))
    want = tcoll.compressed_mean(x, key, cfg, tcoll.StackedComm(n, "cpu"))
    assert _same(got.cpu(), want)


# the error-feedback presets and the training default with error feedback
EF_ROUND_CASES = ("ef_fixed_k", "ef_bernoulli", "ef_binary", "ef_ternary", "ef_rotated_binary",
                  "fixed_k_1bit")


@pytest.mark.parametrize("data,d", [("grid", 1 << 16), ("gauss", 70_001)])
@pytest.mark.parametrize("preset", EF_ROUND_CASES)
def test_ef_round_on_card_equals_cpu(dev, preset, data, d):
    """Two stateful rounds at n = 3 from the same nonzero residuals: the
    card's estimates and residuals equal the CPU's bit for bit (the 2-means
    sums, the ternary twin's mean and μ are fixed-order tree sums; the
    Bernoulli twin's unpack is kernel 2 from −0.0 on the card, the plain
    draw on the CPU)."""
    n = 3
    cfg = dataclasses.replace(compression_preset(preset, axes=("data",)), min_compress_size=1,
                              error_feedback=True)
    e0 = 0.1 * (_grid_stack if data == "grid" else _gauss_stack)(n, d, 7)
    states = {"cpu": e0.clone(), "cuda": e0.to(dev)}
    for t in range(2):
        x = (_grid_stack if data == "grid" else _gauss_stack)(n, d, n + t)
        key = R.fold_in(R.PRNGKey(17), t)
        got, states["cuda"] = tcoll.compressed_mean_stateful(
            x.to(dev), states["cuda"], key, cfg, tcoll.StackedComm(n, dev))
        want, states["cpu"] = tcoll.compressed_mean_stateful(
            x, states["cpu"], key, cfg, tcoll.StackedComm(n, "cpu"))
        assert _same(got.cpu(), want), t
        assert _same(states["cuda"].cpu(), states["cpu"]), t


def _same_or_nan(a, b):
    """Same bits, NaN where the other is NaN: a NaN's sign and payload are
    the platform's (the card returns its canonical NaN)."""
    na, nb = torch.isnan(a), torch.isnan(b)
    return torch.equal(na, nb) and torch.equal(a[~na].view(torch.int32),
                                               b[~nb].view(torch.int32))


ROBUST_PRESETS = sorted(p for p in COMPRESSION_PRESETS if p != "fixed_k_1bit")
# (decode_policy, whether one peer is dropped)
ROBUST_POLICIES = (("trim(1)", False), ("median", False), ("mean_trim(1)", False),
                   ("mean", True))


def _robust_stack(n, d):
    """Gaussian rows with a block of ±0.0 columns (ties in the sort)."""
    x = _gauss_stack(n, d, n + 3)
    x[:, :64] = 0.0
    x[1::2, :32] = -0.0
    return x


@pytest.mark.parametrize("n", (3, 8))
@pytest.mark.parametrize("policy,drop", ROBUST_POLICIES)
@pytest.mark.parametrize("preset", ROBUST_PRESETS)
def test_robust_round_on_card_equals_cpu(dev, preset, policy, drop, n):
    """One round with a dropped peer and one with each Byzantine row mode
    (rank 1's gathered wire row corrupted): card == CPU, NaN for NaN."""
    cfg = dataclasses.replace(robust_preset(preset, policy, axes=("data",)),
                              min_compress_size=1)
    d = 20_011
    x = _robust_stack(n, d)
    key = R.fold_in(R.PRNGKey(19), n)
    mask = torch.ones(n)
    mask[n - 1] = 0.0
    for mode in (None,) + ft.CORRUPTION_MODES:
        out = {}
        for where in ("cpu", dev):
            comm = tcoll.StackedComm(n, where)
            if mode is not None:
                comm = ft.ByzantineComm(comm, 1, mode)
            dm = mask.to(where) if drop or mode is None else None
            out[str(where)] = tcoll.compressed_mean(x.to(where), key, cfg, comm, drop_mask=dm)
        assert _same_or_nan(out[str(dev)].cpu(), out["cpu"]), mode


@pytest.mark.parametrize("preset", ("fixed_k_1bit",) + EF_ROUND_CASES[:-1])
def test_masked_round_on_card_equals_cpu(dev, preset):
    """The masked psum (``fixed_k_1bit``) and the five ``ef_*`` presets with
    a mask, one stateful round from nonzero residuals at n = 3."""
    n, d = 3, 70_001
    cfg = dataclasses.replace(compression_preset(preset, axes=("data",)), min_compress_size=1)
    e0 = 0.1 * _gauss_stack(n, d, 7)
    x = _gauss_stack(n, d, 4)
    mask = torch.tensor([1.0, 0.0, 1.0])
    got, st = tcoll.compressed_mean_stateful(x.to(dev), e0.clone().to(dev), R.PRNGKey(5), cfg,
                                             tcoll.StackedComm(n, dev), mask.to(dev))
    want, want_st = tcoll.compressed_mean_stateful(x, e0.clone(), R.PRNGKey(5), cfg,
                                                   tcoll.StackedComm(n, "cpu"), mask)
    assert _same(got.cpu(), want) and _same(st.cpu(), want_st)


@pytest.mark.parametrize("n", (3, 8))
def test_reduce_rows_on_card_equals_cpu_without_sync(dev, n):
    """Every kind and f over a stack with ±0.0 ties, NaN of both signs and
    ±Inf columns, masked and not, the mask on the card: no host sync (the
    sync debug mode raises on one), and card == CPU, NaN for NaN."""
    s = torch.randn(n, 4099, generator=torch.Generator().manual_seed(n))
    s[:, 0] = 0.0
    s[1::2, 0] = -0.0
    s[0, 1], s[1, 1] = float("nan"), -float("nan")
    s[:, 2] = float("nan")
    s[0, 3], s[1, 3] = float("inf"), -float("inf")
    s[:, 4:64] = torch.round(s[:, 4:64])
    masks = (None, torch.tensor([1.0, 0.0, 1.0] + [1.0] * (n - 3)), torch.zeros(n))
    sd = s.to(dev)
    for kind, f in (("mean", 0), ("trim", 1), ("median", 0), ("mean_trim", 1), ("mean_trim", 0)):
        for m in masks:
            md = None if m is None else m.to(dev)
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
            try:
                got = robust.reduce_rows(sd, kind, f, md)
            finally:
                torch.cuda.set_sync_debug_mode("default")
            assert _same_or_nan(got.cpu(), robust.reduce_rows(s, kind, f, m)), (kind, f, m)


# --------------------------------------------------------------------------- #
# The MoE block (plain torch: no kernel of its own) on the card against the
# CPU: the same routing, outputs within the dtype's tolerance, and a backward
# that gives the same bits twice (the train step's two issue schedules are
# held bit for bit on the card).
# --------------------------------------------------------------------------- #

def _moe_case(arch, capacity_factor, dtype, dev):
    cfg = dataclasses.replace(smoke_config(arch).moe, capacity_factor=capacity_factor)
    e, f, d = cfg.num_experts, cfg.d_ff_expert, 64
    g = torch.Generator().manual_seed(7)
    p = {"router": torch.randn(d, e, generator=g) * 0.1,
         "w_up": torch.randn(e, d, f, generator=g) * d ** -0.5,
         "w_gate": torch.randn(e, d, f, generator=g) * d ** -0.5,
         "w_down": torch.randn(e, f, d, generator=g) * f ** -0.5}
    if cfg.num_shared:
        fs = cfg.d_ff_shared
        p.update({"shared.w_up": torch.randn(d, fs, generator=g) * d ** -0.5,
                  "shared.w_gate": torch.randn(d, fs, generator=g) * d ** -0.5,
                  "shared.w_down": torch.randn(fs, d, generator=g) * fs ** -0.5})
    x = torch.randn(4, 64, d, generator=g).to(getattr(torch, dtype))
    return cfg, p, x, mcommon.ShardCtx(compute_dtype=getattr(torch, dtype))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("capacity_factor", [1.25, 0.5])
@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "qwen2-moe-a2.7b"])
def test_moe_block_on_card_equals_cpu(dev, arch, capacity_factor, dtype):
    cfg, p, x, ctx = _moe_case(arch, capacity_factor, dtype, dev)
    t = x.shape[0] * x.shape[1]
    routes = {}
    for where in ("cpu", dev):
        probs, _, ids = tmoe.route(p["router"].to(where), x.reshape(t, -1).to(where), cfg)
        top = torch.topk(probs, cfg.top_k + 1, dim=-1).values
        margin = top[:, cfg.top_k - 1] - top[:, cfg.top_k]
        routes[str(where)] = (ids.cpu(), margin.cpu())
    assert float(routes["cpu"][1].min()) > 1e-5             # no near-tie at these inputs
    assert torch.equal(routes["cpu"][0], routes[str(dev)][0])
    want, want_aux = tmoe.moe_block(ctx, p, x, cfg)
    got, got_aux = tmoe.moe_block(ctx, {k: v.to(dev) for k, v in p.items()}, x.to(dev), cfg)
    tol = dict(atol=1e-5, rtol=1e-5) if dtype == "float32" else dict(atol=2e-2, rtol=1e-2)
    torch.testing.assert_close(got.cpu().float(), want.float(), **tol)
    torch.testing.assert_close(got_aux.cpu(), want_aux, atol=0, rtol=1e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "qwen2-moe-a2.7b"])
def test_moe_backward_on_card_is_reproducible(dev, arch, dtype):
    """Capacity factor 0.5: dropped pairs collide on each expert's last
    slot in the combine's gather; two backward passes give the same bits."""
    cfg, p, x, ctx = _moe_case(arch, 0.5, dtype, dev)
    grads = []
    for _ in range(2):
        leaves = {k: v.to(dev).requires_grad_() for k, v in p.items()}
        xd = x.to(dev).requires_grad_()
        y, aux = tmoe.moe_block(ctx, leaves, xd, cfg)
        (y.float().square().sum() + aux).backward()
        grads.append([xd.grad] + [leaves[k].grad for k in sorted(leaves)])
    torch.cuda.synchronize()
    assert all(bool(torch.isfinite(g).all()) for g in grads[0])
    assert all(torch.equal(a, b) for a, b in zip(*grads))


# --------------------------------------------------------------------------- #
# The Mamba-2 block (plain torch: no kernel of its own) on the card against
# the CPU at the smoke SSM config in f32, its decode, a backward that gives
# the same bits twice, and TF32 refused for the scan's f32 products.
# --------------------------------------------------------------------------- #

def _ssm_case(seed: int = 21):
    cfg = smoke_config("mamba2-130m")
    s, d = cfg.ssm, cfg.d_model
    din, nh, n, w = s.d_inner(d), s.nheads(d), s.d_state, s.conv_width
    g = torch.Generator().manual_seed(seed)
    shapes = {"w_z": (d, din), "w_x": (d, din), "w_B": (d, n), "w_C": (d, n), "w_dt": (d, nh),
              "conv_x": (w, din), "conv_B": (w, n), "conv_C": (w, n), "A_log": (nh,),
              "D": (nh,), "dt_bias": (nh,), "norm": (din,), "w_out": (din, d)}
    p = {k: torch.randn(v, generator=g) * (v[0] ** -0.5 if len(v) > 1 else 1.0)
         for k, v in shapes.items()}
    x = torch.randn(2, 64, d, generator=g)
    return s, p, x, mcommon.ShardCtx(compute_dtype=torch.float32)


def _ssm_close(got, want):
    scale = float(want.abs().max())
    torch.testing.assert_close(got.cpu(), want, atol=1e-5 * scale, rtol=1e-5)


def test_mamba_block_on_card_equals_cpu(dev):
    cfg, p, x, ctx = _ssm_case()
    want, (wconv, wst) = tssm.mamba_block(ctx, p, x, cfg, return_state=True)
    got, (gconv, gst) = tssm.mamba_block(ctx, {k: v.to(dev) for k, v in p.items()}, x.to(dev),
                                         cfg, return_state=True)
    _ssm_close(got, want)
    _ssm_close(gst, wst)
    for k in wconv:                  # the windows hold the projections' last outputs
        _ssm_close(gconv[k], wconv[k])


def test_mamba_decode_on_card_equals_cpu(dev):
    cfg, p, x, ctx = _ssm_case(22)
    _, (conv, st) = tssm.mamba_block(ctx, p, x, cfg, return_state=True)
    conv = {k: v.to(torch.bfloat16) for k, v in conv.items()}
    tok = x[:, -1:] * 0.5
    want, (wconv, wst) = tssm.mamba_decode(ctx, p, tok, cfg, conv, st)
    got, (gconv, gst) = tssm.mamba_decode(ctx, {k: v.to(dev) for k, v in p.items()}, tok.to(dev),
                                          cfg, {k: v.to(dev) for k, v in conv.items()},
                                          st.to(dev))
    _ssm_close(got, want)
    _ssm_close(gst, wst)
    for k in wconv:
        _ssm_close(gconv[k], wconv[k])


def test_mamba_backward_on_card_is_reproducible(dev):
    cfg, p, x, ctx = _ssm_case(23)
    grads = []
    for _ in range(2):
        leaves = {k: v.to(dev).requires_grad_() for k, v in p.items()}
        xd = x.to(dev).requires_grad_()
        tssm.mamba_block(ctx, leaves, xd, cfg).square().sum().backward()
        grads.append([xd.grad] + [leaves[k].grad for k in sorted(leaves)])
    torch.cuda.synchronize()
    assert all(bool(torch.isfinite(g).all()) for g in grads[0])
    assert all(torch.equal(a, b) for a, b in zip(*grads))


def test_ssm_refuses_tf32(dev):
    cfg, p, x, ctx = _ssm_case()
    pd = {k: v.to(dev) for k, v in p.items()}
    old = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = True
    try:
        with pytest.raises(RuntimeError, match="allow_tf32"):
            tssm.mamba_block(ctx, pd, x.to(dev), cfg)
        with pytest.raises(RuntimeError, match="allow_tf32"):
            tssm.ssd_decode_step(torch.zeros(2, 8, 16, 16, device=dev),
                                 torch.zeros(2, 8, 16, device=dev), torch.zeros(2, 16, device=dev),
                                 torch.zeros(2, 16, device=dev), torch.zeros(2, 8, device=dev),
                                 torch.zeros(2, 8, device=dev))
    finally:
        torch.backends.cuda.matmul.allow_tf32 = old


# --------------------------------------------------------------------------- #
# The hybrid family (jamba-v0.1-52b): kernel 11 at its 32,768-token prompt
# (batch 1, 32/8 heads of 128), held to the plain version in 2048-row
# blocks (one block of 32k rows would take 137 GB of scores); the smoke
# model at two periods, f32, on the card against the CPU on the card's
# routes (the flash kernel at hd 16 there).
# --------------------------------------------------------------------------- #

def test_flash_attention_kernel_at_the_hybrid_long_prompt(dev):
    q, k, v = _qkv(dev, 1, 32768, 32768, 32, 8, 128, torch.bfloat16)
    before = backend.launches["flash_attention_fwd"]
    o = fao.flash_attention(q, k, v, causal=True)
    assert backend.launches["flash_attention_fwd"] == before + 1
    _, lse = fak.flash_attention_fwd(q, k, v, causal=True)
    op, lsep = far.flash_attention_fwd(q, k, v, causal=True, block_q=2048, block_k=2048)
    torch.cuda.synchronize()
    assert bool(torch.isfinite(o.float()).all())
    torch.testing.assert_close(o.float(), op.float(), atol=FLASH_TOL[torch.bfloat16], rtol=0)
    torch.testing.assert_close(lse, lsep, atol=1e-3, rtol=0)


def test_hybrid_forward_on_card_equals_cpu(dev):
    from repro_torch.models import model as tmodel
    from repro_torch.models import transformer as ttfm

    cfg = dataclasses.replace(smoke_config("jamba-v0.1-52b"), num_layers=8)
    run = RunConfig(attn_chunk_q=16, attn_chunk_k=16, remat=False, compute_dtype="float32")
    ctx = tmodel.make_ctx(cfg, run)
    params = tmodel.init(0, cfg, device="cpu")
    toks = torch.randint(0, cfg.vocab_size, (2, 64), generator=torch.Generator().manual_seed(5))
    route, log = tmoe.route, []

    def recorded(router, x, mcfg):
        out = route(router, x, mcfg)
        log.append(out[2].cpu())
        return out

    def forced(router, x, mcfg):
        probs, _, _ = route(router, x, mcfg)
        ids = log.pop(0)
        gates = probs.gather(1, ids)
        return probs, gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9), ids

    out = {}
    for where, fn in ((dev, recorded), ("cpu", forced)):
        tmoe.route = fn
        try:
            p = {k: v.to(where) for k, v in params.items()}
            x = tmodel.embed_inputs(ctx, p, cfg, {"tokens": toks.to(where)})
            h, aux, _ = ttfm.forward(ctx, p, cfg, run, x, torch.arange(64, device=where))
            out[str(where)] = (h.cpu(), aux.cpu())
        finally:
            tmoe.route = route
    assert not log
    (hc, ac), (hh, ah) = out[str(dev)], out["cpu"]
    assert float((hc.double() - hh.double()).norm() / hh.double().norm()) <= 5e-3
    torch.testing.assert_close(ac, ah, atol=0, rtol=1e-5)


# --------------------------------------------------------------------------- #
# The encoder-decoder family (whisper-medium): no kernel (its attention is
# the plain chunked softmax, as the reference's); the smoke model's f32
# encoder and decoder on the card against the CPU, and a training batch's
# loss and gradients there, at phase 4c's limit on hidden states.
# --------------------------------------------------------------------------- #

def test_encdec_forward_on_card_equals_cpu(dev):
    from repro_torch.models import encdec as tencdec
    from repro_torch.models import model as tmodel

    cfg = smoke_config("whisper-medium")
    run = RunConfig(attn_chunk_q=16, attn_chunk_k=16, remat=False, compute_dtype="float32")
    ctx = tmodel.make_ctx(cfg, run)
    params = tmodel.init(0, cfg, device="cpu")
    batch = SyntheticLM(cfg, ShapeSpec("t", "train", 64, 2)).batch(0, "cpu")
    out = {}
    before = dict(backend.launches)
    for where in (dev, torch.device("cpu")):
        p = {k: v.to(where).requires_grad_() for k, v in params.items()}
        b = {k: v.to(where) for k, v in batch.items()}
        enc = tencdec.encode(ctx, p, cfg, run, b["frames"])
        h, _ = tencdec._decoder_forward(ctx, p, cfg, run,
                                        tencdec.embed_decoder(ctx, p, cfg, b["tokens"]), enc,
                                        False)
        loss, _ = tmodel.train_loss(ctx, p, cfg, run, b, 128.0)
        grads = torch.autograd.grad(loss, [p[k] for k in sorted(p)])
        out[where.type] = (h.detach().cpu(), float(loss), [g.cpu() for g in grads])
    assert dict(backend.launches) == before
    (hc, lc, gc), (hh, lh, gh) = out["cuda"], out["cpu"]
    assert bool(torch.isfinite(hc).all())
    assert float((hc.double() - hh.double()).norm() / hh.double().norm()) <= 5e-3
    assert abs(lc - lh) <= 1e-5 * abs(lh)
    for a, b in zip(gc, gh):
        assert float((a.double() - b.double()).norm() / b.double().norm()) <= 5e-3


# --------------------------------------------------------------------------- #
# The VLM family (llava-next-34b): its heads (56/8, g = 7) are in the kernel
# cases above; the smoke model (2 layers, 8 patches) in f32 on the card (the
# flash kernel at hd 16) against the CPU, forward and a training batch's loss
# and gradients, at phase 4c's limit on hidden states.
# --------------------------------------------------------------------------- #

def test_vlm_forward_and_grads_on_card_equal_cpu(dev):
    from repro_torch.models import model as tmodel
    from repro_torch.models import transformer as ttfm

    cfg = smoke_config("llava-next-34b")
    run = RunConfig(attn_chunk_q=16, attn_chunk_k=16, remat=False, compute_dtype="float32")
    ctx = tmodel.make_ctx(cfg, run)
    params = tmodel.init(0, cfg, device="cpu")
    batch = SyntheticLM(cfg, ShapeSpec("t", "train", 64, 2)).batch(0, "cpu")
    out = {}
    backend.reset_launches()
    for where in (dev, torch.device("cpu")):
        p = {k: v.to(where).requires_grad_() for k, v in params.items()}
        b = {k: v.to(where) for k, v in batch.items()}
        x = tmodel.embed_inputs(ctx, p, cfg, b)
        h, _, _ = ttfm.forward(ctx, p, cfg, run, x, torch.arange(64, device=where))
        loss, _ = tmodel.train_loss(ctx, p, cfg, run, b, 128.0)
        grads = torch.autograd.grad(loss, [p[k] for k in sorted(p)])
        out[where.type] = (h.detach().cpu(), float(loss), [g.cpu() for g in grads])
    assert backend.launches["flash_attention_fwd_hd16"] == 2 * cfg.num_layers
    assert backend.launches["flash_attention_bwd_dq_hd16"] == cfg.num_layers
    (hc, lc, gc), (hh, lh, gh) = out["cuda"], out["cpu"]
    assert bool(torch.isfinite(hc).all())
    assert float((hc.double() - hh.double()).norm() / hh.double().norm()) <= 5e-3
    assert abs(lc - lh) <= 1e-5 * abs(lh)
    for a, b in zip(gc, gh):
        assert float((a.double() - b.double()).norm() / b.double().norm()) <= 5e-3


# --------------------------------------------------------------------------- #
# FSDP with a pod axis: the stacked (pod 2, data 2) step of the dense smoke in
# f32 compute, two steps under fixed_k_1bit over pod, on the card against the
# CPU from the same parameters (kernel 4 once per pod rank and round: an FSDP
# shard bucket's round once per data coordinate; the flash kernels at hd 16).
# --------------------------------------------------------------------------- #

def test_multipod_fsdp_step_on_card_equals_cpu(dev):
    from repro_torch.models import model as tmodel

    cfg = smoke_config("mistral-large-123b")
    cmp = dataclasses.replace(compression_preset("fixed_k_1bit", axes=("pod",)),
                              min_compress_size=1024)
    run = RunConfig(fsdp=True, attn_chunk_q=16, attn_chunk_k=16, remat=False,
                    compute_dtype="float32", compression=cmp)
    shape = ShapeSpec("t", "train", 64, 4)
    mesh = {"pod": 2, "data": 2}
    params = tmodel.init(0, cfg, device="cpu")
    out = {}
    for where in (dev, torch.device("cpu")):
        step_fn, init_fn, plan = build_train_step(cfg, run, shape, device=where, mesh=mesh)
        _, opt, ef = init_fn(0)
        p = {k: v.to(where) for k, v in params.items()}
        data = SyntheticLM(cfg, shape)
        backend.reset_launches()
        metrics = []
        for step in range(2):
            p, opt, ef, m = step_fn(p, opt, ef, data.batch(step, where), step)
            metrics.append((float(m["loss"]), float(m["grad_norm"])))
        out[where.type] = (metrics, {k: v.cpu() for k, v in p.items()}, dict(backend.launches))
    (mc, pc, lc), (mh, ph, _) = out["cuda"], out["cpu"]
    shard = [b for b in plan.buckets if b.kind == "compressed" and not b.eaxes]
    other = [b for b in plan.buckets if b.kind == "compressed" and b.eaxes]
    assert shard and other
    assert lc["fixed_k_gather"] == 2 * (2 * 2 * len(shard) + 2 * len(other))
    assert lc["flash_attention_fwd_hd16"] == 2 * 4 * cfg.num_layers
    for (lcu, gcu), (lh, gh) in zip(mc, mh):
        assert abs(lcu - lh) <= 1e-5 * abs(lh) and abs(gcu - gh) <= 1e-3 * abs(gh)
    for k in ph:
        assert bool(torch.isfinite(pc[k]).all()), k
        assert float((pc[k].double() - ph[k].double()).norm() / ph[k].double().norm()) <= 5e-3, k
