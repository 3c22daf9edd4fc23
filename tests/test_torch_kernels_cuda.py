"""The port's CUDA kernels against their plain versions, on a card.

Marked ``cuda``; every test skips, with its reason, where no CUDA device is
present (decided in a fixture, never at import).  On a card:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_kernels_cuda.py

``chip_smoke.py`` runs the same comparisons at the main path's shapes.
"""
import pytest
import torch

from repro_torch import random as R
from repro_torch.core import bitplane as cbp
from repro_torch.core import comm_cost
from repro_torch.core import rotation
from repro_torch.kernels.bernoulli_wire import kernel as bwk
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

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


def _same(a, b):
    return torch.equal(a.view(torch.int32), b.view(torch.int32))


@pytest.mark.parametrize("d,p,cap", [(1, 0.5, None), (70001, 1 / 16, None),
                                     (70001, 1 / 16, 100), (4103, 0.3, None)])
def test_encode_kernel_equals_plain(dev, d, p, cap):
    cap = cap or comm_cost.bernoulli_capacity(d, p)
    x = torch.randn(d, device=dev, generator=torch.Generator(dev).manual_seed(d))
    key = R.fold_in(R.PRNGKey(1), 2)
    mu = x.mean()
    assert _same(bwk.encode(x, key, mu, p=p, cap=cap), bwr.encode(x, key, p, cap, mu))


@pytest.mark.parametrize("d,n,cap", [(33, 2, None), (70001, 8, None), (5000, 4, 1500)])
def test_decode_kernels_equal_plain(dev, d, n, cap):
    p = 1 / 16 if cap is None else 0.5
    cap = cap or comm_cost.bernoulli_capacity(d, p)
    g = torch.Generator(dev).manual_seed(d)
    bufs = torch.randn(n, cap, device=dev, generator=g)
    mus = torch.randn(n, device=dev, generator=g)
    keys = torch.stack([R.fold_in(R.PRNGKey(d), i) for i in range(n)])
    want = bwr.decode_sum_sequential(bufs, mus, keys, p, cap, d)
    assert _same(bwk.decode_sum(bufs, mus, keys, p=p, cap=cap, d=d), want)
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


@pytest.mark.parametrize("b,m", [(1, 0), (3, 1), (2, 5), (3, 8), (2, 13), (3, 14), (2, 17)])
def test_fwht_and_rotate_minmax_equal_plain(dev, b, m):
    """One pass up to 2^13, two beyond; odd m, where sqrt(c) is not a power
    of two, included."""
    c = 1 << m
    x = torch.randn(b, c, device=dev, generator=torch.Generator(dev).manual_seed(b * c))
    assert _same(hk.fwht(x), hr.fwht(x))
    signs = R.rademacher(R.PRNGKey(m), (b, c), dev)
    scale = float(rotation.chunk_scale(c, "cpu"))
    z, mm = rek.rotate_minmax(x, signs, scale)
    zp, mmp = rer.rotate_minmax(x, signs, scale)
    assert _same(z, zp) and _same(mm, mmp)


@pytest.mark.parametrize("dp", (1, 33, 70001, 131072))
def test_encode_pack_equals_plain(dev, dp):
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
