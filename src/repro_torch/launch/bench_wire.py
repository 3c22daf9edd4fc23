"""Kernels 1, 2, 3 (decode half), 6, 7, 8, 9 and 10 timed on the card at the
main path's shapes, beside another build of their sources.

    PYTHONPATH=src python -m repro_torch.launch.bench_wire \
        [--baseline-dir OLD/src/repro_torch/csrc] [--profile] \
        [--only KERNEL ...] [--out PATH.json]

Shapes (:func:`cases`), from the main path's largest bucket (qwen3-4b's
embedding, 388,956,160 coordinates, ``train/synthetic.py::main_shapes``):

* kernel 1, the seed-trick Bernoulli encode (``kernels/bernoulli_wire``), at
  d = 388,956,160, p = 1/16, cap = ``bernoulli_capacity(d, p)``;
* kernel 2, the flat Bernoulli decode, at the same d, p and cap over n = 8
  peers (``synthetic.N``): seeded buffers and centers, keys folded per rank
  as ``chip_smoke.py`` folds them;
* kernel 3's decode half (the scan and decode of ``decode_sum_shard``) on
  shard N − 2 of ⌈d/8⌉ coordinates, its support and prior counts from the
  count phase of this build;
* kernel 6, the bit-plane unpack (``kernels/bitplane``), of seeded words
  starting one word into their buffer (4-byte aligned, as a gathered row's
  plane is): ``bitplane_unpack_w1`` and ``bitplane_unpack_w2`` at d =
  388,956,160 (the binary and ternary planes), ``bitplane_unpack_w1_rotated``
  at dp = 371 · 2²⁰ (``rotated_binary``'s decode);
* kernel 7, the binary accumulate (``bitplane_binary_accum``), over the n =
  8 peers' word windows of shard N − 2 of ⌈d/8⌉ coordinates, views of
  seeded rows [plane ‖ one tail word] as the §13 decode passes them;
* kernel 8, the FWHT (``kernels/hadamard``), at (371, 2²⁰): the bucket's
  block-diagonal rotation chunks;
* kernel 9, rotate + (min, max) (``kernels/rotated_encode``), at the same
  rows with seeded ±1 signs;
* kernel 10, the rotated 1-bit encode-pack, at dp = 371 · 2²⁰ of seeded z,
  (vmin, vmax) its extremes.

Only the inputs of the kernels ``--only`` names are made, and only their
sources built.  Each is timed by CUDA events (20 calls after a warm-up).  With
``--baseline-dir`` (a ``git archive`` of another revision's
``src/repro_torch/csrc``, headers included) the same functions of that
revision's ``bernoulli_wire.cu``, ``bitplane.cu``, ``hadamard.cu`` and
``rotated_encode.cu`` are built with the port's ``nvcc`` flags and timed in turns: baseline, new,
new, baseline; their outputs are held bit-equal to the new ones.  The
baseline's C entry points are called with the signatures they have: the
three-launch encode (``bw_support_counts``, ``bw_scan_rows``,
``bw_encode_write``) or ``bw_encode``; the three-launch decode
(``bw_support_counts``, ``bw_scan_rows``, ``bw_decode``) or
``bw_decode_sum``, and ``bw_scan_rows`` + ``bw_decode`` or
``bw_decode_sum_shard`` for the shard; the scratch-free ``hd_fwht`` and
``re_rotate_minmax`` of older revisions, or this revision's; ``bp_unpack``
and ``bp_binary_accum`` as they are.  Prints, and
writes as JSON, the card's name and power limit, each kernel's ms, its
bound (bytes over 3.35 TB/s, int32 operations over 16.75 T/s, as
``chip_smoke.py`` counts them) and its share of the bound.  With
``--profile`` it also runs 5 calls of each (and of the baseline's) under
``torch.profiler`` and reports the device ms per launch of every CUDA
kernel they launch, by name: the split between a function's kernels.
Exits 1 if a baseline disagrees.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import pathlib
import subprocess

import torch

from repro_torch import random as prandom
from repro_torch import resolve_device
from repro_torch.core import comm_cost
from repro_torch.kernels import backend
from repro_torch.kernels.bernoulli_wire import kernel as bwk
from repro_torch.kernels.bernoulli_wire import ref as bwr
from repro_torch.kernels.bitplane import bitplane as bpk
from repro_torch.kernels.bitplane import ref as bpr
from repro_torch.kernels.hadamard import hadamard as hk
from repro_torch.kernels.rotated_encode import kernel as rek
from repro_torch.launch.bench_encode_speed import device_line, time_ms
from repro_torch.train.synthetic import N

D = 388_956_160            # qwen3-4b's embedding bucket (the main path's largest)
ROWS = -(-D // (1 << 20))  # its rotation's rows of 2^20
SHARD = -(-D // N)         # its §12 shard length
P = 1 / 16
HBM_BYTES_PER_S = 3.35e12                # H100 SXM, NVIDIA data sheet
INT32_OPS_PER_S = 67e12 * 64 / (128 * 2)  # chip_smoke.py's int32 rate
OPS_PER_CALL = 72                        # int32 operations of one Threefry call

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
SOURCES = ("bernoulli_wire", "bitplane", "hadamard", "rotated_encode")


def bound_ms(nbytes: float, int_ops: float = 0.0):
    tb = nbytes / HBM_BYTES_PER_S * 1e3
    to = int_ops / INT32_OPS_PER_S * 1e3
    return (tb, "bytes") if tb >= to else (to, "operations")


def build_baseline(src_dir: pathlib.Path, names=SOURCES) -> dict:
    """lib<name>_baseline.so for each of ``names`` in ``src_dir``, built in
    parallel with the port's flags (headers from ``src_dir``)."""
    out_dir = backend.BUILD_DIR.parent / "baseline"
    out_dir.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        so = out_dir / f"lib{name}_baseline.so"
        cmd = [backend.nvcc_path(), *backend.NVCC_FLAGS, "-I", str(src_dir), "-o", str(so),
               str(src_dir / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                                        text=True), so)
    libs = {}
    for name, (proc, so) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for the baseline's {name}.cu:\n{log}")
        libs[name] = ctypes.CDLL(str(so))
    return libs


def _sig(lib, name, argtypes, restype=ctypes.c_int):
    f = getattr(lib, name)
    f.argtypes, f.restype = argtypes, restype
    return f


def _check(err, what):
    backend.check_launch(err, f"baseline {what}")


def baseline_encode(lib, x, key, mu, cap):
    """The baseline's encode of x into a fresh (cap,) buffer, as a call."""
    dev, d = x.device, x.shape[0]
    p32, inv_p, c = bwr.coefficients(P)
    k0, k1 = (int(w) & 0xFFFFFFFF for w in torch.as_tensor(key).reshape(2))
    out = torch.empty(cap, dtype=torch.float32, device=dev)
    if hasattr(lib, "bw_encode"):
        nbytes = _sig(lib, "bw_encode_scratch_bytes", [_I64], _I64)(d)
        work = torch.empty(nbytes, dtype=torch.uint8, device=dev)
        fn = _sig(lib, "bw_encode", [ctypes.c_uint32, ctypes.c_uint32, _P, _I64, ctypes.c_float,
                                     _I64, ctypes.c_float, ctypes.c_float, _P, _P, _P, _P])

        def call():
            _check(fn(k0, k1, x.data_ptr(), d, p32, cap, inv_p, c, mu.data_ptr(), out.data_ptr(),
                      work.data_ptr(), backend.stream_ptr(dev)), "bw_encode")
        return call, out
    count = _sig(lib, "bw_support_counts", [_P, ctypes.c_int, _I64, _I64, _I64, ctypes.c_float,
                                            _P, _P, _P])
    scan = _sig(lib, "bw_scan_rows", [_P, _P, ctypes.c_int, _I64, _P, _P, _P])
    write = _sig(lib, "bw_encode_write", [_P, _P, _P, _P, _I64, _I64, ctypes.c_float,
                                          ctypes.c_float, _P, _P, _P])
    keys = (ctypes.c_uint32 * 2)(k0, k1)
    nck = bwr.num_chunks(d)
    counts = torch.empty(nck, dtype=torch.int32, device=dev)
    mask = torch.empty(nck * bwr.WORDS, dtype=torch.int32, device=dev)
    offsets = torch.empty_like(counts)
    total = torch.empty(1, dtype=torch.int32, device=dev)

    def call():
        s = backend.stream_ptr(dev)
        _check(count(keys, 1, 0, d, d, p32, counts.data_ptr(), mask.data_ptr(), s), "count")
        _check(scan(counts.data_ptr(), None, 1, nck, offsets.data_ptr(), total.data_ptr(), s),
               "scan")
        _check(write(x.data_ptr(), mask.data_ptr(), offsets.data_ptr(), total.data_ptr(), d, cap,
                     inv_p, c, mu.data_ptr(), out.data_ptr(), s), "encode write")
    return call, out


def _offsets_call(lib, counts, init, ds, n):
    """The parent's row scan of (n, chunks) counts into fresh offsets."""
    scan = _sig(lib, "bw_scan_rows", [_P, _P, ctypes.c_int, _I64, _P, _P, _P])
    offsets = torch.empty_like(counts)
    totals = torch.empty(n, dtype=torch.int32, device=counts.device)

    def call(s):
        _check(scan(counts.data_ptr(), None if init is None else init.data_ptr(), n,
                    bwr.num_chunks(ds), offsets.data_ptr(), totals.data_ptr(), s), "scan")
    return call, offsets


def _decode_call(lib, bufs, mus, mask, offsets, ds, cap, out):
    fn = _sig(lib, "bw_decode", [_P, _I64, _P, _P, _P, ctypes.c_int, _I64, _I64, _P, _P])
    return lambda s: _check(fn(bufs.data_ptr(), bufs.stride(0), mus.data_ptr(), mask.data_ptr(),
                               offsets.data_ptr(), bufs.shape[0], ds, cap, out.data_ptr(), s),
                            "decode")


def baseline_decode(lib, bufs, mus, keys, cap):
    """The baseline's flat decode of (n, cap) buffers into a fresh (D,) sum."""
    dev, n = bufs.device, bufs.shape[0]
    p32 = bwr.coefficients(P)[0]
    kh = (ctypes.c_uint32 * (2 * n))(*[int(w) & 0xFFFFFFFF for w in keys.reshape(-1)])
    out = torch.empty(D, dtype=torch.float32, device=dev)
    if hasattr(lib, "bw_decode_sum"):
        nbytes = _sig(lib, "bw_decode_scratch_bytes", [ctypes.c_int, _I64], _I64)(n, D)
        work = torch.empty(nbytes, dtype=torch.uint8, device=dev)
        fn = _sig(lib, "bw_decode_sum", [_P, ctypes.c_int, _I64, ctypes.c_float, _P, _I64, _P,
                                         _I64, _P, _P, _P])

        def call():
            _check(fn(kh, n, D, p32, bufs.data_ptr(), bufs.stride(0), mus.data_ptr(), cap,
                      out.data_ptr(), work.data_ptr(), backend.stream_ptr(dev)), "bw_decode_sum")
        return call, out
    count = _sig(lib, "bw_support_counts", [_P, ctypes.c_int, _I64, _I64, _I64, ctypes.c_float,
                                            _P, _P, _P])
    nck = bwr.num_chunks(D)
    counts = torch.empty((n, nck), dtype=torch.int32, device=dev)
    mask = torch.empty((n, nck * bwr.WORDS), dtype=torch.int32, device=dev)
    scan, offsets = _offsets_call(lib, counts, None, D, n)
    decode = _decode_call(lib, bufs, mus, mask, offsets, D, cap, out)

    def call():
        s = backend.stream_ptr(dev)
        _check(count(kh, n, 0, D, D, p32, counts.data_ptr(), mask.data_ptr(), s), "count")
        scan(s)
        decode(s)
    return call, out


def baseline_decode_shard(lib, bufs, mus, sup, prior, cap):
    """The baseline's scan and decode of one shard's support."""
    dev, n = bufs.device, bufs.shape[0]
    out = torch.empty(sup.ds, dtype=torch.float32, device=dev)
    if hasattr(lib, "bw_decode_sum_shard"):
        nbytes = _sig(lib, "bw_shard_scratch_bytes", [ctypes.c_int, _I64], _I64)(n, sup.ds)
        work = torch.empty(nbytes, dtype=torch.uint8, device=dev)
        fn = _sig(lib, "bw_decode_sum_shard", [_P, _I64, _P, _P, _P, _P, ctypes.c_int, _I64,
                                               _I64, _P, _P, _P])

        def call():
            _check(fn(bufs.data_ptr(), bufs.stride(0), mus.data_ptr(), sup.counts.data_ptr(),
                      sup.mask.data_ptr(), prior.data_ptr(), n, sup.ds, cap, out.data_ptr(),
                      work.data_ptr(), backend.stream_ptr(dev)), "bw_decode_sum_shard")
        return call, out
    scan, offsets = _offsets_call(lib, sup.counts, prior, sup.ds, n)
    decode = _decode_call(lib, bufs, mus, sup.mask, offsets, sup.ds, cap, out)

    def call():
        s = backend.stream_ptr(dev)
        scan(s)
        decode(s)
    return call, out


def baseline_encode_pack(lib, z, key, vmm):
    dp = z.numel()
    k0, k1 = (int(w) & 0xFFFFFFFF for w in torch.as_tensor(key).reshape(2))
    out = torch.empty(-(-dp // 32), dtype=torch.int32, device=z.device)
    fn = _sig(lib, "re_encode_pack", [_P, _I64, ctypes.c_uint32, ctypes.c_uint32, _P, _P, _P])
    return (lambda: _check(fn(z.data_ptr(), dp, k0, k1, vmm.data_ptr(), out.data_ptr(),
                              backend.stream_ptr(z.device)), "re_encode_pack")), out


def baseline_fwht(lib, x):
    b, c = x.shape
    out = torch.empty_like(x)
    s = backend.stream_ptr(x.device)
    if hasattr(lib, "hd_scratch_bytes"):
        work = hk.scratch(_sig(lib, "hd_scratch_bytes", [_I64, _I64], _I64)(b, c), x.device)
        fn = _sig(lib, "hd_fwht", [_P, _P, _I64, _I64, _P, _P])
        return (lambda: _check(fn(x.data_ptr(), out.data_ptr(), b, c, work.data_ptr(), s),
                               "hd_fwht")), out
    fn = _sig(lib, "hd_fwht", [_P, _P, _I64, _I64, _P])
    return (lambda: _check(fn(x.data_ptr(), out.data_ptr(), b, c, s), "hd_fwht")), out


def baseline_rotate(lib, x, signs, scale):
    b, c = x.shape
    z = torch.empty_like(x)
    mm = torch.empty((b, 2), dtype=torch.float32, device=x.device)
    s = backend.stream_ptr(x.device)
    if hasattr(lib, "re_scratch_bytes"):
        nbytes = _sig(lib, "re_scratch_bytes", [_I64, _I64], _I64)(b, c)
    else:
        nbytes = 8 * b * _sig(lib, "re_partials_per_row", [_I64], _I64)(c)
    work = hk.scratch(nbytes, x.device)
    fn = _sig(lib, "re_rotate_minmax", [_P, _P, _P, _P, _P, _I64, _I64, ctypes.c_float, _P])
    return (lambda: _check(fn(x.data_ptr(), signs.data_ptr(), z.data_ptr(), mm.data_ptr(),
                              work.data_ptr(), b, c, scale, s), "re_rotate_minmax")), (z, mm)


def baseline_unpack(lib, words, width, d):
    out = torch.empty(d, dtype=bpr.symbol_dtype(width), device=words.device)
    fn = _sig(lib, "bp_unpack", [_P, _I64, ctypes.c_int, _P, ctypes.c_int, _P])
    return (lambda: _check(fn(words.data_ptr(), d, width, out.data_ptr(), out.element_size(),
                              backend.stream_ptr(words.device)), "bp_unpack")), out


def baseline_binary_accum(lib, win, lo, hi, d):
    out = torch.empty(d, dtype=torch.float32, device=win.device)
    fn = _sig(lib, "bp_binary_accum", [_P, _I64, ctypes.c_int, _P, _P, _I64, _P, _P])
    return (lambda: _check(fn(win.data_ptr(), win.stride(0), win.shape[0], lo.data_ptr(),
                              hi.data_ptr(), d, out.data_ptr(), backend.stream_ptr(win.device)),
                           "bp_binary_accum")), out


def same_bits(a, b) -> bool:
    if a.dtype.is_floating_point:
        a, b = a.view(torch.int32), b.view(torch.int32)
    return torch.equal(a, b)


def bernoulli_cases(device, gen):
    """Kernels 1, 2 and 3's decode half."""
    flat = torch.randn(D, generator=gen, device=device) * 0.5 + 0.1
    mu = flat.mean()
    key = prandom.fold_in(prandom.PRNGKey(7), 3)
    cap = comm_cost.bernoulli_capacity(D, P)
    bufs = torch.randn(N, cap, generator=gen, device=device) * 0.7
    mus = torch.randn(N, generator=gen, device=device) * 0.1
    base = prandom.PRNGKey(D)
    keys = torch.stack([prandom.fold_in(base, i) for i in range(N)])
    shard = N - 2
    sup = bwk.support_counts(keys, p=P, d=D, start=shard * SHARD, ds=SHARD, device=device)
    before = bwk.support_counts(keys, p=P, d=D, start=0, ds=shard * SHARD, device=device)
    prior = before.counts.sum(1, dtype=torch.int32)
    del before
    nck = sup.counts.shape[1]
    kept = int((cap - prior.long()).clamp(min=0).clamp(max=sup.counts.sum(1).long()).sum())
    return {
        "bernoulli_encode": (lambda: bwk.encode(flat, key, mu, p=P, cap=cap),
                             lambda lib: baseline_encode(lib["bernoulli_wire"], flat, key, mu, cap),
                             bound_ms(4 * D + 4 * cap, OPS_PER_CALL * -(-D // 2)),
                             {"d": D, "p": P, "cap": cap}),
        "bernoulli_decode_sum": (lambda: bwk.decode_sum(bufs, mus, keys, p=P, cap=cap, d=D),
                                 lambda lib: baseline_decode(lib["bernoulli_wire"], bufs, mus,
                                                             keys, cap),
                                 bound_ms(4 * N * cap + 4 * N + 4 * D,
                                          OPS_PER_CALL * N * -(-D // 2)),
                                 {"d": D, "n": N, "p": P, "cap": cap}),
        "bernoulli_decode_sum_shard": (
            lambda: bwk.decode_sum_shard(bufs, mus, sup, prior, cap=cap),
            lambda lib: baseline_decode_shard(lib["bernoulli_wire"], bufs, mus, sup, prior, cap),
            bound_ms(4 * kept + N * nck * 128 + 4 * N * nck + 4 * N + 4 * SHARD),
            {"d": D, "n": N, "shard": shard, "ds": SHARD, "cap": cap}),
    }


def _bits32(shape, gen, device):
    return torch.randint(-(1 << 31), 1 << 31, shape, generator=gen, device=device,
                         dtype=torch.int64).to(torch.int32)


def bitplane_cases(device, gen):
    """Kernel 6 at w = 1 and 2 (d = D) and at w = 1 (dp = 371 · 2²⁰);
    kernel 7 on shard N − 2 of the binary plane's §13 split."""
    out = {}
    for name, width, d in (("bitplane_unpack_w1", 1, D), ("bitplane_unpack_w2", 2, D),
                           ("bitplane_unpack_w1_rotated", 1, ROWS << 20)):
        nw = bpr.num_words(d, width)
        words = _bits32((nw + 1,), gen, device)[1:]

        def call(words=words, width=width, d=d):
            return bpk.unpack_bits(words, width, d)

        def factory(lib, words=words, width=width, d=d):
            return baseline_unpack(lib["bitplane"], words, width, d)
        out[name] = (call, factory, bound_ms(4 * nw + d, 2 * d),
                     {"d": d, "width": width})
    ds = -(-SHARD // 32) * 32
    ws, pw, shard = ds // 32, bpr.num_words(D, 1), N - 2
    rows = _bits32((N, pw + 1), gen, device)
    win = rows[:, shard * ws:(shard + 1) * ws]
    lo = torch.randn(N, generator=gen, device=device)
    hi = lo + torch.rand(N, generator=gen, device=device)
    out["bitplane_binary_accum"] = (
        lambda: bpk.binary_accum(win, lo, hi, ds),
        lambda lib: baseline_binary_accum(lib["bitplane"], win, lo, hi, ds),
        bound_ms(4 * N * ws + 8 * N + 4 * ds, N * ds),
        {"d": D, "n": N, "shard": shard, "ds": ds, "ld": pw + 1})
    return out


def rotation_cases(device, gen):
    """Kernels 8, 9 and 10 at (371, 2²⁰)."""
    x = torch.randn(ROWS, 1 << 20, generator=gen, device=device) * 0.02
    signs = prandom.rademacher(prandom.fold_in(prandom.PRNGKey(11), 2), x.shape, device)
    scale = float(torch.sqrt(torch.tensor(float(1 << 20))))
    n = x.numel()
    z = torch.randn(n, generator=gen, device=device)
    vmm = torch.stack([z.amin(), z.amax()])
    kenc = prandom.fold_in(prandom.fold_in(prandom.PRNGKey(11), 2), 5)
    return {
        "fwht": (lambda: hk.fwht(x), lambda lib: baseline_fwht(lib["hadamard"], x),
                 bound_ms(8 * n), {"rows": ROWS, "c": 1 << 20}),
        "rotate_minmax": (lambda: rek.rotate_minmax(x, signs, scale),
                          lambda lib: baseline_rotate(lib["rotated_encode"], x, signs, scale),
                          bound_ms(12 * n + 8 * ROWS), {"rows": ROWS, "c": 1 << 20}),
        "encode_pack": (lambda: rek.encode_pack(z, kenc, vmm[0], vmm[1], n),
                        lambda lib: baseline_encode_pack(lib["rotated_encode"], z, kenc, vmm),
                        bound_ms(4 * n + 4 * -(-n // 32) + 8, OPS_PER_CALL * -(-n // 2)),
                        {"dp": n}),
    }


# kernel names by the source that holds them, and the function making their
# inputs
GROUPS = {
    "bernoulli_wire": (("bernoulli_encode", "bernoulli_decode_sum",
                        "bernoulli_decode_sum_shard"), bernoulli_cases),
    "bitplane": (("bitplane_unpack_w1", "bitplane_unpack_w2", "bitplane_unpack_w1_rotated",
                  "bitplane_binary_accum"), bitplane_cases),
    "hadamard": (("fwht",), rotation_cases),
    "rotated_encode": (("rotate_minmax", "encode_pack"), rotation_cases),
}
KERNELS = tuple(k for names, _ in GROUPS.values() for k in names)


def sources_for(only) -> tuple:
    """The sources holding the kernels ``only`` names (all for None)."""
    return tuple(src for src, (names, _) in GROUPS.items()
                 if only is None or any(k in only for k in names))


def cases(device, only=None):
    """{name: (kernel call, baseline factory, (bound ms, bound by), shape)}
    at the main path's shapes, on seeded inputs, for the kernels ``only``
    names (all for None); a factory takes the baseline's libraries and
    returns (call, its preallocated output(s))."""
    gen = torch.Generator(device=device).manual_seed(19)
    out = {}
    for src in sources_for(only):
        make = GROUPS[src][1]
        if not any(k in out for k in GROUPS[src][0]):
            out.update(make(device, gen))
    return {k: v for k, v in out.items() if only is None or k in only}


def kernel_split(fn, calls: int = 5) -> dict:
    """{kernel name: [launches, device ms per launch]} over ``calls`` calls
    of fn under torch.profiler."""
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    split = {}
    for e in prof.key_averages():
        t = getattr(e, "device_time_total", 0.0)
        if t and e.count:
            split[e.key[:120]] = [e.count, t / e.count / 1e3]
    return split


def flat_outputs(o):
    return list(o) if isinstance(o, tuple) else [o]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--baseline-dir", type=pathlib.Path, default=None,
                    help="another revision's src/repro_torch/csrc to time beside this one")
    ap.add_argument("--profile", action="store_true",
                    help="also report each kernel's device ms per launch (torch.profiler)")
    ap.add_argument("--only", nargs="+", default=None, metavar="KERNEL", choices=KERNELS,
                    help="time only these of the kernels (names as in the output)")
    ap.add_argument("--out", default="chiprun_out/bench_wire.json")
    args = ap.parse_args(argv)
    dev = resolve_device(None)
    card = device_line(dev)
    print(card, flush=True)
    names = sources_for(args.only)
    backend.build(names)
    libs = build_baseline(args.baseline_dir, names) if args.baseline_dir else None
    result = {"device": card, "torch": torch.__version__,
              "baseline": str(args.baseline_dir) if args.baseline_dir else None, "rows": []}
    ok = True
    for name, (kernel, factory, (bound, by), shape) in cases(dev, args.only).items():
        row = {"kernel": name, **shape, "bound_ms": bound, "bound_by": by}
        if libs is not None:
            call, bout = factory(libs)
            call()
            got = kernel()
            torch.cuda.synchronize(dev)
            row["baseline_bit_equal"] = all(same_bits(a, b) for a, b in
                                            zip(flat_outputs(bout), flat_outputs(got)))
            ok &= row["baseline_bit_equal"]
            del got
            b1 = time_ms(call, dev)
            k1, k2 = time_ms(kernel, dev), time_ms(kernel, dev)
            b2 = time_ms(call, dev)
            row.update(ms=[k1, k2], baseline_ms=[b1, b2])
        else:
            row["ms"] = [time_ms(kernel, dev)]
        row["share_of_bound"] = bound / (sum(row["ms"]) / len(row["ms"]))
        if args.profile:
            row["split"] = kernel_split(kernel)
            if libs is not None:
                row["baseline_split"] = kernel_split(call)
        result["rows"].append(row)
        print(json.dumps(row), flush=True)
    path = pathlib.Path(args.out)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(result, indent=1))
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
