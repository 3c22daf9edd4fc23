"""ctypes wrappers of the Hopper Bernoulli wire kernels (``csrc/bernoulli_wire.cu``).

Each wrapper takes CUDA tensors only, checks device, dtype, shape and
contiguity, allocates its outputs and scratch with ``torch.empty``,
launches on PyTorch's current stream, raises on a nonzero
``cudaGetLastError`` after every launch, and adds one to its launch count
in :data:`repro_torch.kernels.backend.launches`:

* :func:`encode` — ``bernoulli_encode`` (replaces ``encode_pallas``), the
  Eq. (1) values, or, counted as ``bernoulli_encode_unscaled``, the raw ones
  of the error-feedback twin (``scaled=False``);
* :func:`decode_sum` — ``bernoulli_decode_sum`` (``decode_sum_pallas``);
  from ``acc0 = -0.0`` at n = 1 it is one peer's reconstruction bit for bit
  (the twin's unpack), counted as ``bernoulli_unpack``;
* :func:`support_counts` — ``bernoulli_support_counts``, the count phase of
  the shard decode, run before the §12 count exchange;
* :func:`decode_sum_shard` — ``bernoulli_decode_sum_shard`` (the rest of
  ``decode_sum_shard_pallas``).

The design, the bit-exactness argument and the bound of each kernel are in
the source's header comment.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import backend
from repro_torch.kernels.bernoulli_wire import ref
from repro_torch.kernels.bernoulli_wire.ref import Support, num_chunks

_LIB = "bernoulli_wire"
MAX_PEERS = 256

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_SIGS = {
    "bw_support_counts": [_P, ctypes.c_int, _I64, _I64, _I64, ctypes.c_float,
                          _P, _P, _P],
    "bw_encode_ex": [ctypes.c_uint32, ctypes.c_uint32, _P, _I64, ctypes.c_float, _I64,
                     ctypes.c_int, ctypes.c_float, ctypes.c_float, _P, _P, _P, _P],
    "bw_decode_sum_from": [_P, ctypes.c_int, _I64, ctypes.c_float, _P, _I64, _P, _I64,
                           ctypes.c_float, _P, _P, _P],
    "bw_decode_sum_shard": [_P, _I64, _P, _P, _P, _P, ctypes.c_int, _I64, _I64, _P, _P, _P],
    "bw_encode_scratch_bytes": [_I64],
    "bw_decode_scratch_bytes": [ctypes.c_int, _I64],
    "bw_shard_scratch_bytes": [ctypes.c_int, _I64],
}


def _fn(name: str):
    f = getattr(backend.lib(_LIB), name)
    if f.argtypes is None:
        f.argtypes = _SIGS[name]
        f.restype = ctypes.c_int64 if name.endswith("_bytes") else ctypes.c_int
    return f


def _host_keys(keys) -> ctypes.Array:
    """(n, 2) key words → a host uint32 array the launch copies by value."""
    k = torch.as_tensor(keys).reshape(-1, 2).to(torch.int64).cpu()
    n = k.shape[0]
    if not 1 <= n <= MAX_PEERS:
        raise ValueError(f"need 1..{MAX_PEERS} peer keys, got {n}")
    return (ctypes.c_uint32 * (2 * n))(*[int(w) & 0xFFFFFFFF for w in k.reshape(-1)])


def _scratch(nbytes: int, device):
    """Per-call scratch of int32 words (the C side writes all it reads)."""
    return torch.empty(-(-nbytes // 4), dtype=torch.int32, device=device)


def _count(keys_host, n, start, ds, d, p32, device):
    nck = num_chunks(ds)
    counts = torch.empty((n, nck), dtype=torch.int32, device=device)
    mask = torch.empty((n, nck * ref.WORDS), dtype=torch.int32, device=device)
    err = _fn("bw_support_counts")(keys_host, n, start, ds, d, p32,
                                   counts.data_ptr(), mask.data_ptr(),
                                   backend.stream_ptr(device))
    backend.check_launch(err, "bernoulli support count")
    return counts, mask


def _check_bufs(bufs, mus, cap):
    if bufs.dim() != 2 or bufs.shape[1] != cap:
        raise ValueError(f"bufs: expected (n, {cap}), got {tuple(bufs.shape)}")
    backend.check(bufs, "bufs", torch.float32, contiguous=False)
    if bufs.stride(1) != 1:
        raise ValueError("bufs: rows must be contiguous (stride 1)")
    backend.check(mus, "mus", torch.float32, (bufs.shape[0],))


def encode(flat, key, mu, *, p: float, cap: int, scaled: bool = True):
    """(d,) f32 + rank-folded (2,) key + device f32 μ → (cap,) f32 buffer:
    ``x·(1/p) − ((1−p)/p)·μ`` at each kept rank, or x itself when
    ``scaled`` is false (μ then unread)."""
    backend.check(flat, "flat", torch.float32)
    if flat.dim() != 1:
        raise ValueError(f"flat: expected 1-D, got {tuple(flat.shape)}")
    backend.check(mu, "mu", torch.float32, ())
    dev = flat.device
    d = flat.shape[0]
    p32, inv_p, c = ref.coefficients(p)
    k0, k1 = _host_keys(key)
    work = torch.empty(_fn("bw_encode_scratch_bytes")(d), dtype=torch.uint8, device=dev)
    out = torch.empty(cap, dtype=torch.float32, device=dev)
    err = _fn("bw_encode_ex")(k0, k1, flat.data_ptr(), d, p32, cap, int(bool(scaled)), inv_p, c,
                              mu.data_ptr(), out.data_ptr(), work.data_ptr(),
                              backend.stream_ptr(dev))
    backend.check_launch(err, "bernoulli encode")
    backend.launches["bernoulli_encode" if scaled else "bernoulli_encode_unscaled"] += 1
    return out


def support_counts(keys, *, p: float, d: int, start: int, ds: int, device):
    """Count phase of the shard decode over [start, start + ds): a Support."""
    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"support_counts kernel needs a CUDA device, got {device}")
    kh = _host_keys(keys)
    n = len(kh) // 2
    counts, mask = _count(kh, n, int(start), int(ds), int(d),
                          ref.coefficients(p)[0], device)
    backend.launches["bernoulli_support_counts"] += 1
    return Support(counts, mask, int(ds))


def decode_sum_shard(bufs, mus, support: Support, prior, *, cap: int):
    """Σ_i reconstruction_i over the support's window, as (ds,) f32."""
    _check_bufs(bufs, mus, cap)
    n = bufs.shape[0]
    nck = num_chunks(support.ds)
    backend.check(support.counts, "support.counts", torch.int32, (n, nck))
    backend.check(support.mask, "support.mask", torch.int32, (n, nck * ref.WORDS))
    backend.check(prior, "prior", torch.int32, (n,))
    dev, ds = bufs.device, support.ds
    work = _scratch(_fn("bw_shard_scratch_bytes")(n, ds), dev)
    out = torch.empty(ds, dtype=torch.float32, device=dev)
    err = _fn("bw_decode_sum_shard")(bufs.data_ptr(), bufs.stride(0), mus.data_ptr(),
                                     support.counts.data_ptr(), support.mask.data_ptr(),
                                     prior.data_ptr(), n, ds, cap, out.data_ptr(),
                                     work.data_ptr(), backend.stream_ptr(dev))
    backend.check_launch(err, "bernoulli shard decode")
    backend.launches["bernoulli_decode_sum_shard"] += 1
    return out


def decode_sum(bufs, mus, keys, *, p: float, cap: int, d: int, acc0: float = 0.0):
    """Σ_i reconstruction_i as (d,) f32 (pair count, scan and decode phases),
    each coordinate's sum started at ``acc0``; a call from ``acc0 = -0.0``
    (the twin's unpack) is counted as ``bernoulli_unpack``."""
    _check_bufs(bufs, mus, cap)
    dev = bufs.device
    kh = _host_keys(keys)
    n = len(kh) // 2
    if n != bufs.shape[0]:
        raise ValueError(f"{n} keys for {bufs.shape[0]} buffers")
    work = _scratch(_fn("bw_decode_scratch_bytes")(n, d), dev)
    out = torch.empty(d, dtype=torch.float32, device=dev)
    err = _fn("bw_decode_sum_from")(kh, n, d, ref.coefficients(p)[0], bufs.data_ptr(),
                                    bufs.stride(0), mus.data_ptr(), cap, float(acc0),
                                    out.data_ptr(), work.data_ptr(), backend.stream_ptr(dev))
    backend.check_launch(err, "bernoulli decode")
    unpack = acc0 == 0.0 and math.copysign(1.0, acc0) < 0.0
    backend.launches["bernoulli_unpack" if unpack else "bernoulli_decode_sum"] += 1
    return out
