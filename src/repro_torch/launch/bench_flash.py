"""Kernel 11, the bf16 flash-attention forward, timed on the card at the
main paths' shapes beside SDPA and, optionally, another build of its source.

    PYTHONPATH=src python -m repro_torch.launch.bench_flash \
        [--baseline-source OLD/flash_attention.cu] [--out chiprun_out/bench_flash.json]

Shapes (:data:`SHAPES`): the serving prefill (8, 2048, 32/8, 128) and the
training step (1, 4096, 32/8, 128), bf16, causal.  At each, on the same
seeded inputs, it times by CUDA events (20 calls after a warm-up)
the port's kernel (``kernels/flash_attention/kernel.py``),
``F.scaled_dot_product_attention`` (the yardstick; the port never calls it)
and, with ``--baseline-source``, ``fa_fwd`` of that file built with the
port's own ``nvcc`` flags (headers from its directory, then ``csrc/``) in
turns: baseline, kernel, kernel, baseline.  The baseline's o and lse are
held to the kernel's (bf16 atol 3e-2, lse 1e-3).  Prints ms, TFLOP/s and
the share of the operation bound (4·hd flops a live (q, k) pair at 989
TFLOP/s) with the card's name and power limit, and writes them as JSON.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import pathlib
import subprocess

import torch
import torch.nn.functional as F

from repro_torch import resolve_device
from repro_torch.kernels import backend
from repro_torch.kernels.flash_attention import kernel as fak
from repro_torch.launch.bench_encode_speed import device_line, time_ms

# (b, s, hq, hkv, hd): qwen3-4b's heads at the serving prefill and the
# training sequence
SHAPES = {"serving": (8, 2048, 32, 8, 128), "training": (1, 4096, 32, 8, 128)}
BF16_FLOPS_PER_S = 989e12   # H100 SXM dense bf16, NVIDIA data sheet


def build_baseline(source: pathlib.Path):
    """``fa_fwd`` of ``source`` built as the port builds its own."""
    out = backend.BUILD_DIR.parent / "baseline" / "libflash_attention_baseline.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([backend.nvcc_path(), *backend.NVCC_FLAGS, "-I", str(source.parent),
                    "-I", str(backend.CSRC), "-o", str(out), str(source)], check=True)
    fn = ctypes.CDLL(str(out)).fa_fwd
    fn.argtypes = fak._SIGS[("flash_attention", "fa_fwd")]
    fn.restype = ctypes.c_int
    return fn


def baseline_call(fn, q, k, v):
    b, sq, hq, hd = q.shape
    o = torch.empty_like(q)
    lse = torch.empty((b, hq, sq), dtype=torch.float32, device=q.device)

    def call():
        backend.check_launch(fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
                                lse.data_ptr(), *fak._tail(q, fak._check(q, k, v, 0, None),
                                                           0, True, None)),
                             "baseline fa_fwd")
    return call, o, lse


def bench_shape(name: str, shape, baseline, device) -> dict:
    b, s, hq, hkv, hd = shape
    gen = torch.Generator(device=device).manual_seed(s * hq + hd)
    q = torch.randn(b, s, hq, hd, generator=gen, device=device).to(torch.bfloat16)
    k = torch.randn(b, s, hkv, hd, generator=gen, device=device).to(torch.bfloat16)
    v = torch.randn(b, s, hkv, hd, generator=gen, device=device).to(torch.bfloat16)
    flops = 4 * b * hq * hd * s * (s + 1) // 2
    bound = flops / BF16_FLOPS_PER_S * 1e3
    kernel = lambda: fak.flash_attention_fwd(q, k, v, causal=True)   # noqa: E731
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    row = {"shape": name, "b_s_hq_hkv_hd": list(shape), "tflop": flops / 1e12,
           "bound_ms": bound, "bound_by": "operations"}
    if baseline is not None:
        call, bo, blse = baseline_call(baseline, q, k, v)
        call()
        o, lse = kernel()
        torch.cuda.synchronize()
        row["baseline_max_abs_err"] = float((bo.float() - o.float()).abs().max())
        row["baseline_lse_err"] = float((blse - lse).abs().max())
        row["baseline_agrees"] = (row["baseline_max_abs_err"] <= 3e-2
                                  and row["baseline_lse_err"] <= 1e-3)
        b1 = time_ms(call, device)
        k1, k2 = time_ms(kernel, device), time_ms(kernel, device)
        b2 = time_ms(call, device)
        row.update(ms=[k1, k2], baseline_ms=[b1, b2])
    else:
        row["ms"] = [time_ms(kernel, device)]
    row["sdpa_ms"] = time_ms(lambda: F.scaled_dot_product_attention(
        qt, kt, vt, is_causal=True, enable_gqa=True), device)
    ms = sum(row["ms"]) / len(row["ms"])
    row["tflops"] = flops / ms / 1e9
    row["share_of_bound"] = bound / ms
    return row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--baseline-source", type=pathlib.Path, default=None,
                    help="a flash_attention.cu (another revision's) to time beside this one")
    ap.add_argument("--out", default="chiprun_out/bench_flash.json")
    args = ap.parse_args(argv)
    dev = resolve_device(None)
    card = device_line(dev)
    print(card, flush=True)
    baseline = build_baseline(args.baseline_source) if args.baseline_source else None
    result = {"device": card, "torch": torch.__version__, "rows": []}
    for name, shape in SHAPES.items():
        row = bench_shape(name, shape, baseline, dev)
        result["rows"].append(row)
        print(json.dumps(row), flush=True)
    path = pathlib.Path(args.out)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(result, indent=1))
    return 0 if all(r.get("baseline_agrees", True) for r in result["rows"]) else 1


if __name__ == "__main__":
    raise SystemExit(main())
