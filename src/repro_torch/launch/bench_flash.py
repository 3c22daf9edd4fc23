"""Kernels 11–13, the bf16 flash-attention forward and backward, timed on
the card at the main paths' shapes beside SDPA and, optionally, another
build of their sources.

    PYTHONPATH=src python -m repro_torch.launch.bench_flash \
        [--baseline-source OLD/flash_attention.cu] \
        [--baseline-bwd-source OLD/flash_attention_bwd.cu] \
        [--out chiprun_out/bench_flash.json]

Forward (:data:`SHAPES`): the serving prefill (8, 2048, 32/8, 128) and the
training step (1, 4096, 32/8, 128), bf16, causal.  At each, on the same
seeded inputs, it times by CUDA events (20 calls after a warm-up)
the port's kernel (``kernels/flash_attention/kernel.py``),
``F.scaled_dot_product_attention`` (the yardstick; the port never calls it)
and, with ``--baseline-source``, ``fa_fwd`` of that file built with the
port's own ``nvcc`` flags (headers from its directory, then ``csrc/``) in
turns: baseline, kernel, kernel, baseline.  The baseline's o and lse are
held to the kernel's (bf16 atol 3e-2, lse 1e-3).

Backward (:data:`BWD_SHAPES`): the training step's shape.  On seeded q, k,
v, do (lse from the port's forward, delta = rowsum(do · o)) it times kernel
12 (dK/dV) and kernel 13 (dQ), the backward of SDPA (``torch.autograd.grad``
of a forward built outside the timed region) and, with
``--baseline-bwd-source``, ``fa_bwd_dkv`` and ``fa_bwd_dq`` of that file
built the same way, in turns: baseline, kernel, kernel, baseline.  The
baseline's dq, dk and dv are held to the kernels' within
:data:`BWD_BF16_REL` relative (‖Δ‖/‖ref‖ each).

Prints ms, TFLOP/s and the share of the operation bound (4·hd flops a live
(q, k) pair for the forward, 8·hd for dK/dV, 6·hd for dQ, at 989 TFLOP/s)
with the card's name and power limit, and writes them as JSON.
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
BWD_SHAPES = {"training": (1, 4096, 32, 8, 128)}
BF16_FLOPS_PER_S = 989e12   # H100 SXM dense bf16, NVIDIA data sheet
BWD_BF16_REL = 2e-4         # chip_smoke.py's limit for the bf16 backward


def build_baseline(source: pathlib.Path, lib: str, names):
    """The C entry points ``names`` of ``source`` built as the port builds
    its own, with the port's argument types."""
    out = backend.BUILD_DIR.parent / "baseline" / f"lib{lib}_baseline.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run([backend.nvcc_path(), *backend.NVCC_FLAGS, "-I", str(source.parent),
                    "-I", str(backend.CSRC), "-o", str(out), str(source)], check=True)
    so = ctypes.CDLL(str(out))
    fns = []
    for name in names:
        fn = getattr(so, name)
        fn.argtypes = fak._SIGS[(lib, name)]
        fn.restype = ctypes.c_int
        fns.append(fn)
    return fns


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


def rel_err(a, b) -> float:
    """‖a − b‖ / ‖b‖, in f64."""
    return float(torch.linalg.vector_norm(a.double() - b.double())
                 / torch.linalg.vector_norm(b.double()))


def bench_bwd_shape(name: str, shape, baseline, device) -> dict:
    b, s, hq, hkv, hd = shape
    gen = torch.Generator(device=device).manual_seed(s * hq + hd + 1)
    q = torch.randn(b, s, hq, hd, generator=gen, device=device).to(torch.bfloat16)
    k = torch.randn(b, s, hkv, hd, generator=gen, device=device).to(torch.bfloat16)
    v = torch.randn(b, s, hkv, hd, generator=gen, device=device).to(torch.bfloat16)
    do = torch.randn(b, s, hq, hd, generator=gen, device=device).to(torch.bfloat16)
    o, lse = fak.flash_attention_fwd(q, k, v, causal=True)
    delta = torch.sum(do.float() * o.float(), -1).transpose(1, 2).contiguous()
    args = (q, k, v, do, lse, delta)
    pairs = b * hq * s * (s + 1) // 2
    kernels = {"dkv": (lambda: fak.flash_attention_bwd_dkv(*args, causal=True), 8 * hd * pairs),
               "dq": (lambda: fak.flash_attention_bwd_dq(*args, causal=True), 6 * hd * pairs)}
    row = {"shape": name, "b_s_hq_hkv_hd": list(shape)}
    dk, dv = kernels["dkv"][0]()
    dq = kernels["dq"][0]()
    if baseline is not None:
        dkv_fn, dq_fn = baseline
        tail = fak._tail(q, fak._check(q, k, v, 0, None), 0, True, None)
        bdk, bdv = torch.empty_like(dk), torch.empty_like(dv)
        bdq = torch.empty_like(dq)
        calls = {"dkv": lambda: backend.check_launch(dkv_fn(
                     *(t.data_ptr() for t in (*args, bdk, bdv)), *tail), "baseline fa_bwd_dkv"),
                 "dq": lambda: backend.check_launch(dq_fn(
                     *(t.data_ptr() for t in (*args, bdq)), *tail), "baseline fa_bwd_dq")}
        calls["dkv"]()
        calls["dq"]()
        torch.cuda.synchronize()
        row["baseline_rel_err"] = {n: rel_err(want, got) for n, want, got in
                                   (("dq", bdq, dq), ("dk", bdk, dk), ("dv", bdv, dv))}
        row["baseline_agrees"] = max(row["baseline_rel_err"].values()) <= BWD_BF16_REL
        for n, (fn, _) in kernels.items():
            b1 = time_ms(calls[n], device)
            k1, k2 = time_ms(fn, device), time_ms(fn, device)
            b2 = time_ms(calls[n], device)
            row[n] = {"ms": [k1, k2], "baseline_ms": [b1, b2]}
    else:
        for n, (fn, _) in kernels.items():
            row[n] = {"ms": [time_ms(fn, device)]}
    qt, kt, vt = (x.transpose(1, 2).detach().requires_grad_() for x in (q, k, v))
    out = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, enable_gqa=True)
    dot = do.transpose(1, 2)
    row["sdpa_bwd_ms"] = time_ms(lambda: torch.autograd.grad(out, (qt, kt, vt), dot,
                                                             retain_graph=True), device)
    for n, (_, flops) in kernels.items():
        ms = sum(row[n]["ms"]) / len(row[n]["ms"])
        bound = flops / BF16_FLOPS_PER_S * 1e3
        row[n].update(tflop=flops / 1e12, bound_ms=bound, bound_by="operations",
                      tflops=flops / ms / 1e9, share_of_bound=bound / ms)
    total = sum(sum(row[n]["ms"]) / len(row[n]["ms"]) for n in kernels)
    row["kernels_ms"] = total
    row["kernels_over_sdpa_bwd"] = total / row["sdpa_bwd_ms"]
    return row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--baseline-source", type=pathlib.Path, default=None,
                    help="a flash_attention.cu (another revision's) to time beside this one")
    ap.add_argument("--baseline-bwd-source", type=pathlib.Path, default=None,
                    help="a flash_attention_bwd.cu (another revision's) to time beside this one")
    ap.add_argument("--out", default="chiprun_out/bench_flash.json")
    args = ap.parse_args(argv)
    dev = resolve_device(None)
    card = device_line(dev)
    print(card, flush=True)
    baseline = (build_baseline(args.baseline_source, "flash_attention", ["fa_fwd"])[0]
                if args.baseline_source else None)
    baseline_bwd = (build_baseline(args.baseline_bwd_source, "flash_attention_bwd",
                                   ["fa_bwd_dkv", "fa_bwd_dq"])
                    if args.baseline_bwd_source else None)
    result = {"device": card, "torch": torch.__version__, "rows": []}
    for name, shape in SHAPES.items():
        row = bench_shape(name, shape, baseline, dev)
        result["rows"].append(row)
        print(json.dumps(row), flush=True)
    for name, shape in BWD_SHAPES.items():
        row = bench_bwd_shape(name, shape, baseline_bwd, dev)
        result["rows"].append(row)
        print(json.dumps(row), flush=True)
    path = pathlib.Path(args.out)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(result, indent=1))
    return 0 if all(r.get("baseline_agrees", True) for r in result["rows"]) else 1


if __name__ == "__main__":
    raise SystemExit(main())
