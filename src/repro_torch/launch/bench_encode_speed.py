"""§1.1: the paper's encoder is O(d), the rotation baseline O(d log d) — on
the card.  Port of ``benchmarks/bench_encode_speed.py``.

    PYTHONPATH=src python -m repro_torch.launch.bench_encode_speed \
        [--device cpu] [--out chiprun_out/bench_encode_speed.json]

For each d of :data:`SIZES` (the reference's 2¹⁶ and 2²⁰, then 2²⁴ and the
qwen3-4b embedding bucket of 388,956,160 coordinates, the largest of the
sync path) it times, after a warm-up, one call of each encoder on a seeded
Gaussian x: the dense Bernoulli encode (kernel 14: p = 1/16, μ = 0, seed
7), the fixed-k gather (kb = nb/16 of the nb 1024-blocks), binary
quantization (kernel 15, seed 7, with its min/max) and the FWHT on the
rotation's padded layout (x itself at a power of two ≤ 2²⁰, above that
(padded_dim(d)/2²⁰, 2²⁰) rows).  Prints the reference's row fields
(``name``, ``us_per_call`` of the Bernoulli encode, ``derived`` in ns a
coordinate, ``check``) and the card's name and power limit, and writes them
as JSON to ``--out``.  Times
are CUDA events on the card; with ``--device cpu`` the plain versions run
and the times are the host's.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import time

import torch

from repro_torch import random as prandom
from repro_torch import resolve_device
from repro_torch.core import rotation
from repro_torch.kernels.bernoulli_encode import ops as bern_ops
from repro_torch.kernels.binary_quant import ops as bq_ops
from repro_torch.kernels.fixed_k_encode import ops as fk_ops
from repro_torch.kernels.hadamard import ops as h_ops

SIZES = (1 << 16, 1 << 20, 1 << 24, 388_956_160)
REPS = 20
BERN_P, BERN_MU, SEED = 1 / 16, 0.0, 7


def time_ms(fn, device, reps: int = REPS) -> float:
    """Mean ms of one call after a warm-up: CUDA events on the card, the
    host clock on the CPU."""
    fn()
    if device.type != "cuda":
        t0 = time.perf_counter()
        for _ in range(reps):
            fn()
        return (time.perf_counter() - t0) / reps * 1e3
    torch.cuda.synchronize(device)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def fwht_input(x):
    """The FWHT's input for a flat x: the rotation's layout, x zero-padded
    to padded_dim(d) in rows of min(padded_dim(d), 2²⁰) (x itself at a
    power of two ≤ 2²⁰, as the reference transforms it)."""
    d = x.shape[0]
    dp = rotation.padded_dim(d)
    xp = x if dp == d else torch.nn.functional.pad(x, (0, dp - d))
    return xp.reshape(-1, min(dp, h_ops.MAX_D))


def rows(device, sizes=SIZES, reps: int = REPS):
    """One row a size: the reference's fields plus each encoder's ms."""
    gen = torch.Generator(device=device).manual_seed(0)
    key = prandom.PRNGKey(0)
    out = []
    for d in sizes:
        x = torch.randn(d, generator=gen, device=device)
        nb = fk_ops.num_blocks(d)
        ids = fk_ops.sample_blocks(key, nb, max(1, nb // 16), device)
        xh = fwht_input(x)
        ms = {
            "bernoulli": time_ms(lambda: bern_ops.bernoulli_encode(x, BERN_P, BERN_MU, SEED),
                                 device, reps),
            "fixed_k": time_ms(lambda: fk_ops.fixed_k_encode(x, ids, 0.0), device, reps),
            "binary": time_ms(lambda: bq_ops.binary_encode(x, SEED)[0], device, reps),
            "hadamard": time_ms(lambda: h_ops.fwht(xh), device, reps),
        }
        del x, xh, ids
        out.append({
            "name": f"encode_speed.d{d}",
            "us_per_call": ms["bernoulli"] * 1e3,
            "derived": " ".join(f"{k}={v * 1e6 / d:.4g}ns/el" for k, v in ms.items()),
            "check": ms["bernoulli"] > 0,
            "d": d, "ms": ms,
        })
    return out


def device_line(device) -> str:
    """The card's name and power limit as nvidia-smi gives them, or "cpu"."""
    if device.type != "cuda":
        return "cpu (plain PyTorch versions; host times)"
    return subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True,
                          timeout=60).stdout.strip().splitlines()[0]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None, help="cpu, or cuda (the default)")
    ap.add_argument("--out", default="chiprun_out/bench_encode_speed.json")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    card = device_line(dev)
    print(card, flush=True)
    result = {"device": card, "torch": torch.__version__, "rows": []}
    for r in rows(dev):
        result["rows"].append(r)
        print(json.dumps({k: r[k] for k in ("name", "us_per_call", "derived", "check")}),
              flush=True)
    path = pathlib.Path(args.out)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(result, indent=1))
    return 0 if all(r["check"] for r in result["rows"]) else 1


if __name__ == "__main__":
    raise SystemExit(main())
