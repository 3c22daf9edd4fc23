"""Where the time of serving a model goes, on the card.

    PYTHONPATH=src python -m repro_torch.launch.profile_serve \
        [--arch qwen3-4b] [--layers N] [--prompt 2048] [--batch 8] \
        [--out build/profile_serve.json]

Builds the serving path of ``chip_smoke.py`` phases 4, 4b, 4c, 4d and 4e
(``--arch`` at full width, all its layers or the first ``--layers``,
parameters drawn from seed 0 and cast to bf16, 8 prompts of 2048 seeded
tokens, flash attention where the model has attention, bf16 compute;
qwen3-4b by default; mamba2-130m is the SSM family's; jamba-v0.1-52b the
hybrid's, with ``--layers`` a multiple of its 8-layer period: ``--layers
8`` is one period, 13.3 B parameters; whisper-medium the
encoder–decoder's, each prompt with 1536 seeded frames, its attention the
plain chunked softmax; llava-next-34b the VLM's, each prompt 1152 seeded
patch embeddings and 896 tokens, ``--layers 20`` as phase 4f;
h2o-danube-3-4b, minitron-4b and mistral-large-123b phase 4g's, with
``--prompt 4080`` for danube's prompts or ``--prompt 32768 --batch 1`` for
its long one), runs one
prefill and 4 decode steps to warm up, times 2 prefills and 8 decode steps
by the host clock around a synchronize, then profiles one prefill and, in a
second window, 4 decode steps under ``torch.profiler`` (CPU and CUDA
activity).  For each window it prints and writes as JSON: the wall time,
the time the card was busy (the union of its kernel, copy and fill
intervals), the idle share, the device time by class — the flash-attention
kernel (``fa_fwd_*``), matrix products (cuBLAS / CUTLASS kernels), and
everything else (PyTorch's elementwise and reduction kernels, copies) — and
the top kernels by device time and operations by host time.  Needs a CUDA
card; fails without one.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import pathlib
import subprocess
import time

from repro_torch.launch.profile_sync import _busy_ms

BATCH, PROMPT, DECODE = 8, 2048, 4


def _kind(name: str) -> str:
    low = name.lower()
    if "fa_fwd" in low:
        return "flash_attention"
    if any(t in low for t in ("gemm", "nvjet", "cutlass", "xmma", "cublas")):
        return "matmul"
    return "other"


def _window(prof, wall_ms: float, kind=_kind) -> dict:
    """Wall and busy ms, idle share, device ms by ``kind(kernel name)``, and
    the top kernels by device time and operations by host time, of one
    profiled window."""
    from torch.autograd import DeviceType

    on_card = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    if not on_card:
        raise RuntimeError("torch.profiler recorded no device activity")
    averages = prof.key_averages()
    device = sorted(((e.key, e.self_device_time_total / 1e3, e.count)
                     for e in averages if e.device_type == DeviceType.CUDA),
                    key=lambda r: -r[1])
    host = sorted(((e.key, e.self_cpu_time_total / 1e3, e.count)
                   for e in averages if e.device_type == DeviceType.CPU),
                  key=lambda r: -r[1])
    by_kind = {}
    for k, ms, _ in device:
        by_kind[kind(k)] = by_kind.get(kind(k), 0.0) + ms
    busy = _busy_ms(on_card)
    return {"wall_ms": wall_ms, "device_busy_ms": busy, "idle_share": 1.0 - busy / wall_ms,
            "device_events": len(on_card), "device_ms_by_kind": by_kind,
            "top_device": [[k, ms, c] for k, ms, c in device[:12]],
            "top_host": [[k, ms, c] for k, ms, c in host[:12]]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="qwen3-4b")
    ap.add_argument("--layers", type=int, default=None, help="the first N layers (all by default)")
    ap.add_argument("--prompt", type=int, default=PROMPT, help="positions a prompt")
    ap.add_argument("--batch", type=int, default=BATCH, help="prompts")
    ap.add_argument("--out", default="build/profile_serve.json")
    args = ap.parse_args(argv)

    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        raise SystemExit("profile_serve: no CUDA device is available")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60).stdout.strip()
    print(f"card: {card}", flush=True)
    from repro_torch.configs.base import RunConfig, ShapeSpec
    from repro_torch.configs.registry import get_config
    from repro_torch.kernels import backend
    from repro_torch.models import model
    from repro_torch.serving import engine

    backend.build()
    dev = torch.device("cuda")
    cfg = get_config(args.arch)
    if args.layers:
        cfg = dataclasses.replace(cfg, num_layers=args.layers)
    params = model.init(0, cfg, device=dev)
    for name in list(params):
        params[name] = params[name].to(torch.bfloat16)
    gen = torch.Generator(device=dev).manual_seed(1)
    batch, plen = args.batch, args.prompt
    text = plen - (cfg.num_patches if cfg.family == "vlm" else 0)
    prompt = {"tokens": torch.randint(0, cfg.vocab_size, (batch, text), generator=gen,
                                      device=dev)}
    if cfg.family == "vlm":
        prompt["patches"] = torch.randn((batch, cfg.num_patches, cfg.d_model), generator=gen,
                                        device=dev)
    if cfg.family == "encdec":
        from repro_torch.models.encdec import enc_seq_padded
        prompt["frames"] = torch.randn((batch, enc_seq_padded(cfg, 16), cfg.d_model),
                                       generator=gen, device=dev)
    prefill_fn, decode_fn = engine.build_serve_fns(
        cfg, RunConfig(), ShapeSpec("serve", "decode", plen + 4 * DECODE, batch), device=dev)

    def decode(cache, logits, start, steps):
        tok = torch.argmax(logits, dim=-1)
        for i in range(steps):
            tok, cache = decode_fn(params, cache, tok, start + i)
        return cache

    def timed(fn):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    cache, logits = prefill_fn(params, prompt)            # warm-up
    cache = decode(cache, logits, plen, DECODE)
    prefill_ms = [timed(lambda: prefill_fn(params, prompt))[1] for _ in range(2)]
    (cache, logits), _ = timed(lambda: prefill_fn(params, prompt))
    _, dms = timed(lambda: decode(cache, logits, plen, 2 * DECODE))
    out = {"card": card, "torch": torch.__version__, "model": cfg.name,
           "layers": cfg.num_layers, "batch": batch, "prompt": plen,
           "prefill_ms": prefill_ms, "decode_ms_per_token": dms / (2 * DECODE)}

    backend.reset_launches()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        (cache, logits), wall = timed(lambda: prefill_fn(params, prompt))
    out["prefill"] = _window(prof, wall)
    out["prefill"]["wrapper_launches"] = dict(backend.launches)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        _, wall = timed(lambda: decode(cache, logits, plen, DECODE))
    out["decode"] = _window(prof, wall)
    out["decode"]["steps"] = DECODE

    print(json.dumps({k: out[k] for k in ("prefill_ms", "decode_ms_per_token")}), flush=True)
    for phase in ("prefill", "decode"):
        r = out[phase]
        print(json.dumps({"phase": phase, **{k: r[k] for k in (
            "wall_ms", "device_busy_ms", "idle_share", "device_events",
            "device_ms_by_kind")}}), flush=True)
        for k, ms, c in r["top_device"][:8]:
            print(f"  device {ms:9.3f} ms  x{c:<6d} {k[:90]}")
        for k, ms, c in r["top_host"][:6]:
            print(f"  host   {ms:9.3f} ms  x{c:<6d} {k[:90]}")
    path = pathlib.Path(args.out)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
