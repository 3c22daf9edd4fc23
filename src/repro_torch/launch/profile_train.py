"""Where the time of a training step goes, on the card.

    PYTHONPATH=src python -m repro_torch.launch.profile_train \
        [--arch qwen3-4b] [--out build/profile_train.json] [--no-overlap]

Builds the training path of ``chip_smoke.py`` phase 5, 5b, 5c, 5d or 5e by
``--arch`` (``train/synthetic.py``: qwen3-4b by ``train_main_path``, at
full width and 4 layers, ``fixed_k_1bit``, flash attention; olmoe-1b-7b by
``moe_train_path``, 2 layers; mamba2-130m by ``ssm_train_path``, all 24
layers; whisper-medium by ``encdec_train_path``, all 24 + 24 layers, 1536
frames a sequence; each with 8 ranks stacked on the card; llava-next-34b
by ``vlm_train_path``, 1 layer, 4 ranks, 1152 patches a sequence; one
4096-position sequence a rank, bf16 compute, remat; the backward-pipelined sync, or the
post-backward one with ``--no-overlap``),
runs one step to warm up, times 2 steps by the host clock (a synchronize at each phase
boundary: forward+backward over the ranks, sync, optimizer), then profiles
one step under ``torch.profiler`` (CPU and CUDA activity).  Prints and
writes as JSON: the step's wall time, the time the card was busy (the union
of its kernel, copy and fill intervals), the idle share, the device time by
class — the flash-attention forward (``fa_fwd_*``) and backward
(``fa_bwd_*``) kernels, the fixed-k gather, matrix products (cuBLAS /
CUTLASS kernels), and everything else (PyTorch's elementwise and reduction
kernels, copies) — and the top kernels by device time and operations by
host time.  Last, the cost of taking the layers alone
(``models/transformer.py``: one rank's ``unbind_layers`` and
``take_layer`` of every layer, the rows cast to bf16, then the backward of
those casts with unit cotangents, which stacks each leaf's row gradients
once), timed by CUDA events.  Needs a CUDA card; fails without one.
"""
from __future__ import annotations

import argparse
import collections
import dataclasses
import json
import pathlib
import subprocess
import time

from repro_torch.launch.profile_serve import _kind as _serve_kind
from repro_torch.launch.profile_serve import _window


def _kind(name: str) -> str:
    low = name.lower()
    if "fa_bwd" in low:
        return "flash_attention_bwd"
    if "fixed_k" in low:
        return "fixed_k_gather"
    return _serve_kind(name)


def _paths():
    from repro_torch.train import synthetic
    return {synthetic.MODEL: synthetic.train_main_path, synthetic.MOE_MODEL: synthetic.moe_train_path,
            synthetic.SSM_MODEL: synthetic.ssm_train_path,
            synthetic.ENCDEC_MODEL: synthetic.encdec_train_path,
            synthetic.VLM_MODEL: synthetic.vlm_train_path}


def take_layer_ms(cfg, run, params, reps: int = 3) -> dict:
    """ms of one rank's ``unbind_layers`` and ``take_layer`` over all layers
    (forward: the rows and casts) and of their backward with unit
    cotangents, CUDA events, after a warm-up: the min of ``reps``.  The
    stacks are the ``layers.*`` leaves, or an encoder–decoder's ``enc.*``
    and ``dec.*``."""
    import torch
    from repro_torch.models import model, transformer as tfm

    stacks = ({"enc": cfg.encoder_layers, "dec": cfg.num_layers} if cfg.family == "encdec"
              else {"layers": cfg.num_layers})
    lp = {f"{g}.{k}": v.detach().requires_grad_() for g in stacks
          for k, v in tfm.sub(params, g).items()}
    names = sorted(lp)
    fwd, bwd = [], []
    for _ in range(reps + 1):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(3)]
        ev[0].record()
        ctx = model.make_ctx(cfg, run)
        outs = [t for g in stacks for row in tfm.unbind_layers(tfm.sub(lp, g))
                for t in tfm.take_layer(ctx, cfg, g, row).values()]
        ones = [torch.ones_like(t) for t in outs]
        ev[1].record()
        torch.autograd.grad(outs, [lp[k] for k in names], grad_outputs=ones)
        ev[2].record()
        torch.cuda.synchronize()
        fwd.append(ev[0].elapsed_time(ev[1]))
        bwd.append(ev[1].elapsed_time(ev[2]))
        del outs, ones
    return {"forward_ms": min(fwd[1:]), "backward_ms": min(bwd[1:]),
            "stacked_f32_bytes": sum(v.numel() * 4 for v in lp.values())}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", default="qwen3-4b", choices=sorted(_paths()))
    ap.add_argument("--out", default="build/profile_train.json")
    ap.add_argument("--no-overlap", action="store_true",
                    help="the post-backward sync instead of the backward-pipelined one")
    args = ap.parse_args(argv)

    import torch
    from torch.profiler import ProfilerActivity, profile

    if not torch.cuda.is_available():
        raise SystemExit("profile_train: no CUDA device is available")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60).stdout.strip()
    print(f"card: {card}", flush=True)
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.kernels import backend
    from repro_torch.train import synthetic
    from repro_torch.train.train_step import build_train_step

    backend.build()
    dev = torch.device("cuda")
    cfg, run, shape = _paths()[args.arch]()
    if args.no_overlap:
        cmp = run.compression
        run = dataclasses.replace(run, compression=dataclasses.replace(
            cmp, bucket=dataclasses.replace(cmp.bucket, overlap=False)))
    phase_ms = collections.defaultdict(list)
    clock = {"t": 0.0}

    def on_phase(name, **state):
        torch.cuda.synchronize()
        now = time.perf_counter()
        if name != "start":
            phase_ms[name].append((now - clock["t"]) * 1e3)
        clock["t"] = now

    n = shape.global_batch                  # one sequence a rank
    step_fn, init_fn, _ = build_train_step(cfg, run, shape, n, device=dev, on_phase=on_phase)
    params, opt_state, ef_state = init_fn(0)
    data = SyntheticLM(cfg, shape)
    batches = [data.batch(step, dev) for step in range(4)]

    def step(i):
        nonlocal params, opt_state, ef_state
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        params, opt_state, ef_state, _ = step_fn(params, opt_state, ef_state, batches[i], i)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    step(0)                                               # warm-up
    phase_ms.clear()
    torch.cuda.reset_peak_memory_stats()
    step_ms = [step(1), step(2)]
    out = {"card": card, "torch": torch.__version__, "model": cfg.name,
           "layers": cfg.num_layers, "ranks": n, "tokens_per_rank": shape.seq_len,
           "preset": synthetic.TRAIN_PRESET, "overlap": not args.no_overlap,
           "step_ms": step_ms,
           "phase_ms": {k: list(v) for k, v in phase_ms.items()},
           "peak_GiB": torch.cuda.max_memory_allocated() / 2**30}
    backend.reset_launches()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        wall = step(3)
    out["step"] = _window(prof, wall, kind=_kind)
    out["step"]["wrapper_launches"] = dict(backend.launches)
    out["take_layer"] = take_layer_ms(cfg, run, params)
    out["take_layer"]["per_step_ms"] = n * (out["take_layer"]["forward_ms"]
                                            + out["take_layer"]["backward_ms"])

    print(json.dumps({k: out[k] for k in ("step_ms", "phase_ms", "peak_GiB", "take_layer")}),
          flush=True)
    r = out["step"]
    print(json.dumps({k: r[k] for k in ("wall_ms", "device_busy_ms", "idle_share",
                                        "device_events", "device_ms_by_kind")}), flush=True)
    for k, ms, c in r["top_device"][:10]:
        print(f"  device {ms:9.3f} ms  x{c:<6d} {k[:90]}")
    for k, ms, c in r["top_host"][:8]:
        print(f"  host   {ms:9.3f} ms  x{c:<6d} {k[:90]}")
    path = pathlib.Path(args.out)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
