"""Where the time of one bucketed gradient sync goes, on the card.

    PYTHONPATH=src python -m repro_torch.launch.profile_sync \
        [--mesh pod=4,data=2] [--out chiprun_out/profile_sync.json]

Drives ``sync_grads_bucketed`` over the main path of ``train/synthetic.py``
(qwen3-4b at full width, 4 of its 36 layers, 8 ranks stacked on the card,
synthetic seeded gradients), as ``chip_smoke.py`` does.  ``--mesh`` lays
the ranks out on named axes instead (``pod=4,data=2`` is
``synthetic.HIER_MESH``) and profiles ``synthetic.HIER_PRESETS`` unflattened
(the §11 two-level sync).  Per preset (``synthetic.PRESETS`` without a
mesh): one warm-up step,
two steps timed by the host clock around a synchronize, then one step under
``torch.profiler`` (CPU and CUDA activity).  Prints and writes as JSON: the
step's wall time, the time the card was busy (the union of its kernel,
copy and fill intervals), the idle share of the profiled step, the number
of device events, the top kernels by device time, the port's own kernels
(``csrc``) by device time, and the top operations by host time.  Before the presets it times, by CUDA events, the plain-torch
Threefry uniform draw (``random.uniform``) of the largest bucket — the draw
every binary and ternary pack makes once per rank and bucket — and the
Rademacher sign draw (``random.rademacher``) at that bucket's rotated
length, which the rotated presets make once per rank's pack and once per
unrotate.  Needs a CUDA card; fails without one.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import subprocess
import time


def _busy_ms(kernels) -> float:
    """Length of the union of the kernels' device intervals, in ms."""
    busy, end = 0.0, float("-inf")
    for lo, hi in sorted((e.time_range.start, e.time_range.end) for e in kernels):
        if hi > end:
            busy += hi - max(lo, end)
            end = hi
    return busy / 1e3


def time_draw(draw, d: int):
    """Device ms and peak GB of one ``draw(key, d, "cuda")`` (3 after a warm-up)."""
    import torch

    from repro_torch.train import synthetic

    key = synthetic.step_key(0)
    draw(key, d, "cuda")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(3):
        draw(key, d, "cuda")
    end.record()
    end.synchronize()
    return {"d": d, "ms": start.elapsed_time(end) / 3,
            "peak_GB": torch.cuda.max_memory_allocated() / 1e9}


def parse_mesh(text: str):
    """``"pod=4,data=2"`` → {"pod": 4, "data": 2} in the order given."""
    out = {}
    for part in text.split(","):
        name, _, size = part.partition("=")
        out[name.strip()] = int(size)
    return out


def profile_preset(preset: str, mesh=None):
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels import backend
    from repro_torch.train import bucketing, synthetic

    from repro_torch.configs.registry import compression_preset

    cmp = synthetic.preset(preset) if mesh is None else compression_preset(preset)
    shapes, plan, comm = synthetic.main_path(cmp, "cuda", mesh)
    grads = synthetic.synthetic_grads(shapes, synthetic.N, 0, "cuda")
    ef = (bucketing.init_ef_state(plan, cmp, synthetic.N, "cuda") if cmp.error_feedback
          else None)

    def step(i):
        return bucketing.sync_grads_bucketed(grads, plan, cmp, synthetic.step_key(i), comm,
                                             ef)[0]

    step(0)
    torch.cuda.synchronize()
    walls = []
    for i in (1, 2):
        t0 = time.perf_counter()
        step(i)
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    backend.reset_launches()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        step(3)
        torch.cuda.synchronize()
        prof_wall = (time.perf_counter() - t0) * 1e3
    # device activity (kernels, memcpy, memset) is what ran on the card; the
    # CPU ops carry their kernels' time as well and are ranked by host time
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
    busy = _busy_ms(on_card)
    # the port's own kernels (csrc/*.cu): every device row that is not one of
    # PyTorch's kernels, copies or fills
    own = [r for r in device
           if not any(t in r[0] for t in ("at::native", "at_cuda_detail", "Memcpy", "Memset"))]
    return {
        "preset": preset, "layers": synthetic.LAYERS, "n": synthetic.N, "mesh": mesh,
        "wall_ms": walls, "profiled_wall_ms": prof_wall,
        "device_busy_ms": busy, "idle_share": 1.0 - busy / prof_wall,
        "device_events": len(on_card),
        "wrapper_launches": dict(backend.launches),
        "top_device": [[k, ms, c] for k, ms, c in device[:12]],
        "own_kernels": [[k, ms, c] for k, ms, c in own],
        "top_host": [[k, ms, c] for k, ms, c in host[:12]],
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--out", default="chiprun_out/profile_sync.json")
    ap.add_argument("--mesh", default=None, help="named axes, e.g. pod=4,data=2")
    args = ap.parse_args(argv)
    mesh = parse_mesh(args.mesh) if args.mesh else None

    import torch

    if not torch.cuda.is_available():
        raise SystemExit("profile_sync: no CUDA device is available")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60).stdout.strip()
    from repro_torch.kernels import backend
    from repro_torch.train import synthetic
    backend.build()
    out = {"card": card, "torch": torch.__version__, "results": []}
    print(f"card: {card}", flush=True)
    import math

    from repro_torch import random as prandom
    from repro_torch.core import rotation
    shapes, _ = synthetic.main_shapes()
    d = max(math.prod(s) for s in shapes.values())
    out["uniform_draw"] = time_draw(prandom.uniform, d)
    out["sign_draw"] = time_draw(prandom.rademacher, rotation.padded_dim(d))
    print(f"uniform draw: {json.dumps(out['uniform_draw'])}", flush=True)
    print(f"sign draw: {json.dumps(out['sign_draw'])}", flush=True)
    presets = synthetic.PRESETS if mesh is None else synthetic.HIER_PRESETS
    for preset in presets:
        r = profile_preset(preset, mesh)
        out["results"].append(r)
        print(json.dumps({k: r[k] for k in ("preset", "wall_ms", "profiled_wall_ms",
                                             "device_busy_ms", "idle_share",
                                             "device_events")}),
              flush=True)
        for k, ms, c in r["top_device"][:8]:
            print(f"  device {ms:9.3f} ms  x{c:<6d} {k[:90]}")
        for k, ms, c in r["own_kernels"]:
            print(f"  kernel {ms:9.3f} ms  x{c:<6d} {k[:90]}")
        for k, ms, c in r["top_host"][:8]:
            print(f"  host   {ms:9.3f} ms  x{c:<6d} {k[:90]}")
    path = pathlib.Path(args.out)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
