"""The training cell with one rank per card over NCCL against the stacked
step, both issue schedules, on one host's cards.

    PYTHONPATH=src python -m repro_torch.launch.bench_dist [--world 4] [--steps 2] \\
        [--out chiprun_out/bench_dist.json] [--fsdp-path [--layers 4]]

Runs ``launch/train.py --main-path`` (``chip_smoke.py`` phase 5's training
cell: qwen3-4b at full width and 4 layers, one 4096-token sequence a rank,
``fixed_k_1bit``) four times, each with ``--report``: under ``torchrun``
with ``--dist nccl`` on ``--world`` cards, backward-pipelined and then
post-backward (``--no-overlap``), and with the same ranks stacked on card 0
(``--devices``), both schedules.  Prints and writes each run's card, steps
(phase ms, exposed sync ms, wire bytes of one rank's communicator), losses,
the rounds' issue order and timeline, and whether its end state (digests
of the parameters, m and v) equals the stacked backward-pipelined run's.
With ``--fsdp-path`` the cell is ``chip_smoke.py`` phase 5g's instead
(``train/synthetic.py::fsdp_train_path``: qwen2-moe-a2.7b at full width and
``--layers`` layers, FSDP over ``data``), run twice, under its own
schedule: over NCCL, each process holding its rank's shards, and stacked
on card 0 with every leaf whole; the digests hold an FSDP leaf by its rank
shards, so the two compare.  With ``--multipod-fsdp-path [--layers 3]`` it is phase
5h's (``synthetic.multipod_fsdp_train_path``: the same model on the (pod
2, data 2) mesh, FSDP over ``data``, ``fixed_k_1bit`` over ``pod``; a
world of 4), the same two runs, the NCCL one on sub-groups of the world:
the data groups' gathers and reduce-scatters and the pod groups' rounds;
the digests hold an FSDP leaf by its data shards.
Needs ``--world`` CUDA cards; fails without them.
"""
from __future__ import annotations

import argparse
import json
import os
import pathlib
import subprocess
import sys


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--world", type=int, default=4)
    ap.add_argument("--steps", type=int, default=2)
    ap.add_argument("--out", default="chiprun_out/bench_dist.json")
    ap.add_argument("--fsdp-path", action="store_true",
                    help="phase 5g's FSDP cell instead of phase 5's training cell")
    ap.add_argument("--multipod-fsdp-path", action="store_true",
                    help="phase 5h's multi-pod FSDP cell (pod 2, data 2): a world of 4")
    ap.add_argument("--layers", type=int, default=None, help="the FSDP cell's depth")
    args = ap.parse_args(argv)
    fsdp = args.fsdp_path or args.multipod_fsdp_path

    import torch

    if torch.cuda.device_count() < args.world:
        raise SystemExit(f"bench_dist: {torch.cuda.device_count()} CUDA cards, "
                         f"{args.world} needed")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60).stdout.strip()
    print(card, flush=True)
    from repro_torch.kernels import backend

    backend.build()              # once, before the ranks start
    out = pathlib.Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    cell = (["--multipod-fsdp-path" if args.multipod_fsdp_path else "--fsdp-path"]
            + (["--layers", str(args.layers)] if args.layers else []))
    train = [sys.executable, "-m", "repro_torch.launch.train",
             *(cell if fsdp else ["--main-path"]), "--steps", str(args.steps)]
    runs = {}
    for where in ("nccl", "stacked"):
        for overlap in ((True,) if fsdp else (True, False)):
            name = f"{where}_{'overlapped' if overlap else 'post_backward'}"
            report = out.with_name(f"{out.stem}_{name}.json")
            flags = ["--report", str(report)] + ([] if overlap else ["--no-overlap"])
            env = dict(os.environ)
            if where == "nccl":
                cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
                       "--nproc-per-node", str(args.world), *train[1:], "--dist", "nccl",
                       *flags]
            else:
                cmd = [*train, "--devices", str(args.world), *flags]
                env["CUDA_VISIBLE_DEVICES"] = "0"
            proc = subprocess.run(cmd, capture_output=True, text=True, env=env, timeout=900)
            if proc.returncode != 0:
                raise SystemExit(f"bench_dist: {name} failed\n{proc.stdout}\n{proc.stderr}")
            runs[name] = json.loads(report.read_text())
    ref = runs["stacked_overlapped"]["digest"]
    summary = {"card": card, "world": args.world, "steps": args.steps,
               "plan_schedule": runs["stacked_overlapped"]["plan_schedule"], "runs": {}}
    for name, r in runs.items():
        summary["runs"][name] = {
            "device": r["device"], "overlap": r["overlap"], "ranks": r["ranks"],
            "mesh": r["mesh"], "layers": r["layers"],
            "end_state_equals_stacked": r["digest"] == ref,
            "loss": [h["loss"] for h in r["history"]],
            "grad_norm": [h["grad_norm"] for h in r["history"]],
            "peak_GiB_by_rank": r.get("peak_GiB_by_rank"), "steps": r["steps"]}
        print(name, json.dumps(summary["runs"][name]), flush=True)
    out.write_text(json.dumps(summary, indent=1))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
