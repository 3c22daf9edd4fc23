"""Training launcher — port of ``repro.launch.train``.

    PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-4b \\
        --steps 100 --ckpt-dir /tmp/ckpt [--smoke] [--devices 8] [--device cpu]

With ``--ckpt-dir`` the run saves every ``--ckpt-every`` steps and at its
last step; killed and started again with the same directory, it resumes
from the newest checkpoint there (``train/trainer.py``).  ``--smoke`` uses
the arch's reduced config and the reference's smoke run: fixed-k 1/16 with
shared support over ``data``, error feedback, ``min_compress_size`` 1024;
without it the full config, ``SHAPES[--shape]`` and ``get_run_config``
(qwen3-4b at 36 layers does not fit one card: ROADMAP.md, queue 1).
``--arch`` takes the dense, VLM, MoE, SSM, hybrid and encoder–decoder
configs of the registry (qwen3-4b, llava-next-34b, olmoe-1b-7b,
qwen2-moe-a2.7b, mamba2-130m, jamba-v0.1-52b, whisper-medium); the SSM and
hybrid smoke configs' chunk is 16 tokens, so their ``--seq`` must be a
multiple of 16 (the default 128 is); whisper's batches carry its frames
(512 of them in the smoke config, 1536 in the full one); llava's sequences
are its patches (8 in the smoke config, 1152 in the full one) and then
``--seq`` less that many tokens.  mistral-large-123b, qwen2-moe-a2.7b,
jamba-v0.1-52b and llava-next-34b train with FSDP over ``data``, as the
reference's ``get_run_config`` sets it (at full size they need cards to
match: ROADMAP.md, queue 1).

``--devices N`` stacks N data-parallel ranks on the one device, the port's
counterpart of the reference's N simulated host devices; ``--data`` times
``--model`` must be N (a ``ValueError`` otherwise).  ``--model`` above
1 is tensor parallelism, which raises :class:`NotPortedError`.  The run is
on the card unless ``--device cpu``.

``--dist {gloo,nccl}`` runs one rank per process over
``torch.distributed`` (:class:`DistComm`) instead, the ranks and the
rendezvous taken from ``torchrun``'s environment (``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``); the mesh
is the world, ``--data`` × ``--model`` of it::

    torchrun --nproc-per-node 4 -m repro_torch.launch.train --dist nccl \
        --main-path --steps 2 --report chiprun_out/nccl.json

``nccl`` runs on the cards (one a process, ``cuda:LOCAL_RANK``), ``gloo``
on the CPU (``--device cpu``); only rank 0 prints and writes checkpoints.
``--main-path`` trains ``chip_smoke.py`` phase 5's training cell
(``train/synthetic.py::train_main_path``: qwen3-4b at full width and 4
layers, one ``train_4k`` sequence a rank, ``fixed_k_1bit``);
``--fsdp-path`` phase 5g's FSDP cell (``synthetic.fsdp_train_path``:
qwen2-moe-a2.7b at full width, ``--layers`` of its 24 layers, 4 by
default, one ``train_4k`` sequence a rank, FSDP over ``data``); under
``--dist nccl`` each process then holds its rank's shards::

    torchrun --nproc-per-node 4 -m repro_torch.launch.train --dist nccl \
        --fsdp-path --layers 24 --steps 2 --report chiprun_out/fsdp24.json

``--multipod-fsdp-path`` trains phase 5h's cell
(``synthetic.multipod_fsdp_train_path``: the same model at ``--layers``
layers on its own mesh, (pod 2, data 2), with the reference's
``get_run_config(..., multi_pod=True)``: FSDP over ``data``,
``fixed_k_1bit`` over ``pod``), under ``--devices 4`` or a world of 4;
``--dist`` runs the data groups' gathers and reduce-scatters and the pod
groups' rounds as sub-groups of the world.  Under ``--dist`` every
collective fails the run after ``COLLECTIVE_TIMEOUT`` instead of hanging.

``--report``
writes each step's phase ms, exposed sync ms, bucket rounds and wire bytes
and a digest of the end state (:mod:`repro_torch.launch.step_report`;
an FSDP leaf's by rank shard, so a run whose processes hold shards and
one whose stacked ranks hold whole leaves compare).
The sync runs the backward-pipelined schedule by the reference's rule
unless ``--no-overlap``.
"""
from __future__ import annotations

import argparse
import dataclasses
import datetime
import json
import math
import os
import pathlib
import sys

import torch
import torch.distributed as dist

from repro_torch.configs.base import SHAPES, RunConfig, ShapeSpec
from repro_torch.configs.registry import get_config, get_run_config, smoke_config
from repro_torch.core import types as core_types
from repro_torch.core.collectives import DistComm
from repro_torch.launch import mesh as mesh_lib
from repro_torch.launch.step_report import StepTimer, fsdp_state_digest
from repro_torch.optim.optimizers import AdamWConfig
from repro_torch.train import synthetic
from repro_torch.train.trainer import Trainer, TrainerConfig

# how long one collective of a --dist run, sub-groups' included, may wait
# before the run fails (a rank that never joins it would hang the run)
COLLECTIVE_TIMEOUT = datetime.timedelta(seconds=300)


def _parse(argv=None):
    ap = argparse.ArgumentParser(description="Train with compressed gradient sync; resumes "
                                             "from --ckpt-dir")
    ap.add_argument("--arch", default="qwen3-4b")
    ap.add_argument("--shape", default="train_4k")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--devices", type=int, default=0,
                    help="stack N data-parallel ranks on the one device (the reference "
                         "simulates N host devices); default 1")
    ap.add_argument("--data", type=int, default=0, help="data-axis size")
    ap.add_argument("--model", type=int, default=0,
                    help="model-axis size (above 1: tensor parallelism, not ported)")
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--batch", type=int, default=16)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--no-compress", action="store_true")
    ap.add_argument("--no-overlap", action="store_true",
                    help="set BucketSpec.overlap=False, as the reference does: the sync runs "
                         "after the backward (the post-backward schedule) instead of in it")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the ranks run (default: the card)")
    ap.add_argument("--dist", choices=("gloo", "nccl"), default=None,
                    help="one rank per process over torch.distributed, from torchrun's "
                         "environment (nccl: the cards; gloo: the CPU)")
    ap.add_argument("--main-path", action="store_true",
                    help="chip_smoke.py phase 5's training cell: qwen3-4b at full width and "
                         "4 layers, one train_4k sequence a rank, fixed_k_1bit")
    ap.add_argument("--fsdp-path", action="store_true",
                    help="chip_smoke.py phase 5g's FSDP cell: qwen2-moe-a2.7b at full width "
                         "and --layers layers, one train_4k sequence a rank, FSDP over data")
    ap.add_argument("--multipod-fsdp-path", action="store_true",
                    help="chip_smoke.py phase 5h's cell: qwen2-moe-a2.7b at full width and "
                         "--layers layers on the (pod 2, data 2) mesh, FSDP over data, "
                         "fixed_k_1bit over pod; --devices 4 or a world of 4")
    ap.add_argument("--layers", type=int, default=None,
                    help="the depth of --fsdp-path (default: synthetic.FSDP_LAYERS) or "
                         "--multipod-fsdp-path (synthetic.MULTIPOD_FSDP_LAYERS)")
    ap.add_argument("--report", default=None,
                    help="write each step's phase ms, exposed sync ms, bucket rounds, wire "
                         "bytes and a digest of the end state to this JSON file (rank 0)")
    return ap.parse_args(argv)


def _init_dist(args):
    """(rank, world, device) of this process, its process group started
    from torchrun's environment with ``COLLECTIVE_TIMEOUT`` on each
    collective."""
    if args.devices > 1:
        raise ValueError("--dist runs one rank per process; --devices N stacks N ranks on "
                         "one device: give one or the other")
    env = {k: os.environ.get(k) for k in ("RANK", "WORLD_SIZE", "LOCAL_RANK", "MASTER_ADDR",
                                          "MASTER_PORT")}
    missing = [k for k, v in env.items() if v is None]
    if missing:
        raise ValueError(f"--dist takes its ranks from torchrun's environment; {missing} "
                         "not set")
    rank, world, local = int(env["RANK"]), int(env["WORLD_SIZE"]), int(env["LOCAL_RANK"])
    if args.dist == "nccl":
        if args.device != "cuda":
            raise ValueError("--dist nccl runs on the cards: --device cuda")
        if not torch.cuda.is_available():
            raise RuntimeError("--dist nccl: no CUDA device is available")
        torch.cuda.set_device(local)
        device = torch.device("cuda", local)
    else:
        if args.device != "cpu":
            raise ValueError("--dist gloo runs on the CPU: --device cpu")
        device = torch.device("cpu")
    dist.init_process_group(args.dist, init_method=f"tcp://{env['MASTER_ADDR']}:"
                                                   f"{env['MASTER_PORT']}",
                            world_size=world, rank=rank, timeout=COLLECTIVE_TIMEOUT)
    return rank, world, device


def main(argv=None) -> int:
    args = _parse(argv)
    rank, device = 0, args.device
    if args.dist:
        rank, n, device = _init_dist(args)
    else:
        n = args.devices or 1
    if args.multipod_fsdp_path:
        cfg, run, shape, mesh = synthetic.multipod_fsdp_train_path(
            args.layers or synthetic.MULTIPOD_FSDP_LAYERS)
        if math.prod(mesh.values()) != n or args.data or args.model:
            raise ValueError(f"--multipod-fsdp-path runs on its mesh {mesh}: "
                             f"{math.prod(mesh.values())} ranks, not {n}, and no --data/--model")
        run = _overlap_flag(args, run)
    else:
        data = args.data or max(1, n // max(1, args.model or 1))
        model = args.model or (n // data)
        if data * model != n:
            raise ValueError(f"a mesh of data {data} x model {model} does not hold {n} ranks "
                             f"({'the world' if args.dist else '--devices'})")
        mesh = mesh_lib.data_parallel(mesh_lib.make_debug_mesh(data, model))
        cfg, run, shape = build_config(args, n, model)
    comm = DistComm(device=device, mesh=mesh, timeout=COLLECTIVE_TIMEOUT) if args.dist else None

    tcfg = TrainerConfig(steps=args.steps, ckpt_dir=args.ckpt_dir,
                         ckpt_every=args.ckpt_every, log_every=max(1, args.steps // 20))
    timer = StepTimer(device) if args.report else None
    tr = Trainer(cfg, run, shape, tcfg, opt_cfg=AdamWConfig(lr=args.lr, total_steps=args.steps),
                 device=device, on_phase=timer, mesh=None if comm else mesh, comm=comm)
    params, opt_state, hist = tr.fit()
    if rank == 0:
        for h in hist:
            print(f"step {h['step']:5d}  loss {h['loss']:.4f}  "
                  f"gnorm {h['grad_norm']:.3f}  lr {h['lr']:.2e}")
    if args.report:
        digest = {"params": _digest(tr, params), "m": _digest(tr, opt_state.m),
                  "v": _digest(tr, opt_state.v)}
        dev = torch.device(device)
        peak = torch.cuda.max_memory_allocated(dev) / 2**30 if dev.type == "cuda" else None
        peaks = [peak]
        if args.dist:
            peaks = [None] * n
            dist.all_gather_object(peaks, peak)
        if rank == 0:
            _write_report(args, tr, n, device, timer, hist, digest, peaks)
    if args.dist:
        dist.destroy_process_group()
    return 0


def build_config(args, n: int, model: int):
    """(cfg, run, shape) the command line asks for over ``n`` ranks (a model
    axis of ``model``)."""
    if args.layers is not None and not args.fsdp_path:
        raise ValueError("--layers sets the depth of --fsdp-path or --multipod-fsdp-path")
    if args.main_path:
        cfg, run, shape = synthetic.train_main_path()
        shape = dataclasses.replace(shape, global_batch=n)
    elif args.fsdp_path:
        cfg, run, shape = synthetic.fsdp_train_path(args.layers or synthetic.FSDP_LAYERS, n)
    elif args.smoke:
        cfg = smoke_config(args.arch)
        shape = ShapeSpec("cli", "train", args.seq, args.batch)
        comp = (core_types.CompressionConfig(mode="none") if args.no_compress
                else core_types.CompressionConfig(
                    encoder=core_types.EncoderSpec(kind="fixed_k", fraction=1 / 16),
                    mode="shared_support", axes=("data",),
                    min_compress_size=1024, error_feedback=True))
        run = RunConfig(microbatches=1, model_parallel=model > 1, seq_shard=model > 1,
                        attn_chunk_q=min(128, args.seq), attn_chunk_k=min(128, args.seq),
                        remat=False, compression=comp)
    else:
        cfg = get_config(args.arch)
        shape = SHAPES[args.shape]
        run = get_run_config(args.arch, args.shape)
    return cfg, _overlap_flag(args, run), shape


def _overlap_flag(args, run: RunConfig) -> RunConfig:
    """``run`` with ``BucketSpec.overlap`` off under ``--no-overlap``."""
    if not args.no_overlap:
        return run
    comp = run.compression
    return dataclasses.replace(run, compression=dataclasses.replace(
        comp, bucket=dataclasses.replace(comp.bucket, overlap=False)))


def _digest(tr, tree):
    """:func:`fsdp_state_digest` of ``tree``: an FSDP leaf's by data shard,
    cut from the whole leaf where the ranks are stacked, gathered from every
    process where each holds its own (a collective: every rank calls it).
    Every pod holds the same shards: a shard whose pods' digests differ is
    reported as all of them, joined by ``|``."""
    n, n_data = math.prod(tr.mesh.values()), tr.mesh["data"]

    def gather(d):
        got = [None] * n
        dist.all_gather_object(got, d)
        # rank r holds data shard r % n_data (pod-major)
        return ["|".join(dict.fromkeys(got[e::n_data])) for e in range(n_data)]

    return fsdp_state_digest(tree, tr.fsdp_dims, n_data, gather if tr.sharded else None)


def _write_report(args, tr, n, device, timer, hist, digest, peaks) -> None:
    dev = torch.device(device)
    report = {
        "device": torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu",
        "dist": args.dist, "ranks": n, "mesh": tr.mesh, "model": tr.cfg.name,
        "layers": tr.cfg.num_layers, "seq": tr.shape.seq_len,
        "global_batch": tr.shape.global_batch, "overlap": tr.overlap,
        "plan_schedule": list(tr.sync_plan.schedule()) if tr.sync_plan else None,
        "fsdp": tr.run.fsdp, "peak_GiB_by_rank": peaks,
        "steps": timer.steps, "history": hist, "digest": digest}
    path = pathlib.Path(args.report)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(json.dumps(report, indent=1))


if __name__ == "__main__":
    sys.exit(main())
