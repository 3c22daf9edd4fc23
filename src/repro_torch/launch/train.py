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

``--devices N`` stacks N data-parallel ranks on the one device, the port's
counterpart of the reference's N simulated host devices; ``--data`` times
``--model`` must be N (a ``ValueError`` otherwise).  ``--model`` above
1 is tensor parallelism, which raises :class:`NotPortedError`.  The run is
on the card unless ``--device cpu``.
"""
from __future__ import annotations

import argparse
import dataclasses
import sys

from repro_torch.configs.base import SHAPES, RunConfig, ShapeSpec
from repro_torch.configs.registry import get_config, get_run_config, smoke_config
from repro_torch.core import types as core_types
from repro_torch.launch import mesh as mesh_lib
from repro_torch.optim.optimizers import AdamWConfig
from repro_torch.train.trainer import Trainer, TrainerConfig


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
                    help="set BucketSpec.overlap=False, as the reference does; the port's "
                         "step runs the post-backward schedule either way")
    ap.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                    help="where the ranks run (default: the card)")
    return ap.parse_args(argv)


def main(argv=None) -> int:
    args = _parse(argv)
    n = args.devices or 1
    data = args.data or max(1, n // max(1, args.model or 1))
    model = args.model or (n // data)
    if data * model != n:
        raise ValueError(f"a mesh of data {data} x model {model} does not hold {n} ranks "
                         "(--devices)")
    mesh = mesh_lib.data_parallel(mesh_lib.make_debug_mesh(data, model))

    if args.smoke:
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
    if args.no_overlap:
        comp = run.compression
        run = dataclasses.replace(
            run, compression=dataclasses.replace(
                comp, bucket=dataclasses.replace(comp.bucket, overlap=False)))

    tcfg = TrainerConfig(steps=args.steps, ckpt_dir=args.ckpt_dir,
                         ckpt_every=args.ckpt_every, log_every=max(1, args.steps // 20))
    tr = Trainer(cfg, run, shape, tcfg, opt_cfg=AdamWConfig(lr=args.lr, total_steps=args.steps),
                 device=args.device, mesh=mesh)
    _, _, hist = tr.fit()
    for h in hist:
        print(f"step {h['step']:5d}  loss {h['loss']:.4f}  "
              f"gnorm {h['grad_norm']:.3f}  lr {h['lr']:.2e}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
