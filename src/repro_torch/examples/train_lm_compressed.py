"""Train a small LM with compressed gradient aggregation on 8 data-parallel
ranks, the paper's 1-bit-class operating point against exact
synchronization — port of ``examples/train_lm_compressed.py``.

    PYTHONPATH=src python -m repro_torch.examples.train_lm_compressed \\
        [--steps 200] [--preset NAME] [--device cpu]

The 8 ranks are stacked on one device (the card unless ``--device cpu``):
each takes its own rows of the global batch, and the gradient sync runs
over them (``train.train_step``).  The default runs the exact mean, then
fixed-k 1/16 with shared support plus error feedback (``fixed_k_1bit`` +
EF), and prints each run's logged losses and, for error feedback, every
bucket's residual norm.  ``--preset NAME`` runs one named preset of
``configs.registry.COMPRESSION_PRESETS`` instead (``ef_*`` presets print
their residual norms too).

Attention is the flash path, as in the reference: on the card the Hopper
kernels at lm-8m's head dim of 32 (counted as ``flash_attention_*_hd32``),
on the CPU their plain blockwise versions in 128 × 128 blocks.
"""
from __future__ import annotations

import argparse
import dataclasses

import torch

from repro_torch import resolve_device
from repro_torch.configs import registry
from repro_torch.configs.base import ArchConfig, RunConfig, ShapeSpec
from repro_torch.core import types as core_types
from repro_torch.optim.optimizers import AdamWConfig
from repro_torch.train.trainer import Trainer, TrainerConfig

CFG = ArchConfig(name="lm-8m", family="dense", num_layers=4, d_model=256, num_heads=8,
                 num_kv_heads=4, head_dim=32, d_ff=1024, vocab_size=2048, tie_embeddings=True)
SHAPE = ShapeSpec("train", "train", seq_len=128, global_batch=32)
N = 8


def ef_compression() -> core_types.CompressionConfig:
    """The reference example's compressed run: fixed-k 1/16, shared
    support, error feedback, over the data axis."""
    return core_types.CompressionConfig(
        encoder=core_types.EncoderSpec(kind="fixed_k", fraction=1 / 16, center="mean"),
        mode="shared_support", axes=("data",), min_compress_size=1024, error_feedback=True)


def run(steps: int, compression: core_types.CompressionConfig, label: str, device=None,
        cfg: ArchConfig = CFG, shape: ShapeSpec = SHAPE, n: int = N):
    """``steps`` steps of ``Trainer.fit`` under ``compression``; prints the
    logged metrics and, with error feedback, each bucket's residual norm.
    Returns (metrics history, the trainer)."""
    run_cfg = RunConfig(microbatches=1, model_parallel=False, attn_chunk_q=128,
                        attn_chunk_k=128, remat=False, compression=compression)
    tcfg = TrainerConfig(steps=steps, log_every=max(1, steps // 10), seed=0)
    tr = Trainer(cfg, run_cfg, shape, tcfg, n,
                 AdamWConfig(lr=1e-3, warmup_steps=20, total_steps=steps), device=device)
    _, _, hist = tr.fit()
    print(f"\n== {label} ==")
    for h in hist:
        print(f"  step {h['step']:4d}  loss {h['loss']:.4f}  "
              f"gnorm {h['grad_norm']:.3f}  ({h['sec']:.0f}s)")
    if compression.error_feedback and tr.ef_state:
        # the compression error each step recycles; bounded residuals make
        # the time-averaged estimates unbiased
        if len(hist) > 1:
            sec_per_step = ((hist[-1]["sec"] - hist[0]["sec"])
                            / max(1, hist[-1]["step"] - hist[0]["step"]))
        else:
            sec_per_step = hist[-1]["sec"] / max(1, hist[-1]["step"] + 1)
        for bid in sorted(tr.ef_state):
            e = tr.ef_state[bid][0]       # rank 0's, the reference's global view
            print(f"  ef residual ‖e‖ {float(torch.linalg.vector_norm(e)):9.4f}  "
                  f"({e.numel()} coords)  bucket {bid}  [{sec_per_step * 1e3:.0f} ms/step]")
    return hist, tr


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--preset", default=None,
                    help="run one named wire preset of COMPRESSION_PRESETS (e.g. "
                         "rotated_binary, ef_rotated_binary, ternary_opt) instead of the "
                         "exact-vs-fixed-k comparison; ef_* presets print residual norms")
    ap.add_argument("--device", default=None, help="cpu, or cuda (the default)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    if args.preset:
        cfg = dataclasses.replace(registry.compression_preset(args.preset, axes=("data",)),
                                  min_compress_size=1024)
        hist, _ = run(args.steps, cfg, f"preset {args.preset}", dev)
        print(f"\nfinal loss — {args.preset}: {hist[-1]['loss']:.4f}")
        return 0

    exact, _ = run(args.steps, core_types.CompressionConfig(mode="none"),
                   "exact gradient mean (baseline)", dev)
    compressed, _ = run(args.steps, ef_compression(),
                        "fixed-k 1/16 + error feedback (1-bit-class wire cost)", dev)
    print(f"\nfinal loss — exact: {exact[-1]['loss']:.4f}   "
          f"compressed(1/16 + EF): {compressed[-1]['loss']:.4f}")
    print("wire bytes per step (gradient sync): exact = 2(n-1)/n·|g|·4B; "
          "compressed ≈ |g|/16·4B + scalars  (×~32 reduction)")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
