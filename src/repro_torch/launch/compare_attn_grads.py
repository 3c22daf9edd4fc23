"""Training gradients with flash attention against ``attn_impl="xla"``, or
against themselves with the backward perturbed.

    PYTHONPATH=src python -m repro_torch.launch.compare_attn_grads \
        [--layers 2] [--seq 512] [--flash-block 64] [--xla-block 512] \
        [--dtype bfloat16] [--perturb EPS] [--device cpu]

qwen3-4b at full width and ``--layers`` layers, parameters drawn from seed
0, remat: the loss of one ``--seq``-token ``SyntheticLM`` sequence (over
the training path's global token count, 8 × 4096) and its gradients
(``train/synthetic.py::rank_loss_and_grads``), once with
``attn_impl="flash"`` at blocks of ``--flash-block`` and once with
``"xla"`` at chunks of ``--xla-block``.  Prints the relative loss
difference and each leaf's ‖Δg‖/‖g‖, largest first.  On the CPU the flash
path runs the plain blockwise forward and backward, so it rehearses the
comparison ``chip_smoke.py`` phase 5 makes with the kernels (which tile by
64); equal blocks run the same operations on both paths.

``--perturb EPS`` (CPU only) compares the flash path with itself instead,
the second time with every dq, dk and dv of the backward sweeps times
``1 + EPS · N(0, 1)`` (seeded): how far a difference of that size in the
attention backward moves the model's gradients at ``--dtype``.
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses


@contextlib.contextmanager
def _perturbed_backward(eps: float):
    """The plain backward sweeps' outputs times 1 + eps · N(0, 1)."""
    import torch

    from repro_torch.kernels.flash_attention import ops

    gen = torch.Generator().manual_seed(1)
    exact = ops._ref.flash_attention_bwd

    def perturbed(*args, **kwargs):
        return tuple(x * (1 + eps * torch.randn(x.shape, generator=gen))
                     for x in exact(*args, **kwargs))

    ops._ref.flash_attention_bwd = perturbed
    try:
        yield
    finally:
        ops._ref.flash_attention_bwd = exact


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--layers", type=int, default=2)
    ap.add_argument("--seq", type=int, default=512)
    ap.add_argument("--flash-block", type=int, default=64)
    ap.add_argument("--xla-block", type=int, default=512)
    ap.add_argument("--dtype", default="bfloat16")
    ap.add_argument("--perturb", type=float, default=None)
    ap.add_argument("--device", default=None)
    args = ap.parse_args(argv)

    from repro_torch import resolve_device
    from repro_torch.configs.base import RunConfig, ShapeSpec
    from repro_torch.configs.registry import get_config
    from repro_torch.data.pipeline import SyntheticLM
    from repro_torch.models import model
    from repro_torch.train import synthetic

    dev = resolve_device(args.device)
    if args.perturb is not None and dev.type != "cpu":
        raise SystemExit("--perturb runs the plain backward: pass --device cpu")
    cfg = dataclasses.replace(get_config(synthetic.MODEL), num_layers=args.layers)
    params = model.init(0, cfg, device=dev)
    batch = SyntheticLM(cfg, ShapeSpec("one", "train", args.seq, 1)).batch(0, dev)
    global_tokens = float(synthetic.N * 4096)

    def grads(impl, block, ctx=contextlib.nullcontext()):
        run = RunConfig(attn_impl=impl, attn_chunk_q=block, attn_chunk_k=block,
                        compute_dtype=args.dtype)
        with ctx:
            return synthetic.rank_loss_and_grads(cfg, run, params, batch, global_tokens)

    lf, gf = grads("flash", args.flash_block)
    if args.perturb is None:
        what = f"flash block {args.flash_block} vs xla chunk {args.xla_block}"
        lx, gx = grads("xla", args.xla_block)
    else:
        what = f"flash block {args.flash_block} vs itself, backward perturbed by {args.perturb:g}"
        lx, gx = grads("flash", args.flash_block, _perturbed_backward(args.perturb))
    print(f"layers {args.layers} seq {args.seq} {args.dtype}, {what}: loss {lf} vs {lx}, "
          f"relative {abs(lf - lx) / abs(lx):.3g}")
    errs = synthetic.grad_rel_errs(gf, gx)
    for k in sorted(errs, key=errs.get, reverse=True):
        print(f"  {k:24s} {errs[k]:.3g}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
