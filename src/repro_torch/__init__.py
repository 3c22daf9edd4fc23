"""PyTorch + CUDA port of the randomized distributed mean estimation system.

``repro_torch`` mirrors the layout and names of the JAX package ``repro``
(the reference), module for module, so that each function's counterpart is
easy to find.  It imports ``torch``, numpy and ctypes only — never JAX and
never ``repro``.

Slices 1–4 cover the compressed-mean gradient sync of the
``fixed_k_1bit``, ``bernoulli_seed_1bit``, ``binary_packed``,
``ternary_packed``, ``ternary_opt``, ``rotated_binary`` and
``rotated_fixed_k`` presets and the dense simulation:
``train.bucketing.sync_grads_bucketed`` → ``core.collectives
.compressed_mean`` → ``core.wire.registry.resolve`` → codec pack →
all_gather / psum → decode → mean, with hand-written CUDA kernels for the
Threefry-driven Bernoulli wire, the fixed-k gather, the bit-plane pack,
unpack and binary accumulate, the FWHT and the rotated encode.  Slice 5
serves the dense family (qwen3-4b): ``serving.engine.build_serve_fns`` →
``models.model.prefill`` / ``decode_step`` → ``models.transformer.forward``
→ the flash-attention forward kernel, then ``serving.engine.generate``.
Slice 6 trains it (``train.trainer.Trainer``) with the flash-attention
backward kernels.  Slice 7 adds the hash-PRNG encoders of the §1.1 encode
benchmark (``launch.bench_encode_speed``) and the single-host stack
(``core.protocol.MeanEstimator``, the §6 solvers, ``examples``).  The
Mixture-of-Experts family (``models.moe``: olmoe-1b-7b, qwen2-moe-a2.7b),
the SSM family (``models.ssm``: mamba2-130m) and the hybrid family that
interleaves them with attention (jamba-v0.1-52b) are served and trained on
the same paths.  The kernels are in
``src/repro_torch/csrc``.

Entry points run on the CUDA card unless the caller passes a CPU device;
with no card and no device given they raise (:func:`resolve_device`).
"""
from __future__ import annotations

import torch


def resolve_device(device=None) -> torch.device:
    """The device an entry point runs on: ``device`` if given, else cuda.

    Raises RuntimeError when no device was asked for and no CUDA card is
    present — the port never falls back to the CPU on its own.
    """
    if device is not None:
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; pass device='cpu' to run the "
            "plain PyTorch versions")
    return torch.device("cuda")
