"""Serving example: prefill a prompt batch and greedily decode tokens with
the serving engine (KV cache, greedy sampling) — port of
``examples/serve_lm.py``.

    PYTHONPATH=src python -m repro_torch.examples.serve_lm [--device cpu]

The smoke qwen3-4b (2 layers, head dim 16) with random weights drawn from
a seed: 4 prompts of 16 tokens, then 16 greedy tokens.  On the card its
prefill runs the flash-attention forward kernel at hd 16 (counted as
``flash_attention_fwd_hd16``); on the CPU the plain blockwise version.
"""
from __future__ import annotations

import argparse

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import RunConfig, ShapeSpec
from repro_torch.configs.registry import smoke_config
from repro_torch.core import types as core_types
from repro_torch.models import model as model_lib
from repro_torch.serving import engine

CFG = smoke_config("qwen3-4b")
RUN = RunConfig(microbatches=1, model_parallel=True, seq_shard=False, attn_chunk_q=16,
                attn_chunk_k=16, remat=False,
                compression=core_types.CompressionConfig(mode="none"))
SHAPE = ShapeSpec("serve", "decode", seq_len=64, global_batch=4)
PROMPT_LEN, STEPS = 16, 16


def serve(params, prompt, device=None, cfg=CFG):
    """Greedy generation from ``prompt`` (B, S) ints with ``params`` of
    ``cfg`` (on ``device``, the card unless given): the token the prefill's
    logits pick, then ``STEPS`` decoded tokens → (B, 1 + STEPS) int32."""
    prefill_fn, decode_fn = engine.build_serve_fns(cfg, RUN, SHAPE, device)
    cache, logits = prefill_fn(params, {"tokens": prompt})
    tok = torch.argmax(logits, dim=-1).to(torch.int32)
    out = [tok]
    for i in range(STEPS):
        tok, cache = decode_fn(params, cache, tok, prompt.shape[1] + i)
        out.append(tok.to(torch.int32))
    return torch.cat(out, dim=1)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default=None, help="cpu, or cuda (the default)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    params = model_lib.init(0, CFG, device=dev)
    gen = torch.Generator().manual_seed(1)
    prompt = torch.randint(0, CFG.vocab_size, (SHAPE.global_batch, PROMPT_LEN), generator=gen,
                           dtype=torch.int32)
    out = serve(params, prompt, dev).cpu()
    print("prompt shape:", tuple(prompt.shape), "-> first sampled token:",
          out[:, 0].tolist())
    print("generated (greedy, random weights):")
    for row in out.tolist():
        print("  ", row)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
