"""Serving: prefill and decode step functions on one device, and the
batched greedy-generation loop — port of ``repro.serving.engine`` without
a mesh (no cache shardings: the whole cache lives on the one device).
"""
from __future__ import annotations

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ArchConfig, RunConfig, ShapeSpec
from repro_torch.models import model as model_lib


def build_serve_fns(cfg: ArchConfig, run: RunConfig, shape: ShapeSpec, device=None):
    """Returns (prefill_fn, decode_fn) on ``device`` (the card unless given):

    prefill_fn(params, batch) -> (cache, logits (B, 1, V) f32), the cache
        padded to ``shape.seq_len`` (a window's width when smaller; the SSM
        family's conv windows and states do not grow with it, and of the
        hybrid's cache only the attention K/V does);
    decode_fn(params, cache, tok, pos) -> (next_tok (B, 1), cache), the
        cache updated in place (the reference donates it).

    Tokens (and an encoder–decoder model's frames, a VLM's patches) are
    moved to the device; the parameters must already lie there.
    """
    dev = resolve_device(device)
    ctx = model_lib.make_ctx(cfg, run)
    s_max = shape.seq_len if cfg.window is None else min(shape.seq_len, cfg.window)

    def prefill_fn(params, batch):
        batch = {k: batch[k].to(dev) for k in ("tokens", "frames", "patches") if k in batch}
        return model_lib.prefill(ctx, params, cfg, run, batch, s_max=s_max)

    def decode_fn(params, cache, tok, pos: int):
        nxt, _, cache = model_lib.decode_step(ctx, params, cfg, run, cache, tok.to(dev), pos)
        return nxt, cache

    return prefill_fn, decode_fn


def generate(prefill_fn, decode_fn, params, batch, steps: int):
    """Greedy generation (host loop), as the reference's loop: the first
    token fed to decode is the argmax of the prefill logits; returns the
    ``steps`` decoded tokens (B, steps).

    Decoding starts at the prefill's length: a VLM prompt's patches and
    tokens.  The reference's loop (``repro/serving/engine.py:155``) starts
    at ``batch["tokens"].shape[1]``, the text alone, so for a VLM it would
    write its first decoded K/V over a prompt slot, at the wrong rope
    position: a hazard of the reference, not copied here."""
    cache, logits = prefill_fn(params, batch)
    prompt_len = model_lib.seq_total(batch)
    tok = torch.argmax(logits, dim=-1)
    toks = []
    for i in range(steps):
        tok, cache = decode_fn(params, cache, tok, prompt_len + i)
        toks.append(tok)
    return torch.cat(toks, dim=1)
