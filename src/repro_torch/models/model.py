"""Model facade, dense, VLM, MoE, SSM, hybrid and encoder–decoder families
— port of ``repro.models.model`` at ``tp = 1``: context, init, input
embedding, the train loss, the decode cache, prefill and the decode step.
The VLM family runs the dense stack on its patch embeddings, projected by
``patch_proj`` and prepended to the tokens: its positions, caches and
labels span patches and tokens.
The encoder–decoder family's init, train loss, cache, prefill and decode
step are :mod:`repro_torch.models.encdec`'s, as the reference dispatches
them.

The reference runs these per shard inside ``shard_map``; the port runs them
on one device, or under FSDP on this process's shards of the ``data``
axis.  A mesh with a model axis above 1 raises :class:`NotPortedError`.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ArchConfig, RunConfig
from repro_torch.configs.registry import hybrid_layout
from repro_torch.models import attention as attn_lib
from repro_torch.models import common
from repro_torch.models import encdec as encdec_lib
from repro_torch.models import mlp as mlp_lib
from repro_torch.models import moe as moe_lib
from repro_torch.models import ssm as ssm_lib
from repro_torch.models import transformer as tfm
from repro_torch.models.common import ShardCtx
from repro_torch.models.transformer import sub


def make_ctx(cfg: ArchConfig, run: RunConfig, mesh_sizes: Optional[Dict[str, int]] = None,
             dtype: Optional[torch.dtype] = None, comm=None) -> ShardCtx:
    """The context; ``dtype`` defaults to ``run.compute_dtype`` (the
    reference's default, bf16), FSDP is ``run.fsdp`` over ``data``, and
    ``comm`` the communicator over ``data`` when this process holds only its
    rank's FSDP shards (:class:`ShardCtx`).  A model axis above 1 raises."""
    tp = (mesh_sizes or {}).get("model", 1) if run.model_parallel else 1
    return ShardCtx(tp=tp, compute_dtype=dtype or getattr(torch, run.compute_dtype),
                    fsdp=run.fsdp, comm=comm)


def init(seed: int, cfg: ArchConfig, device=None, keep=None) -> Dict[str, torch.Tensor]:
    """f32 parameters drawn on ``device`` (the card unless given) from a
    ``torch.Generator`` seeded with ``seed``; ``keep(name, leaf)``, when
    given, takes what this process keeps of each whole leaf as it is drawn
    (:class:`~repro_torch.models.common.ParamBuilder`)."""
    gen = torch.Generator(resolve_device(device)).manual_seed(seed)
    if cfg.family == "encdec":
        return encdec_lib.init_encdec(gen, cfg, keep)
    return tfm.init_lm(gen, cfg, keep)


def embed_inputs(ctx: ShardCtx, params, cfg: ArchConfig, batch):
    """(B, S, D) input embeddings in the compute dtype: the tokens'; for
    the VLM family the patches (B, P, D), cast to the compute dtype and
    multiplied by ``patch_proj`` in it, before them (S = P + the tokens)."""
    tfm.check_family(cfg)
    text = tfm.embed_tokens(ctx, params, cfg, batch["tokens"])
    if cfg.family != "vlm":
        return text
    dt = ctx.compute_dtype
    patches = torch.einsum("bpd,de->bpe", batch["patches"].to(dt), params["patch_proj"].to(dt))
    return torch.cat([patches, text], dim=1)


def seq_total(batch) -> int:
    """The positions a batch runs through the stack, and a prompt fills in
    the decode cache: its tokens, and a VLM batch's patches (B, P, D)
    before them."""
    return batch["tokens"].shape[1] + (batch["patches"].shape[1] if "patches" in batch else 0)


def _labels_local(cfg: ArchConfig, batch):
    """(labels, mask) of a token batch; the mask defaults to ones (f32).  The
    VLM family's patch positions carry zero labels under a zero f32 mask."""
    labels = batch["labels"]
    mask = batch.get("mask")
    if mask is None:
        mask = torch.ones(labels.shape, dtype=torch.float32, device=labels.device)
    if cfg.family == "vlm":
        b, dev = labels.shape[0], labels.device
        labels = torch.cat([torch.zeros((b, cfg.num_patches), dtype=labels.dtype, device=dev),
                            labels], dim=1)
        mask = torch.cat([torch.zeros((b, cfg.num_patches), dtype=torch.float32, device=dev),
                          mask.float()], dim=1)
    return labels, mask


def train_loss(ctx: ShardCtx, params, cfg: ArchConfig, run: RunConfig, batch,
               global_token_count: float):
    """Returns (loss, metrics): loss = local CE sum / global token count +
    the layers' summed MoE aux loss / the layer count, so that the ranks'
    gradients sum (or, n times, average) to the global batch's.  Both
    divisions are by f32 tensors on the device, true divisions as in the
    reference.  Metrics: ``ce_sum``, ``count``, ``aux`` (the layer sum; 0
    for the dense and SSM families).  The aux term is over all layers,
    also in the hybrid family, whose MoE FFNs are every ``every_n``-th.
    The encoder–decoder family's is :func:`encdec.train_loss`.  The VLM
    family's positions span patches and tokens; its patch positions count
    no loss, but the global count the caller passes is the reference's
    ``global_batch × seq_len``, patch positions included."""
    tfm.check_family(cfg)
    if cfg.family == "encdec":
        return encdec_lib.train_loss(ctx, params, cfg, run, batch, global_token_count)
    x = embed_inputs(ctx, params, cfg, batch)
    positions = torch.arange(x.shape[1], device=x.device)
    h, aux, _ = tfm.forward(ctx, params, cfg, run, x, positions)
    labels, mask = _labels_local(cfg, batch)
    ce_sum, cnt = tfm.vocab_parallel_ce(ctx, params, cfg, h, labels, mask)
    dev = ce_sum.device
    loss = (ce_sum / torch.tensor(global_token_count, dtype=torch.float32, device=dev)
            + aux / torch.tensor(max(1, cfg.num_layers), dtype=torch.float32, device=dev))
    return loss, {"ce_sum": ce_sum, "count": cnt, "aux": aux}


def make_cache(ctx: ShardCtx, cfg: ArchConfig, b_local: int, s_max: int,
               dtype=torch.bfloat16, device=None):
    """Zeroed decode cache {"k", "v"}: (L, B, s_max, Hkv, hd) each (the MoE
    and VLM families' attention cache is the dense family's).  The SSM family's
    (:func:`ssm_cache`) does not grow with ``s_max``; the hybrid's is
    {"attn": {"k", "v"} (periods, B, s_max, Hkv, hd), "ssm": the SSM cache
    of its periods × (period − 1) mixers}; the encoder–decoder's
    :func:`encdec.make_cache`."""
    tfm.check_family(cfg)
    if cfg.family == "encdec":
        return encdec_lib.make_cache(ctx, cfg, b_local, s_max, dtype, device)
    if cfg.family == "ssm":
        return ssm_cache(cfg, b_local, dtype, device)
    if cfg.family == "hybrid":
        per, np_, nm, _, _ = hybrid_layout(cfg)
        return {"attn": attn_cache(cfg, np_, b_local, s_max, dtype, device),
                "ssm": ssm_cache(cfg, b_local, dtype, device, layers=np_ * nm)}
    return attn_cache(cfg, cfg.num_layers, b_local, s_max, dtype, device)


def attn_cache(cfg: ArchConfig, layers: int, b_local: int, s_max: int, dtype=torch.bfloat16,
               device=None):
    """Zeroed attention cache {"k", "v"}: (layers, B, s_max, Hkv, hd) each,
    ``s_max`` cut to a sliding window's width."""
    if cfg.window is not None:
        s_max = min(s_max, cfg.window)
    shape = (layers, b_local, s_max, cfg.num_kv_heads, cfg.hd)
    dev = resolve_device(device)
    return {"k": torch.zeros(shape, dtype=dtype, device=dev),
            "v": torch.zeros(shape, dtype=dtype, device=dev)}


def ssm_cache(cfg: ArchConfig, b_local: int, dtype=torch.bfloat16, device=None,
              layers: Optional[int] = None):
    """Zeroed SSM decode cache, the reference's layout: the conv windows
    ``conv_x`` (L, B, W−1, d_inner), ``conv_B`` and ``conv_C`` (L, B, W−1,
    n) in ``dtype``; ``state`` (L, B, h, p, n) f32.  L is ``layers``, by
    default the config's layer count."""
    s, dev = cfg.ssm, resolve_device(device)
    L = cfg.num_layers if layers is None else layers
    w, gn = s.conv_width - 1, s.n_groups * s.d_state

    def zeros(*shape, dt=dtype):
        return torch.zeros(shape, dtype=dt, device=dev)

    return {"conv_x": zeros(L, b_local, w, s.d_inner(cfg.d_model)),
            "conv_B": zeros(L, b_local, w, gn), "conv_C": zeros(L, b_local, w, gn),
            "state": zeros(L, b_local, s.nheads(cfg.d_model), s.head_dim, s.d_state,
                           dt=torch.float32)}


def _ssm_decode_layer(ctx, cfg, p, x, cache, li: int):
    """norm → ``mamba_decode`` → residual, writing layer ``li``'s conv
    windows and state in place (the reference's
    ``dynamic_update_index_in_dim`` on the carry)."""
    h = common.rms_norm(x, p["norm1"])
    conv = {"x": cache["conv_x"][li], "B": cache["conv_B"][li], "C": cache["conv_C"][li]}
    out, (conv, st) = ssm_lib.mamba_decode(ctx, sub(p, "ssm"), h, cfg.ssm, conv,
                                           cache["state"][li])
    for k in ("x", "B", "C"):
        cache[f"conv_{k}"][li] = conv[k].to(cache[f"conv_{k}"].dtype)
    cache["state"][li] = st
    return x + out


def _attn_decode_layer(ctx, cfg, p, x, kcs, vcs, li: int, pos: int, dims):
    """Decode attention writing the new token's K/V slot of layer ``li`` in
    place (the reference's ``dynamic_update_slice`` on the carry, which
    aliases)."""
    h = common.rms_norm(x, p["norm1"])
    positions = torch.full((1,), pos, dtype=torch.int64, device=x.device)
    q, k, v = attn_lib.project_qkv(ctx, sub(p, "attn"), h, dims, cfg.qk_norm, positions,
                                   cfg.rope_theta)
    write = pos if cfg.window is None else pos % kcs.shape[2]
    kcs[li, :, write] = k[:, 0].to(kcs.dtype)
    vcs[li, :, write] = v[:, 0].to(vcs.dtype)
    # a window's ring buffer: every slot is valid once full
    valid = pos + 1 if cfg.window is None else min(pos + 1, kcs.shape[2])
    o = attn_lib.decode_attention(q, kcs[li], vcs[li], valid)
    return x + attn_lib.output_proj(ctx, sub(p, "attn"), o)


def _ffn_decode(ctx, cfg, p, x, kind: str):
    """norm → the gated MLP or :func:`moe_decode` (no capacity) → residual."""
    h = common.rms_norm(x, p["norm2"])
    if kind == "mlp":
        return x + mlp_lib.mlp(ctx, sub(p, "mlp"), h)
    return x + moe_lib.moe_decode(ctx, sub(p, "moe"), h, cfg.moe)


def decode_step(ctx: ShardCtx, params, cfg: ArchConfig, run: RunConfig, cache, tok, pos: int):
    """tok: (B, 1) ints; pos: the current length.  Returns (next_token
    (B, 1), logits (B, 1, V) f32, cache) — the cache updated in place."""
    tfm.check_family(cfg)
    if cfg.family == "encdec":
        return encdec_lib.decode_step(ctx, params, cfg, run, cache, tok, pos)
    dims = attn_lib.attn_dims(cfg.num_heads, cfg.num_kv_heads, cfg.hd, ctx.tp)
    x = tfm.embed_tokens(ctx, params, cfg, tok)
    if cfg.family == "hybrid":
        return _finish_decode(ctx, params, cfg,
                              _decode_hybrid(ctx, params, cfg, cache, x, pos, dims), cache)
    rows = tfm.unbind_layers(sub(params, "layers"))
    kind = tfm.ffn_kind(cfg)
    for li in range(cfg.num_layers):
        layer = tfm.take_layer(ctx, cfg, "layers", rows[li])
        if cfg.family == "ssm":
            x = _ssm_decode_layer(ctx, cfg, layer, x, cache, li)
            continue
        x = _attn_decode_layer(ctx, cfg, layer, x, cache["k"], cache["v"], li, pos, dims)
        x = _ffn_decode(ctx, cfg, layer, x, kind)
    return _finish_decode(ctx, params, cfg, x, cache)


def _finish_decode(ctx, params, cfg, x, cache):
    h = common.rms_norm(x, params["final_norm"])
    logits = tfm.lm_head_logits(ctx, params, cfg, h)
    return tfm.greedy_sample(ctx, logits), logits, cache


def _decode_hybrid(ctx, params, cfg, cache, x, pos: int, dims):
    """The hybrid's decode step over its periods (the reference's
    ``_decode_hybrid``): attention reads and writes period ``pi``'s K/V,
    mixer ``mi`` of period ``pi`` row ``pi·(period − 1) + mi`` of the SSM
    cache, both in place; then the position's MoE (``moe_decode``) or MLP
    FFN."""
    per, np_, nm, _, moe_at = hybrid_layout(cfg)
    a_cache, s_cache = cache["attn"], cache["ssm"]
    rows = {k: torch.unbind(v) for k, v in params.items() if k.startswith("periods.")}
    for pi in range(np_):
        mi = 0
        for i, p in enumerate(tfm.period_layers(rows, cfg, pi)):
            p = tfm.gather_sublayer(ctx, cfg, p)
            if i == cfg.attn_offset:
                x = _attn_decode_layer(ctx, cfg, p, x, a_cache["k"], a_cache["v"], pi, pos, dims)
            else:
                x = _ssm_decode_layer(ctx, cfg, p, x, s_cache, pi * nm + mi)
                mi += 1
            x = _ffn_decode(ctx, cfg, p, x, "moe" if i in moe_at else "mlp")
    return x


def prefill(ctx: ShardCtx, params, cfg: ArchConfig, run: RunConfig, batch,
            s_max: Optional[int] = None):
    """Run the prompt through the model; returns (cache, last-position logits
    (B, 1, V) f32).  The cache holds the prompt's K/V in bf16, zero-padded
    to ``s_max`` when given and never cut (the reference's ``pad_to``):
    max(S, s_max) slots, with a sliding window too, where :func:`make_cache`
    cuts to the window; the SSM family's the final conv windows in bf16 and
    states in f32, whatever ``s_max``; the hybrid's both
    (:func:`regroup_hybrid_caches`); the encoder–decoder's
    :func:`encdec.prefill` (``batch`` also carries ``frames``).  A VLM
    batch also carries ``patches``; its cache holds patches and tokens, so
    the first decode position is :func:`seq_total`."""
    if cfg.family == "encdec":
        return encdec_lib.prefill(ctx, params, cfg, run, batch, s_max)
    x = embed_inputs(ctx, params, cfg, batch)
    positions = torch.arange(x.shape[1], device=x.device)
    h, _, caches = tfm.forward(ctx, params, cfg, run, x, positions, want_cache=True)
    del x
    logits = tfm.lm_head_logits(ctx, params, cfg, h[:, -1:])
    if cfg.family == "ssm":
        conv, st = caches
        cache = {f"conv_{k}": conv[k].to(torch.bfloat16) for k in ("x", "B", "C")}
        cache["state"] = st
        return cache, logits
    if cfg.family == "hybrid":
        k, v, conv, st = regroup_hybrid_caches(caches, cfg)
    else:
        k, v = caches
    s = k.shape[2]
    # the zero cache of the config without its window: make_cache would cut
    # it to the window, the reference's pad_to never cuts
    cache = make_cache(ctx, dataclasses.replace(cfg, window=None), k.shape[1],
                       max(s, s_max or s), device=k.device)
    kv = cache["attn"] if cfg.family == "hybrid" else cache
    kv["k"][:, :, :s] = k
    kv["v"][:, :, :s] = v
    if cfg.family == "hybrid":
        for n in ("x", "B", "C"):
            cache["ssm"][f"conv_{n}"].copy_(conv[n])
        cache["ssm"]["state"].copy_(st)
    return cache, logits


def regroup_hybrid_caches(caches, cfg: ArchConfig):
    """The hybrid forward's caches (one entry a period position, each
    stacked over the periods) → (k, v) (periods, B, S, Hkv, hd) and the
    mixers' ({"x", "B", "C"} windows, states) with rows ``pi·(period − 1)
    + mi``: the reference's ``_regroup_hybrid_caches``."""
    k = v = None
    mixers = []
    for i, c in enumerate(caches):
        if i == cfg.attn_offset:
            k, v = c
        else:
            mixers.append(c)

    def pack(parts):
        arr = torch.stack(parts, dim=1)              # (periods, mixers, ...)
        return arr.reshape((-1,) + arr.shape[2:])

    conv = {n: pack([c[n] for c, _ in mixers]) for n in ("x", "B", "C")}
    return k, v, conv, pack([s for _, s in mixers])
