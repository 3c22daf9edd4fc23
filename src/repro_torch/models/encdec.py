"""Whisper-style encoder–decoder backbone — port of ``repro.models.encdec``
at ``tp = 1``.

The conv/mel frontend is a stub, as in the reference: a batch carries
frame embeddings ``frames`` (B, S_enc, D), f32.  The backbone: a
bidirectional encoder (norm → attention → residual, norm → GELU MLP →
residual, a final norm), then a causal decoder whose layers add a
cross-attention over the encoder output between the self-attention and the
GELU MLP.  Both take sinusoidal positions (the decoder's at any offset, so
decode caches longer than whisper's learned 448 positions are defined);
there is no RoPE and no qk-norm, and the norms are RMSNorm, as the
reference's.

Every attention call is the plain chunked online softmax
(:func:`repro_torch.models.attention.chunked_attention`, or
:func:`~repro_torch.models.attention.decode_attention` in the decode step),
whatever ``run.attn_impl`` says: the reference calls ``chunked_attention``
directly here, so this family reaches no flash kernel.  The encoder's
chunk is ``min(768, S_enc)``; the decoder's ``min(run.attn_chunk_q/k,
S_dec)``; the cross-attention's key chunk ``min(768, S_enc)``.  A length
that is not a multiple of its chunk raises (no padding).

Each layer's weights, its norms included, go through ``gather_fsdp``
(``transformer.take_layer``): cast to the compute dtype, FSDP leaves
gathered where this process holds shards; with a gradient to compute,
``run.remat`` recomputes each encoder and decoder layer in the backward.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch import resolve_device
from repro_torch.configs.base import ArchConfig, RunConfig
from repro_torch.models import attention as attn_lib
from repro_torch.models import common
from repro_torch.models import mlp as mlp_lib
from repro_torch.models import transformer as tfm
from repro_torch.models.common import ShardCtx
from repro_torch.models.transformer import sub

ENC_CHUNK = 768


def enc_seq_padded(cfg: ArchConfig, tp: int) -> int:
    """``cfg.encoder_seq`` rounded up to a multiple of max(96, 32·tp): the
    data pipeline pads frames with tp = 16 (1500 → 1536; the smoke config's
    24 → 512), the decode cache with the context's tp (1536; 96)."""
    base = max(96, tp * 32)
    return -(-cfg.encoder_seq // base) * base


def init_encdec(gen: torch.Generator, cfg: ArchConfig, keep=None) -> Dict[str, torch.Tensor]:
    """The f32 parameters on ``gen``'s device, drawn from ``gen``: the names
    and shapes of ``configs.registry.param_shapes`` and the reference's
    scales, leaf by leaf in ``init_encdec``'s order; ``keep`` as in
    :class:`~repro_torch.models.common.ParamBuilder`."""
    pb = common.ParamBuilder(gen, keep)
    d = cfg.d_model
    dims = attn_lib.attn_dims(cfg.num_heads, cfg.num_kv_heads, cfg.hd, 1)
    pb.add("embed", (cfg.vocab_padded(1), d), scale=0.02)
    if not cfg.tie_embeddings:
        pb.add("lm_head", (cfg.vocab_padded(1), d), scale=d ** -0.5)
    pb.ones("final_norm", (d,))
    pb.ones("enc_final_norm", (d,))
    le, ld = cfg.encoder_layers, cfg.num_layers
    attn_lib.init_attention(pb, "enc.attn", le, d, dims, False)
    mlp_lib.init_mlp(pb, "enc.mlp", le, d, cfg.d_ff, gated=False)
    pb.ones("enc.norm1", (le, d))
    pb.ones("enc.norm2", (le, d))
    attn_lib.init_attention(pb, "dec.attn", ld, d, dims, False)
    attn_lib.init_attention(pb, "dec.xattn", ld, d, dims, False)
    mlp_lib.init_mlp(pb, "dec.mlp", ld, d, cfg.d_ff, gated=False)
    for i in (1, 2, 3):
        pb.ones(f"dec.norm{i}", (ld, d))
    return pb.params


def encode(ctx: ShardCtx, params, cfg: ArchConfig, run: RunConfig, frames):
    """frames (B, S_enc, D) → the encoder output (B, S_enc, D) in the
    compute dtype: the frames cast to it plus the sinusoids cast to it,
    then the bidirectional layers and the final norm."""
    dims = attn_lib.attn_dims(cfg.num_heads, cfg.num_kv_heads, cfg.hd, ctx.tp)
    cd = ctx.compute_dtype
    s = frames.shape[1]
    x = frames.to(cd) + common.sinusoidal_positions(s, cfg.d_model,
                                                    device=frames.device)[None].to(cd)
    lp = sub(params, "enc")
    rows = tfm.unbind_layers(lp)
    chunk = min(ENC_CHUNK, s)

    def body(x, i: int):
        layer = tfm.take_layer(ctx, cfg, "enc", rows[i])
        h = common.rms_norm(x, layer["norm1"])
        q, k, v = attn_lib.project_qkv(ctx, sub(layer, "attn"), h, dims, False, None, None)
        o = attn_lib.chunked_attention(q, k, v, causal=False, chunk_q=chunk, chunk_k=chunk)
        x = x + attn_lib.output_proj(ctx, sub(layer, "attn"), o)
        h2 = common.rms_norm(x, layer["norm2"])
        return x + mlp_lib.mlp(ctx, sub(layer, "mlp"), h2, gated=False)

    remat = run.remat and tfm._needs_grad(x, *lp.values())
    for i in range(cfg.encoder_layers):
        x = checkpoint(body, x, i, use_reentrant=False) if remat else body(x, i)
    return common.rms_norm(x, params["enc_final_norm"])


def _decoder_forward(ctx: ShardCtx, params, cfg: ArchConfig, run: RunConfig, x, enc,
                     want_cache: bool):
    """The decoder layers over x (B, S_dec, D) against the encoder output
    ``enc`` (B, S_enc, D).  Returns (the final-normed h, caches): with
    ``want_cache`` the stacked (L, B, S, Hkv, hd) self-attention k and v
    and cross-attention kx and vx (S_enc long) in the compute dtype, else
    None."""
    dims = attn_lib.attn_dims(cfg.num_heads, cfg.num_kv_heads, cfg.hd, ctx.tp)
    lp = sub(params, "dec")
    rows = tfm.unbind_layers(lp)
    s_dec = x.shape[1]
    chunk_q, chunk_k = min(run.attn_chunk_q, s_dec), min(run.attn_chunk_k, s_dec)
    chunk_x = min(ENC_CHUNK, enc.shape[1])

    def body(x, enc, i: int):
        layer = tfm.take_layer(ctx, cfg, "dec", rows[i])
        h = common.rms_norm(x, layer["norm1"])
        q, k, v = attn_lib.project_qkv(ctx, sub(layer, "attn"), h, dims, False, None, None)
        o = attn_lib.chunked_attention(q, k, v, causal=True, chunk_q=chunk_q, chunk_k=chunk_k)
        x = x + attn_lib.output_proj(ctx, sub(layer, "attn"), o)
        h2 = common.rms_norm(x, layer["norm2"])
        qx = torch.einsum("bsd,dhk->bshk", h2, layer["xattn.wq"])
        kx = torch.einsum("bsd,dhk->bshk", enc, layer["xattn.wk"])
        vx = torch.einsum("bsd,dhk->bshk", enc, layer["xattn.wv"])
        ox = attn_lib.chunked_attention(qx, kx, vx, causal=False, chunk_q=chunk_q,
                                        chunk_k=chunk_x)
        x = x + torch.einsum("bshk,hkd->bsd", ox, layer["xattn.wo"])
        h3 = common.rms_norm(x, layer["norm3"])
        x = x + mlp_lib.mlp(ctx, sub(layer, "mlp"), h3, gated=False)
        return x, ((k, v, kx, vx) if want_cache else None)

    remat = run.remat and tfm._needs_grad(x, enc, *lp.values())
    caches = []
    for i in range(cfg.num_layers):
        x, c = checkpoint(body, x, enc, i, use_reentrant=False) if remat else body(x, enc, i)
        caches.append(c)
    stacked = tuple(torch.stack(t) for t in zip(*caches)) if want_cache else None
    return common.rms_norm(x, params["final_norm"]), stacked


def embed_decoder(ctx: ShardCtx, params, cfg: ArchConfig, tokens):
    """Token embeddings plus the sinusoids of positions 0 … S − 1, both in
    the compute dtype."""
    x = tfm.embed_tokens(ctx, params, cfg, tokens)
    pos = common.sinusoidal_positions(tokens.shape[1], cfg.d_model, device=x.device)
    return x + pos[None].to(x.dtype)


def train_loss(ctx: ShardCtx, params, cfg: ArchConfig, run: RunConfig, batch,
               global_token_count: float):
    """Returns (loss, metrics): the local CE sum of the decoder's
    predictions over the global token count (a true division by an f32
    tensor), and ``ce_sum``, ``count`` and ``aux`` (0: no MoE)."""
    enc = encode(ctx, params, cfg, run, batch["frames"])
    x = embed_decoder(ctx, params, cfg, batch["tokens"])
    h, _ = _decoder_forward(ctx, params, cfg, run, x, enc, False)
    labels = batch["labels"]
    mask = batch.get("mask")
    if mask is None:
        mask = torch.ones(labels.shape, dtype=torch.float32, device=labels.device)
    ce_sum, cnt = tfm.vocab_parallel_ce(ctx, params, cfg, h, labels, mask)
    dev = ce_sum.device
    loss = ce_sum / torch.tensor(global_token_count, dtype=torch.float32, device=dev)
    return loss, {"ce_sum": ce_sum, "count": cnt,
                  "aux": torch.zeros((), dtype=torch.float32, device=dev)}


def make_cache(ctx: ShardCtx, cfg: ArchConfig, b_local: int, s_max: int,
               dtype=torch.bfloat16, device=None):
    """Zeroed decode cache: the self-attention {"k", "v"} (L, B, s_max, Hkv,
    hd) and the cross-attention {"xk", "xv"} (L, B, S_enc, Hkv, hd), S_enc
    = ``enc_seq_padded(cfg, ctx.tp)``."""
    dev = resolve_device(device)
    L, kv, hd = cfg.num_layers, cfg.num_kv_heads, cfg.hd
    s_enc = enc_seq_padded(cfg, ctx.tp)

    def zeros(s):
        return torch.zeros((L, b_local, s, kv, hd), dtype=dtype, device=dev)

    return {"k": zeros(s_max), "v": zeros(s_max), "xk": zeros(s_enc), "xv": zeros(s_enc)}


def prefill(ctx: ShardCtx, params, cfg: ArchConfig, run: RunConfig, batch,
            s_max: Optional[int] = None):
    """Encode the frames, run the prompt through the decoder; returns
    (cache, last-position logits (B, 1, V) f32).  Every cache in bf16: the
    self K/V zero-padded along the sequence to ``s_max`` when given, the
    cross K/V as long as the frames given (the reference's)."""
    enc = encode(ctx, params, cfg, run, batch["frames"])
    x = embed_decoder(ctx, params, cfg, batch["tokens"])
    h, (k, v, xk, xv) = _decoder_forward(ctx, params, cfg, run, x, enc, True)
    del enc, x
    logits = tfm.lm_head_logits(ctx, params, cfg, h[:, -1:])
    s = k.shape[2]
    shape = list(k.shape)
    shape[2] = max(s, s_max or s)
    cache = {}
    for name, t in (("k", k), ("v", v)):
        cache[name] = torch.zeros(shape, dtype=torch.bfloat16, device=t.device)
        cache[name][:, :, :s] = t
    cache["xk"] = xk.to(torch.bfloat16)
    cache["xv"] = xv.to(torch.bfloat16)
    return cache, logits


def decode_step(ctx: ShardCtx, params, cfg: ArchConfig, run: RunConfig, cache, tok, pos: int):
    """tok: (B, 1) ints; pos: the current length.  Returns (next_token
    (B, 1), logits (B, 1, V) f32, cache): each layer writes its new K/V
    slot ``pos`` in place and attends to slots 0 … pos, then to all of its
    cross K/V."""
    dims = attn_lib.attn_dims(cfg.num_heads, cfg.num_kv_heads, cfg.hd, ctx.tp)
    x = tfm.embed_tokens(ctx, params, cfg, tok)
    pos_emb = common.sinusoidal_positions(1, cfg.d_model, offset=pos, device=x.device)
    x = x + pos_emb[None].to(x.dtype)
    rows = tfm.unbind_layers(sub(params, "dec"))
    kcs, vcs = cache["k"], cache["v"]
    for li in range(cfg.num_layers):
        layer = tfm.take_layer(ctx, cfg, "dec", rows[li])
        h = common.rms_norm(x, layer["norm1"])
        q, k, v = attn_lib.project_qkv(ctx, sub(layer, "attn"), h, dims, False, None, None)
        kcs[li, :, pos] = k[:, 0].to(kcs.dtype)
        vcs[li, :, pos] = v[:, 0].to(vcs.dtype)
        o = attn_lib.decode_attention(q, kcs[li], vcs[li], pos + 1)
        x = x + attn_lib.output_proj(ctx, sub(layer, "attn"), o)
        h2 = common.rms_norm(x, layer["norm2"])
        qx = torch.einsum("bsd,dhk->bshk", h2, layer["xattn.wq"])
        xk = cache["xk"][li]
        ox = attn_lib.decode_attention(qx, xk, cache["xv"][li], xk.shape[1])
        x = x + torch.einsum("bshk,hkd->bsd", ox, layer["xattn.wo"])
        h3 = common.rms_norm(x, layer["norm3"])
        x = x + mlp_lib.mlp(ctx, sub(layer, "mlp"), h3, gated=False)
    h = common.rms_norm(x, params["final_norm"])
    logits = tfm.lm_head_logits(ctx, params, cfg, h)
    return tfm.greedy_sample(ctx, logits), logits, cache
