"""Decoder-only LM assembly, dense, VLM, MoE, SSM and hybrid families — port of
``repro.models.transformer`` at ``tp = 1``: init, embedding, the tied or
untied LM head, the cross-entropy over it, greedy sampling, the attention
and FFN sublayers (the gated MLP, or the MoE block with its aux loss), the
SSM family's norm → Mamba-2 block → residual, the hybrid family's periods
(:func:`_forward_hybrid`), and the forward over the stacked layers (a
Python loop where the reference scans).

Each stack of layer leaves is split into its rows once a forward
(:func:`unbind_layers`), and every layer's rows go through
:func:`~repro_torch.models.common.gather_fsdp` (:func:`take_layer`): cast
to the compute dtype, and gathered whole where this process holds only its
FSDP shards, as the reference's ``gather_fsdp``; the embedding and the
final norm are not.  With a gradient to compute, ``run.remat`` recomputes each layer
in the backward (``torch.utils.checkpoint``, non-reentrant, around the
layer body as ``jax.checkpoint(body)``; the hybrid's around a whole
period) and ``run.remat_attention`` the attention call.  The
encoder–decoder family's init, forward and decode are
:mod:`repro_torch.models.encdec`'s, on this module's embedding, head,
cross-entropy and sampling.  The VLM family is the dense stack with a
``patch_proj`` leaf (:func:`repro_torch.models.model.embed_inputs`
prepends the projected patches to the tokens).
"""
from __future__ import annotations

import functools
from typing import Any, Dict, List, Optional, Tuple

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.configs.base import ArchConfig, RunConfig
from repro_torch.configs.registry import hybrid_layout, param_shapes
from repro_torch.core.wire.base import NotPortedError
from repro_torch.kernels.flash_attention import ops as fa_ops
from repro_torch.models import attention as attn_lib
from repro_torch.models import common
from repro_torch.models import mlp as mlp_lib
from repro_torch.models import moe as moe_lib
from repro_torch.models import ssm as ssm_lib
from repro_torch.models.common import ShardCtx


def sub(p: Dict[str, Any], prefix: str) -> Dict[str, Any]:
    pl = len(prefix) + 1
    return {k[pl:]: v for k, v in p.items() if k.startswith(prefix + ".")}


def unbind_layers(p: Dict[str, torch.Tensor]) -> List[Dict[str, torch.Tensor]]:
    """The rows of stacked (L, ...) leaves, one dict a layer: one
    ``torch.unbind`` per leaf.  The rows are views; the backward stacks
    their gradients once a leaf, where indexing layer i would write a
    zero-filled (L, ...) gradient at every layer."""
    cols = {k: torch.unbind(v) for k, v in p.items()}
    n = len(next(iter(cols.values()))) if cols else 0
    return [{k: c[i] for k, c in cols.items()} for i in range(n)]


@functools.lru_cache(maxsize=None)
def layer_specs(cfg: ArchConfig, fsdp_axis: str) -> Dict[str, tuple]:
    """Every leaf's spec under FSDP over ``fsdp_axis`` with its stack dim
    stripped, by full name (``param_shapes(cfg, fsdp=fsdp_axis)``)."""
    return {k: v[1:] for k, v in param_shapes(cfg, fsdp=fsdp_axis)[1].items()}


def take_layer(ctx: ShardCtx, cfg: ArchConfig, prefix: str,
               row: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """One layer's rows of the ``prefix`` stacks (an entry of
    :func:`unbind_layers`) through ``gather_fsdp``: in the compute dtype,
    the FSDP leaves gathered where this process holds shards."""
    specs = layer_specs(cfg, ctx.fsdp_axis)
    return common.gather_fsdp(row, {k: specs[f"{prefix}.{k}"] for k in row}, ctx)


FAMILIES = ("dense", "vlm", "moe", "ssm", "hybrid", "encdec")


def check_family(cfg: ArchConfig) -> None:
    if cfg.family not in FAMILIES:
        raise NotPortedError(
            f"the {cfg.family!r} family is not ported yet: the port runs the "
            f"{', '.join(FAMILIES[:-1])} and {FAMILIES[-1]} families (ROADMAP.md, queue 1)")


def ffn_kind(cfg: ArchConfig) -> str:
    return "moe" if cfg.family == "moe" else "mlp"


def init_lm(gen: torch.Generator, cfg: ArchConfig, keep=None) -> Dict[str, torch.Tensor]:
    """The f32 parameters on ``gen``'s device, drawn from ``gen``: the names
    and shapes of ``configs.registry.param_shapes`` and the reference's
    scales, leaf by leaf in its order; ``keep`` as in
    :class:`~repro_torch.models.common.ParamBuilder`."""
    check_family(cfg)
    pb = common.ParamBuilder(gen, keep)
    d = cfg.d_model
    dims = attn_lib.attn_dims(cfg.num_heads, cfg.num_kv_heads, cfg.hd, 1)
    pb.add("embed", (cfg.vocab_padded(1), d), scale=0.02)
    if not cfg.tie_embeddings:
        pb.add("lm_head", (cfg.vocab_padded(1), d), scale=d ** -0.5)
    pb.ones("final_norm", (d,))
    L = cfg.num_layers
    if cfg.family == "hybrid":
        per, np_, nm, n_moe, _ = hybrid_layout(cfg)
        attn_lib.init_attention(pb, "periods.attn", np_, d, dims, cfg.qk_norm)
        ssm_lib.init_ssm(pb, "periods.ssm", np_ * nm, d, cfg.ssm)
        moe_lib.init_moe(pb, "periods.moe", np_ * n_moe, d, cfg.moe)
        mlp_lib.init_mlp(pb, "periods.mlp", np_ * (per - n_moe), d, cfg.d_ff)
        pb.ones("periods.norm1", (L, d))
        pb.ones("periods.norm2", (L, d))
        return pb.params
    if cfg.family == "ssm":
        ssm_lib.init_ssm(pb, "layers.ssm", L, d, cfg.ssm)
        pb.ones("layers.norm1", (L, d))
        return pb.params
    attn_lib.init_attention(pb, "layers.attn", L, d, dims, cfg.qk_norm)
    if cfg.family == "moe":
        moe_lib.init_moe(pb, "layers.moe", L, d, cfg.moe)
    else:
        mlp_lib.init_mlp(pb, "layers.mlp", L, d, cfg.d_ff)
    pb.ones("layers.norm1", (L, d))
    pb.ones("layers.norm2", (L, d))
    if cfg.family == "vlm":
        pb.add("patch_proj", (d, d), scale=d ** -0.5)
    return pb.params


def _needs_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def embed_tokens(ctx: ShardCtx, params, cfg: ArchConfig, tokens):
    """tokens (B, S) → (B, S, D) embeddings in the compute dtype."""
    return params["embed"][tokens.long()].to(ctx.compute_dtype)


def lm_head_logits(ctx: ShardCtx, params, cfg: ArchConfig, h):
    """h: (B, T, D) → logits (B, T, V) f32 (products of compute-dtype
    inputs summed in f32)."""
    w = params["lm_head"] if not cfg.tie_embeddings else params["embed"]
    return torch.einsum("btd,vd->btv", h.float(), w.to(ctx.compute_dtype).float())


def vocab_parallel_ce(ctx: ShardCtx, params, cfg: ArchConfig, h, labels, mask,
                      chunk: int = 512):
    """Cross-entropy over the head at ``tp = 1``, in sequence chunks.

    h: (B, S, D) final hidden states; labels, mask: (B, S).  Returns (CE
    sum f32, token count f32).  Each chunk of ``chunk`` positions (all of
    the batch) takes f32 logits of the compute-dtype inputs (B, chunk, V)
    against the whole vocab, never (B, S, V) at once; the row max is a
    shift under ``detach`` (the reference's ``stop_gradient``)."""
    w = params["lm_head"] if not cfg.tie_embeddings else params["embed"]
    wf = w.to(ctx.compute_dtype).float()
    common.check_no_tf32(wf, "the f32 LM head")
    v = w.shape[0]
    s = h.shape[1]
    chunk = min(chunk, s)
    if s % chunk:
        raise ValueError(f"sequence length {s} must be a multiple of the chunk {chunk}")
    sums, cnts = [], []
    for c in range(s // chunk):
        sl = slice(c * chunk, (c + 1) * chunk)
        logits = torch.matmul(h[:, sl].float(), wf.t())                # (B, chunk, V)
        lmax = logits.amax(-1).detach()
        lse = torch.log(torch.sum(torch.exp(logits - lmax[..., None]), -1)) + lmax
        y = labels[:, sl].long()
        ok = (y >= 0) & (y < v)
        tgt = torch.gather(logits, -1, y.clamp(0, v - 1)[..., None])[..., 0]
        m = mask[:, sl].float()
        tok_loss = (lse - torch.where(ok, tgt, 0.0)) * m
        sums.append(tok_loss.sum())
        cnts.append(m.sum())
    return torch.stack(sums).sum(), torch.stack(cnts).sum()


def greedy_sample(ctx: ShardCtx, logits):
    """(B, 1, V) → (B, 1) int64: the first index among ties, as
    ``jnp.argmax``."""
    return torch.argmax(logits, dim=-1)


def _attn_sublayer(ctx, cfg: ArchConfig, run: RunConfig, p, x, positions, dims):
    """norm → attention → residual.  Returns (x, (k, v) for the cache)."""
    h = common.rms_norm(x, p["norm1"])
    q, k, v = attn_lib.project_qkv(ctx, sub(p, "attn"), h, dims, cfg.qk_norm, positions,
                                   cfg.rope_theta)
    if run.attn_impl == "flash":
        attn_fn = functools.partial(fa_ops.flash_attention, causal=True, window=cfg.window,
                                    block_q=run.attn_chunk_q, block_k=run.attn_chunk_k)
    elif run.attn_impl == "xla":
        attn_fn = functools.partial(attn_lib.chunked_attention, causal=True, window=cfg.window,
                                    chunk_q=run.attn_chunk_q, chunk_k=run.attn_chunk_k)
    else:
        raise ValueError(f"attn_impl must be 'flash' or 'xla', got {run.attn_impl!r}")
    if run.remat_attention and _needs_grad(q, k, v):
        o = checkpoint(attn_fn, q, k, v, use_reentrant=False)
    else:
        o = attn_fn(q, k, v)
    o = attn_lib.output_proj(ctx, sub(p, "attn"), o)
    return x + o, (k, v)


def _ffn_sublayer(ctx, cfg, run, p, x, kind: str):
    """norm → the gated MLP (``kind`` "mlp") or the MoE block ("moe") →
    residual.  Returns (x, the aux loss: 0.0 for the MLP)."""
    h = common.rms_norm(x, p["norm2"])
    if kind == "mlp":
        return x + mlp_lib.mlp(ctx, sub(p, "mlp"), h), 0.0
    out, aux = moe_lib.moe_block(ctx, sub(p, "moe"), h, cfg.moe)
    return x + out, aux


def forward(ctx: ShardCtx, params, cfg: ArchConfig, run: RunConfig, x, positions,
            want_cache: bool = False
            ) -> Tuple[torch.Tensor, torch.Tensor, Optional[Tuple]]:
    """Run all blocks.  x: (B, S, D).  Returns (final-normed h, aux, caches):
    aux is the f32 sum of the layers' MoE aux losses (0 for the dense and
    SSM families), caches when ``want_cache`` (else None) the stacked (L,
    B, S, Hkv, hd) k and v in the compute dtype, or for the SSM family
    ({"x", "B", "C"} conv windows (L, B, W−1, C) in the compute dtype, the
    final states (L, B, h, p, n) f32), or for the hybrid family one entry a
    period position, each stacked over the periods (:func:`_forward_hybrid`)."""
    check_family(cfg)
    if cfg.family == "ssm":
        return _forward_ssm(ctx, params, cfg, run, x, want_cache)
    if cfg.family == "hybrid":
        return _forward_hybrid(ctx, params, cfg, run, x, positions, want_cache)
    dims = attn_lib.attn_dims(cfg.num_heads, cfg.num_kv_heads, cfg.hd, ctx.tp)
    lp = sub(params, "layers")
    rows = unbind_layers(lp)
    kind = ffn_kind(cfg)

    def body(x, i: int):
        layer = take_layer(ctx, cfg, "layers", rows[i])
        x, kv = _attn_sublayer(ctx, cfg, run, layer, x, positions, dims)
        x, a = _ffn_sublayer(ctx, cfg, run, layer, x, kind)
        return x, a, kv

    remat = run.remat and _needs_grad(x, *lp.values())
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    ks: List[torch.Tensor] = []
    vs: List[torch.Tensor] = []
    for i in range(cfg.num_layers):
        if remat:
            x, a, (k, v) = checkpoint(body, x, i, use_reentrant=False)
        else:
            x, a, (k, v) = body(x, i)
        aux = aux + a
        if want_cache:
            ks.append(k)
            vs.append(v)
    caches = (torch.stack(ks), torch.stack(vs)) if want_cache else None
    return common.rms_norm(x, params["final_norm"]), aux, caches


def _forward_ssm(ctx: ShardCtx, params, cfg: ArchConfig, run: RunConfig, x, want_cache: bool):
    """The SSM family's forward: per layer norm1 → ``mamba_block`` →
    residual, remat per layer as the other families'."""
    lp = sub(params, "layers")
    rows = unbind_layers(lp)

    def body(x, i: int):
        layer = take_layer(ctx, cfg, "layers", rows[i])
        h = common.rms_norm(x, layer["norm1"])
        if want_cache:
            out, st = ssm_lib.mamba_block(ctx, sub(layer, "ssm"), h, cfg.ssm, return_state=True)
            return x + out, st
        return x + ssm_lib.mamba_block(ctx, sub(layer, "ssm"), h, cfg.ssm), None

    remat = run.remat and _needs_grad(x, *lp.values())
    states = []
    for i in range(cfg.num_layers):
        x, st = checkpoint(body, x, i, use_reentrant=False) if remat else body(x, i)
        states.append(st)
    caches = None
    if want_cache:
        conv = {k: torch.stack([c[k] for c, _ in states]) for k in ("x", "B", "C")}
        caches = (conv, torch.stack([f for _, f in states]))
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    return common.rms_norm(x, params["final_norm"]), aux, caches


def period_layers(params, cfg: ArchConfig, pi: int):
    """Period ``pi``'s sublayers of the hybrid's ``periods.*`` leaves (the
    stacks, or each stack's rows as ``torch.unbind`` gives them), one dict
    a position, as stored: ``norm1`` and ``norm2``, then ``attn.*`` at
    ``attn_offset``, ``ssm.*`` elsewhere, ``moe.*`` or ``mlp.*`` by the
    position's FFN (:func:`gather_sublayer` readies them).  Row ``pi·n +
    j`` of a stack of n sublayers a period is the j-th of period ``pi``:
    the reference's ``reshape_stack``."""
    per, _, nm, n_moe, moe_at = hybrid_layout(cfg)
    pp = sub(params, "periods")
    groups = {g: sub(pp, g) for g in ("attn", "ssm", "moe", "mlp")}

    def row(group, j):
        return {f"{group}.{k}": v[j] for k, v in groups[group].items()}

    out = []
    mi = fi_moe = fi_mlp = 0
    for i in range(per):
        p = {"norm1": pp["norm1"][pi * per + i], "norm2": pp["norm2"][pi * per + i]}
        if i == cfg.attn_offset:
            p.update(row("attn", pi))
        else:
            p.update(row("ssm", pi * nm + mi))
            mi += 1
        if i in moe_at:
            p.update(row("moe", pi * n_moe + fi_moe))
            fi_moe += 1
        else:
            p.update(row("mlp", pi * (per - n_moe) + fi_mlp))
            fi_mlp += 1
        out.append(p)
    return out


def gather_sublayer(ctx: ShardCtx, cfg: ArchConfig, p: Dict[str, torch.Tensor]):
    """One hybrid position of :func:`period_layers` through ``gather_fsdp``,
    its two norms left f32 as the reference takes them outside it."""
    rest = {k: v for k, v in p.items() if k not in ("norm1", "norm2")}
    return {"norm1": p["norm1"], "norm2": p["norm2"],
            **take_layer(ctx, cfg, "periods", rest)}


def _forward_hybrid(ctx: ShardCtx, params, cfg: ArchConfig, run: RunConfig, x, positions,
                    want_cache: bool):
    """The hybrid family's forward (the reference's ``_forward_hybrid``):
    each period's positions in turn, attention (norm1 → attention →
    residual) at ``attn_offset`` and norm1 → ``mamba_block`` → residual
    elsewhere, then norm2 → the MoE block or the gated MLP → residual.  aux
    sums the MoE sublayers' aux losses.  Remat wraps one whole period, as
    ``jax.checkpoint(body)`` over the reference's period scan.  With
    ``want_cache`` the caches are a tuple over the period's positions, each
    stacked over the periods: (k, v) (periods, B, S, Hkv, hd) at
    ``attn_offset``, ({"x", "B", "C"} conv windows, final states) with a
    leading periods axis elsewhere."""
    per, np_, _, _, moe_at = hybrid_layout(cfg)
    dims = attn_lib.attn_dims(cfg.num_heads, cfg.num_kv_heads, cfg.hd, ctx.tp)

    rows = {k: torch.unbind(v) for k, v in params.items() if k.startswith("periods.")}

    def body(x, aux, pi: int):
        slots = []
        for i, p in enumerate(period_layers(rows, cfg, pi)):
            p = gather_sublayer(ctx, cfg, p)
            if i == cfg.attn_offset:
                x, kv = _attn_sublayer(ctx, cfg, run, p, x, positions, dims)
                slots.append(kv)
            else:
                h = common.rms_norm(x, p["norm1"])
                if want_cache:
                    out, st = ssm_lib.mamba_block(ctx, sub(p, "ssm"), h, cfg.ssm,
                                                  return_state=True)
                else:
                    out, st = ssm_lib.mamba_block(ctx, sub(p, "ssm"), h, cfg.ssm), None
                x = x + out
                slots.append(st)
            x, a = _ffn_sublayer(ctx, cfg, run, p, x, "moe" if i in moe_at else "mlp")
            aux = aux + a
        return x, aux, tuple(slots) if want_cache else None

    remat = run.remat and _needs_grad(x, *params.values())
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    per_period = []
    for pi in range(np_):
        x, aux, slots = (checkpoint(body, x, aux, pi, use_reentrant=False) if remat
                         else body(x, aux, pi))
        per_period.append(slots)
    caches = None
    if want_cache:
        caches = []
        for i in range(per):
            got = [slots[i] for slots in per_period]
            if i == cfg.attn_offset:
                caches.append((torch.stack([k for k, _ in got]), torch.stack([v for _, v in got])))
            else:
                conv = {k: torch.stack([c[k] for c, _ in got]) for k in ("x", "B", "C")}
                caches.append((conv, torch.stack([s for _, s in got])))
        caches = tuple(caches)
    return common.rms_norm(x, params["final_norm"]), aux, caches
