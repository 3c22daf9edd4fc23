"""Mixture-of-Experts at ``tp = 1`` — port of ``repro.models.moe``.

The reference shards experts over its model axis and ships capacity slots
between shards with two ``all_to_all``; at ``tp = 1`` both are identities,
every expert is local, and ``padded(1)`` is the routed expert count, so no
expert is inert.  The port keeps the reference's computation step for
step:

* routing in f32 (:func:`route`): router logits, softmax, top-k with ties
  to the lower index (``jax.lax.top_k``: a stable descending sort, sliced),
  gates renormalized over the k choices;
* the Switch aux loss on each token's first choice;
* capacity slots (:func:`capacity_slots`): the token-major count of earlier
  (token, choice) pairs sent to the same expert; pairs past
  ``cap = int(capacity_factor · t · k / E)`` are dropped;
* dispatch into ``(E, cap, d)``, three batched expert products in the
  compute dtype (plain ``torch.bmm``: the reference leaves them to XLA
  outside any kernel), the gate-weighted combine, and the shared MLP.

The backward is reproducible on the card (the train step's two issue
schedules are held bit for bit): the dispatch writes each (expert, slot)
once, dropped pairs going to one spare row that is cut off, so its
gradient is a gather; a token's k copies come from an ``expand`` whose
gradient is a sum over a (t, k, d) view, not atomics over repeated token
indices; the combine's gather collides only on dropped pairs, whose
contributions are exact zeros.

:func:`moe_decode` runs every expert densely on the decode tokens, weighted
by the gate matrix, as the reference's decode does: no capacity, so a
token's decode output is the forward's only when the forward dropped none
of its pairs.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.models import common
from repro_torch.models import mlp as mlp_lib


@dataclasses.dataclass(frozen=True)
class MoECfg:
    """The reference's ``MoECfg``, field for field."""

    num_experts: int          # routed experts (pre-padding)
    top_k: int
    d_ff_expert: int
    num_shared: int = 0       # shared-expert copies (qwen2-moe: 4 → one MLP
    d_ff_shared: int = 0      # with d_ff_shared = 4·1408 = 5632)
    capacity_factor: float = 1.25
    every_n: int = 1          # MoE layer cadence (jamba: 2)
    router_aux_weight: float = 0.01

    def padded(self, tp: int) -> int:
        return common.ceil_to(self.num_experts, tp)


def init_moe(pb: common.ParamBuilder, prefix: str, layers: int, d_model: int,
             cfg: MoECfg, tp: int = 1) -> None:
    """The reference's leaves, in its order and at its scales."""
    ep = cfg.padded(tp)
    pb.add(f"{prefix}.router", (layers, d_model, ep), scale=0.02)
    pb.add(f"{prefix}.w_up", (layers, ep, d_model, cfg.d_ff_expert))
    pb.add(f"{prefix}.w_gate", (layers, ep, d_model, cfg.d_ff_expert))
    pb.add(f"{prefix}.w_down", (layers, ep, cfg.d_ff_expert, d_model),
           scale=cfg.d_ff_expert ** -0.5)
    if cfg.num_shared:
        mlp_lib.init_mlp(pb, f"{prefix}.shared", layers, d_model, cfg.d_ff_shared)


def route(router, x, cfg: MoECfg):
    """x: (t, d) → (probs (t, E) f32, gates (t, k) f32, expert ids (t, k)
    int64).  The logits are full f32 products (TF32 off on the card: a
    TF32 router reroutes tokens); among equal probabilities the lower
    expert index comes first, as ``jax.lax.top_k`` orders them."""
    w = router.float()
    common.check_no_tf32(w, "the f32 router")
    probs = torch.softmax(x.float() @ w, dim=-1)
    vals, ids = torch.sort(probs, dim=-1, descending=True, stable=True)
    gates = vals[:, :cfg.top_k]
    gates = gates / torch.clamp(gates.sum(-1, keepdim=True), min=1e-9)
    return probs, gates, ids[:, :cfg.top_k]


def capacity_slots(flat_e, ep: int, cap: int):
    """flat_e: (t·k,) expert of each (token, choice) pair, token-major →
    (slot, keep): the pair's slot is the number of earlier pairs sent to
    the same expert; it is kept when the slot is below ``cap``."""
    # (E, t·k): the count runs along the last dim, where the card's scan is
    # parallel (along dim 0 of a (t·k, E) one-hot it runs E threads)
    onehot = (flat_e[None, :] == torch.arange(ep, device=flat_e.device)[:, None]).to(torch.int32)
    pos = torch.cumsum(onehot, dim=1, dtype=torch.int32)
    slot = pos.gather(0, flat_e[None, :])[0] - 1
    return slot, slot < cap


def _shared(p):
    return {"w_up": p["shared.w_up"], "w_gate": p["shared.w_gate"],
            "w_down": p["shared.w_down"]}


def moe_block(ctx: common.ShardCtx, p, x_seq, cfg: MoECfg):
    """x_seq: (B, S, D) in the compute dtype.  Returns (out (B, S, D), aux
    f32 scalar)."""
    cd = ctx.compute_dtype
    b, s, d = x_seq.shape
    t, k = b * s, cfg.top_k
    ep = cfg.padded(ctx.tp)
    x = x_seq.reshape(t, d)

    probs, gates, expert_ids = route(p["router"], x, cfg)
    # Switch-style aux loss: E·Σ_e f_e·P_e over the experts
    density = torch.nn.functional.one_hot(expert_ids[:, 0], ep).float().mean(0)
    aux = cfg.num_experts * torch.sum(density * probs.mean(0)) * cfg.router_aux_weight

    cap = max(1, int(cfg.capacity_factor * t * k / ep))
    flat_e = expert_ids.reshape(-1)                             # (t·k,)
    slot, keep = capacity_slots(flat_e, ep, cap)
    gate_keep = gates.reshape(-1) * keep

    # dispatch: kept pairs to (expert, slot), dropped ones to a spare last row
    dest = torch.where(keep, flat_e * cap + slot, ep * cap)
    rows = x.to(cd)[:, None].expand(t, k, d).reshape(t * k, d)
    send = torch.zeros((ep * cap + 1, d), dtype=cd, device=x.device).index_copy(0, dest, rows)
    recv = send[:ep * cap].view(ep, cap, d)

    up = torch.bmm(recv, p["w_up"].to(cd))
    gate = torch.bmm(recv, p["w_gate"].to(cd))
    h = gate * torch.sigmoid(gate) * up        # jax.nn.silu is x * sigmoid(x)
    out = torch.bmm(h, p["w_down"].to(cd)).reshape(ep * cap, d)

    gathered = out.index_select(0, flat_e * cap + torch.clamp(slot, max=cap - 1))
    combined = (gathered * gate_keep[:, None].to(cd)).view(t, k, d).sum(1)
    y = combined.view(b, s, d)
    if cfg.num_shared:
        y = y + mlp_lib.mlp(ctx, _shared(p), x_seq)
    return y, aux


def moe_decode(ctx: common.ShardCtx, p, x, cfg: MoECfg):
    """x: (B, 1, D) decode tokens.  Every expert runs on every token,
    weighted by the gate matrix (zero off a token's top k), as the
    reference's decode computes its local experts; no capacity."""
    cd = ctx.compute_dtype
    b, one, d = x.shape
    t = b * one
    ep = cfg.padded(ctx.tp)
    xt = x.reshape(t, d)

    _, gates, expert_ids = route(p["router"], xt, cfg)
    gmat = torch.sum(gates[..., None]
                     * torch.nn.functional.one_hot(expert_ids, ep).float(), dim=1)   # (t, E)

    up = torch.einsum("td,edf->etf", xt, p["w_up"].to(cd))
    gate = torch.einsum("td,edf->etf", xt, p["w_gate"].to(cd))
    h = gate * torch.sigmoid(gate) * up
    oute = torch.einsum("etf,efd->etd", h, p["w_down"].to(cd))
    out = torch.einsum("te,etd->td", gmat.to(cd), oute)
    if cfg.num_shared:
        out = out + mlp_lib.mlp(ctx, _shared(p), x).reshape(t, d)
    return out.reshape(b, one, d)
