"""Timing and fingerprints of training steps, for the CLI's ``--report``
and ``chip_smoke.py`` phase 5.

* :class:`StepTimer` — an ``on_phase`` callback
  (:func:`~repro_torch.train.train_step.build_train_step`) that times each
  step by phase on the host clock (a synchronize at every phase boundary on
  the card), counts the bytes handed to the communicator, and reads the
  bucket rounds' issue order and timeline (:func:`sync_timeline`).
* :func:`sync_timeline` — each bucket round's issue and end against the end
  of the backward, and the exposed sync: how long the step waits for its
  gradients beyond the backward.
* :func:`state_digest` — a 64-bit fingerprint of each tensor's bits, so two
  runs' states can be held equal bit for bit without keeping both;
  :func:`fsdp_state_digest` the same with FSDP leaves by rank shard.
"""
from __future__ import annotations

import time
import zlib
from typing import Dict, Mapping, Optional

import torch

# digest chunk length and weights: odd, below 2^21, fixed by the seed
_CHUNK = 1 << 22
_SEED = 20261018
_FNV = 0x100000001B3
_MASK = (1 << 64) - 1
_WEIGHTS: Dict[torch.device, torch.Tensor] = {}


def _weights(device: torch.device) -> torch.Tensor:
    if device not in _WEIGHTS:
        gen = torch.Generator(device="cpu").manual_seed(_SEED)
        w = torch.randint(0, 1 << 20, (_CHUNK,), generator=gen, dtype=torch.int64) * 2 + 1
        _WEIGHTS[device] = w.to(device)
    return _WEIGHTS[device]


def _words(t: torch.Tensor) -> torch.Tensor:
    """The tensor's bits as a flat int32 (4- and 8-byte elements) or int16
    (2-byte) view; 1-byte elements widened to int32."""
    flat = t.detach().contiguous().reshape(-1)
    if t.element_size() >= 4:
        return flat.view(torch.int32)
    if t.element_size() == 2:
        return flat.view(torch.int16)
    return flat.to(torch.int32)


def tensor_digest(t: torch.Tensor) -> str:
    """A 64-bit fingerprint of ``t``'s dtype, shape and bits: per chunk of
    2^22 words, Σ word · w mod 2^64 with fixed odd weights w, chained over
    the chunks.  Any one flipped bit changes it (an odd weight times a
    power of two is nonzero mod 2^64); the same bits give the same digest
    on any device."""
    words = _words(t)
    w = _weights(words.device)
    sums = [(words[i:i + _CHUNK].to(torch.int64) * w[:min(_CHUNK, words.numel() - i)]).sum()
            for i in range(0, words.numel(), _CHUNK)]
    h = zlib.crc32(f"{t.dtype} {tuple(t.shape)}".encode())
    for s in (torch.stack(sums).tolist() if sums else []):
        h = (h * _FNV + s) & _MASK
    return f"{h:016x}"


def state_digest(tree: Mapping[str, torch.Tensor]) -> Dict[str, str]:
    """:func:`tensor_digest` of every tensor of ``tree``, by name."""
    return {k: tensor_digest(v) for k, v in sorted(tree.items())}


def fsdp_state_digest(tree: Mapping[str, torch.Tensor], fsdp_dims: Mapping[str, int], n: int,
                      gather=None) -> Dict[str, object]:
    """:func:`state_digest` of ``tree`` with each FSDP leaf's (``fsdp_dims``:
    name → the dim its rank shards split) given as the list of its ``n``
    data shards' digests in data order: cut from the whole leaf, or, with
    ``gather`` (a function of this process's digest returning every data
    shard's in order), from this process's own shard.  A run whose processes
    hold shards and one whose stacked ranks hold whole leaves compare."""
    out = state_digest({k: v for k, v in tree.items() if k not in fsdp_dims})
    for k in fsdp_dims:
        if gather is not None:
            out[k] = list(gather(tensor_digest(tree[k])))
        else:
            out[k] = [tensor_digest(c) for c in torch.chunk(tree[k], n, fsdp_dims[k])]
    return dict(sorted(out.items()))


def sync_timeline(start, backward, rounds) -> Dict[str, object]:
    """A step's bucket rounds against its backward, on the card.

    ``start`` and ``backward`` are timing events recorded on the compute
    stream as the step started and once its backward was enqueued;
    ``rounds`` is the step's :class:`~repro_torch.train.bucketing.RoundLog`;
    every event must have completed.  Returns ``rounds_ms`` — per bucket,
    [issued, done] in ms from the end of the backward (negative: before it)
    — and ``exposed_sync_ms`` = max(0, last done − max(end of backward,
    first issued)): the time the step waits for its gradients beyond the
    backward.  Empty on the CPU (no events)."""
    if backward is None or not rounds.events:
        return {}
    end = start.elapsed_time(backward)
    rel = {bid: [start.elapsed_time(s) - end, start.elapsed_time(d) - end]
           for bid, (s, d) in rounds.events.items()}
    first = min(v[0] for v in rel.values())
    last = max(v[1] for v in rel.values())
    return {"exposed_sync_ms": max(0.0, last - max(0.0, first)), "rounds_ms": rel}


class StepTimer:
    """``on_phase`` callback: one dict per step in :attr:`steps` with the
    phase ms (``backward_ms``: forward and backward over the local ranks,
    with the overlapped rounds' launches; ``sync_ms``; ``update_ms``), their
    sum ``step_ms``, the bytes handed to the communicator (``wire_bytes``,
    this process's, over the codec axes; ``fsdp_bytes``, FSDP's gathers and
    reduce-scatters; ``inner_bytes``, the exact means over the axes the
    codec does not span, such as ``data`` under a compression over ``pod``;
    the counters are reset each step), on the card ``fsdp_reduce_ms``, the
    stacked ranks' FSDP rank sum and its rounding within the backward (by
    their events; None where the reduce-scatters run inside the backward
    under DistComm), the schedule, the
    rounds' issue order (``issued``) and, on the card, :func:`sync_timeline`'s
    ``exposed_sync_ms`` and ``rounds_ms``."""

    def __init__(self, device):
        self.cuda = torch.device(device).type == "cuda"
        self.steps = []
        self._cur: Optional[dict] = None
        self._events: Dict[str, object] = {}
        self._t = 0.0

    def _event(self, name: str) -> None:
        if self.cuda:
            ev = torch.cuda.Event(enable_timing=True)
            ev.record()
            self._events[name] = ev

    def __call__(self, name: str, **state) -> None:
        if name in ("start", "backward"):
            self._event(name)
        if self.cuda:
            torch.cuda.synchronize()
        now = time.perf_counter()
        if name == "start":
            self._cur = {"step": state["step"]}
        else:
            self._cur[f"{name}_ms"] = (now - self._t) * 1e3
        if name == "backward":
            ev = [e for e in state.get("reduce_events", ()) if e[0] is not None]
            self._cur["fsdp_reduce_ms"] = sum(a.elapsed_time(b) for a, b in ev) if ev else None
        if name == "sync":
            comm = state["comm"]
            self._cur["wire_bytes"] = comm.bytes_gathered + comm.bytes_reduced
            self._cur["fsdp_bytes"] = comm.bytes_fsdp
            self._cur["inner_bytes"] = comm.bytes_inner
            comm.reset_bytes()
            self._cur["schedule"] = state["schedule"]
            rounds = state["rounds"]
            if rounds is not None:
                self._cur["issued"] = list(rounds.issued)
                self._cur.update(sync_timeline(self._events.get("start"),
                                               self._events.get("backward"), rounds))
        if name == "update":
            c = self._cur
            c["step_ms"] = c["backward_ms"] + c["sync_ms"] + c["update_ms"]
            self.steps.append(c)
        self._t = time.perf_counter()
