"""Checkpoints: atomic save, retention, restore at any rank count — port of
``repro.checkpoint.checkpointing``.

The on-disk format is the reference's, so a checkpoint written by either
package restores in the other: ``<path>/step-%08d/``, committed by
``os.rename`` from ``<path>/tmp-<step>/``, holds ``arrays.npz`` (keys
``params|<name>``, ``opt|step``, ``opt|m|<name>``, ``opt|v|<name>``) and
``manifest.json`` (``step``; ``specs``, each leaf's spec as a list, as
``param_shapes`` gives it; ``extra``).  A crash mid-save leaves a
``tmp-<step>`` directory, which is never read as a checkpoint.
``keep_last`` prunes the oldest steps.  The parameters are f32 masters and
``opt.step`` an int32 scalar, so numpy holds every leaf unchanged.

Every leaf is saved whole, with its spec: an FSDP leaf's names ``data``,
and the trainer gathers its shards first where each process holds only
its own.  The reference's elastic restore, which reshards onto the current
mesh, is a restore under any rank count: whole leaves where the ranks hold
them whole, or (``shard``) the slice of each FSDP leaf the current rank
count gives this rank.

:class:`AsyncCheckpointer` overlaps the file write with the next training
steps, one save in flight, as the reference's does.
"""
from __future__ import annotations

import json
import os
import shutil
import threading
import time
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from repro_torch import resolve_device

MANIFEST = "manifest.json"


def _flatten(tree, prefix=""):
    out = {}
    if isinstance(tree, dict):
        for k, v in tree.items():
            out.update(_flatten(v, f"{prefix}{k}/"))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            out.update(_flatten(v, f"{prefix}{i}/"))
    else:
        out[prefix[:-1]] = tree
    return out


def _leaves(params, opt_state) -> Dict[str, Any]:
    """The saved leaves by their ``arrays.npz`` key."""
    flat = _flatten({"params": params, "opt": {
        "step": opt_state.step, "m": opt_state.m, "v": opt_state.v}})
    return {k.replace("/", "|"): v for k, v in flat.items()}


def _check_leaf(name: str, t: torch.Tensor):
    if t.dtype not in (torch.float32, torch.int32):
        raise TypeError(f"checkpoint leaves are f32 or int32, got {t.dtype} ({name})")


def _commit(path: str, step: int, arrays: Dict[str, np.ndarray], specs, extra,
            keep_last: int) -> str:
    """Write ``tmp-<step>``, rename it to ``step-%08d``, prune."""
    tmp = f"{path}/tmp-{step}"
    final = f"{path}/step-{step:08d}"
    os.makedirs(tmp, exist_ok=True)
    np.savez(os.path.join(tmp, "arrays.npz"), **arrays)
    manifest = {
        "step": int(step),
        "specs": {k: list(v) for k, v in specs.items()},
        "extra": extra or {},
    }
    with open(os.path.join(tmp, MANIFEST), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    _prune(path, keep_last)
    return final


def save(path: str, step: int, params: Dict[str, Any], opt_state,
         specs: Dict[str, Any], extra: Optional[Dict] = None, keep_last: int = 3) -> str:
    """Synchronous save with atomic commit; returns the committed directory.
    Leaves are f32 or int32 tensors on any device."""
    arrays = {}
    for k, t in _leaves(params, opt_state).items():
        _check_leaf(k, t)
        arrays[k] = t.detach().cpu().numpy()
    return _commit(path, step, arrays, specs, extra, keep_last)


def _prune(path: str, keep_last: int):
    steps = sorted(d for d in os.listdir(path) if d.startswith("step-"))
    for d in steps[:-keep_last]:
        shutil.rmtree(os.path.join(path, d), ignore_errors=True)


def latest_step(path: str) -> Optional[int]:
    """The newest committed step under ``path`` (``tmp-*`` is ignored)."""
    if not os.path.isdir(path):
        return None
    steps = sorted(d for d in os.listdir(path) if d.startswith("step-"))
    return int(steps[-1].split("-")[1]) if steps else None


def restore(path: str, specs: Optional[Dict[str, Any]], opt_template,
            step: Optional[int] = None, device=None,
            shard: Optional[Callable[[str, np.ndarray], np.ndarray]] = None):
    """Load a checkpoint onto ``device`` (the card unless given).

    Returns (step, params, opt_state, extra).  ``opt_template`` is an
    ``AdamWState`` used only for its type.  The leaves come back whole, or,
    with ``shard(name, array)``, as that function cuts each parameter and
    its moments (this rank's FSDP slice at the current rank count: the
    reference's elastic restore); ``specs``, when given, must name the
    checkpoint's parameters.
    """
    dev = resolve_device(device)
    step = step if step is not None else latest_step(path)
    if step is None:
        raise FileNotFoundError(f"no checkpoints under {path}")
    final = f"{path}/step-{step:08d}"
    with open(os.path.join(final, MANIFEST)) as f:
        manifest = json.load(f)

    def put(name, arr):
        if shard is not None:
            arr = np.ascontiguousarray(shard(name, arr))
        return torch.from_numpy(arr).to(dev)

    params, m, v = {}, {}, {}
    opt_step = None
    with np.load(os.path.join(final, "arrays.npz")) as data:
        for key in data.files:
            k = key.replace("|", "/")
            if k.startswith("params/"):
                name = k[len("params/"):]
                params[name] = put(name, data[key])
            elif k.startswith("opt/m/"):
                name = k[len("opt/m/"):]
                m[name] = put(name, data[key])
            elif k.startswith("opt/v/"):
                name = k[len("opt/v/"):]
                v[name] = put(name, data[key])
            elif k == "opt/step":
                opt_step = torch.from_numpy(data[key]).to(dev)
    if specs is not None and set(params) != set(specs):
        raise ValueError(f"checkpoint {final} holds parameters {sorted(params)}, "
                         f"the model {sorted(specs)}")
    opt_state = type(opt_template)(step=opt_step, m=m, v=v)
    return manifest["step"], params, opt_state, manifest.get("extra", {})


class AsyncCheckpointer:
    """Overlap checkpoint writes with training (one save in flight).

    The writing thread holds only host copies, made before it starts: on
    the card, :meth:`save` copies every leaf into pinned host buffers on a
    side stream, ordered after the current stream's work, without waiting
    (``non_blocking``), and the thread waits on an event recorded after the
    copies; on the CPU it clones.  The steps that follow may run while the
    copies are in flight: they read the saved tensors but never write them,
    since ``adamw_update`` (``repro_torch.optim.optimizers``) builds new
    tensors, and each saved tensor is marked as used by the copy stream
    (``record_stream``), so the allocator does not give its memory to a
    later step's tensors before the copy has read it.  A step that updates
    in place (FSDP's) must not run ahead of the copies: :meth:`fence`
    orders the current stream after them.  The pinned buffers are reused by
    the next save of the same leaves.

    :attr:`history` has one entry per save: ``step``, ``enqueue_ms`` (host
    time of :meth:`save`: the first save of a checkpointer allocates its
    pinned buffers), ``copy_ms`` (the device → host copies, by CUDA events;
    0 on the CPU) and ``write_ms`` (the thread's file write).
    """

    def __init__(self):
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None
        self._pinned: Dict[str, torch.Tensor] = {}
        self._stream = None
        self._copied = None
        self.history = []

    def _host_copies(self, leaves: Dict[str, Any]):
        """(numpy views of the host copies, the copy's (start, end) events
        or None)."""
        for k, t in leaves.items():
            _check_leaf(k, t)
        cuda = [t for t in leaves.values() if t.is_cuda]
        if not cuda:
            return {k: t.detach().clone().numpy() for k, t in leaves.items()}, None
        dev = cuda[0].device
        if self._stream is None or self._stream.device != dev:
            self._stream = torch.cuda.Stream(dev)
        for k, t in leaves.items():      # pinned buffers first: allocating them is slow
            buf = self._pinned.get(k)
            if buf is None or buf.shape != t.shape or buf.dtype != t.dtype:
                self._pinned[k] = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        stream = self._stream
        stream.wait_stream(torch.cuda.current_stream(dev))
        start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
        out = {}
        with torch.cuda.stream(stream):
            start.record(stream)
            for k, t in leaves.items():
                buf = self._pinned[k]
                buf.copy_(t, non_blocking=True)
                if t.is_cuda:
                    t.record_stream(stream)
                out[k] = buf.numpy()
            end.record(stream)
        return out, (start, end)

    def save(self, path: str, step: int, params, opt_state, specs,
             extra: Optional[Dict] = None, keep_last: int = 3):
        """Start a save of this state (the arguments of :func:`save`) after
        the one in flight has finished."""
        self.wait()
        t0 = time.perf_counter()
        arrays, events = self._host_copies(_leaves(params, opt_state))
        self._copied = None if events is None else events[1]
        entry = {"step": int(step), "enqueue_ms": (time.perf_counter() - t0) * 1e3}

        def write():
            try:
                if events is not None:
                    events[1].synchronize()
                    entry["copy_ms"] = events[0].elapsed_time(events[1])
                else:
                    entry["copy_ms"] = 0.0
                t1 = time.perf_counter()
                _commit(path, step, arrays, specs, extra, keep_last)
                entry["write_ms"] = (time.perf_counter() - t1) * 1e3
                self.history.append(entry)
            except BaseException as e:     # re-raised by wait()
                self._error = e

        self._thread = threading.Thread(target=write, daemon=True)
        self._thread.start()

    def fence(self):
        """Make the current stream wait until the last save's device → host
        copies have read the saved tensors (no wait on the CPU, whose copies
        are made at once), without blocking the host: later kernels may
        then write those tensors in place."""
        if self._copied is not None:
            torch.cuda.current_stream(self._stream.device).wait_event(self._copied)

    def wait(self):
        """Block until the save in flight is committed; re-raise its error."""
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise err
