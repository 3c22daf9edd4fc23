"""Carry state from the JAX package to the port, names kept.

The port imports nothing of ``repro``; these functions take what the JAX
side hands over as numpy arrays and plain objects:

* :func:`tree_to_torch` — a gradient or parameter dict of numpy arrays →
  torch tensors on ``device`` (same leaf names, same dtypes: every leaf
  crosses, a VLM's ``patch_proj`` with the rest);
* :func:`key_to_torch` — raw ``uint32[2]`` Threefry key data
  (``jax.random.key_data(key)``) → the port's key (int64 words);
* :func:`compression_config` — any object with the fields of
  ``repro.core.types.CompressionConfig`` → the port's config;
* :func:`arch_config` / :func:`run_config` — objects with the fields of
  ``repro.configs.base.ArchConfig`` / ``RunConfig`` → the port's (the dense,
  VLM, MoE, SSM, hybrid and encoder–decoder families, the MoE and SSM
  sub-configs as the port's ``MoECfg`` and ``SSMCfg``; the run config with
  its compression config);
* :func:`adamw_state` — an ``AdamWState``-shaped object (``step``, ``m``,
  ``v``, numpy leaves) → the port's optimizer state;
* :func:`ef_state` — the reference's per-rank error-feedback residuals
  (each rank holds its own, per bucket id or per leaf) → the port's
  stacked state, one (n, ...) tensor per key;
* :func:`mesh_stack` — per-rank arrays laid out on a named mesh (a
  ``(pod, data, ...)`` array, as the reference's devices are) → the port's
  (n, ...) stack in mesh order, row r = (pod r // n_in, data r % n_in), the
  order of ``StackedComm(mesh=...)`` and the train step's ranks.
* :func:`fsdp_shard` / :func:`fsdp_unshard` — a whole array (the
  reference's global array, numpy, or a torch tensor) → rank r's FSDP
  shard of it by the leaf's spec, and the n ranks' shards → the whole
  array: what ``NamedSharding(mesh, P(*spec))`` places on data rank r of
  a ``(data n, model 1)`` mesh, and what the reference's checkpoint saves.

A multi-pod run configuration (``get_run_config(..., multi_pod=True)``)
carries its compression over ``("pod",)``, and a hierarchical preset its
``inner_axes``, through :func:`run_config` / :func:`compression_config`
unchanged.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Sequence

import numpy as np
import torch

from repro_torch.configs.base import ArchConfig, RunConfig
from repro_torch.core import types as t
from repro_torch.models.moe import MoECfg
from repro_torch.models.ssm import SSMCfg
from repro_torch.optim.optimizers import AdamWState


def tree_to_torch(tree: Mapping[str, np.ndarray], device="cpu") -> Dict[str, torch.Tensor]:
    """Numpy leaves → torch tensors on ``device``; names and dtypes kept."""
    return {name: torch.from_numpy(np.ascontiguousarray(v)).to(device)
            for name, v in tree.items()}


def key_to_torch(key_data) -> torch.Tensor:
    """uint32[2] key data → the port's (2,) int64 key."""
    k = np.asarray(key_data).reshape(-1)
    if k.shape != (2,) or k.dtype != np.uint32:
        raise ValueError(f"expected uint32[2] key data, got {k.dtype}{list(k.shape)}")
    return torch.from_numpy(k.astype(np.int64))


def _copy(cls, src, **override):
    kw = {f.name: getattr(src, f.name) for f in dataclasses.fields(cls)}
    kw.update(override)
    return cls(**kw)


def compression_config(src) -> t.CompressionConfig:
    """A CompressionConfig-shaped object → the port's CompressionConfig."""
    wire_dtype = src.wire_dtype
    if not isinstance(wire_dtype, str):
        wire_dtype = np.dtype(wire_dtype).name
    return _copy(t.CompressionConfig, src,
                 encoder=_copy(t.EncoderSpec, src.encoder),
                 bucket=_copy(t.BucketSpec, src.bucket),
                 axes=tuple(src.axes), inner_axes=tuple(src.inner_axes),
                 wire_dtype=wire_dtype)


def arch_config(src) -> ArchConfig:
    """An ArchConfig-shaped object → the port's ArchConfig, an MoE or SSM
    sub-config copied field for field into :class:`MoECfg` or
    :class:`SSMCfg`.  A family the port lacks converts; its model raises
    (``models.transformer.check_family``)."""
    return _copy(ArchConfig, src, moe=None if src.moe is None else _copy(MoECfg, src.moe),
                 ssm=None if src.ssm is None else _copy(SSMCfg, src.ssm))


def run_config(src) -> RunConfig:
    """A RunConfig-shaped object → the port's RunConfig, ``fsdp`` with the
    rest."""
    return _copy(RunConfig, src, compression=compression_config(src.compression))


def adamw_state(src, device="cpu") -> AdamWState:
    """An AdamWState-shaped object (``step``; ``m``, ``v`` dicts of numpy
    leaves) → the port's :class:`~repro_torch.optim.optimizers.AdamWState`
    on ``device``."""
    return AdamWState(step=torch.tensor(int(np.asarray(src.step)), dtype=torch.int32,
                                        device=device),
                      m=tree_to_torch(src.m, device), v=tree_to_torch(src.v, device))


def ef_state(per_rank: Mapping[str, Sequence[np.ndarray]], device="cpu") -> Dict[str, torch.Tensor]:
    """The reference's error-feedback residuals, ``{bucket id or leaf name:
    the n ranks' arrays in rank order}`` (a list of n arrays of one shape,
    or one (n, ...) array; :func:`mesh_stack` gives that order from arrays
    laid out on a mesh) → the port's ``{key: (n, ...) f32 tensor}``, row i
    being rank i's residual."""
    return {k: torch.from_numpy(np.stack([np.asarray(a, dtype=np.float32) for a in v])).to(device)
            for k, v in per_rank.items()}


def mesh_stack(per_device: Mapping[str, np.ndarray],
               mesh: Mapping[str, int]) -> Dict[str, np.ndarray]:
    """Arrays whose leading axes are the mesh's, in mesh order (``(P, D,
    ...)`` for ``{"pod": P, "data": D}``) → (n, ...) arrays in rank order,
    rank r at (pod r // D, data r % D): a row-major flatten of the mesh
    axes, as the reference's ``Mesh(devices.reshape(P, D), ("pod",
    "data"))`` numbers its devices."""
    sizes = tuple(int(v) for v in mesh.values())
    out = {}
    for k, v in per_device.items():
        a = np.asarray(v)
        if a.shape[:len(sizes)] != sizes:
            raise ValueError(f"{k}: leading axes {a.shape[:len(sizes)]} are not the mesh's {sizes}")
        out[k] = a.reshape((-1,) + a.shape[len(sizes):])
    return out


def _fsdp_dim(spec, axis: str) -> int:
    spec = tuple(spec)
    if axis not in spec:
        raise ValueError(f"spec {spec} does not shard over {axis!r}")
    return spec.index(axis)


def fsdp_shard(x, spec, rank: int, n: int, axis: str = "data"):
    """Rank ``rank``'s shard of the whole array ``x`` (numpy or torch), one of
    ``n`` equal slices along the dim whose spec entry is ``axis``: a view."""
    dim = _fsdp_dim(spec, axis)
    if x.shape[dim] % n:
        raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split into {n} shards")
    size = x.shape[dim] // n
    return x[(slice(None),) * dim + (slice(rank * size, (rank + 1) * size),)]


def fsdp_unshard(shards: Sequence, spec, axis: str = "data"):
    """The whole array from its ranks' shards in rank order (numpy or torch,
    as the shards are): their concatenation along the ``axis`` dim."""
    dim = _fsdp_dim(spec, axis)
    if isinstance(shards[0], torch.Tensor):
        return torch.cat(tuple(shards), dim=dim)
    return np.concatenate(shards, axis=dim)
