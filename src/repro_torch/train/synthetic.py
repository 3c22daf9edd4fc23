"""The main paths on the card, defined once for ``chip_smoke.py`` and the
``launch/profile_*`` scripts, and synthetic seeded gradients for the sync.

* The sync path: one step's bucketed sync of the qwen3-4b gradient at full
  width, ``LAYERS`` of its 36 layers, ``N`` ranks stacked on one device,
  under each of ``PRESETS``, driven with gradients made from a seed (per
  leaf, a component shared by all ranks, a per-rank component and a
  per-rank offset, so the node centers μ_i differ) drawn with a seeded
  ``torch.Generator`` on the target device: every preset in seconds,
  without the model.
* The error-feedback sync path: the same, under each of ``EF_PRESETS``
  (the reference's five ``ef_*`` presets), the residuals carried from step
  to step.
* The hierarchical sync path: the same tree and ranks laid out as
  ``HIER_MESH`` = (pod 4, data 2), under each of ``HIER_PRESETS`` (the
  reference's §11 two-level presets, unflattened: the exact mean inside
  each pod, the codec across the 4 pods).
* The multi-pod training path (:func:`multipod_train_path`): the same model
  and depth on ``MULTIPOD_MESH`` = (pod 2, data 4), with the reference's
  ``get_run_config(MODEL, "train_4k", multi_pod=True)``: ``fixed_k_1bit``
  over ``pod``, the exact mean inside each pod.
* The MoE training path (:func:`moe_train_path`): ``MOE_MODEL`` at full
  width and ``MOE_LAYERS`` of its 16 layers, ``N`` ranks of one
  ``train_4k`` sequence, the reference's
  ``get_run_config(MOE_MODEL, "train_4k")`` (``fixed_k_1bit`` over
  ``data``) with one microbatch.
* The SSM training path (:func:`ssm_train_path`): ``SSM_MODEL``
  (mamba2-130m) at full width and all 24 layers, ``N`` ranks of one
  ``train_4k`` sequence, the reference's ``get_run_config(SSM_MODEL,
  "train_4k")`` as it is (``fixed_k_1bit`` over ``data``, one microbatch,
  no model axis, remat).
* The encoder–decoder training path (:func:`encdec_train_path`):
  ``ENCDEC_MODEL`` (whisper-medium) whole (24 encoder and 24 decoder
  layers at full width), ``N`` ranks of one ``train_4k`` sequence with its
  1536 frames, the reference's ``get_run_config(ENCDEC_MODEL, "train_4k")``
  unchanged (``fixed_k_1bit`` over ``data``, one microbatch, remat).
* The VLM training path (:func:`vlm_train_path`): ``VLM_MODEL``
  (llava-next-34b) at full width and ``VLM_LAYERS`` of its 60 layers,
  ``VLM_N`` ranks of one ``train_4k`` sequence (1152 patches and 2944
  tokens), the reference's ``get_run_config(VLM_MODEL, "train_4k")`` with
  FSDP off and one microbatch, not 8.
* The sliding-window training path (:func:`window_train_path`):
  ``WINDOW_MODEL`` (h2o-danube-3-4b: hd 120, window 4096) at full width
  and ``WINDOW_LAYERS`` of its 24 layers, ``N`` ranks of one ``train_4k``
  sequence, the reference's ``get_run_config(WINDOW_MODEL, "train_4k")``
  with one microbatch, not 4.
* The FSDP training path (:func:`fsdp_train_path`): ``FSDP_MODEL``
  (qwen2-moe-a2.7b) at full width and ``FSDP_LAYERS`` of its 24 layers,
  ``FSDP_N`` ranks of one ``train_4k`` sequence, the reference's
  ``get_run_config(FSDP_MODEL, "train_4k")`` (FSDP over ``data``,
  ``fixed_k_1bit`` over ``data`` for the leaves FSDP does not shard, remat,
  flash) with one microbatch, not 4.
* The multi-pod FSDP training path (:func:`multipod_fsdp_train_path`):
  ``FSDP_MODEL`` at full width and ``MULTIPOD_FSDP_LAYERS`` of its 24
  layers on ``MULTIPOD_FSDP_MESH`` = (pod 2, data 2), one ``train_4k``
  sequence a rank, the reference's ``get_run_config(FSDP_MODEL,
  "train_4k", multi_pod=True)`` (FSDP over ``data``, ``fixed_k_1bit``
  over ``pod`` on the FSDP shards and, after the exact mean over
  ``data``, on the other leaves) with one microbatch, not 4.
* The training path (:func:`train_main_path`): the same model, depth and
  ranks, one ``train_4k`` sequence per rank, the real forward and backward
  feeding the same sync under ``fixed_k_1bit``, then AdamW; with
  ``error_feedback=True`` the same under ``fixed_k_1bit`` + error feedback
  (``EF_TRAIN_STEPS`` steps), the default of the reference's training
  example (``examples/train_lm_compressed.py``); and one
  rank's gradients before the sync (:func:`rank_loss_and_grads`), which
  ``chip_smoke.py`` and ``launch/compare_attn_grads.py`` compare across
  attention paths (:func:`grad_rel_errs`).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Mapping, Sequence

import torch

from repro_torch import random as prandom
from repro_torch.configs import registry
from repro_torch.configs.base import SHAPES, RunConfig
from repro_torch.configs.registry import (compression_preset, get_config, get_run_config,
                                          param_shapes)
from repro_torch.core import types as t
from repro_torch.core.collectives import StackedComm
from repro_torch.models import model
from repro_torch.train import bucketing

MODEL = "qwen3-4b"
LAYERS = 4          # of 36: depth is cut, width is not
N = 8               # data-parallel ranks, stacked on one device
TRAIN_PRESET = "fixed_k_1bit"   # the reference's default train compression
TRAIN_STEPS = 4
PRESETS = ("fixed_k_1bit", "bernoulli_seed_1bit", "binary_packed", "ternary_packed",
           "ternary_opt", "rotated_binary", "rotated_fixed_k")
EF_PRESETS = ("ef_fixed_k", "ef_bernoulli", "ef_binary", "ef_ternary", "ef_rotated_binary")
EF_TRAIN_STEPS = 4
HIER_MESH = {"pod": 4, "data": 2}
HIER_PRESETS = ("hier_fixed_k", "hier_bernoulli")
MULTIPOD_MESH = {"pod": 2, "data": 4}
MOE_MODEL = "olmoe-1b-7b"
MOE_LAYERS = 2      # of 16
SSM_MODEL = "mamba2-130m"      # all 24 layers: 8 f32 gradient stacks take 4.13 GB
ENCDEC_MODEL = "whisper-medium"   # all 24 + 24 layers: 8 f32 gradient stacks take 24.25 GB
VLM_MODEL = "llava-next-34b"
# 1 of 60 layers: 1.53 B parameters; 4 f32 gradient stacks take 24.4 GB.  At 2
# layers (2.08 B) the stacked step peaked at 66.3 GiB and its second step ran
# out of the card's 80 GB under the default caching allocator
VLM_LAYERS = 1
VLM_N = 4
WINDOW_MODEL = "h2o-danube-3-4b"
WINDOW_LAYERS = 4   # of 24: 865 M parameters; 8 f32 gradient stacks take 27.7 GB
FSDP_MODEL = "qwen2-moe-a2.7b"
# 4 of 24 layers: 2.90 B parameters.  Stacked at n = 4 the f32 parameters and
# moments take 34.9 GB, the FSDP gradients 9.1 GB and the other leaves' 4
# gradient rows 10.0 GB; a rank's backward returns another 11.6 GB before
# it is summed.  Without FSDP the 4 gradient rows of every leaf take 46.5 GB
FSDP_LAYERS = 4
FSDP_N = 4
MULTIPOD_FSDP_MESH = {"pod": 2, "data": 2}
# 3 of 24 layers: 2.33 B parameters.  Stacked at (pod 2, data 2) the f32
# parameters and moments take 28.0 GB, the two pods' sums of the FSDP leaves
# (their bucket rows) 13.7 GB, the other leaves' 4 gradient rows 10.0 GB and
# the synced gradients 9.3 GB; a rank's backward returns 9.3 GB before it is
# summed.  The step peaked at 61.7 GiB on an 80 GB card; at 4 layers it ran
# out of memory
MULTIPOD_FSDP_LAYERS = 3


def synthetic_grads(shapes: Mapping[str, Sequence[int]], n: int, step: int,
                    device) -> Dict[str, torch.Tensor]:
    """(n, *shape) f32 gradient stacks for every leaf, from seed ``step``."""
    dev = torch.device(device)
    gen = torch.Generator(device=dev)
    offs = (torch.arange(n, device=dev, dtype=torch.float32) - (n - 1) / 2) * 1e-3
    out = {}
    for i, name in enumerate(sorted(shapes)):
        shape = tuple(shapes[name])
        gen.manual_seed(1000 * step + i)
        g = torch.randn((n,) + shape, generator=gen, device=dev) * 0.01
        g += torch.randn(shape, generator=gen, device=dev) * 0.02
        g += offs.reshape((n,) + (1,) * len(shape))
        out[name] = g
    return out


def main_shapes():
    """(shapes, specs) of the main path's parameter tree."""
    return param_shapes(dataclasses.replace(get_config(MODEL), num_layers=LAYERS))


def preset(name: str) -> t.CompressionConfig:
    """A compression preset over the main path's single data axis."""
    return compression_preset(name, axes=("data",))


def main_path(cmp: t.CompressionConfig, device, mesh=None):
    """(shapes, bucket plan, communicator) of the main path under ``cmp``:
    the ``N`` ranks on the flat data axis, or laid out as ``mesh`` (axis →
    size in mesh order, ``N`` ranks in all)."""
    shapes, specs = main_shapes()
    if mesh is None:
        plan = bucketing.build_plan(shapes, specs, ("data",), {"data": N}, cmp)
        return shapes, plan, StackedComm(N, device)
    plan = bucketing.build_plan(shapes, specs, tuple(mesh), dict(mesh), cmp)
    return shapes, plan, StackedComm(device=device, mesh=mesh)


def step_key(step: int):
    """The sync key of training step ``step``."""
    return prandom.fold_in(prandom.PRNGKey(0), step)


def train_main_path(error_feedback: bool = False):
    """(cfg, run, shape) of the training path: ``MODEL`` at full width and
    ``LAYERS`` layers; the reference's defaults (bf16 compute, flash
    attention, remat) with ``TRAIN_PRESET`` over the data axis, plus error
    feedback when asked; ``train_4k`` sequences, one per rank (global batch
    ``N``, not 256)."""
    cfg = dataclasses.replace(get_config(MODEL), num_layers=LAYERS)
    cmp = dataclasses.replace(preset(TRAIN_PRESET), error_feedback=error_feedback)
    run = RunConfig(compression=cmp)
    return cfg, run, dataclasses.replace(SHAPES["train_4k"], global_batch=N)


def multipod_train_path():
    """(cfg, run, shape, mesh) of the multi-pod training path: ``MODEL`` at
    full width and ``LAYERS`` layers; the reference's
    ``get_run_config(MODEL, "train_4k", multi_pod=True)`` (``fixed_k_1bit``
    over ``pod``) with one microbatch, not 4: a rank's one sequence does not
    split; ``train_4k`` sequences, one per rank of ``MULTIPOD_MESH``."""
    cfg = dataclasses.replace(get_config(MODEL), num_layers=LAYERS)
    run = dataclasses.replace(get_run_config(MODEL, "train_4k", multi_pod=True),
                              microbatches=1)
    n = math.prod(MULTIPOD_MESH.values())
    return cfg, run, dataclasses.replace(SHAPES["train_4k"], global_batch=n), dict(MULTIPOD_MESH)


def moe_train_path():
    """(cfg, run, shape) of the MoE training path: ``MOE_MODEL`` at full
    width and ``MOE_LAYERS`` layers; the reference's
    ``get_run_config(MOE_MODEL, "train_4k")`` (``fixed_k_1bit`` over
    ``data``; not in its FSDP set) with one microbatch, not 2: a rank's one
    sequence does not split; ``train_4k`` sequences, one per rank (global
    batch ``N``)."""
    cfg = dataclasses.replace(get_config(MOE_MODEL), num_layers=MOE_LAYERS)
    run = dataclasses.replace(get_run_config(MOE_MODEL, "train_4k"), microbatches=1)
    return cfg, run, dataclasses.replace(SHAPES["train_4k"], global_batch=N)


def ssm_train_path():
    """(cfg, run, shape) of the SSM training path: ``SSM_MODEL`` whole (full
    width, all its layers); the reference's ``get_run_config(SSM_MODEL,
    "train_4k")`` unchanged (``fixed_k_1bit`` over ``data``, its one
    microbatch); ``train_4k`` sequences, one per rank (global batch
    ``N``)."""
    run = get_run_config(SSM_MODEL, "train_4k")
    return get_config(SSM_MODEL), run, dataclasses.replace(SHAPES["train_4k"], global_batch=N)


def encdec_train_path():
    """(cfg, run, shape) of the encoder–decoder training path:
    ``ENCDEC_MODEL`` whole; the reference's ``get_run_config(ENCDEC_MODEL,
    "train_4k")`` unchanged; ``train_4k`` sequences, one per rank (global
    batch ``N``), each with its frames (``SyntheticLM``)."""
    run = get_run_config(ENCDEC_MODEL, "train_4k")
    return get_config(ENCDEC_MODEL), run, dataclasses.replace(SHAPES["train_4k"], global_batch=N)


def vlm_train_path():
    """(cfg, run, shape) of the VLM training path: ``VLM_MODEL`` at full
    width and ``VLM_LAYERS`` layers; the reference's
    ``get_run_config(VLM_MODEL, "train_4k")`` (``fixed_k_1bit`` over
    ``data``, remat) with FSDP off (the port keeps every parameter whole)
    and one microbatch, not 8: a rank's one sequence does not split;
    ``train_4k`` sequences, one per rank (global batch ``VLM_N``), each its
    patches and then its tokens."""
    cfg = dataclasses.replace(get_config(VLM_MODEL), num_layers=VLM_LAYERS)
    run = dataclasses.replace(registry._run_config(VLM_MODEL, "train_4k", fsdp=False),
                              microbatches=1)
    return cfg, run, dataclasses.replace(SHAPES["train_4k"], global_batch=VLM_N)


def window_train_path():
    """(cfg, run, shape) of the sliding-window training path:
    ``WINDOW_MODEL`` (hd 120, window 4096) at full width and
    ``WINDOW_LAYERS`` layers; the reference's ``get_run_config(WINDOW_MODEL,
    "train_4k")`` (``fixed_k_1bit`` over ``data``, remat) with one
    microbatch, not 4: a rank's one sequence does not split; ``train_4k``
    sequences, one per rank (global batch ``N``), which the window of 4096
    does not cut."""
    cfg = dataclasses.replace(get_config(WINDOW_MODEL), num_layers=WINDOW_LAYERS)
    run = dataclasses.replace(get_run_config(WINDOW_MODEL, "train_4k"), microbatches=1)
    return cfg, run, dataclasses.replace(SHAPES["train_4k"], global_batch=N)


def fsdp_train_path(layers: int = FSDP_LAYERS, n: int = FSDP_N):
    """(cfg, run, shape) of the FSDP training path: ``FSDP_MODEL`` at full
    width and ``layers`` layers; the reference's ``get_run_config(FSDP_MODEL,
    "train_4k")`` as it is (FSDP on, ``fixed_k_1bit`` over ``data``, remat,
    flash) with one microbatch, not 4: a rank's one sequence does not
    split; ``train_4k`` sequences, one per rank of ``n``."""
    cfg = dataclasses.replace(get_config(FSDP_MODEL), num_layers=layers)
    run = dataclasses.replace(get_run_config(FSDP_MODEL, "train_4k"), microbatches=1)
    return cfg, run, dataclasses.replace(SHAPES["train_4k"], global_batch=n)


def multipod_fsdp_train_path(layers: int = MULTIPOD_FSDP_LAYERS):
    """(cfg, run, shape, mesh) of the multi-pod FSDP training path:
    ``FSDP_MODEL`` at full width and ``layers`` layers on
    ``MULTIPOD_FSDP_MESH``; the reference's ``get_run_config(FSDP_MODEL,
    "train_4k", multi_pod=True)`` as it is (FSDP over ``data``,
    ``fixed_k_1bit`` over ``pod``, remat, flash) with one microbatch, not 4:
    a rank's one sequence does not split; ``train_4k`` sequences, one per
    rank (global batch 4)."""
    cfg = dataclasses.replace(get_config(FSDP_MODEL), num_layers=layers)
    run = dataclasses.replace(get_run_config(FSDP_MODEL, "train_4k", multi_pod=True),
                              microbatches=1)
    mesh = dict(MULTIPOD_FSDP_MESH)
    shape = dataclasses.replace(SHAPES["train_4k"], global_batch=math.prod(mesh.values()))
    return cfg, run, shape, mesh


def rank_loss_and_grads(cfg, run, params, batch, global_tokens: float):
    """(loss, {leaf: gradient}) of one rank's ``train_loss`` at ``params``
    (over ``global_tokens``, as in the step), before any sync."""
    leaves = {k: v.detach().requires_grad_() for k, v in params.items()}
    loss, _ = model.train_loss(model.make_ctx(cfg, run), leaves, cfg, run, batch, global_tokens)
    names = sorted(leaves)
    grads = torch.autograd.grad(loss, [leaves[k] for k in names])
    return float(loss.detach()), dict(zip(names, grads))


def grad_rel_errs(got: Mapping[str, torch.Tensor],
                  want: Mapping[str, torch.Tensor]) -> Dict[str, float]:
    """Per leaf ‖got − want‖ / ‖want‖, in f64."""
    return {k: float(torch.linalg.vector_norm(got[k].double() - want[k].double())
                     / torch.linalg.vector_norm(want[k].double())) for k in want}
