"""Synthetic seeded gradients, and the gradient sync they drive.

The model forward and backward are not ported yet, so the sync is driven
with gradients made from a seed: per leaf, a component shared by all ranks,
a per-rank component and a per-rank offset (so the node centers μ_i
differ), drawn with a seeded ``torch.Generator`` on the target device.

The main path this drives — one step's bucketed sync of the qwen3-4b
gradient at full width, ``LAYERS`` of its 36 layers, ``N`` ranks stacked
on one device, under each of ``PRESETS`` — is defined here once, for
``chip_smoke.py`` and ``launch/profile_sync.py``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Mapping, Sequence

import torch

from repro_torch import random as prandom
from repro_torch.configs.registry import compression_preset, get_config, param_shapes
from repro_torch.core import types as t
from repro_torch.core.collectives import StackedComm
from repro_torch.train import bucketing

MODEL = "qwen3-4b"
LAYERS = 4          # of 36: depth is cut, width is not
N = 8               # data-parallel ranks, stacked on one device
PRESETS = ("fixed_k_1bit", "bernoulli_seed_1bit", "binary_packed", "ternary_packed",
           "ternary_opt", "rotated_binary", "rotated_fixed_k")


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


def main_path(cmp: t.CompressionConfig, device):
    """(shapes, bucket plan, communicator) of the main path under ``cmp``."""
    shapes, specs = main_shapes()
    plan = bucketing.build_plan(shapes, specs, ("data",), {"data": N}, cmp)
    return shapes, plan, StackedComm(N, device)


def step_key(step: int):
    """The sync key of training step ``step``."""
    return prandom.fold_in(prandom.PRNGKey(0), step)
