"""Production and debug meshes — port of ``repro.launch.mesh``.

The reference builds ``jax.make_mesh`` over TPU chips.  The port's meshes
are plain mappings, axis → size in mesh order, the form ``Trainer`` and
``StackedComm`` take (``mesh=``): the ranks of a mapping are stacked on one
card, or one to a process over ``torch.distributed`` (``DistComm``).

Single pod: (data=16, model=16), 256 ranks.  Multi-pod: (pod=2, data=16,
model=16), 512; the ``pod`` axis is the default compression axis of the
paper's gradient aggregation (DESIGN.md §2).  A ``model`` axis above 1 is
tensor parallelism, which the port does not have yet: :func:`data_parallel`
raises :class:`NotPortedError` for it, as ``ShardCtx`` does.
"""
from __future__ import annotations

from typing import Dict, Mapping

from repro_torch.core.wire.base import NotPortedError


def make_production_mesh(*, multi_pod: bool = False) -> Dict[str, int]:
    if multi_pod:
        return {"pod": 2, "data": 16, "model": 16}
    return {"data": 16, "model": 16}


def make_debug_mesh(data: int = 1, model: int = 1) -> Dict[str, int]:
    """Small mesh for CPU tests."""
    return {"data": data, "model": model}


def data_parallel(mesh: Mapping[str, int]) -> Dict[str, int]:
    """The mesh without its ``model`` axis, which must have size 1: the
    data-parallel ranks a ``Trainer`` stacks."""
    model = mesh.get("model", 1)
    if model != 1:
        raise NotPortedError(f"a model axis of {model} is tensor parallelism, which is not "
                             "ported yet (ROADMAP.md, queue 1)")
    return {a: s for a, s in mesh.items() if a != "model"}
