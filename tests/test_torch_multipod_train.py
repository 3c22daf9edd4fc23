"""The port's multi-pod training on a stacked ``(pod, data)`` mesh: the
reference's run configuration (``get_run_config(..., multi_pod=True)``:
``fixed_k_1bit`` over ``pod``, the exact mean inside each pod), the train
step and ``Trainer`` on the smoke config, and the hierarchical presets'
error-feedback state.

* ``get_run_config`` equals the reference's, field for field, with and
  without ``multi_pod`` and with a preset name;
* ``build_train_step`` and ``Trainer.fit`` for 2 steps on ``(pod 2, data
  2)``: finite, each step's sync equal bit for bit to the flat
  ``fixed_k_1bit`` round over the pod means of its gradients (the exact
  buckets to the exact mean over all four ranks), and the bytes handed to
  the pod axis equal to the accounting;
* with error feedback (``fixed_k_1bit`` over ``pod``, and ``hier_fixed_k``
  whose codec pre-reduces the data axis itself) the (n, size) residual rows
  of one pod end bit-equal;
* ``convert.mesh_stack`` lays (pod, data, ...) arrays out in the stacked
  rank order, and ``synthetic.multipod_train_path`` is the reference's run
  configuration cut to one microbatch.

The per-leaf and bucketed multi-pod syncs are held to the reference's
``shard_map`` run in tests/test_torch_hierarchical.py.
"""
import dataclasses

import numpy as np
import pytest
import torch

from repro.configs import registry as jregistry
from repro_torch import convert
from repro_torch import random as R
from repro_torch.configs import registry as tregistry
from repro_torch.configs.base import RunConfig
from repro_torch.core import collectives as tcoll
from repro_torch.core import wire as twire
from repro_torch.core.wire import NotPortedError
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.train import bucketing
from repro_torch.train import train_step as tts
from repro_torch.train.trainer import Trainer, TrainerConfig
from test_torch_training import CFG, SHAPE

# one intra-op thread: beside other test workers on a loaded machine, torch's
# thread pool stalls for tens of seconds
torch.set_num_threads(1)

MESH = {"pod": 2, "data": 2}


@pytest.mark.parametrize("multi_pod", (False, True))
@pytest.mark.parametrize("compression", (None, "hier_bernoulli", "bernoulli_seed_1bit"))
def test_get_run_config_equals_reference(multi_pod, compression):
    want = jregistry.get_run_config("qwen3-4b", "train_4k", multi_pod=multi_pod,
                                    compression=compression)
    got = tregistry.get_run_config("qwen3-4b", "train_4k", multi_pod=multi_pod,
                                   compression=compression)
    assert convert.run_config(want) == got
    assert got.microbatches == 4 and got.compression.mode != "none"
    if multi_pod:
        assert got.compression.axes == ("pod",)


def _run(cmp, **kw):
    cmp = dataclasses.replace(cmp, min_compress_size=2048,
                              bucket=dataclasses.replace(cmp.bucket, capacity=1 << 14), **kw)
    return RunConfig(attn_chunk_q=16, attn_chunk_k=16, compression=cmp)


def _multipod(**kw):
    return _run(tregistry.get_run_config("qwen3-4b", "train_4k", multi_pod=True).compression,
                **kw)


def _pod_round(grads, plan, cmp, key):
    """Per bucket: the exact mean over all ranks, or the flat round over the
    pod means (``mean_over`` the data axis) on a 2-rank communicator."""
    comm = tcoll.StackedComm(device="cpu", mesh=MESH)
    out = {}
    for j, b in enumerate(plan.buckets):
        v = bucketing.pack_bucket(grads, b)
        if b.kind == "exact":
            y = tcoll.exact_mean(v, comm)
        else:
            y = tcoll.compressed_mean(comm.mean_over(v, ("data",)), R.fold_in(key, j),
                                      dataclasses.replace(cmp, axes=("pod",)),
                                      tcoll.StackedComm(2, "cpu"))
        out.update(bucketing.unpack_bucket(y, b, grads))
    return out


def test_trainer_fit_multipod_syncs_the_pod_means():
    run = _multipod()
    seen = []

    def on_phase(name, **st):
        if name == "sync":
            seen.append({k: st[k] for k in ("grads", "synced", "key", "comm")})

    trainer = Trainer(CFG, run, SHAPE, TrainerConfig(steps=2, log_every=1), mesh=MESH,
                      device="cpu", on_phase=on_phase)
    assert trainer.mesh == MESH
    plan = trainer.sync_plan
    assert all(b.caxes == ("pod",) and b.eaxes == ("data",)
               for b in plan.buckets if b.kind == "compressed")
    assert any(b.kind == "compressed" for b in plan.buckets)
    params, opt, hist = trainer.fit()
    assert int(opt.step) == 2 and len(seen) == 2
    assert all(np.isfinite(h["loss"]) and np.isfinite(h["grad_norm"]) for h in hist)
    assert all(bool(torch.isfinite(v).all()) for v in params.values())
    for st in seen:
        want = _pod_round(st["grads"], plan, run.compression, st["key"])
        for k, v in want.items():
            assert torch.equal(st["synced"][k].view(torch.int32), v.view(torch.int32)), k
    codec = twire.resolve(run.compression)
    wire = sum(codec.wire_bits(2, b.size, run.compression)
               for b in plan.buckets if b.kind == "compressed")
    exact = sum(4 * b.size * 32 for b in plan.buckets if b.kind == "exact")
    comm = seen[-1]["comm"]
    assert comm.bytes_reduced * 8 == 2 * (wire + exact)   # two steps, not reset
    assert comm.bytes_inner > 0 and comm.bytes_gathered == 0


def test_build_train_step_takes_the_mesh():
    run = _multipod()
    step_fn, init_fn, plan = tts.build_train_step(CFG, run, SHAPE, mesh=MESH, device="cpu")
    params, opt, ef = init_fn(0)
    assert ef == {}
    batch = SyntheticLM(CFG, SHAPE).batch(0, "cpu")
    params, opt, ef, m = step_fn(params, opt, ef, batch, 0)
    assert bool(torch.isfinite(m["loss"])) and bool(torch.isfinite(m["grad_norm"]))
    assert tts.resolve_mesh(4) == {"data": 4}
    with pytest.raises(ValueError, match="either"):
        tts.resolve_mesh(4, MESH)
    with pytest.raises(NotPortedError, match="replicated"):
        tts.build_train_step(CFG, run, SHAPE, mesh={"pod": 8, "data": 1}, device="cpu")


@pytest.mark.parametrize("preset", ("multipod", "hier_fixed_k"))
def test_ef_rows_of_one_pod_stay_equal(preset):
    """Two error-feedback steps on (pod 2, data 2): each compressed bucket's
    residual rows agree within each pod and differ across pods."""
    if preset == "multipod":
        run = _multipod(error_feedback=True, mode="gather_decode")
    else:
        run = _run(tregistry.compression_preset("hier_fixed_k"), error_feedback=True)
    trainer = Trainer(CFG, run, SHAPE, TrainerConfig(steps=2, log_every=1), mesh=MESH,
                      device="cpu")
    _, _, hist = trainer.fit()
    assert all(np.isfinite(h["loss"]) for h in hist)
    assert trainer.ef_state
    for bid, e in trainer.ef_state.items():
        assert e.shape[0] == 4
        assert torch.equal(e[0], e[1]) and torch.equal(e[2], e[3]), bid
        assert not torch.equal(e[0], e[2]) and bool(e.abs().sum() > 0), bid


def test_mesh_stack_is_the_stacked_rank_order():
    a = np.arange(2 * 3 * 5, dtype=np.float32).reshape(2, 3, 5)
    got = convert.mesh_stack({"e": a}, {"pod": 2, "data": 3})["e"]
    assert got.shape == (6, 5)
    comm = tcoll.StackedComm(device="cpu", mesh={"pod": 2, "data": 3})
    for r in range(6):
        pod, data = comm.ranks_over(("pod",))[r], comm.ranks_over(("data",))[r]
        np.testing.assert_array_equal(got[r], a[pod, data])
    state = convert.ef_state(convert.mesh_stack({"e": a}, {"pod": 2, "data": 3}))["e"]
    assert torch.equal(state, torch.from_numpy(got))
    with pytest.raises(ValueError, match="mesh"):
        convert.mesh_stack({"e": a}, {"pod": 3, "data": 2})


def test_multipod_train_path_is_the_reference_config_cut():
    from repro_torch.launch import profile_sync
    from repro_torch.train import synthetic

    cfg, run, shape, mesh = synthetic.multipod_train_path()
    want = jregistry.get_run_config("qwen3-4b", "train_4k", multi_pod=True)
    assert dataclasses.replace(run, microbatches=want.microbatches) == convert.run_config(want)
    assert run.microbatches == 1 and mesh == {"pod": 2, "data": 4}
    assert shape.global_batch == 8 and cfg.num_layers == synthetic.LAYERS
    assert profile_sync.parse_mesh("pod=4,data=2") == synthetic.HIER_MESH
