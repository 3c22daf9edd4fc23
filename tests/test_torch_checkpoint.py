"""The port's checkpoints: the reference's four tests (``tests/test_checkpoint.py``)
ported, the on-disk format read both ways, and the atomic commit.

A checkpoint written by the reference's ``ckpt.save`` restores in the port,
and one written by the port's ``save`` restores in the reference's
``ckpt.restore`` on a one-device mesh, bit for bit: the format is the same
and numpy holds every leaf (f32 parameters and moments, an int32 step)
unchanged.  The port keeps no sharding, so the reference's elastic restore
is a restore under another rank count: a 4-rank trainer's checkpoint is
what a 2-rank trainer starts from.  The state passes between the packages
as numpy.
"""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import checkpointing as jckpt
from repro.optim import optimizers as jopt
from repro_torch.checkpoint import checkpointing as ckpt
from repro_torch.configs.base import RunConfig, ShapeSpec
from repro_torch.configs.registry import compression_preset, smoke_config
from repro_torch.optim import optimizers as topt
from repro_torch.train.trainer import Trainer, TrainerConfig

# one intra-op thread: beside other test workers on a loaded machine, torch's
# thread pool stalls for tens of seconds
torch.set_num_threads(1)

D = 64
SPECS = {"w": (None, None), "layers.norm": (None, None)}


def _np_state(seed):
    """Parameters and an AdamW state of numpy leaves, as after a few steps."""
    rng = np.random.default_rng(seed)
    params = {"w": rng.standard_normal((D, D), np.float32),
              "layers.norm": rng.standard_normal((4, D), np.float32)}
    m = {k: rng.standard_normal(v.shape, np.float32) for k, v in params.items()}
    v = {k: np.abs(rng.standard_normal(p.shape, np.float32)) for k, p in params.items()}
    return params, np.int32(5), m, v


def _torch_state(seed):
    params, step, m, v = _np_state(seed)
    t = lambda tree: {k: torch.from_numpy(a) for k, a in tree.items()}
    return t(params), topt.AdamWState(step=torch.tensor(step), m=t(m), v=t(v))


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a.view(np.uint32) if a.dtype == np.float32 else a,
                                  b.view(np.uint32) if b.dtype == np.float32 else b)


def _same_state(params, opt_state, want_params, want_opt):
    assert sorted(params) == sorted(want_params)
    for k in want_params:
        _same(params[k], want_params[k])
        _same(opt_state.m[k], want_opt.m[k])
        _same(opt_state.v[k], want_opt.v[k])
    _same(opt_state.step, want_opt.step)


def test_save_restore_roundtrip(tmp_path):
    params, st = _torch_state(0)
    ckpt.save(str(tmp_path), 7, params, st, SPECS)
    step, p2, st2, extra = ckpt.restore(str(tmp_path), SPECS, st, device="cpu")
    assert step == 7 and extra == {}
    assert st2.step.dtype == torch.int32 and st2.step.shape == ()
    _same_state(p2, st2, params, st)


def test_latest_and_retention(tmp_path):
    params, st = _torch_state(1)
    for s in (1, 2, 3, 4, 5):
        ckpt.save(str(tmp_path), s, params, st, SPECS, keep_last=2)
    assert ckpt.latest_step(str(tmp_path)) == 5
    kept = sorted(d for d in os.listdir(tmp_path) if d.startswith("step-"))
    assert kept == ["step-00000004", "step-00000005"]


def test_elastic_restore_under_fewer_ranks(tmp_path):
    """Saved from a 4-rank trainer's state, restored by a 2-rank trainer:
    the same parameters and optimizer state, bit for bit."""
    cfg = smoke_config("qwen3-4b")
    shape = ShapeSpec("train_smoke", "train", 32, 4)
    run = RunConfig(attn_chunk_q=16, attn_chunk_k=16, remat=False,
                    compression=compression_preset("fixed_k_1bit", axes=("data",)))
    tcfg = TrainerConfig(steps=1, ckpt_dir=str(tmp_path), log_every=1)
    params, opt_state, _ = Trainer(cfg, run, shape, tcfg, n=4, device="cpu").fit()
    start, p2, o2, _ = Trainer(cfg, run, shape, tcfg, n=2, device="cpu").init_or_restore()
    assert start == 1 and int(o2.step) == 1
    _same_state(p2, o2, params, opt_state)


def test_async_checkpointer(tmp_path):
    params, st = _torch_state(3)
    ac = ckpt.AsyncCheckpointer()
    ac.save(str(tmp_path), 11, params, st, SPECS)
    ac.wait()
    assert ckpt.latest_step(str(tmp_path)) == 11
    # the thread wrote host copies: later writes to the tensors do not reach it
    w = params["w"].clone()
    ac.save(str(tmp_path), 12, params, st, SPECS)
    params["w"].add_(1.0)
    ac.wait()
    _, p2, _, _ = ckpt.restore(str(tmp_path), SPECS, st, device="cpu")
    _same(p2["w"], w)
    assert [h["step"] for h in ac.history] == [11, 12]
    assert all(h["write_ms"] >= 0 and h["copy_ms"] == 0.0 for h in ac.history)


def test_reference_checkpoint_restores_in_the_port(tmp_path):
    params, step, m, v = _np_state(4)
    jparams = {k: jnp.asarray(a) for k, a in params.items()}
    jst = jopt.AdamWState(step=jnp.asarray(step), m={k: jnp.asarray(a) for k, a in m.items()},
                          v={k: jnp.asarray(a) for k, a in v.items()})
    jckpt.save(str(tmp_path), 9, jparams, jst, SPECS, extra={"arch": "reference"})
    _, tst = _torch_state(4)
    got_step, p2, st2, extra = ckpt.restore(str(tmp_path), SPECS, tst, device="cpu")
    assert got_step == 9 and extra == {"arch": "reference"}
    _same_state(p2, st2, params, topt.AdamWState(step=step, m=m, v=v))


def test_port_checkpoint_restores_in_the_reference(tmp_path):
    params, st = _torch_state(5)
    ckpt.save(str(tmp_path), 13, params, st, SPECS, extra={"arch": "port"})
    mesh = jax.make_mesh((1,), ("data",))
    template = jopt.AdamWState(step=jnp.zeros((), jnp.int32), m={}, v={})
    step, p2, st2, extra = jckpt.restore(str(tmp_path), mesh, SPECS, template)
    assert step == 13 and extra == {"arch": "port"}
    np_st = topt.AdamWState(step=st.step.numpy(), m={k: t.numpy() for k, t in st.m.items()},
                            v={k: t.numpy() for k, t in st.v.items()})
    _same_state({k: np.asarray(a) for k, a in p2.items()},
                jopt.AdamWState(step=np.asarray(st2.step), m={k: np.asarray(a) for k, a
                                                              in st2.m.items()},
                                v={k: np.asarray(a) for k, a in st2.v.items()}),
                {k: t.numpy() for k, t in params.items()}, np_st)


def test_uncommitted_save_is_not_a_checkpoint(tmp_path):
    """A crash mid-save leaves ``tmp-<step>``: it is not a checkpoint, and
    the newest committed step is what restores."""
    params, st = _torch_state(6)
    ckpt.save(str(tmp_path), 3, params, st, SPECS)
    os.makedirs(tmp_path / "tmp-8")
    (tmp_path / "tmp-8" / "arrays.npz").write_bytes(b"half written")
    assert ckpt.latest_step(str(tmp_path)) == 3
    step, p2, st2, _ = ckpt.restore(str(tmp_path), SPECS, st, device="cpu")
    assert step == 3
    _same_state(p2, st2, params, st)
    with pytest.raises(FileNotFoundError):
        ckpt.restore(str(tmp_path / "empty"), SPECS, st, device="cpu")
    with pytest.raises(ValueError, match="holds parameters"):
        ckpt.restore(str(tmp_path), {"w": (None, None)}, st, device="cpu")
