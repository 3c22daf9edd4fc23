"""Checkpoint and restart through ``Trainer`` on the CPU, at the smoke config.

* A run of 2 steps that checkpoints, then a run to 4 steps from its
  directory, ends bit-equal to one uninterrupted 4-step run: parameters,
  ``m``, ``v``, ``step`` and the metrics of steps 2–3.  Batches and sync
  keys are functions of the step, so the resumed stream is the same.
* The reference's restore contract (``tests/distributed_checks/
  train_integration_check.py``): ``init_or_restore`` at the saved step
  equals the saved state exactly, under the saving run's 2 ranks and under
  1 (the elastic restore).
* Error feedback: the reference saves no residuals and restarts them at
  ``init_fn``'s zeros, and so does the port.  The resumed run equals an
  uninterrupted one whose residuals are zeroed at step 2.
"""
import dataclasses
import shutil

import pytest
import torch

from repro_torch.checkpoint import checkpointing as ckpt
from repro_torch.configs.base import RunConfig, ShapeSpec
from repro_torch.configs.registry import compression_preset, smoke_config
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.train import train_step as tts
from repro_torch.train.trainer import Trainer, TrainerConfig

# one intra-op thread: beside other test workers on a loaded machine, torch's
# thread pool stalls for tens of seconds
torch.set_num_threads(1)

CFG = smoke_config("qwen3-4b")
SHAPE = ShapeSpec("train_smoke", "train", 32, 4)
N = 2
# compressed buckets at the smoke size, as the training CLI's --smoke sets them
FIXED_K = dataclasses.replace(compression_preset("fixed_k_1bit", axes=("data",)),
                              min_compress_size=1024)
EF = dataclasses.replace(FIXED_K, error_feedback=True)


def _run(cmp):
    return RunConfig(attn_chunk_q=16, attn_chunk_k=16, remat=False, compression=cmp)


def _trainer(cmp, steps, ckpt_dir=None, n=N, **kw):
    tcfg = TrainerConfig(steps=steps, ckpt_dir=ckpt_dir, log_every=1, **kw)
    return Trainer(CFG, _run(cmp), SHAPE, tcfg, n=n, device="cpu")


def _bits(t):
    return t.contiguous().view(torch.int32)


def _assert_same_state(params, opt_state, want_params, want_opt):
    assert sorted(params) == sorted(want_params)
    for k in want_params:
        for got, want in ((params[k], want_params[k]), (opt_state.m[k], want_opt.m[k]),
                          (opt_state.v[k], want_opt.v[k])):
            assert got.dtype == want.dtype and torch.equal(_bits(got), _bits(want)), k
    assert opt_state.step.dtype == torch.int32 and torch.equal(opt_state.step, want_opt.step)


@pytest.fixture(scope="module")
def saved(tmp_path_factory):
    """A 2-step run that checkpoints at step 2: (its directory, params,
    opt_state)."""
    d = tmp_path_factory.mktemp("ckpt")
    tr = _trainer(FIXED_K, 2, str(d), ckpt_every=2)
    params, opt_state, _ = tr.fit()
    assert any(b.kind == "compressed" for b in tr.sync_plan.buckets)
    return d, params, opt_state


def test_resume_equals_uninterrupted(saved, tmp_path):
    d = tmp_path / "ckpt"
    shutil.copytree(saved[0], d)
    resumed = _trainer(FIXED_K, 4, str(d))
    params, opt_state, hist = resumed.fit()
    assert [h["step"] for h in hist] == [2, 3]
    assert ckpt.latest_step(str(d)) == 4
    want_params, want_opt, want_hist = _trainer(FIXED_K, 4).fit()
    _assert_same_state(params, opt_state, want_params, want_opt)
    assert int(opt_state.step) == 4
    for got, want in zip(hist, want_hist[2:]):
        assert all(got[k] == want[k] for k in ("step", "loss", "grad_norm", "lr")), (got, want)


@pytest.mark.parametrize("n", [2, 1], ids=["same_ranks", "elastic_half"])
def test_init_or_restore_equals_saved_state(saved, n):
    d, params, opt_state = saved
    start, p2, o2, ef = _trainer(FIXED_K, 2, str(d), n=n).init_or_restore()
    assert start == 2 and ef == {}
    _assert_same_state(p2, o2, params, opt_state)


def test_error_feedback_restarts_at_zero(tmp_path):
    first = _trainer(EF, 2, str(tmp_path), ckpt_every=2)
    first.fit()
    assert any(bool(e.abs().sum() > 0) for e in first.ef_state.values())
    resumed = _trainer(EF, 4, str(tmp_path))
    start, _, _, ef = resumed.init_or_restore()
    assert start == 2 and ef and all(not bool(e.any()) for e in ef.values())
    params, opt_state, _ = resumed.fit()

    # uninterrupted, with the residuals zeroed at step 2
    step_fn, init_fn, _ = tts.build_train_step(CFG, _run(EF), SHAPE, N, device="cpu")
    data = SyntheticLM(CFG, SHAPE, seed=0)
    want_params, want_opt, want_ef = init_fn(0)
    for step in range(4):
        if step == 2:
            want_ef = {k: torch.zeros_like(e) for k, e in want_ef.items()}
        want_params, want_opt, want_ef, _ = step_fn(want_params, want_opt, want_ef,
                                                    data.batch(step, "cpu"), step)
    _assert_same_state(params, opt_state, want_params, want_opt)
    assert sorted(resumed.ef_state) == sorted(want_ef)
    for k in want_ef:
        assert torch.equal(_bits(resumed.ef_state[k]), _bits(want_ef[k])), k
