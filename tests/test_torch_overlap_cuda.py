"""The backward-pipelined bucket sync on a card: the overlapped stacked
step against the post-backward one, and the side stream's ordering.

Marked ``cuda``; every test skips, with its reason, where no CUDA device is
present (decided in a fixture, never at import).  On a card:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_overlap_cuda.py

* At the smoke config (4 ranks stacked, fixed-k with error feedback), 2
  steps with overlap on and off give bit-identical parameters, m, v,
  losses and residuals; every overlapped round was issued before the
  backward's end (by its events), every post-backward one after it.
* The synced buffers are not read before their bucket's event: with each
  round held back on its side stream (``torch.cuda._sleep`` before it), the
  step's results are still the post-backward step's bits.
"""

import pytest
import torch

from repro_torch.configs.base import RunConfig, ShapeSpec
from repro_torch.configs.registry import smoke_config
from repro_torch.core import types as ttypes
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.launch.step_report import sync_timeline
from repro_torch.train import bucketing
from repro_torch.train import train_step as tts

torch.set_num_threads(1)

pytestmark = pytest.mark.cuda

CFG = smoke_config("qwen3-4b")
SHAPE = ShapeSpec("smoke", "train", 128, 8)


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the side stream and the kernels have no CPU mode")
    return torch.device("cuda")


def _run(overlap: bool) -> RunConfig:
    cmp = ttypes.CompressionConfig(
        encoder=ttypes.EncoderSpec(kind="fixed_k", fraction=1 / 16), mode="shared_support",
        axes=("data",), min_compress_size=1024, error_feedback=True,
        bucket=ttypes.BucketSpec(capacity=1 << 14, overlap=overlap))
    return RunConfig(attn_chunk_q=128, attn_chunk_k=128, remat=False, compression=cmp)


def _steps(dev, overlap: bool, steps: int = 2):
    seen = []
    events = {}

    def on_phase(name, **st):
        if name in ("start", "backward"):
            events[name] = torch.cuda.Event(enable_timing=True)
            events[name].record()
        if name == "sync":
            seen.append((st["rounds"], events["start"], events["backward"]))

    step_fn, init_fn, plan = tts.build_train_step(CFG, _run(overlap), SHAPE, 4, device=dev,
                                                  on_phase=on_phase)
    params, opt, ef = init_fn(0)
    data = SyntheticLM(CFG, SHAPE)
    losses = []
    for step in range(steps):
        params, opt, ef, m = step_fn(params, opt, ef, data.batch(step, dev), step)
        losses.append(m["loss"])
    torch.cuda.synchronize()
    return params, opt, ef, torch.stack(losses), seen, plan


def _same(a, b):
    return a.dtype == b.dtype and torch.equal(a.view(torch.int32), b.view(torch.int32))


def _assert_same_state(a, b):
    (p1, o1, e1, l1, _, _), (p0, o0, e0, l0, _, _) = a, b
    assert _same(l1, l0)
    for k in p0:
        assert _same(p1[k], p0[k]) and _same(o1.m[k], o0.m[k]) and _same(o1.v[k], o0.v[k]), k
    assert sorted(e1) == sorted(e0) and e0
    assert all(_same(e1[k], e0[k]) for k in e0)


def test_overlapped_step_equals_post_backward_on_a_card(dev):
    on, off = _steps(dev, True), _steps(dev, False)
    _assert_same_state(on, off)
    rounds, start, bwd = on[4][-1]
    plan = on[5]
    assert sorted(rounds.issued) == sorted(b.bid for b in plan.buckets)
    assert sorted(rounds.events) == sorted(rounds.issued)
    line = sync_timeline(start, bwd, rounds)
    for bid, (issued, done) in line["rounds_ms"].items():
        assert issued <= done, bid
        assert issued <= 0.0, bid          # issued from inside the backward
    assert line["exposed_sync_ms"] >= 0.0
    rounds, start, bwd = off[4][-1]
    assert rounds.issued == [b.bid for b in plan.buckets]
    assert all(v[0] >= 0.0 for v in sync_timeline(start, bwd, rounds)["rounds_ms"].values())


def test_synced_buffers_wait_for_their_rounds(dev, monkeypatch):
    """Each round starts only after 2·10⁷ clock cycles of ``_sleep`` on the
    side stream: were the norm or AdamW to read a bucket's output before its
    event, the step would differ from the post-backward one."""
    round_fn = bucketing._bucket_round

    def late_round(*args, **kwargs):
        torch.cuda._sleep(20_000_000)
        return round_fn(*args, **kwargs)

    off = _steps(dev, False, steps=1)
    monkeypatch.setattr(bucketing, "_bucket_round", late_round)
    on = _steps(dev, True, steps=1)
    _assert_same_state(on, off)
