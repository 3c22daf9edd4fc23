"""The train step with one rank per process (``DistComm`` over gloo)
against the stacked step (``StackedComm``), at the smoke config.

Each gloo worker builds ``build_train_step(..., comm=DistComm(...))`` and
takes 2 steps from ``init_fn(0)`` under the overlapped and the
post-backward schedule; the test runs the stacked step of the same config
in process.  Every rank must hold the stacked run's parameters, m, v and
losses bit for bit, and its own row of the stacked error-feedback
residuals; every rank must issue the bucket rounds in the same order (the
order NCCL needs), which under the overlapped schedule is the stacked
step's.  Meshes: world 2 and 4 on the flat ``data`` axis
(``fixed_k_1bit`` with error feedback; ``fixed_k_1bit``), and (pod 2,
data 2) under the multi-pod run config (``fixed_k_1bit`` over ``pod``,
the exact mean in each pod), with error feedback, in the world-4 workers'
process group after the flat mesh.

The training CLI: ``launch/train.py --smoke --dist gloo`` in 2 processes
prints the losses of ``--smoke --devices 2``.

Workers are spawned as tests/test_torch_collective.py spawns them, each
with one intra-op thread (``OMP_NUM_THREADS=1``), as this process runs.
"""
import dataclasses
import json
import os
import pathlib
import re
import sys

import numpy as np
import pytest
import torch

from repro_torch.configs import registry as tregistry
from repro_torch.configs.base import RunConfig, ShapeSpec
from repro_torch.core import types as ttypes
from repro_torch.data.pipeline import SyntheticLM
from repro_torch.launch import train as train_cli
from repro_torch.train import train_step as tts

# one intra-op thread: beside other test workers on a loaded machine, torch's
# thread pool stalls for tens of seconds
torch.set_num_threads(1)

ROOT = pathlib.Path(__file__).resolve().parent.parent
CFG = tregistry.smoke_config("qwen3-4b")
SHAPE = ShapeSpec("dist", "train", 32, 8)
STEPS = 2
MESHES = {"w2": {"data": 2}, "w4": {"data": 4}, "pod2_data2": {"pod": 2, "data": 2}}
WORLDS = {2: ("w2",), 4: ("w4", "pod2_data2")}      # the meshes each world's workers run


def _cmp(mesh_name: str, overlap: bool) -> ttypes.CompressionConfig:
    if mesh_name == "pod2_data2":
        cmp = dataclasses.replace(
            tregistry.get_run_config("qwen3-4b", "train_4k", multi_pod=True).compression,
            error_feedback=True, mode="gather_decode")
    else:
        cmp = dataclasses.replace(tregistry.compression_preset("fixed_k_1bit", axes=("data",)),
                                  error_feedback=mesh_name == "w2")
    return dataclasses.replace(cmp, min_compress_size=2048,
                               bucket=ttypes.BucketSpec(capacity=1 << 14, overlap=overlap))


def _run(mesh_name: str, overlap: bool) -> RunConfig:
    return RunConfig(attn_chunk_q=16, attn_chunk_k=16, remat=False,
                     compression=_cmp(mesh_name, overlap))


def _train(step_fn, init_fn):
    params, opt, ef = init_fn(0)
    data = SyntheticLM(CFG, SHAPE)
    losses = []
    for step in range(STEPS):
        params, opt, ef, m = step_fn(params, opt, ef, data.batch(step, "cpu"), step)
        losses.append(m["loss"])
    return params, opt, ef, torch.stack(losses)


_WORKER = r"""
import json, sys
sys.path.insert(0, sys.argv[1])
sys.path.insert(0, sys.argv[2])
import numpy as np, torch, torch.distributed as dist
torch.set_num_threads(1)
import test_torch_dist_train as t
from repro_torch.core.collectives import DistComm
from repro_torch.train import train_step as tts
import datetime
rank, port, out, world = int(sys.argv[3]), sys.argv[4], sys.argv[5], int(sys.argv[6])
dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", world_size=world,
                        rank=rank, timeout=datetime.timedelta(seconds=float(sys.argv[7])))
for mesh_name in t.WORLDS[world]:
    comm = DistComm(device="cpu", mesh=t.MESHES[mesh_name])
    for overlap in (True, False):
        rounds = []
        step_fn, init_fn, _ = tts.build_train_step(
            t.CFG, t._run(mesh_name, overlap), t.SHAPE, device="cpu", comm=comm,
            on_phase=lambda name, **st: rounds.append(st["rounds"].issued)
            if name == "sync" else None)
        params, opt, ef, losses = t._train(step_fn, init_fn)
        res = {"losses": losses.numpy()}
        for k in params:
            res["p." + k], res["m." + k], res["v." + k] = (
                params[k].numpy(), opt.m[k].numpy(), opt.v[k].numpy())
        for k, e in ef.items():
            res["ef." + k] = e.numpy()
        np.savez(f"{out}/{mesh_name}.{overlap}.{rank}.npz", **res)
        json.dump(rounds, open(f"{out}/{mesh_name}.{overlap}.{rank}.json", "w"))
dist.destroy_process_group()
"""


def _env():
    return {**os.environ, "OMP_NUM_THREADS": "1"}


@pytest.fixture(scope="module")
def gloo_runs(tmp_path_factory):
    """Runs the workers of both worlds at once, each world's meshes in one
    process group; returns the output directory."""
    from test_torch_collective import GLOO_INIT_TIMEOUT_S, GlooWorld

    tmp = tmp_path_factory.mktemp("dist_train")
    worlds = [GlooWorld(lambda port, world=world: [
        [sys.executable, "-c", _WORKER, str(ROOT / "src"), str(ROOT / "tests"), str(r), port,
         str(tmp), str(world), str(GLOO_INIT_TIMEOUT_S)] for r in range(world)], env=_env())
        for world in WORLDS]
    for world in worlds:
        world.wait()
    return tmp


def _bits(a):
    return np.asarray(a).view(np.int32)


@pytest.mark.parametrize("overlap", [True, False], ids=["overlapped", "post_backward"])
@pytest.mark.parametrize("name", sorted(MESHES))
def test_dist_step_equals_stacked(gloo_runs, name, overlap):
    tmp = gloo_runs
    mesh = MESHES[name]
    rounds = []
    step_fn, init_fn, plan = tts.build_train_step(
        CFG, _run(name, overlap), SHAPE, mesh=mesh, device="cpu",
        on_phase=lambda n, **st: rounds.append(st["rounds"].issued) if n == "sync" else None)
    params, opt, ef, losses = _train(step_fn, init_fn)
    assert plan is not None and bool(ef) == _cmp(name, overlap).error_feedback
    world = int(np.prod(list(mesh.values())))
    for r in range(world):
        with np.load(tmp / f"{name}.{overlap}.{r}.npz") as z:
            got = {k: z[k] for k in z.files}
        np.testing.assert_array_equal(_bits(got["losses"]), _bits(losses.numpy()), err_msg=f"{r}")
        for k in params:
            for pre, want in (("p.", params[k]), ("m.", opt.m[k]), ("v.", opt.v[k])):
                np.testing.assert_array_equal(_bits(got[pre + k]), _bits(want.numpy()),
                                              err_msg=f"{r} {pre}{k}")
        assert sorted(k[3:] for k in got if k.startswith("ef.")) == sorted(ef)
        for bid, e in ef.items():
            np.testing.assert_array_equal(_bits(got["ef." + bid][0]), _bits(e[r].numpy()),
                                          err_msg=f"{r} {bid}")
        issued = json.loads((tmp / f"{name}.{overlap}.{r}.json").read_text())
        assert issued == rounds, r


@pytest.mark.parametrize("name", sorted(MESHES))
def test_every_rank_issues_the_rounds_in_one_order(gloo_runs, name):
    """The rounds' issue order, per step, is the same on every rank; under
    the overlapped schedule it is the order the backward completes the
    buckets, not ``plan.schedule()``; post-backward it is the plan's."""
    tmp = gloo_runs
    world = int(np.prod(list(MESHES[name].values())))
    plan = tts.build_train_step(CFG, _run(name, True), SHAPE, mesh=MESHES[name],
                                device="cpu")[2]
    for overlap in (True, False):
        orders = [json.loads((tmp / f"{name}.{overlap}.{r}.json").read_text())
                  for r in range(world)]
        assert all(o == orders[0] for o in orders)
        assert len(orders[0]) == STEPS and orders[0][0] == orders[0][1]
        assert sorted(orders[0][0]) == sorted(b.bid for b in plan.buckets)
        if overlap:
            assert orders[0][0] != list(plan.schedule())
        else:
            assert orders[0][0] == [b.bid for b in plan.buckets]


STEP_LINE = re.compile(r"^step +(\d+)  loss (\S+)  gnorm (\S+)  lr (\S+)$", re.M)
CLI = ["--smoke", "--steps", "3", "--seq", "32", "--batch", "4", "--device", "cpu"]


def _gloo_cli(args):
    """Starts ``launch/train.py ARGS --dist gloo`` in 2 processes; returns a
    function that waits for them and returns their stdout."""
    from test_torch_collective import GlooWorld

    env = {**_env(), "PYTHONPATH": str(ROOT / "src"), "MASTER_ADDR": "127.0.0.1",
           "WORLD_SIZE": "2"}
    cmd = [sys.executable, "-m", "repro_torch.launch.train", *args, "--dist", "gloo"]
    world = GlooWorld(lambda port: [cmd, cmd], env=lambda port, r: {
        **env, "MASTER_PORT": port, "RANK": str(r), "LOCAL_RANK": str(r)})
    return lambda: [out for out, _ in world.wait()]


def test_cli_dist_gloo_prints_the_stacked_losses(tmp_path, capsys):
    """Also: rank 0 alone writes the checkpoints, and both ranks resume from
    them."""
    ckpt = ["--ckpt-dir", str(tmp_path / "ck"), "--ckpt-every", "2"]
    wait = _gloo_cli([*CLI, *ckpt, "--report", str(tmp_path / "gloo.json")])
    assert train_cli.main([*CLI, "--devices", "2", "--report", str(tmp_path / "st.json")]) == 0
    outs = wait()
    want = STEP_LINE.findall(capsys.readouterr().out)
    assert len(want) == 3
    assert STEP_LINE.findall(outs[0]) == want and not STEP_LINE.findall(outs[1])
    gloo, st = (json.loads((tmp_path / f).read_text()) for f in ("gloo.json", "st.json"))
    assert gloo["overlap"] and st["overlap"] and gloo["ranks"] == st["ranks"] == 2
    assert gloo["digest"] == st["digest"]
    assert [s["issued"] for s in gloo["steps"]] == [s["issued"] for s in st["steps"]]
    assert all(2 * g["wire_bytes"] == s["wire_bytes"] for g, s in zip(gloo["steps"], st["steps"]))
    assert sorted(os.listdir(tmp_path / "ck")) == ["step-00000002", "step-00000003"]
    outs = _gloo_cli([*CLI[:1], "--steps", "4", *CLI[3:], *ckpt])()
    assert [int(m[0]) for m in STEP_LINE.findall(outs[0])] == [3] and not outs[1].strip()


def test_cli_dist_refuses_stacked_ranks_and_a_missing_card(monkeypatch):
    with pytest.raises(ValueError, match="--devices"):
        train_cli.main(["--smoke", "--dist", "gloo", "--devices", "2", "--device", "cpu"])
    for k, v in {"RANK": "0", "WORLD_SIZE": "1", "LOCAL_RANK": "0", "MASTER_ADDR": "127.0.0.1",
                 "MASTER_PORT": "1"}.items():
        monkeypatch.setenv(k, v)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_cli.main(["--smoke", "--dist", "nccl"])
    with pytest.raises(ValueError, match="--device cpu"):
        train_cli.main(["--smoke", "--dist", "gloo"])
