"""The port stands alone: importing every module of ``repro_torch`` loads
neither JAX nor the JAX package, entry points refuse to run without a card
unless a device is given, and the kernel dispatch rule takes no mixed or
foreign devices."""
import pathlib
import subprocess
import sys

import pytest
import torch

from repro_torch import resolve_device
from repro_torch.configs.base import RunConfig, ShapeSpec
from repro_torch.configs.registry import list_archs, smoke_config
from repro_torch.core import collectives as tcoll
from repro_torch.examples import federated_mean, quickstart
from repro_torch.kernels import backend
from repro_torch.launch import bench_encode_speed, bench_flash, bench_wire
from repro_torch.models import model
from repro_torch.serving import engine
from repro_torch.train import train_step
from repro_torch.train.trainer import Trainer, TrainerConfig

ROOT = pathlib.Path(__file__).resolve().parent.parent

# one intra-op thread: beside other test workers on a loaded machine, torch's
# thread pool stalls for tens of seconds
torch.set_num_threads(1)

_IMPORT_ALL = r"""
import importlib, pkgutil, sys
sys.path.insert(0, sys.argv[1])
import repro_torch
for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch."):
    importlib.import_module(m.name)
bad = sorted(k for k in sys.modules if k.split(".")[0] in ("jax", "jaxlib", "repro"))
print("LOADED", len([k for k in sys.modules if k.startswith("repro_torch")]), "BAD", bad)
sys.exit(1 if bad else 0)
"""


def test_port_imports_no_jax_and_no_reference():
    res = subprocess.run([sys.executable, "-c", _IMPORT_ALL, str(ROOT / "src")],
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stdout + res.stderr
    assert "BAD []" in res.stdout


def test_chip_smoke_imports_no_jax():
    src = (ROOT / "chip_smoke.py").read_text()
    assert "import jax" not in src and "from repro." not in src and "import repro\n" not in src


def test_entry_points_raise_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        resolve_device()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tcoll.StackedComm(4)
    assert tcoll.StackedComm(4, "cpu").device == torch.device("cpu")
    cfg, run = smoke_config("qwen3-4b"), RunConfig()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        model.init(0, cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        engine.build_serve_fns(cfg, run, ShapeSpec("serve", "decode", 64, 4))
    assert model.init(0, cfg, device="cpu")["embed"].device == torch.device("cpu")
    shape = ShapeSpec("train", "train", 64, 4)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_step.build_train_step(cfg, run, shape, 2)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(cfg, run, shape, TrainerConfig(), 2)
    for entry in (quickstart.main, federated_mean.main, bench_encode_speed.main,
                  bench_flash.main, bench_wire.main):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            entry([])
    # before it builds another revision's kernels
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench_flash.main(["--baseline-bwd-source", str(ROOT / "missing" / "bwd.cu")])


@pytest.mark.parametrize("arch", list_archs())
def test_every_arch_runs_on_the_card_unless_asked(arch, monkeypatch):
    """Each registered arch's smoke model (the dense, VLM, MoE, SSM, hybrid
    and encoder-decoder families) refuses to run without a card unless a device
    is given."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg, run = smoke_config(arch), RunConfig()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        model.init(0, cfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        engine.build_serve_fns(cfg, run, ShapeSpec("serve", "decode", 64, 4))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_step.build_train_step(cfg, run, ShapeSpec("train", "train", 64, 4), 2)
    params = model.init(0, cfg, device="cpu")
    assert all(v.device == torch.device("cpu") for v in params.values())
    cache = model.make_cache(model.make_ctx(cfg, run), cfg, 2, 64, device="cpu")
    leaves = [v for part in cache.values() for v in (part.values() if isinstance(part, dict)
                                                      else [part])]
    assert leaves and all(v.device == torch.device("cpu") for v in leaves)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        model.make_cache(model.make_ctx(cfg, run), cfg, 2, 64)


def test_bench_wire_raises_without_a_card_before_building(monkeypatch, tmp_path):
    """The kernel-1/8/9 bench needs a card: with a baseline it fails before
    it starts nvcc on another revision's sources."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.setattr(bench_wire, "build_baseline", lambda d: pytest.fail("built"))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench_wire.main(["--baseline-dir", str(tmp_path), "--profile"])


def test_fwht_wrapper_checks_out():
    """fwht into `out` takes only a same-shaped f32 CUDA tensor."""
    from repro_torch.kernels.hadamard import hadamard as hk

    x = torch.zeros(2, 1024)
    with pytest.raises(ValueError, match="CUDA"):
        hk.fwht(x, out=x)


def test_dispatch_rule():
    cpu = torch.zeros(3)
    assert backend.use_plain(cpu, None, cpu)
    with pytest.raises(ValueError):
        backend.use_plain(cpu, torch.zeros(3, device="meta"))


def test_kernel_wrappers_reject_cpu_tensors():
    from repro_torch.kernels.bernoulli_encode import bernoulli_encode as bek
    from repro_torch.kernels.bernoulli_wire import kernel as bwk
    from repro_torch.kernels.binary_quant import binary_quant as bqk
    from repro_torch.kernels.bitplane import bitplane as bpk
    from repro_torch.kernels.fixed_k_encode import fixed_k_encode as fkk
    from repro_torch.kernels.flash_attention import kernel as fak
    from repro_torch.kernels.hadamard import hadamard as hk
    from repro_torch.kernels.rotated_encode import kernel as rek

    x = torch.zeros(2048)
    words = torch.zeros(64, dtype=torch.int32)
    with pytest.raises(ValueError, match="CUDA"):
        bpk.pack_bits(torch.zeros(64, dtype=torch.uint8), 1)
    with pytest.raises(ValueError, match="CUDA"):
        bpk.unpack_bits(words, 2, 1024)
    with pytest.raises(ValueError, match="CUDA"):
        bpk.binary_accum(words.reshape(2, 32), torch.zeros(2), torch.ones(2), 1024)
    with pytest.raises(ValueError, match="CUDA"):
        bwk.encode(x, torch.tensor([0, 1]), torch.tensor(0.0), p=0.5, cap=10)
    with pytest.raises(ValueError, match="CUDA"):
        fkk.fixed_k_gather(x, torch.tensor([0, 1]), 2.0, torch.tensor(0.0))
    with pytest.raises(ValueError, match="CUDA"):
        hk.fwht(x.reshape(2, 1024))
    with pytest.raises(ValueError, match="CUDA"):
        rek.rotate_minmax(x.reshape(2, 1024), x.reshape(2, 1024), 32.0)
    with pytest.raises(ValueError, match="CUDA"):
        rek.encode_pack(x, torch.tensor([0, 1]), torch.tensor(0.0), torch.tensor(1.0), 2048)
    with pytest.raises(ValueError, match="CUDA"):
        fak.flash_attention_fwd(torch.zeros(1, 64, 2, 64), torch.zeros(1, 64, 1, 64),
                                torch.zeros(1, 64, 1, 64))
    q, kv, lse = torch.zeros(1, 64, 2, 64), torch.zeros(1, 64, 1, 64), torch.zeros(1, 2, 64)
    with pytest.raises(ValueError, match="CUDA"):
        fak.flash_attention_bwd_dkv(q, kv, kv, q, lse, lse)
    with pytest.raises(ValueError, match="CUDA"):
        fak.flash_attention_bwd_dq(q, kv, kv, q, lse, lse)
    with pytest.raises(ValueError, match="CUDA"):
        bek.encode(x, 0.5, 0.0, 1)
    with pytest.raises(ValueError, match="CUDA"):
        bqk.encode(x, torch.tensor(0.0), torch.tensor(1.0), 1, 2048)
