"""Build, load and dispatch for the port's hand-written CUDA kernels.

Three jobs, and no backend switch:

* **build** — each ``csrc/<name>.cu`` is compiled by ``nvcc`` for Hopper
  (``sm_90a``) into ``build/kernels/lib<name>.so`` at the repository root on
  first use, with a plain C interface, and loaded with ctypes.  Every source
  is compiled by its own ``nvcc`` process, all started together
  (:func:`build`).  A library is rebuilt when any ``csrc`` file is newer.
* **launch counters** — each kernel wrapper adds one to
  ``launches[<kernel name>]`` where it launches its kernel, and nowhere else,
  so a run can show that the main path went through the kernels.
* **dispatch rule** (:func:`use_plain`) — a CPU tensor goes to the plain
  PyTorch version; a CUDA tensor goes to the kernel or raises.  Nothing ever
  falls back from the kernel to the plain version.

Nothing here runs at import: modules are imported on machines without a
CUDA toolkit (the CPU tests import every one), so ``nvcc`` runs only when a
wrapper first launches a kernel.
"""
from __future__ import annotations

import collections
import ctypes
import os
import pathlib
import shutil
import subprocess
import tempfile
from typing import Dict, Iterable, Optional

import torch

CSRC = pathlib.Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = pathlib.Path(__file__).resolve().parents[3] / "build" / "kernels"
# one shared library per source file; kernels.<pkg> wrappers name theirs
SOURCES = ("bernoulli_encode", "bernoulli_wire", "binary_quant", "bitplane", "fixed_k_encode",
           "flash_attention", "flash_attention_bwd", "hadamard", "rotated_encode")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC")

# launch counts per kernel wrapper name (see module docstring)
launches: collections.Counter = collections.Counter()

_LIBS: Dict[str, ctypes.CDLL] = {}


def reset_launches() -> None:
    launches.clear()


def nvcc_path() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    cand = pathlib.Path(home) / "bin" / "nvcc"
    if cand.exists():
        return str(cand)
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, /usr/local/cuda/bin)")


def _lib_path(name: str) -> pathlib.Path:
    return BUILD_DIR / f"lib{name}.so"


def _stale(name: str) -> bool:
    out = _lib_path(name)
    if not out.exists():
        return True
    newest = max(p.stat().st_mtime for p in CSRC.iterdir())
    return out.stat().st_mtime < newest


def build(names: Iterable[str] = SOURCES) -> Dict[str, float]:
    """Compile the stale ``csrc/<name>.cu`` sources in parallel.

    One ``nvcc`` per source, all started before any is waited on; each
    writes to a temporary file renamed into place, so a concurrent reader
    never loads a half-written library.  Returns the build seconds per
    library built.
    """
    import time

    names = [n for n in names if _stale(n)]
    if not names:
        return {}
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = nvcc_path()
    procs = {}
    t0 = time.perf_counter()
    for name in names:
        fd, tmp = tempfile.mkstemp(prefix=f"lib{name}.", suffix=".so.tmp",
                                   dir=BUILD_DIR)
        os.close(fd)
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", tmp, str(CSRC / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp)
    seconds = {}
    errors = []
    for name, (proc, tmp) in procs.items():
        out, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {name}.cu:\n{out}")
            pathlib.Path(tmp).unlink(missing_ok=True)
            continue
        os.replace(tmp, _lib_path(name))
    if errors:
        raise RuntimeError("\n".join(errors))
    return seconds


def lib(name: str) -> ctypes.CDLL:
    """The loaded kernel library ``name``, built on first use."""
    if name not in _LIBS:
        build([name])
        _LIBS[name] = ctypes.CDLL(str(_lib_path(name)))
    return _LIBS[name]


def use_plain(*tensors: Optional[torch.Tensor]) -> bool:
    """THE dispatch rule: True iff every tensor lies on the CPU.

    False iff every tensor lies on a CUDA device (the caller then launches
    its kernel, which raises on anything it does not take).  Mixed or other
    devices raise.  ``None`` entries are ignored.
    """
    devs = {t.device.type for t in tensors if t is not None}
    if devs == {"cpu"}:
        return True
    if devs == {"cuda"}:
        return False
    raise ValueError(f"tensors must all lie on the CPU or all on CUDA; got {devs}")


def check(t: torch.Tensor, name: str, dtype: torch.dtype, shape=None,
          contiguous: bool = True) -> None:
    """Wrapper-side validation of one kernel argument (device, dtype,
    shape, contiguity); raises ValueError on anything the kernel does not
    take."""
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype != dtype:
        raise ValueError(f"{name}: expected {dtype}, got {t.dtype}")
    if shape is not None and tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
    if contiguous and not t.is_contiguous():
        raise ValueError(f"{name}: expected a contiguous tensor")


def check_launch(err: int, what: str) -> None:
    """Raise if a C entry point returned a nonzero cudaError_t."""
    if err != 0:
        raise RuntimeError(f"CUDA launch of {what} failed: cudaError_t {err}")


def stream_ptr(device: torch.device) -> int:
    return torch.cuda.current_stream(device).cuda_stream
