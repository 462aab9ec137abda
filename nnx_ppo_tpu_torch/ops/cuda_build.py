"""Build and load the port's hand-written CUDA kernels.

No JAX counterpart (Pallas kernels compile inside ``jax.jit``). Each
``nnx_ppo_tpu_torch/csrc/<name>.cu`` exports plain C entry points; it is
compiled with ``nvcc`` for ``sm_90a`` into a shared library under
``build/kernels/`` at the repository root (listed in ``.gitignore``) and
loaded with ``ctypes``. The library's file name carries a hash of the
source and flags, so an edited source is rebuilt and an unchanged one is
reused. Nothing is built at import time: the first caller builds.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

CSRC_DIR = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
NVCC_FLAGS = (
    "-gencode",
    "arch=compute_90a,code=sm_90a",
    "-std=c++17",
    "-O3",
    "-shared",
    "-Xcompiler",
    "-fPIC",
)

_LOADED: dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return nvcc


def library_path(name: str) -> Path:
    source = (CSRC_DIR / f"{name}.cu").read_bytes()
    digest = hashlib.sha256(source + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}_{digest[:16]}.so"


def build(names: list[str]) -> dict[str, Path]:
    """Compile every kernel in ``names`` that is not built yet, one
    ``nvcc`` process per source, all started together."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        target = library_path(name)
        if target.exists():
            continue
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", tmp, str(CSRC_DIR / f"{name}.cu")]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT), tmp)
    failures = []
    for name, (proc, tmp) in procs.items():
        output, _ = proc.communicate()
        if proc.returncode != 0:
            os.unlink(tmp)
            failures.append(f"{name}.cu:\n{output.decode(errors='replace')}")
        else:
            os.replace(tmp, library_path(name))
    if failures:
        raise RuntimeError("nvcc failed for " + "\n".join(failures))
    return {name: library_path(name) for name in names}


def load(name: str) -> ctypes.CDLL:
    """The loaded library of kernel ``name``, built on first use."""
    lib = _LOADED.get(name)
    if lib is None:
        lib = ctypes.CDLL(str(build([name])[name]))
        _LOADED[name] = lib
    return lib
