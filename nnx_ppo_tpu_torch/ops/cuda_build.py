"""Build and load the port's hand-written CUDA kernels.

No JAX counterpart (Pallas kernels compile inside ``jax.jit``). Each
``nnx_ppo_tpu_torch/csrc/<name>.cu`` exports plain C entry points; it is
compiled with ``nvcc`` for ``sm_90a`` into a shared library under
``build/kernels/`` at the repository root (listed in ``.gitignore``) and
loaded with ``ctypes``. A source may be specialised by ``-D`` defines
(array sizes of ``control_step.cu``, ``plane_sampler.cu`` and
``scene_step.cu``) and may
include the headers ``csrc/*.cuh``; the library's file name carries a
hash of the source, of every header and of all flags, defines included,
so an edited source or header or another size is built anew and an
unchanged one is reused. What ptxas reports of each kernel (registers,
stack frame, spills, static shared memory) is kept beside the library and
read with :func:`ptxas_info`. Nothing is built at import time: the first
caller builds.

Processes that start together (one per card under ``torchrun``) build
each library once: the process that builds it holds an ``flock`` on a
``.lock`` file beside the library, and the others wait for it and load
what it built.
The operating system releases the lock when its holder exits, so a
build that was cut off leaves no stale lock behind.

Each kernel's wrapper counts its launches (:func:`counted`,
:func:`count_launch`): ``wrapper.launches`` in all, and
``wrapper.devices[i]`` on card ``i``.
"""

from __future__ import annotations

import collections
import contextlib
import ctypes
import fcntl
import hashlib
import os
import re
import shutil
import subprocess
import tempfile
from collections.abc import Mapping, Sequence
from pathlib import Path
from typing import Union

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

_LOADED: dict[tuple[str, tuple[str, ...]], ctypes.CDLL] = {}

# A kernel to build: its name, or (name, extra nvcc flags) for a source
# that is specialised by ``-D`` defines (or other flags).
Spec = Union[str, tuple[str, Sequence[str]]]


def define_flags(defines: Mapping[str, int]) -> tuple[str, ...]:
    """``-DNAME=value`` flags, in name order."""
    return tuple(f"-D{k}={int(v)}" for k, v in sorted(defines.items()))


def _nvcc() -> str:
    nvcc = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(nvcc):
        raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")
    return nvcc


def _normalize(spec: Spec) -> tuple[str, tuple[str, ...]]:
    if isinstance(spec, str):
        return spec, ()
    name, flags = spec
    return name, tuple(flags)


def library_path(name: str, flags: Sequence[str] = ()) -> Path:
    """Where the library of ``name`` built with the extra ``flags``
    lives: the file name carries a hash of source, headers, base flags
    and extra flags (defines included)."""
    source = (CSRC_DIR / f"{name}.cu").read_bytes()
    for header in sorted(CSRC_DIR.glob("*.cuh")):
        source += header.read_bytes()
    digest = hashlib.sha256(source + " ".join((*NVCC_FLAGS, *flags)).encode()).hexdigest()
    return BUILD_DIR / f"lib{name}_{digest[:16]}.so"


def _try_lock(held: contextlib.ExitStack, key: tuple[str, tuple[str, ...]]) -> bool:
    """Take the build lock of ``key``'s library without waiting, for as
    long as ``held`` is open; False where another process holds it."""
    lock = open(library_path(*key).with_suffix(".lock"), "a")
    try:
        fcntl.flock(lock, fcntl.LOCK_EX | fcntl.LOCK_NB)
    except BlockingIOError:
        lock.close()
        return False
    held.callback(lock.close)  # closing the file releases the lock
    return True


def build(specs: Sequence[Spec], verbose: bool = False) -> dict[tuple[str, tuple[str, ...]], Path]:
    """Compile every kernel in ``specs`` that is not built yet, one
    ``nvcc`` process per library, all started together, each under its
    build lock; a library whose lock another process holds is waited for
    and then loaded (or built here, if that build failed). What nvcc and
    ptxas (``-v``: registers, stack, spills) say goes into the library's
    ``.log`` beside it; ``verbose`` also prints it."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    keys = list(dict.fromkeys(_normalize(spec) for spec in specs))
    todo = [key for key in keys if not library_path(*key).exists()]
    while todo:
        with contextlib.ExitStack() as held:
            mine = [key for key in todo if _try_lock(held, key)]
            _compile([key for key in mine if not library_path(*key).exists()], verbose)
        todo = [key for key in todo if not library_path(*key).exists()]
        if todo:
            # Another process builds it: wait for its lock, then look again.
            with open(library_path(*todo[0]).with_suffix(".lock"), "a") as lock:
                fcntl.flock(lock, fcntl.LOCK_EX)
    return {key: library_path(*key) for key in keys}


def _compile(keys: Sequence[tuple[str, tuple[str, ...]]], verbose: bool) -> None:
    """Run nvcc for each of ``keys`` at once; raise if any fails."""
    procs = {}
    for key in keys:
        name, flags = key
        fd, tmp = tempfile.mkstemp(suffix=".so", dir=BUILD_DIR)
        os.close(fd)
        cmd = [_nvcc(), *NVCC_FLAGS, *flags, "-Xptxas", "-v", "-o", tmp,
               str(CSRC_DIR / f"{name}.cu")]
        procs[key] = (subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT), tmp)
    failures = []
    for (name, flags), (proc, tmp) in procs.items():
        output, _ = proc.communicate()
        text = output.decode(errors="replace")
        if proc.returncode != 0:
            os.unlink(tmp)
            failures.append(f"{name}.cu {' '.join(flags)}:\n{text}")
        else:
            library_path(name, flags).with_suffix(".log").write_text(text)
            os.replace(tmp, library_path(name, flags))
            if verbose and text.strip():
                print(f"nvcc {name}.cu {' '.join(flags)}:\n{text.strip()}")
    if failures:
        raise RuntimeError("nvcc failed for " + "\n".join(failures))


def counted(wrapper) -> None:
    """Give a kernel's wrapper its launch counts: ``wrapper.launches``
    (all) and ``wrapper.devices`` (a Counter by card index)."""
    wrapper.launches = 0
    wrapper.devices = collections.Counter()


def count_launch(wrapper, device, n: int = 1) -> None:
    """``n`` launches of ``wrapper``'s kernel on CUDA ``device``; called
    where the kernel launches (or a CUDA graph that holds it replays), and
    nowhere else."""
    wrapper.launches += n
    wrapper.devices[device.index] += n


def load(name: str, flags: Sequence[str] = ()) -> ctypes.CDLL:
    """The loaded library of kernel ``name`` (with the extra ``flags``),
    built on first use."""
    key = (name, tuple(flags))
    lib = _LOADED.get(key)
    if lib is None:
        lib = ctypes.CDLL(str(build([key])[key]))
        _LOADED[key] = lib
    return lib


def ptxas_info(name: str, flags: Sequence[str], kernel: str) -> dict[str, int]:
    """What ptxas reported, when the library of ``name`` with ``flags`` was
    built, of the ``__global__`` function whose name contains ``kernel``:
    registers per thread, stack frame, spill stores and loads and static
    shared memory, in bytes (dynamic shared memory is the launch's)."""
    log = library_path(name, flags).with_suffix(".log").read_text()
    info: dict[str, int] = {}
    current = None  # the function the next lines describe
    for line in log.splitlines():
        entry = re.search(r"Compiling entry function '([^']+)'", line)
        props = re.search(r"Function properties for (\S+)", line)
        if entry or props:
            current = (entry or props).group(1)
            continue
        if current is None or kernel not in current:
            continue
        stack = re.search(r"(\d+) bytes stack frame, (\d+) bytes spill stores, (\d+) bytes spill loads",
                          line)
        if stack:
            info.update(stack_bytes=int(stack.group(1)), spill_store_bytes=int(stack.group(2)),
                        spill_load_bytes=int(stack.group(3)))
        used = re.search(r"Used (\d+) registers", line)
        if used:
            smem = re.search(r"(\d+) bytes smem", line)
            info.update(registers=int(used.group(1)),
                        static_smem_bytes=int(smem.group(1)) if smem else 0)
    if "registers" not in info:
        raise RuntimeError(f"ptxas reported nothing of {kernel} in {name}.cu {' '.join(flags)}")
    return info
