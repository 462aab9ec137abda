"""What data-parallel training on several cards needs of nnx_ppo_tpu_torch,
checked on the CPU (no JAX counterpart: the JAX package runs one process
over all its devices):

* the kernel builds: processes that start together build each library
  once under its lock, and a process that finds the lock held waits and
  loads what the holder built (``ops/cuda_build.py``);
* the rank's card: ``make_mesh`` makes ``cuda:LOCAL_RANK`` the current
  device, and a bare ``"cuda"`` then means that card, so a state built
  on ``device="cuda"`` under the mesh is accepted (it raised before);
* the examples build on the mesh's device, after the mesh exists.

CUDA is monkeypatched where a test needs it to look present; nothing
here touches a card. What only cards can show is in
``tests/test_torch_gpu.py`` (two cards) and ``chip_smoke.py --cards N``.
"""

import stat
import sys
import threading

import pytest
import torch
import torch.distributed as dist

from nnx_ppo_tpu_torch.algorithms import ppo as ppo_module
from nnx_ppo_tpu_torch.core import device as device_module
from nnx_ppo_tpu_torch.examples import joystick_locomotion, multihost_dp
from nnx_ppo_tpu_torch.ops import cuda_build
from nnx_ppo_tpu_torch.parallel import distributed_initialize, make_mesh
from nnx_ppo_tpu_torch.parallel.mesh import Mesh

FAKE_NVCC = """#!{python}
import os, sys, time
out = sys.argv[sys.argv.index("-o") + 1]
with open({log!r}, "a") as f:
    f.write(os.path.basename(sys.argv[-1]) + "\\n")
time.sleep(0.3)
with open(out, "w") as f:
    f.write("built")
"""


@pytest.fixture
def fake_build(tmp_path, monkeypatch):
    """cuda_build on two sources in ``tmp_path``, with an ``nvcc`` that
    logs each compile, takes 0.3 s and writes its output."""
    csrc, log = tmp_path / "csrc", tmp_path / "nvcc.log"
    csrc.mkdir()
    for name in ("one", "two"):
        (csrc / f"{name}.cu").write_text(f"// {name}\n")
    nvcc = tmp_path / "nvcc"
    nvcc.write_text(FAKE_NVCC.format(python=sys.executable, log=str(log)))
    nvcc.chmod(nvcc.stat().st_mode | stat.S_IEXEC)
    monkeypatch.setattr(cuda_build, "CSRC_DIR", csrc)
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(cuda_build, "_nvcc", lambda: str(nvcc))
    return log


def test_processes_starting_together_build_each_library_once(fake_build):
    """Four builds at once (the four ranks, one card each, as threads:
    ``flock`` locks conflict between open files, in one process as across
    processes) over two libraries, one of them specialised by a define:
    each library compiled once, every caller handed the same paths, and a
    later build compiles nothing."""
    specs = ["one", ("two", ("-DX=1",))]
    start = threading.Barrier(4)
    results, errors = [None] * 4, []

    def rank(i):
        try:
            start.wait(timeout=10)
            results[i] = cuda_build.build(specs)
        except Exception as e:  # reported below
            errors.append(e)

    threads = [threading.Thread(target=rank, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads) and not errors, errors
    assert sorted(fake_build.read_text().split()) == ["one.cu", "two.cu"]
    assert all(r == results[0] for r in results)
    assert all(p.read_text() == "built" for p in results[0].values())
    cuda_build.build(specs)
    assert len(fake_build.read_text().split()) == 2


def test_a_held_lock_is_waited_for_and_its_library_loaded(fake_build):
    """While another holder has the lock of a library, ``build`` waits;
    once the holder has written the library and let go, ``build`` returns
    its path without compiling."""
    import fcntl

    target = cuda_build.library_path("one")
    target.parent.mkdir(parents=True)
    lock = open(target.with_suffix(".lock"), "a")
    fcntl.flock(lock, fcntl.LOCK_EX)
    got = []
    waiter = threading.Thread(target=lambda: got.append(cuda_build.build(["one"])))
    waiter.start()
    waiter.join(timeout=1.0)
    assert waiter.is_alive() and not got  # waiting on the lock
    target.write_text("built elsewhere")
    lock.close()
    waiter.join(timeout=30)
    assert not waiter.is_alive()
    assert got == [{("one", ()): target}] and target.read_text() == "built elsewhere"
    assert not fake_build.exists()  # nvcc never ran


@pytest.fixture
def cards(monkeypatch):
    """Four CUDA cards, as far as the code under test asks: available,
    initialized, card 0 current until ``set_device``, which is recorded."""
    current, calls = [0], []

    def set_device(device):
        calls.append(torch.device(device))
        current[0] = torch.device(device).index

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: current[0])
    monkeypatch.setattr(torch.cuda, "set_device", set_device)
    return calls


@pytest.fixture
def one_process_group():
    assert not dist.is_initialized()
    distributed_initialize(backend="gloo", store=dist.HashStore(), rank=0, world_size=1)
    yield
    dist.destroy_process_group()


def test_make_mesh_makes_the_local_ranks_card_current(cards, one_process_group, monkeypatch):
    """Local rank 3 of a node with four cards: the mesh's device is
    ``cuda:3`` and it is made the current device, once, when the mesh is
    made (before, nothing in the port called ``set_device``, so every
    rank's bare ``"cuda"`` and every device guard's restore meant card
    0)."""
    monkeypatch.setenv("LOCAL_RANK", "3")
    mesh = make_mesh()
    assert mesh.device == torch.device("cuda", 3)
    assert cards == [torch.device("cuda", 3)]
    assert torch.cuda.current_device() == 3


def test_make_mesh_on_the_cpu_sets_no_card(cards, one_process_group):
    assert make_mesh(device="cpu").device == torch.device("cpu") and cards == []


def test_a_bare_cuda_is_the_ranks_card(cards, monkeypatch):
    """With card 3 current, ``"cuda"`` resolves to ``cuda:3``, so
    ``state_device("cuda", mesh)`` accepts a mesh on card 3 (it raised
    "differs from the mesh's cuda:3" before); another card still raises.
    Before CUDA is initialized a bare ``"cuda"`` stays bare."""
    torch.cuda.set_device(torch.device("cuda", 3))
    mesh = Mesh(group=None, rank=3, world_size=4, device=torch.device("cuda", 3), backend="nccl")
    assert device_module.resolve_device("cuda") == torch.device("cuda", 3)
    assert ppo_module.state_device("cuda", mesh) == mesh.device
    assert ppo_module.state_device(None, mesh) == mesh.device
    with pytest.raises(ValueError, match="differs from the mesh"):
        ppo_module.state_device("cuda:0", mesh)
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: False)
    assert device_module.resolve_device("cuda") == torch.device("cuda")


@pytest.mark.parametrize("name", ["multihost_dp", "joystick_locomotion"])
def test_the_examples_build_on_the_mesh_device(name, monkeypatch):
    """Under torchrun with four ranks (``--distributed`` / ``WORLD_SIZE``
    4): the group and the mesh come first, then ``build`` on the mesh's
    device (before, both scripts built on ``"cuda"`` before the mesh
    existed), then ``train_ppo`` with the mesh."""
    script = {"multihost_dp": multihost_dp, "joystick_locomotion": joystick_locomotion}[name]
    events = []
    mesh = Mesh(group=None, rank=2, world_size=4, device=torch.device("cpu"), backend="gloo")
    build = script.build

    def recorded_build(args, device):
        events.append(("build", device))
        return build(args, device)

    class Result:
        eval_history = [{}]
        final_metrics = {}

    def train_ppo(env, networks, config, **kwargs):
        events.append(("train_ppo", kwargs["mesh"]))
        return Result()

    monkeypatch.setenv("WORLD_SIZE", "4")
    monkeypatch.setattr(script, "distributed_initialize", lambda **kw: events.append("group"))
    monkeypatch.setattr(script, "make_mesh", lambda **kw: events.append("mesh") or mesh)
    monkeypatch.setattr(script, "build", recorded_build)
    monkeypatch.setattr(script, "train_ppo", train_ppo)
    monkeypatch.setattr(dist, "destroy_process_group", lambda: None)
    script.main(["--cpu"] + (["--distributed"] if script is multihost_dp else []))
    assert events == ["group", "mesh", ("build", mesh.device), ("train_ppo", mesh)]
