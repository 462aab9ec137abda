"""The example scripts of ``nnx_ppo_tpu_torch/examples/`` against the JAX
package's ``examples/``, script for script.

* Flags: the option strings (and their defaults, types, choices and
  actions) of each JAX script's ``add_argument`` calls, read with ``ast``,
  equal the port parser's, apart from the additions listed in
  ``ADDED_FLAGS``.
* Configs, envs and nets: each JAX ``main`` runs under a patched
  ``sys.argv`` until it reaches ``train_ppo`` (or ``train_distillation``),
  which records its arguments and stops the run (nothing is compiled).
  The ``TrainConfig`` it built equals the port's ``build(...)`` field for
  field; the env class and its settings (model, time limit, terrain, DR
  ranges, pushes, obs noise, height scan) match; the JAX net, carried
  across by ``convert.load_jax_leaves``, gives the port's net the same
  outputs on one seeded observation batch (float32, rtol 1e-5 / atol
  1e-6; JAX at 'highest' matmul precision, tests/conftest.py).
* Each port script's ``main --cpu`` end to end at 4 envs, one PPO
  iteration and one eval of 2 envs x 5 steps, writing its CSV with the
  JAX script's columns; without ``--cpu`` and without a GPU, a
  ``RuntimeError``; and every script imports with ``jax``,
  ``nnx_ppo_tpu`` and ``examples`` hidden.

The JAX examples set ``jax_compilation_cache_dir`` and the persistent
cache's minimum compile time at import and insert into ``sys.path``;
both are put back after each import (``_jax_state_kept``).
"""

from __future__ import annotations

import argparse
import ast
import contextlib
import csv
import dataclasses
import enum
import functools
import importlib
import importlib.util
import os
import subprocess
import sys
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nnx_ppo_tpu.core.struct import partition_params
from nnx_ppo_tpu_torch.convert import load_jax_leaves

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
JAX_EXAMPLES = os.path.join(ROOT, "examples")
TOL = dict(rtol=1e-5, atol=1e-6)

SCRIPTS = ["learning_curves", "legged_training", "arm_reaching", "arm_pushing",
           "distill_quadruped", "mjcf_import", "joystick_locomotion", "multihost_dp",
           "wandb_logging"]
# The port's flags that JAX's scripts lack: --cpu where the JAX script
# has none (it picks its platform from the environment), and
# mjcf_import's --from-saved (the saved import, for machines without
# mujoco).
ADDED_FLAGS = {
    "learning_curves": {"--cpu"},
    "mjcf_import": {"--cpu", "--from-saved"},
    "joystick_locomotion": {"--cpu"},
    "multihost_dp": {"--cpu"},
    "wandb_logging": {"--cpu"},
}
# case -> (script, JAX argv, the port's extra argv)
CASES = {
    "learning_curves": ("learning_curves", [], []),
    "legged_training": ("legged_training", [], []),
    "legged_training_humanoid_full": ("legged_training", ["--env", "humanoid",
                                                          "--full-contact"], []),
    "legged_training_rough_hfield": ("legged_training", [
        "--rough", "--hfield", "--randomize", "--privileged", "--push", "--obs-noise", "0.05",
        "--fast-mass-matrix"], []),
    "legged_training_stairs": ("legged_training", ["--stairs"], []),
    "arm_reaching": ("arm_reaching", [], []),
    "arm_pushing": ("arm_pushing", [], []),
    "distill_quadruped": ("distill_quadruped", [], []),
    "mjcf_import": ("mjcf_import", [], []),
    "mjcf_import_from_saved": ("mjcf_import", [], ["--from-saved"]),
    "joystick_locomotion": ("joystick_locomotion", [], []),
    "multihost_dp": ("multihost_dp", [], []),
    "wandb_logging": ("wandb_logging", [], []),
}
# The CSV columns of the JAX scripts that write one
# (learning_curves.py:80, legged_training.py:263, arm_reaching.py:92,
# arm_pushing.py:92).
CSV_COLUMNS = {
    "learning_curves": ["impl", "step", "reward_mean", "reward_std"],
    "legged_training": ["step", "tracking", "penalty", "lifespan"],
    "arm_reaching": ["step", "reward"],
    "arm_pushing": ["step", "reward"],
}


def port_module(script: str):
    return importlib.import_module(f"nnx_ppo_tpu_torch.examples.{script}")


@contextlib.contextmanager
def _jax_state_kept():
    """Put back the JAX settings and ``sys.path`` that the JAX examples
    change at import, so later tests on this worker keep conftest's."""
    names = ("jax_compilation_cache_dir", "jax_persistent_cache_min_compile_time_secs")
    saved = {name: getattr(jax.config, name) for name in names}
    path = list(sys.path)
    try:
        yield
    finally:
        for name, value in saved.items():
            jax.config.update(name, value)
        sys.path[:] = path


@functools.lru_cache(maxsize=None)
def jax_example(script: str):
    """The JAX script ``examples/<script>.py`` as a module of its own name
    (``jax_examples_<script>``), imported once."""
    spec = importlib.util.spec_from_file_location(
        f"jax_examples_{script}", os.path.join(JAX_EXAMPLES, f"{script}.py"))
    module = importlib.util.module_from_spec(spec)
    with _jax_state_kept():
        sys.path.insert(0, ROOT)  # distill_quadruped imports examples.legged_training
        spec.loader.exec_module(module)
    return module


class _Reached(Exception):
    """Raised by the recording train_ppo: the JAX run stops there."""


@functools.lru_cache(maxsize=None)
def captured(case: str) -> dict:
    """What JAX's ``main`` and the port's ``build`` make for ``case``:
    ``env``, ``nets`` (a tuple) and ``configs`` (a tuple), each side. A
    ``total_steps=`` given to JAX's ``train_ppo`` / ``train_distillation``
    is folded into the config, as those functions do."""
    script, jax_argv, port_extra = CASES[case]
    module = jax_example(script)
    calls = []

    def record(*args, **kwargs):
        calls.append((args, kwargs))
        raise _Reached

    def teacher_trained(*args, **kwargs):
        calls.append((args, kwargs))
        return types.SimpleNamespace(training_state=types.SimpleNamespace(networks=args[1]))

    patches = {"train_ppo": record}
    if script == "distill_quadruped":
        patches = {"train_ppo": teacher_trained, "train_distillation": record,
                   "eval_tracking": lambda *a, **k: 1.0}
    saved = {name: getattr(module, name) for name in patches}
    argv = sys.argv
    try:
        for name, value in patches.items():
            setattr(module, name, value)
        sys.argv = [f"{script}.py", *jax_argv]
        with _jax_state_kept(), pytest.raises(_Reached):
            module.main()
    finally:
        sys.argv = argv
        for name, value in saved.items():
            setattr(module, name, value)

    configs, nets = [], []
    for args, kwargs in calls:
        config = args[-1]
        total = kwargs.get("total_steps")
        if total is not None:
            key = "ppo" if hasattr(config, "ppo") else "distillation"
            config = dataclasses.replace(config, **{
                key: dataclasses.replace(getattr(config, key), total_steps=total)})
        configs.append(config)
        nets.extend(args[1:-1])
    if script == "distill_quadruped":
        nets = nets[1:]  # the teacher once: (teacher, student)
    port = port_module(script)
    args = port.make_parser().parse_args([*jax_argv, *port_extra])
    env, port_nets, port_configs = port.build(args, "cpu")
    return {
        "jax": (calls[0][0][0], tuple(nets), tuple(configs)),
        "port": (env, port_nets if isinstance(port_nets, tuple) else (port_nets,),
                 port_configs if isinstance(port_configs, tuple) else (port_configs,)),
    }


# -- flags -------------------------------------------------------------------------


def _literal(node):
    try:
        return ast.literal_eval(node)
    except ValueError:
        return ast.unparse(node)  # a name such as int or float


def jax_flags(script: str) -> dict:
    """Option string -> (default, type, choices, action) of every
    ``add_argument`` call of the JAX script, read with ``ast``."""
    tree = ast.parse(open(os.path.join(JAX_EXAMPLES, f"{script}.py")).read())
    flags = {}
    for node in ast.walk(tree):
        if (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                and node.func.attr == "add_argument"):
            kw = {k.arg: _literal(k.value) for k in node.keywords}
            flags[_literal(node.args[0])] = (
                kw.get("default", False if kw.get("action") == "store_true" else None),
                kw.get("type"), kw.get("choices"), kw.get("action"))
    return flags


def port_flags(script: str) -> dict:
    flags = {}
    for action in port_module(script).make_parser()._actions:
        for option in action.option_strings:
            if option in ("-h", "--help"):
                continue
            kind = None if action.type is None else action.type.__name__
            store_true = isinstance(action, argparse._StoreTrueAction)
            choices = None if action.choices is None else list(action.choices)
            flags[option] = (action.default, None if store_true else kind, choices,
                             "store_true" if store_true else None)
    return flags


@pytest.mark.parametrize("script", SCRIPTS)
def test_flags_match_the_jax_script(script):
    want, got = jax_flags(script), port_flags(script)
    assert set(got) == set(want) | ADDED_FLAGS.get(script, set())
    for option, spec in want.items():
        assert got[option] == spec, option


# -- configs, envs, nets -----------------------------------------------------------


def plain(x):
    """A config as nested dicts of plain values (flags by value)."""
    if dataclasses.is_dataclass(x):
        return {f.name: plain(getattr(x, f.name)) for f in dataclasses.fields(x)}
    if isinstance(x, enum.Flag):
        return x.value
    if isinstance(x, (list, tuple)):
        return tuple(plain(v) for v in x)
    return x


@pytest.mark.parametrize("case", CASES)
def test_config_matches_the_jax_script(case):
    c = captured(case)
    jax_configs, port_configs = c["jax"][2], c["port"][2]
    assert [type(x).__name__ for x in port_configs] == [type(x).__name__ for x in jax_configs]
    assert plain(port_configs) == plain(jax_configs)


_SKIP = object()


def comparable(v):
    """A plain value to compare, or _SKIP (modules, functions, runners)."""
    if isinstance(v, torch.Tensor):
        return v.numpy()
    if isinstance(v, (jax.Array, np.ndarray)):
        return np.asarray(v)
    if isinstance(v, (bool, int, float, str, type(None))):
        return v
    if isinstance(v, dict) and all(isinstance(x, (int, str)) for x in v.values()):
        return dict(v)
    if isinstance(v, (tuple, list)):
        try:
            return np.asarray(v, dtype=np.float64)
        except (TypeError, ValueError):
            return tuple(v) if all(isinstance(x, str) for x in v) else _SKIP
    return _SKIP


def assert_settings_equal(got, want, where: str) -> int:
    """Every public attribute of ``want`` that ``got`` also has and both
    hold as plain values: equal (arrays to float32 rounding). Models,
    terrains and DR configs are compared field by field. Returns the
    number compared."""
    n = 0
    names = [*vars(want), *(k for k in ("observation_size", "action_size") if k not in vars(want)
                            and hasattr(want, k))]
    for name in names:
        if name.startswith("_") or not hasattr(got, name):
            continue
        value, mine = getattr(want, name), getattr(got, name)
        if name in ("model", "terrain", "randomize"):
            assert type(mine).__name__ == type(value).__name__, f"{where}.{name}"
            if value is not None:
                n += assert_settings_equal(mine, value, f"{where}.{name}")
            continue
        a, b = comparable(mine), comparable(value)
        if a is _SKIP or b is _SKIP:
            continue
        if isinstance(b, np.ndarray):
            np.testing.assert_allclose(np.asarray(a, dtype=np.float64),
                                       np.asarray(b, dtype=np.float64), **TOL,
                                       err_msg=f"{where}.{name}")
        else:
            assert a == b, (f"{where}.{name}", a, b)
        n += 1
    return n


@pytest.mark.parametrize("case", CASES)
def test_env_matches_the_jax_script(case):
    c = captured(case)
    jax_env, port_env = c["jax"][0], c["port"][0]
    assert port_env.max_len == jax_env.max_len
    assert type(port_env.env).__name__ == type(jax_env.env).__name__
    n = assert_settings_equal(port_env.env, jax_env.env, type(jax_env.env).__name__)
    assert n >= 2  # at least the observation and action sizes


def np_leaves(tree):
    """JAX tree -> the same tree with numpy leaves; PRNG keys -> None."""
    return jax.tree.map(
        lambda x: None if jnp.issubdtype(x.dtype, jax.dtypes.prng_key) else np.asarray(x), tree)


def output_leaves(x) -> list:
    """The leaves of a network output, dicts in key order."""
    if isinstance(x, dict):
        return [leaf for k in sorted(x) for leaf in output_leaves(x[k])]
    if dataclasses.is_dataclass(x):
        return [leaf for f in dataclasses.fields(x) for leaf in output_leaves(getattr(x, f.name))]
    return [np.asarray(x.detach() if isinstance(x, torch.Tensor) else x)]


def observation_batch(obs_size, batch: int = 8):
    rng = np.random.RandomState(0)
    if isinstance(obs_size, dict):
        return {k: rng.randn(batch, n).astype(np.float32) for k, n in obs_size.items()}
    return rng.randn(batch, obs_size).astype(np.float32)


@pytest.mark.parametrize("case", CASES)
def test_net_matches_the_jax_script_on_its_weights(case):
    c = captured(case)
    jax_env, jax_nets, _ = c["jax"]
    port_env, port_nets, _ = c["port"]
    assert len(jax_nets) == len(port_nets)
    obs = observation_batch(port_env.observation_size)
    for jax_net, net in zip(jax_nets, port_nets):
        params, rest = partition_params(jax_net)
        load_jax_leaves(net, np_leaves(params))
        load_jax_leaves(net, np_leaves(rest))
        n_jax = sum(np.size(x) for x in jax.tree.leaves(np_leaves(params)) if x is not None)
        assert n_jax == sum(p.numel() for p in net.parameters())
        batch = len(next(iter(obs.values())) if isinstance(obs, dict) else obs)
        # Jitted: one compile, not one per eager op.
        want = jax.jit(lambda n, o: n.eval()(n.initialize_state(batch), o))(
            jax_net, jax.tree.map(jnp.asarray, obs))
        net.eval()
        with torch.no_grad():
            got = net(net.initialize_state(batch), jax.tree.map(torch.from_numpy, obs))
        want_leaves, got_leaves = output_leaves(want.output), output_leaves(got.output)
        assert len(got_leaves) == len(want_leaves) >= 3
        for g, w in zip(got_leaves, want_leaves):
            np.testing.assert_allclose(g, w, **TOL)


# -- end to end, device, imports ----------------------------------------------------


def tiny(cfg):
    """``cfg`` cut to 4 envs, one iteration of 2 steps, and one eval (at
    step 0) of 2 envs x 5 steps."""
    key = "ppo" if hasattr(cfg, "ppo") else "distillation"
    inner = getattr(cfg, key)
    changes = dict(n_envs=4, rollout_length=2, total_steps=8,
                   n_minibatches=min(inner.n_minibatches, 4))
    if hasattr(inner, "steps_per_call"):
        changes["steps_per_call"] = 1
    evaluation = dataclasses.replace(cfg.eval, n_envs=2, max_episode_length=5, every_steps=9)
    return dataclasses.replace(cfg, **{key: dataclasses.replace(inner, **changes),
                                       "eval": evaluation})


def tiny_build(build):
    def run(args, device):
        env, nets, cfg = build(args, device)
        return env, nets, tuple(map(tiny, cfg)) if isinstance(cfg, tuple) else tiny(cfg)
    return run


def out_argv(script: str, path: str) -> list:
    if script == "learning_curves":
        return [path]
    return ["--out", path] if script in CSV_COLUMNS else []


@pytest.mark.parametrize("script", SCRIPTS)
def test_main_runs_on_the_cpu_and_writes_the_jax_columns(script, tmp_path, monkeypatch, capsys):
    path = str(tmp_path / "curve.csv")
    argv = ["--cpu", *out_argv(script, path), *(["--from-saved"] if script == "mjcf_import"
                                                  else [])]
    module = port_module(script)
    monkeypatch.setattr(module, "build", tiny_build(module.build))
    if script == "distill_quadruped":
        monkeypatch.setattr(module, "eval_tracking",
                            functools.partial(module.eval_tracking, n_envs=2, length=5))
    returned = module.main(argv)
    printed = capsys.readouterr().out
    if script in CSV_COLUMNS:
        with open(path, newline="") as f:
            table = list(csv.reader(f))
        assert table[0] == CSV_COLUMNS[script]
        assert len(table) == 2 and table[1][CSV_COLUMNS[script].index("step")] == "0"
        assert all(np.isfinite(float(x)) for x in table[1] if x != "nnx_ppo_tpu_torch")
    elif script == "distill_quadruped":
        assert set(returned) == {"teacher_tracking", "student_tracking", "recovery"}
        assert all(np.isfinite(v) for v in returned.values())
        assert "recovery:" in printed
    else:
        assert "final" in printed
    if script == "multihost_dp":
        # It started a one-process gloo group and left none behind.
        assert "mesh: {'data': 1} (1 devices)" in printed
        assert not torch.distributed.is_initialized()


@pytest.mark.parametrize("script", SCRIPTS)
def test_without_cpu_and_without_a_gpu_main_raises(script, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    argv = ["--from-saved"] if script == "mjcf_import" else []
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port_module(script).main(argv)


def test_mjcf_import_without_mujoco_names_the_flag(monkeypatch):
    """Without mujoco the script stops and names --from-saved; it never
    switches to the saved import on its own."""
    module = port_module("mjcf_import")
    real = importlib.util.find_spec
    monkeypatch.setattr(importlib.util, "find_spec",
                        lambda name, *a: None if name == "mujoco" else real(name, *a))
    with pytest.raises(SystemExit, match="--from-saved"):
        module.build(module.make_parser().parse_args(["--cpu"]), "cpu")


def test_the_scripts_import_neither_jax_nor_the_jax_package():
    code = f"""
import sys
class Hide:
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in ("jax", "jaxlib", "nnx_ppo_tpu", "examples"):
            raise ImportError("hidden")
sys.meta_path.insert(0, Hide())
import importlib
for name in {SCRIPTS!r}:
    importlib.import_module("nnx_ppo_tpu_torch.examples." + name)
assert not any(m.split(".")[0] in ("jax", "nnx_ppo_tpu", "examples") for m in sys.modules)
print("ok")
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, env=dict(os.environ, PYTHONPATH=ROOT))
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
