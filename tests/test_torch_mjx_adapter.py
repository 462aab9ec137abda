"""The port's MJXEnv on the MuJoCo-C backend against raw MuJoCo and
against the JAX package's ``MJXEnv(impl="mjc")``.

Mirrors ``tests/test_mjx_adapter.py``: the reset / step protocol, the
step against a host ``mj_step`` loop, a batch against each env alone,
PPO on the backend, and a raw ``MjModel`` with the default hooks. The
port's env is batched natively (one host loop over the ``[B, ...]``
state per step, as JAX's ``broadcast_all`` callback), so the JAX env is
vmapped; its reset draws (``nnx_ppo_tpu/envs/mjx.py:118-125``) are
injected through ``_reset_from``.

Tolerances: MuJoCo steps in float64 on both sides from the same float32
state and casts the result to float32, so the states agree to the bit
(compared with rtol 1e-6 as the JAX test does); the task hooks are
float32 elementwise, 1e-6.
"""

import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

mujoco = pytest.importorskip("mujoco")

from nnx_ppo_tpu.envs import MJXCartpoleBalance as JaxMJXCartpoleBalance
from nnx_ppo_tpu_torch.algorithms import PPOConfig, make_optimizer, new_training_state, ppo_step
from nnx_ppo_tpu_torch.envs import (
    MJX_AVAILABLE,
    MJCBackend,
    MJCData,
    MJXCartpoleBalance,
    MJXEnv,
)
from nnx_ppo_tpu_torch.networks import make_mlp_actor_critic
from nnx_ppo_tpu_torch.wrappers import EpisodeWrapper

torch.set_num_threads(1)


@pytest.fixture(scope="module")
def env():
    return MJXCartpoleBalance(impl="mjc")


def test_reset_step_protocol(env):
    state = env.reset(3, torch.Generator().manual_seed(0))
    assert isinstance(state.data, MJCData)
    assert state.obs.shape == (3, env.observation_size) and state.data.qpos.shape == (3, 2)
    nxt = env.step(state, torch.ones(3, env.action_size))
    assert nxt.obs.shape == (3, env.observation_size)
    assert bool((nxt.data.time > state.data.time).all())
    assert torch.isfinite(nxt.reward).all() and nxt.done.dtype == torch.float32
    # Pushing the cart right moves it right.
    assert bool((nxt.data.qpos[:, 0] > state.data.qpos[:, 0]).all())


def test_step_matches_raw_mujoco(env):
    """The batched step is the host mj_step loop, to float32."""
    state = env.reset(2, torch.Generator().manual_seed(1))
    nxt = env.step(state, torch.full((2, 1), 0.37))
    for b in range(2):
        d = mujoco.MjData(env._mj_model)
        d.qpos[:] = state.data.qpos[b].numpy().astype(np.float64)
        d.qvel[:] = state.data.qvel[b].numpy().astype(np.float64)
        d.ctrl[:] = np.float32(0.37)
        for _ in range(env.n_substeps):
            mujoco.mj_step(env._mj_model, d)
        np.testing.assert_allclose(nxt.data.qpos[b].numpy(), d.qpos.astype(np.float32), rtol=1e-6)
        np.testing.assert_allclose(nxt.data.qvel[b].numpy(), d.qvel.astype(np.float32), rtol=1e-6)


def test_batch_matches_each_env_alone(env):
    B = 5
    batch = env.reset(B, torch.Generator().manual_seed(2))
    actions = 2.0 * torch.rand((B, 1), generator=torch.Generator().manual_seed(3)) - 1.0
    stepped = env.step(batch, actions)
    for b in range(B):
        one = batch.replace(data=batch.data.replace(**{
            k: getattr(batch.data, k)[b : b + 1] for k in ("qpos", "qvel", "act", "ctrl", "time")
        }))
        single = env.step(one, actions[b : b + 1])
        np.testing.assert_allclose(stepped.data.qpos[b].numpy(), single.data.qpos[0].numpy(),
                                   rtol=1e-6)


def test_matches_jax_mjc_env_with_injected_draws(env):
    """Reset with JAX's draws and three steps against JAX's vmapped
    MJXCartpoleBalance(impl="mjc")."""
    B = 4
    jenv = JaxMJXCartpoleBalance(impl="mjc")
    keys = jax.random.split(jax.random.key(4), B)
    draws = {"qpos_noise": [], "qvel_noise": []}
    for key in keys:
        k1, k2 = jax.random.split(key)
        draws["qpos_noise"].append(np.asarray(jax.random.uniform(k1, (2,))))
        draws["qvel_noise"].append(np.asarray(jax.random.uniform(k2, (2,))))
    state = env._reset_from({k: torch.from_numpy(np.stack(v)) for k, v in draws.items()})
    want = jax.vmap(jenv.reset)(keys)
    step = jax.jit(jax.vmap(jenv.step))
    actions = np.random.RandomState(5).uniform(-1.2, 1.2, (3, B, 1)).astype(np.float32)
    for i in range(4):
        for field in ("qpos", "qvel", "time"):
            np.testing.assert_allclose(getattr(state.data, field).numpy(),
                                       np.asarray(getattr(want.data, field)), rtol=1e-6,
                                       atol=1e-7, err_msg=f"{field} after {i} steps")
        np.testing.assert_allclose(state.obs.numpy(), np.asarray(want.obs), rtol=0, atol=1e-6)
        np.testing.assert_allclose(state.reward.numpy(), np.asarray(want.reward), rtol=0,
                                   atol=1e-6)
        np.testing.assert_array_equal(state.done.numpy(), np.asarray(want.done))
        if i < 3:
            state = env.step(state, torch.from_numpy(actions[i]))
            want = step(want, jnp.asarray(actions[i]))
    assert env.observation_size == jenv.observation_size and env.action_size == jenv.action_size


def test_ppo_trains_on_the_mjc_backend(env):
    wrapped = EpisodeWrapper(env, max_len=25)
    net = make_mlp_actor_critic(wrapped.observation_size, wrapped.action_size, [16], [16], 0)
    config = PPOConfig(n_envs=4, rollout_length=4, n_epochs=2, n_minibatches=2)
    optimizer = make_optimizer(config.learning_rate)
    ts = new_training_state(wrapped, net, config.n_envs, seed=0, optimizer=optimizer,
                            device="cpu")
    for _ in range(2):
        ts, metrics = ppo_step(wrapped, ts, config, optimizer)
    assert torch.isfinite(metrics["losses/actor/mean"])
    assert torch.isfinite(metrics["losses/critic/mean"])
    assert ts.steps_taken == 32


def test_generic_mjmodel_wrap():
    """Any raw MjModel wraps as an env with the default hooks."""
    xml = """
    <mujoco><worldbody><body pos="0 0 1">
      <joint type="hinge" axis="0 1 0"/>
      <geom type="capsule" fromto="0 0 0 0 0 0.4" size="0.04" mass="0.5"/>
    </body></worldbody></mujoco>
    """
    m = mujoco.MjModel.from_xml_string(xml)
    env = MJXEnv(m, n_substeps=2, impl="mjc")
    assert env.observation_size == 2 and env.action_size == 0
    s = env.reset(2, torch.Generator().manual_seed(0))
    s2 = env.step(s, torch.zeros(2, 0))
    assert torch.isfinite(s2.obs).all() and s2.reward.shape == (2,)
    assert isinstance(env._mjc, MJCBackend)


def test_impl_values():
    """"auto" resolves to the C engine; MJX, an XLA program, has no
    counterpart in the port; anything else is refused as in JAX."""
    assert not MJX_AVAILABLE
    assert MJXCartpoleBalance().impl == "mjc"
    with pytest.raises(ValueError, match="XLA program"):
        MJXCartpoleBalance(impl="mjx")
    with pytest.raises(ValueError, match="impl must be"):
        MJXCartpoleBalance(impl="warp")


def test_the_port_imports_without_mujoco():
    """``mujoco`` is needed only by from_mjcf and MJXEnv: with it hidden,
    the physics and env packages import, the saved MJCF quadruped builds
    its env and steps, and MJXEnv says what it needs."""
    code = """
import sys
class Hide:
    def find_spec(self, name, path=None, target=None):
        if name == "mujoco" or name.startswith("mujoco."):
            raise ImportError("hidden")
sys.meta_path.insert(0, Hide())
import torch
import nnx_ppo_tpu_torch.physics, nnx_ppo_tpu_torch.envs
from nnx_ppo_tpu_torch.envs import MJC_AVAILABLE, MJXCartpoleBalance
from nnx_ppo_tpu_torch.physics.models.mjcf_quadruped import make_env
assert not MJC_AVAILABLE
env = make_env(reuse_mass_matrix=True, n_substeps=2)
s = env.reset(2, torch.Generator().manual_seed(0))
s = env.step(s, torch.zeros(2, 12), torch.Generator().manual_seed(1))
assert bool(torch.isfinite(s.data["qpos"]).all())
try:
    MJXCartpoleBalance()
except ImportError as e:
    assert "mujoco" in str(e)
else:
    raise AssertionError("MJXCartpoleBalance built without mujoco")
assert "mujoco" not in sys.modules and "jax" not in sys.modules
print("ok")
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == "ok"
