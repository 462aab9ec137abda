"""The video pipeline of the port: render rollout -> unstack -> env.render
-> video_fn, end to end through train_ppo, and its parts against the JAX
package's (the counterparts of tests/test_video.py, and parity).

Frames: each render is the JAX one's numpy code. The cart-pole's reads
the same float32 ``q``, so its frames are byte-equal. The rigid-body
envs' recompute the kinematics (the port's ``fwd_kinematics`` in PyTorch
against JAX's), which agree to float32 rounding; a point within rounding
of a pixel edge can then land one pixel over, so at most 0.1% of their
pixels may differ (the count is printed).

The render rollout against JAX's, with JAX's reset state injected and
the policy deterministic (eval mode), on the reacher, whose step draws
nothing and which never terminates: qpos at the manipulation parity
tests' 2e-5 (the port's plain scene runner against JAX's generic
engine), the episode reward at 1e-4.
"""

import functools
import subprocess
import sys
import types

import jax
import numpy as np
import pytest
import torch
from test_torch_networks import carried_across, np_leaves

from nnx_ppo_tpu.algorithms import rollout as jax_rollout
from nnx_ppo_tpu.envs import ArmPush as JaxArmPush
from nnx_ppo_tpu.envs import ArmReacher as JaxArmReacher
from nnx_ppo_tpu.envs import CartpoleBalance as JaxCartpoleBalance
from nnx_ppo_tpu.envs import QuadrupedJoystick as JaxQuadrupedJoystick
from nnx_ppo_tpu.networks import Sequential as JaxSequential
from nnx_ppo_tpu.networks import make_mlp_actor_critic as jax_make_mlp_actor_critic
from nnx_ppo_tpu.networks.utils import Flattener as JaxFlattener
from nnx_ppo_tpu_torch.algorithms import (
    EvalConfig,
    LoggingLevel,
    PPOConfig,
    TrainConfig,
    VideoConfig,
    VideoData,
    eval_rollout_for_render_scan,
    train_ppo,
    unstack_trajectory,
    wandb_video_fn,
)
from nnx_ppo_tpu_torch.envs import ArmPush, ArmReacher, CartpoleBalance, QuadrupedJoystick
from nnx_ppo_tpu_torch.networks import Flattener, Sequential, make_mlp_actor_critic
from nnx_ppo_tpu_torch.physics import rough_terrain
from nnx_ppo_tpu_torch.wrappers import EpisodeWrapper, RewardScalingWrapper

torch.set_num_threads(1)

N_SUBSTEPS = 2


def _quadruped_net():
    return Sequential.create([
        Flattener.create(),
        make_mlp_actor_critic(45, 12, [16], [16], 0, normalize_obs=False),
    ])


def _render_rollout(env, net, T, seed=1):
    net.eval()
    stacked, final, reward = eval_rollout_for_render_scan(
        env, net, T, torch.Generator().manual_seed(seed)
    )
    return unstack_trajectory(stacked, final, T), reward


def test_video_pipeline_end_to_end():
    """train_ppo records a video at step 0 and on its cadence: T+1 frames
    (the trajectory and the final state), uint8, a float reward; with
    THROUGHPUT logged, ``throughput/video_sps`` beside it."""
    videos, logged = [], []
    env = EpisodeWrapper(CartpoleBalance(), max_len=60)
    net = make_mlp_actor_critic(5, 1, [16], [16], 0)
    cfg = TrainConfig(
        ppo=PPOConfig(n_envs=8, rollout_length=5, total_steps=400,
                      logging_level=LoggingLevel.LOSSES | LoggingLevel.THROUGHPUT),
        eval=EvalConfig(enabled=False),
        video=VideoConfig(enabled=True, every_steps=200, episode_length=30,
                          render_kwargs=(("height", 120), ("width", 160))),
    )
    train_ppo(env, net, cfg, video_fn=videos.append, device="cpu",
              log_fn=lambda m, s: logged.append((s, m)))
    assert [v.step for v in videos] == [0, 200, 400]
    assert videos[0].frames.shape == (31, 120, 160, 3)
    assert videos[0].frames.dtype.name == "uint8"
    assert isinstance(videos[0].episode_reward, float) and videos[0].episode_length == 30
    video_rows = [s for s, m in logged if "throughput/video_sps" in m]
    assert video_rows == [0, 200, 400]
    assert all(m["throughput/video_sps"] > 0 for _, m in logged if "throughput/video_sps" in m)


def test_an_env_without_render_gives_no_video():
    class NoRender:
        observation_size, action_size = 5, 1

        def __init__(self):
            self.env = CartpoleBalance()

        def reset(self, b, g):
            return self.env.reset(b, g)

        def step(self, s, a, g=None):
            return self.env.step(s, a, g)

    videos = []
    cfg = TrainConfig(ppo=PPOConfig(n_envs=4, rollout_length=2, total_steps=8),
                      eval=EvalConfig(enabled=False),
                      video=VideoConfig(enabled=True, every_steps=8, episode_length=4))
    train_ppo(NoRender(), make_mlp_actor_critic(5, 1, [8], [8], 0), cfg,
              video_fn=videos.append, device="cpu")
    assert videos == []


def test_wrappers_delegate_render():
    env = RewardScalingWrapper(EpisodeWrapper(CartpoleBalance(), max_len=10), reward_scale=2.0)
    assert hasattr(env, "render")
    assert env.observation_size == 5


def test_quadruped_video_pipeline():
    env = EpisodeWrapper(QuadrupedJoystick(n_substeps=N_SUBSTEPS), 100)
    trajectory, _ = _render_rollout(env, _quadruped_net(), 5)
    frames = env.render(trajectory, height=80, width=120)
    assert len(frames) == 6
    assert frames[0].shape == (80, 120, 3) and frames[0].dtype == np.uint8
    assert (frames[0] != 255).any()  # robot pixels present


def test_reacher_video_pipeline():
    env = EpisodeWrapper(ArmReacher(n_substeps=N_SUBSTEPS), 100)
    trajectory, _ = _render_rollout(env, make_mlp_actor_critic(18, 4, [16], [16], 0), 5)
    frames = env.render(trajectory, height=80, width=120)
    assert len(frames) == 6
    assert frames[0].shape == (80, 120, 3) and frames[0].dtype == np.uint8
    assert (frames[0] != 255).any()  # arm and target drawn


def test_pusher_video_pipeline():
    env = EpisodeWrapper(ArmPush(n_substeps=N_SUBSTEPS), 100)
    trajectory, _ = _render_rollout(env, make_mlp_actor_critic(22, 4, [16], [16], 0), 4)
    frames = env.render(trajectory, height=80, width=120)
    assert len(frames) == 5
    assert frames[0].shape == (80, 120, 3) and frames[0].dtype == np.uint8
    assert (frames[0] != 255).any()
    assert (frames[0] == np.array([80, 140, 60])).all(axis=-1).any()  # the green ball


def test_rough_terrain_video_profile():
    """LeggedJoystick.render draws the terrain profile, not the flat
    ground line, when a terrain is set."""
    env = EpisodeWrapper(
        QuadrupedJoystick(terrain=rough_terrain(seed=2, amplitude=0.05, wavelength=1.0),
                          n_substeps=N_SUBSTEPS),
        100,
    )
    trajectory, _ = _render_rollout(env, _quadruped_net(), 2)
    f = env.render(trajectory, height=80, width=120)[0]
    assert f.shape == (80, 120, 3)
    ground_rows = np.unique(np.where((f == 110).all(axis=-1))[0])
    assert len(ground_rows) > 2, ground_rows


def _jax_render_rollout(env, net, T, seed=1):
    stacked, final, reward = jax.jit(
        lambda key: jax_rollout.eval_rollout_for_render_scan(env, net, T, key)
    )(jax.random.key(seed))
    trajectory = jax_rollout.unstack_trajectory(np_leaves(stacked), np_leaves(final), T)
    return trajectory, float(reward)


def _jax_quadruped_net(key):
    return JaxSequential.create([
        JaxFlattener.create(),
        jax_make_mlp_actor_critic(45, 12, [16], [16], key, normalize_obs=False),
    ])


def _jax_rough():
    from nnx_ppo_tpu.physics import rough_terrain as jax_rough_terrain

    return jax_rough_terrain(seed=2, amplitude=0.05, wavelength=1.0)


# name -> (JAX env of the rollout, JAX net, JAX env that renders, port env).
# The rough-terrain quadruped renders the flat quadruped's trajectory.
JAX_ENVS = {
    "cartpole": (JaxCartpoleBalance, lambda k: jax_make_mlp_actor_critic(5, 1, [16], [16], k),
                 JaxCartpoleBalance, CartpoleBalance),
    "quadruped": (lambda: JaxQuadrupedJoystick(n_substeps=N_SUBSTEPS, substep_impl="xla"),
                  _jax_quadruped_net, lambda: JaxQuadrupedJoystick(n_substeps=N_SUBSTEPS),
                  lambda: QuadrupedJoystick(n_substeps=N_SUBSTEPS)),
    "reacher": (lambda: JaxArmReacher(n_substeps=N_SUBSTEPS, substep_impl="xla"),
                lambda k: jax_make_mlp_actor_critic(18, 4, [16], [16], k),
                lambda: JaxArmReacher(n_substeps=N_SUBSTEPS), lambda: ArmReacher(n_substeps=2)),
    "pusher": (lambda: JaxArmPush(n_substeps=N_SUBSTEPS, substep_impl="xla"),
               lambda k: jax_make_mlp_actor_critic(22, 4, [16], [16], k),
               lambda: JaxArmPush(n_substeps=N_SUBSTEPS), lambda: ArmPush(n_substeps=2)),
}
JAX_ENVS["rough_quadruped"] = JAX_ENVS["quadruped"][:2] + (
    lambda: JaxQuadrupedJoystick(n_substeps=N_SUBSTEPS, terrain=_jax_rough()),
    lambda: QuadrupedJoystick(n_substeps=N_SUBSTEPS,
                              terrain=rough_terrain(seed=2, amplitude=0.05, wavelength=1.0)),
)


@functools.lru_cache(maxsize=None)
def _jax_trajectory(rollout_of):
    """JAX's render rollout (4 steps) of a name's env, as numpy."""
    make_env, make_net = JAX_ENVS[rollout_of][:2]
    return _jax_render_rollout(make_env(), make_net(jax.random.key(0)).eval(), 4)[0]


@pytest.mark.parametrize("name", list(JAX_ENVS))
def test_frames_match_jaxs_on_the_same_trajectory(name):
    """JAX's render rollout as numpy, rendered by JAX's env and by the
    port's: byte-equal for the cart-pole, at most 0.1% of the pixels
    apart for the rigid-body envs."""
    _, _, make_jax_renderer, make_port = JAX_ENVS[name]
    trajectory = _jax_trajectory("quadruped" if name == "rough_quadruped" else name)
    want = np.stack(make_jax_renderer().render(trajectory, height=96, width=128))
    got = np.stack(make_port().render(trajectory, height=96, width=128))
    assert got.shape == want.shape == (5, 96, 128, 3) and got.dtype == np.uint8
    assert (want != 255).any()
    differ = int((got != want).any(axis=-1).sum())
    print(f"{name}: {differ} of {got.shape[0] * 96 * 128} pixels differ")
    if name == "cartpole":
        assert differ == 0
    else:
        assert differ <= 0.001 * got.shape[0] * 96 * 128


def test_render_rollout_matches_jaxs_with_its_reset_injected():
    """The reacher's render rollout (6 steps) from JAX's reset state, with
    a deterministic policy carried across from JAX's: the stacked qpos,
    the final state and the episode reward agree with JAX's."""
    T = 6
    jax_env = JaxArmReacher(n_substeps=N_SUBSTEPS, substep_impl="xla")
    jax_net = jax_make_mlp_actor_critic(18, 4, [16], [16], jax.random.key(0))
    key = jax.random.key(3)
    stacked, final, reward = jax.jit(
        lambda k: jax_rollout.eval_rollout_for_render_scan(jax_env, jax_net.eval(), T, k)
    )(key)
    jax_reset = jax_env.reset(jax.random.split(key)[0])

    port_env = ArmReacher(n_substeps=N_SUBSTEPS)
    reset_q = {k: torch.from_numpy(np.array(v))[None] for k, v in jax_reset.data.items()}
    reset_state = port_env._state(reset_q, torch.zeros(1, 4))

    class InjectedReset:
        def reset(self, batch_size, generator):
            assert batch_size == 1
            return reset_state

        def step(self, state, action, generator=None):
            return port_env.step(state, action, generator)

    net = carried_across(jax_net, make_mlp_actor_critic(18, 4, [16], [16], 5)).eval()
    got_stacked, got_final, got_reward = eval_rollout_for_render_scan(
        InjectedReset(), net, T, torch.Generator().manual_seed(0)
    )
    assert got_stacked.data["qpos"].shape == (T, 5) and got_stacked.done.shape == (T,)
    np.testing.assert_allclose(got_stacked.data["qpos"].numpy(), np.asarray(stacked.data["qpos"]),
                               rtol=0, atol=2e-5)
    np.testing.assert_allclose(got_final.data["qpos"].numpy(), np.asarray(final.data["qpos"]),
                               rtol=0, atol=2e-5)
    np.testing.assert_allclose(float(got_reward), float(reward), rtol=0, atol=1e-4)


def test_wandb_video_fn_logs_tchw_frames_at_the_step(monkeypatch):
    calls = {}

    class Video:
        def __init__(self, frames, fps, caption):
            calls["video"] = (frames, fps, caption)

    stub = types.ModuleType("wandb")
    stub.Video = Video
    stub.log = lambda data, step: calls.setdefault("log", (data, step))
    monkeypatch.setitem(sys.modules, "wandb", stub)
    frames = np.random.RandomState(0).randint(0, 255, (5, 8, 6, 3)).astype(np.uint8)
    wandb_video_fn(fps=12)(VideoData(frames=frames, step=300, episode_reward=4.25,
                                     episode_length=4))
    logged, fps, caption = calls["video"]
    assert logged.shape == (5, 3, 8, 6) and np.array_equal(logged, frames.transpose(0, 3, 1, 2))
    assert fps == 12 and caption == "eval @ step 300, reward 4.2"
    assert calls["log"][1] == 300 and isinstance(calls["log"][0]["video"], Video)


def test_wandb_video_fn_needs_wandb_only_when_called(monkeypatch):
    monkeypatch.setitem(sys.modules, "wandb", None)  # import wandb raises
    video_fn = wandb_video_fn()
    with pytest.raises(ImportError):
        video_fn(VideoData(frames=np.zeros((1, 2, 2, 3), np.uint8), step=0,
                           episode_reward=0.0, episode_length=1))


MJX_RENDER = """
import hashlib
import numpy as np
import torch
from nnx_ppo_tpu_torch.algorithms.rollout import SlimData, SlimState
from nnx_ppo_tpu_torch.envs import MJXCartpoleBalance
qpos, qvel = torch.tensor([0.1, 0.2]), torch.zeros(2)
zero = torch.zeros(())
trajectory = [SlimState(SlimData(qpos, qvel, zero, zero, zero, zero), zero, {}, {})]
try:
    frames = np.stack(MJXCartpoleBalance().render(trajectory, width=32, height=24))
except Exception as e:  # the renderer's own error, whatever its type
    print("raised", type(e).__name__)
else:
    print("frames", frames.shape, hashlib.sha256(frames.tobytes()).hexdigest())
"""


def test_mjx_env_render_behaves_as_jaxs():
    """MuJoCo's renderer needs an OpenGL context. Where it cannot make
    one, the port's render and JAX's both raise the same error; where it
    can, both give the same frames. The port's runs in a process of its
    own: a second renderer that fails in one process aborts it."""
    pytest.importorskip("mujoco", reason="MJXEnv needs mujoco")
    import hashlib

    from nnx_ppo_tpu.algorithms.rollout import SlimData, SlimState
    from nnx_ppo_tpu.envs import MJXCartpoleBalance as JaxMJXCartpoleBalance

    qpos, qvel, zero = np.array([0.1, 0.2], np.float32), np.zeros(2, np.float32), np.zeros(())
    trajectory = [SlimState(SlimData(qpos, qvel, zero, zero, zero, zero), zero, {}, {})]
    try:
        frames = np.stack(JaxMJXCartpoleBalance(impl="mjc").render(trajectory, width=32,
                                                                   height=24))
    except Exception as e:  # the renderer's own error, whatever its type
        want = f"raised {type(e).__name__}"
    else:
        want = f"frames {frames.shape} {hashlib.sha256(frames.tobytes()).hexdigest()}"
    out = subprocess.run([sys.executable, "-c", MJX_RENDER], capture_output=True, text=True,
                         timeout=120)
    assert out.returncode == 0, out.stderr
    print(want)
    assert out.stdout.strip().splitlines()[-1] == want
