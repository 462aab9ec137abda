"""EpisodeWrapper's attribute delegation: the port's wrapper against the
JAX package's (``nnx_ppo_tpu/wrappers/episode_wrapper.py:59-67``).

Any attribute that the wrapper lacks comes from the wrapped env; ``env``
itself raises ``AttributeError`` while it is not yet set, so that
``copy.deepcopy`` and unpickling of a bare instance do not recurse.
"""

import copy
import pickle

import pytest
import torch

from nnx_ppo_tpu.envs import ArmReacher as JaxArmReacher
from nnx_ppo_tpu.wrappers import EpisodeWrapper as JaxEpisodeWrapper
from nnx_ppo_tpu_torch.envs import ArmReacher, CartpoleBalance
from nnx_ppo_tpu_torch.wrappers import EpisodeWrapper


def test_wrapped_env_attributes_come_through():
    env = ArmReacher(sigma=0.07, n_substeps=3)
    wrapper = EpisodeWrapper(env, max_len=150)
    assert wrapper.sigma == 0.07 and wrapper.n_substeps == 3
    assert wrapper.model is env.model
    assert wrapper.max_len == 150  # the wrapper's own attributes stay its own
    with pytest.raises(AttributeError, match="no_such_attribute"):
        wrapper.no_such_attribute


@pytest.mark.parametrize("name", ["render", "reset", "sigma", "no_such_attribute"])
def test_hasattr_matches_the_jax_wrapper(name):
    ours = EpisodeWrapper(ArmReacher(), max_len=150)
    theirs = JaxEpisodeWrapper(JaxArmReacher(), max_len=150)
    assert hasattr(ours, name) == hasattr(theirs, name)
    if name == "render":
        assert hasattr(ours, "render")  # what JAX's video gate reads (ppo.py:852)


def test_deepcopy_and_pickle_of_the_wrapper():
    wrapper = EpisodeWrapper(CartpoleBalance(), max_len=500)
    clone = copy.deepcopy(wrapper)
    assert clone.env is not wrapper.env and clone.max_len == 500
    assert clone.observation_size == wrapper.observation_size
    state = clone.reset(4, torch.Generator().manual_seed(0))
    assert state.info["step_counter"].shape == (4,)
    again = pickle.loads(pickle.dumps(wrapper))
    assert isinstance(again.env, CartpoleBalance) and again.max_len == 500


def test_bare_instance_raises_for_env_instead_of_recursing():
    bare = EpisodeWrapper.__new__(EpisodeWrapper)
    with pytest.raises(AttributeError, match="env"):
        bare.env
    with pytest.raises(AttributeError):
        bare.observation_size  # reaches self.env, which raises; no RecursionError
    assert not hasattr(bare, "render")
