"""Multi-tree scenes: several kinematic trees + cross-tree contacts.

Port of ``nnx_ppo_tpu/physics/scene.py``: the :class:`Scene` description
with its checks. Object interaction (an arm pushing a ball) needs several
independent trees in one world: each tree keeps its own ``(qpos, qvel)``
and its own ground/self contacts, and the scene adds sphere-sphere
penalty contacts BETWEEN trees, computed once in the world frame and
applied equal and opposite, so cross-tree collisions conserve the
combined system's momentum as intra-tree pairs do. Contact parameters of
a cross pair are the arithmetic means of the two trees' parameters.

The port steps a scene through the scene control step
(``cuda_scene_step.make_scene_control_step_runner``: the CUDA kernel for
CUDA tensors, its plain version for CPU tensors). ``scene_forward`` and
``scene_step`` of the JAX package run on the generic engine's
``forward_dynamics``, ``body_velocities`` and ``integrate``, which are not
ported yet; both raise ``NotImplementedError`` here.
"""

from __future__ import annotations

import dataclasses

from nnx_ppo_tpu_torch.physics.model import Model


@dataclasses.dataclass(frozen=True)
class Scene:
    """Static scene description: the trees plus cross-tree contact
    pairs ``(tree_a, geom_a, tree_b, geom_b)`` (geom indices are local
    to their tree)."""

    models: tuple[Model, ...]
    pairs: tuple[tuple[int, int, int, int], ...] = ()

    def __post_init__(self):
        for ta, ga, tb, gb in self.pairs:
            if ta == tb:
                raise ValueError(
                    "cross-tree pair within one tree — use "
                    "ModelBuilder.add_collision_pair for self-collision"
                )
            for t, g in ((ta, ga), (tb, gb)):
                if not 0 <= t < len(self.models):
                    raise ValueError(f"tree index {t} out of range")
                if not 0 <= g < len(self.models[t].geom_body):
                    raise ValueError(
                        f"geom index {g} out of range for tree {t}"
                    )


_NOT_PORTED = (
    "{name} is not ported yet: it runs on the generic engine's forward_dynamics, "
    "body_velocities and integrate (ROADMAP.md, Queue 1 item 11). Step a scene with "
    "cuda_scene_step.make_scene_control_step_runner"
)


def scene_forward(scene: Scene, qposs: tuple, qvels: tuple, taus: tuple, dt: float = 0.0,
                  terrain=None):
    """Per-tree forward dynamics with cross-tree contact coupling
    (``nnx_ppo_tpu/physics/scene.py:62``). Not ported yet."""
    raise NotImplementedError(_NOT_PORTED.format(name="scene_forward"))


def scene_step(scene: Scene, qposs: tuple, qvels: tuple, taus: tuple, dt: float,
               n_substeps: int = 1, terrain=None):
    """Advance every tree ``n_substeps`` semi-implicit-Euler steps on the
    generic engine (``nnx_ppo_tpu/physics/scene.py:129``). Not ported yet."""
    raise NotImplementedError(_NOT_PORTED.format(name="scene_step"))
