"""Multi-tree scenes: several kinematic trees + cross-tree contacts.

Port of ``nnx_ppo_tpu/physics/scene.py``: the :class:`Scene` description
with its checks. Object interaction (an arm pushing a ball) needs several
independent trees in one world: each tree keeps its own ``(qpos, qvel)``
and its own ground/self contacts, and the scene adds sphere-sphere
penalty contacts BETWEEN trees, computed once in the world frame and
applied equal and opposite, so cross-tree collisions conserve the
combined system's momentum as intra-tree pairs do. Contact parameters of
a cross pair are the arithmetic means of the two trees' parameters.

:func:`scene_forward` (``nnx_ppo_tpu/physics/scene.py:62``) and
:func:`scene_step` (:129) run on the generic engine (``engine.py``), with
every state tensor carrying any leading (batch) dimensions; the envs use
them under ``substep_impl="xla"``. The scene control step
(``cuda_scene_step.make_scene_control_step_runner``: the CUDA kernel for
CUDA tensors, its plain version for CPU tensors) is the other way to step
a scene.
"""

from __future__ import annotations

import dataclasses

import torch

from nnx_ppo_tpu_torch.physics.engine import (
    _mv,
    _radius,
    _t,
    body_point_velocity,
    body_velocities,
    forward_dynamics,
    fwd_kinematics,
    geom_world_centers,
    integrate,
    sphere_pair_force,
)
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


def _check_trees(scene: Scene, *per_tree: tuple) -> None:
    """One state tensor per tree in each of ``per_tree``. JAX's ``zip``
    drops the trees past the shortest tuple without a word."""
    for values in per_tree:
        if len(values) != len(scene.models):
            raise ValueError(
                f"the scene has {len(scene.models)} trees; qposs, qvels and taus need one "
                f"entry per tree, got {len(values)}"
            )


def scene_forward(scene: Scene, qposs: tuple, qvels: tuple, taus: tuple, dt: float = 0.0,
                  terrain=None) -> tuple:
    """Per-tree forward dynamics with cross-tree contact coupling (JAX
    ``scene.py:62``).

    Returns ``(qaccs per tree, cross-pair normal forces [..., NP])``. Each
    tree also feels its own ground / self contacts, joint limits and
    implicit damping as in :func:`engine.forward_dynamics`; ``terrain``
    applies to every tree. A cross pair's contact parameters are the means
    of the two trees' (the larger friction velocity, the smaller force
    cap)."""
    _check_trees(scene, qposs, qvels, taus)
    kins = [fwd_kinematics(m, qp) for m, qp in zip(scene.models, qposs)]
    vels = [body_velocities(m, k, qv) for m, k, qv in zip(scene.models, kins, qvels)]
    centers = [geom_world_centers(m, k) for m, k in zip(scene.models, kins)]

    def point_velocity(c, t: int, b: int):
        k = kins[t]
        return body_point_velocity(k, vels[t], b, _mv(_t(k.E[b]), c - k.p[b]))

    ext: list[list] = [[] for _ in scene.models]
    normals = []
    for ta, ga, tb, gb in scene.pairs:
        ma, mb = scene.models[ta], scene.models[tb]
        ba, bb = ma.geom_body[ga], mb.geom_body[gb]
        dev = centers[ta][ga].device
        f_w, c_w, fn = sphere_pair_force(
            centers[ta][ga],
            centers[tb][gb],
            _radius(ma, ga, dev),
            _radius(mb, gb, dev),
            stiffness=0.5 * (ma.contact_stiffness + mb.contact_stiffness),
            damping=0.5 * (ma.contact_damping + mb.contact_damping),
            friction=0.5 * (ma.friction + mb.friction),
            friction_vel=max(ma.friction_vel, mb.friction_vel),
            max_force=min(ma.max_contact_force, mb.max_contact_force),
            va_fn=lambda c, t=ta, b=ba: point_velocity(c, t, b),
            vb_fn=lambda c, t=tb, b=bb: point_velocity(c, t, b),
        )
        normals.append(fn)
        ext[tb].append((bb, c_w, f_w))
        ext[ta].append((ba, c_w, -f_w))

    qaccs = tuple(
        forward_dynamics(m, qp, qv, tau, dt=dt, external_forces=ext[t] or None,
                         terrain=terrain)[0]
        for t, (m, qp, qv, tau) in enumerate(zip(scene.models, qposs, qvels, taus))
    )
    if normals:
        cross = torch.stack(normals, dim=-1)
    else:
        qp = qposs[0]
        cross = torch.zeros(qp.shape[:-1] + (0,), device=qp.device)
    return qaccs, cross


def scene_step(scene: Scene, qposs: tuple, qvels: tuple, taus: tuple, dt: float,
               n_substeps: int = 1, terrain=None) -> tuple:
    """Advance every tree ``n_substeps`` semi-implicit Euler steps under
    constant applied torques (JAX ``scene.py:129``; a Python loop in place
    of ``lax.scan``).
    Returns ``(qposs, qvels, the last substep's cross-pair normal
    forces)``."""
    _check_trees(scene, qposs, qvels, taus)
    cross = None
    for _ in range(n_substeps):
        qaccs, cross = scene_forward(scene, qposs, qvels, taus, dt=dt, terrain=terrain)
        nxt = [
            integrate(m, qp, qv, qa, dt)
            for m, qp, qv, qa in zip(scene.models, qposs, qvels, qaccs)
        ]
        qposs = tuple(x[0] for x in nxt)
        qvels = tuple(x[1] for x in nxt)
    return qposs, qvels, cross
