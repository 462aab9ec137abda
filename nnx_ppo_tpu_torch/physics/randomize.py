"""Per-env domain randomization for the physics step.

Port of ``nnx_ppo_tpu/physics/randomize.py``. :class:`DomainParams`
holds per-env overrides as ``[B]`` tensors (``None`` = use the Model
value); :class:`DomainRandomization` is the static range config whose
``sample(batch, generator)`` draws one set of params per env. Envs call
it at ``reset`` and keep the draw in ``State.data``, so every episode,
auto-resets included, gets a fresh draw.

The randomized quantities are the small set that enter the dynamics as
multiplicative factors: body spatial inertias (``mass_scale``), the
contact friction coefficient, viscous joint damping, and actuator gain.
Per-body ``mass_scale`` overrides are not ported (the SoA step takes
scalar draws only, as in the JAX package).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

FIELDS = ("mass_scale", "friction", "damping_scale", "gain_scale")


@dataclasses.dataclass
class DomainParams:
    """Per-env physics overrides, ``[B]`` each (``None`` = Model value).

    ``mass_scale`` multiplies every body's spatial inertia (a density
    scale); ``friction`` is the absolute Coulomb coefficient;
    ``damping_scale`` multiplies the viscous joint damping (both the bias
    term and the implicit ``dt·D`` term); ``gain_scale`` multiplies the
    actuator torque.
    """

    mass_scale: Optional[torch.Tensor] = None
    friction: Optional[torch.Tensor] = None
    damping_scale: Optional[torch.Tensor] = None
    gain_scale: Optional[torch.Tensor] = None


@dataclasses.dataclass(frozen=True)
class DomainRandomization:
    """Static uniform-range config. A range of ``None`` leaves that
    field un-randomized. Defaults are the conventional sim-to-real
    ranges for legged locomotion."""

    mass_scale: Optional[tuple[float, float]] = (0.8, 1.2)
    friction: Optional[tuple[float, float]] = (0.4, 1.0)
    damping_scale: Optional[tuple[float, float]] = None
    gain_scale: Optional[tuple[float, float]] = (0.9, 1.1)

    @property
    def fields(self) -> tuple[str, ...]:
        """Names of the randomized fields, in the fixed field order."""
        return tuple(name for name in FIELDS if getattr(self, name) is not None)

    @property
    def dim(self) -> int:
        """Length of :func:`privileged_vector` for draws from this
        config (one scalar per randomized field)."""
        return len(self.fields)

    def sample(self, batch_size: int, generator: torch.Generator) -> DomainParams:
        """One uniform draw per env and randomized field, in field order."""
        values = {}
        for name in self.fields:
            lo, hi = getattr(self, name)
            u = torch.rand(batch_size, generator=generator, device=generator.device)
            values[name] = lo + (hi - lo) * u
        return DomainParams(**values)

    def identity(self, model: Any, batch_size: int, device=None) -> DomainParams:
        """Params pinned to 1× / Model values: the same structure as
        :meth:`sample`, but the dynamics match the un-randomized step."""
        one = torch.ones(batch_size, device=device)
        return DomainParams(
            mass_scale=one if self.mass_scale is not None else None,
            friction=one * float(model.friction) if self.friction is not None else None,
            damping_scale=one if self.damping_scale is not None else None,
            gain_scale=one if self.gain_scale is not None else None,
        )


def privileged_vector(params: DomainParams) -> torch.Tensor:
    """Stack a draw's non-``None`` fields into one ``[B, dim]`` obs
    tensor (fixed field order): the critic-only "privileged" stream of
    an asymmetric actor-critic (``LeggedJoystick(privileged_obs=True)``)."""
    parts = [getattr(params, name) for name in FIELDS if getattr(params, name) is not None]
    if not parts:
        raise ValueError("privileged_vector of an all-None DomainParams")
    return torch.stack(parts, dim=-1)
