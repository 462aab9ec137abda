"""Procedural heightfield terrain for the penalty-contact step.

Port of ``nnx_ppo_tpu/physics/terrain.py``. A :class:`Terrain` is a
smooth analytic heightfield

    h(x, y) = g_x·x + g_y·y + Σ_k a_k · sin(ω_k · (d_k·(x, y)) + φ_k)

— a global slope plus a superposition of directional waves. The JAX
methods take one ``[2]`` point and are vmapped; these take ``[..., 2]``
tensors and return ``[...]`` (``height``), ``[..., 2]`` (``grad``) and
``[..., 3]`` (``normal``).

Per-env terrain variation needs no per-env parameters: the field is
spatially aperiodic (incommensurate wave directions), so envs that spawn
at random world positions each see their own local terrain.

:class:`HeightGrid` (data terrain, bilinear lookup) is not ported yet:
it waits for the slice that ports the plane-sampler kernel.
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class Terrain:
    """Static description of an analytic heightfield (plain Python
    tuples: hashable, never a tensor)."""

    amplitudes: tuple[float, ...] = ()
    frequencies: tuple[float, ...] = ()  # spatial angular freq [rad/m]
    directions: tuple[tuple[float, float], ...] = ()  # unit wave dirs
    phases: tuple[float, ...] = ()
    slope: tuple[float, float] = (0.0, 0.0)  # (dh/dx, dh/dy) global

    def __post_init__(self):
        n = len(self.amplitudes)
        if not (len(self.frequencies) == len(self.directions) == len(self.phases) == n):
            raise ValueError("wave parameter tuples must share a length")

    def _waves(self):
        return zip(self.amplitudes, self.frequencies, self.directions, self.phases)

    def height(self, xy: torch.Tensor) -> torch.Tensor:
        """Terrain height at world ``xy`` (``[..., 2]`` -> ``[...]``)."""
        x, y = xy[..., 0], xy[..., 1]
        h = self.slope[0] * x + self.slope[1] * y
        for a, f, d, p in self._waves():
            h = h + a * torch.sin(f * (d[0] * x + d[1] * y) + p)
        return h

    def grad(self, xy: torch.Tensor) -> torch.Tensor:
        """Exact analytic ``(dh/dx, dh/dy)`` at ``xy`` (``[..., 2]``)."""
        x, y = xy[..., 0], xy[..., 1]
        gx = torch.zeros_like(x) + self.slope[0]
        gy = torch.zeros_like(y) + self.slope[1]
        for a, f, d, p in self._waves():
            c = a * f * torch.cos(f * (d[0] * x + d[1] * y) + p)
            gx = gx + d[0] * c
            gy = gy + d[1] * c
        return torch.stack([gx, gy], dim=-1)

    def normal(self, xy: torch.Tensor) -> torch.Tensor:
        """Upward unit surface normal at ``xy`` (``[..., 3]``)."""
        g = self.grad(xy)
        n = torch.cat([-g, torch.ones_like(g[..., :1])], dim=-1)
        return n / torch.sqrt(torch.sum(n**2, dim=-1, keepdim=True))


class HeightGrid:
    """Grid-based heightfield (``nnx_ppo_tpu/physics/terrain.py:88``).
    Not ported yet."""

    def __init__(self, *args, **kwargs):
        raise NotImplementedError(
            "HeightGrid terrain is not ported yet (it needs the "
            "plane-sampler kernel); use an analytic Terrain"
        )


def flat() -> Terrain:
    """The trivial terrain h = 0."""
    return Terrain()


def inclined(slope_x: float = 0.0, slope_y: float = 0.0) -> Terrain:
    """A perfect inclined plane."""
    return Terrain(slope=(slope_x, slope_y))


def stairs(
    step_height: float = 0.08,
    step_length: float = 0.35,
    direction: tuple[float, float] = (1.0, 0.0),
) -> Terrain:
    """Smooth staircase climbing along ``direction``:
    ``h(s) = H·(s/L − sin(2πs/L)/(2π))``; the gradient is zero once per
    period (flat treads) and each period rises exactly ``step_height``."""
    dn = math.hypot(direction[0], direction[1])
    dx, dy = direction[0] / dn, direction[1] / dn
    H, L = step_height, step_length
    return Terrain(
        amplitudes=(H / (2.0 * math.pi),),
        frequencies=(2.0 * math.pi / L,),
        directions=((dx, dy),),
        phases=(math.pi,),  # −sin
        slope=(H / L * dx, H / L * dy),
    )


def rough_terrain(
    seed: int = 0,
    amplitude: float = 0.04,
    wavelength: float = 1.2,
    n_waves: int = 6,
    slope: tuple[float, float] = (0.0, 0.0),
) -> Terrain:
    """Standard isotropic rough ground: ``n_waves`` random-direction
    waves with wavelengths in [wavelength, 2·wavelength] and total
    height std ≈ ``amplitude``. Wave parameters come from
    ``numpy.random.RandomState(seed)``, as in the JAX package, so a seed
    names the same terrain in both."""
    rng = np.random.RandomState(seed)
    angles = rng.uniform(0.0, 2.0 * math.pi, n_waves)
    lengths = rng.uniform(wavelength, 2.0 * wavelength, n_waves)
    # Σ (a·sin)² has variance n·a²/2 → scale for total std ≈ amplitude.
    a = amplitude * math.sqrt(2.0 / n_waves)
    return Terrain(
        amplitudes=tuple(float(a) for _ in range(n_waves)),
        frequencies=tuple(float(2.0 * math.pi / L) for L in lengths),
        directions=tuple((float(math.cos(t)), float(math.sin(t))) for t in angles),
        phases=tuple(float(p) for p in rng.uniform(0, 2 * math.pi, n_waves)),
        slope=slope,
    )
