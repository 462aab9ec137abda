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

:class:`HeightGrid` is the counterpart for ground that comes as data: a
sampled height table with bilinear lookup, the same ``height`` / ``grad``
/ ``normal`` surface plus ``plane`` (the local tangent plane that the
plane-sampler kernel computes per contact geom).
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


@dataclasses.dataclass(frozen=True, eq=False)
class HeightGrid:
    """Grid-based heightfield (``nnx_ppo_tpu/physics/terrain.py:88``):
    bilinear interpolation over a sampled height map, for ground that
    comes as data (MuJoCo ``hfield`` assets, scanned elevation maps).
    ``data[i, j]`` is the height at ``(x0 + i·dx, y0 + j·dy)``.

    The gradient is the exact derivative of the bilinear interpolant
    (piecewise linear per cell, consistent with ``height``). Outside the
    grid the edge values extend flat: the cell index is clamped to
    ``[0, n - 2]``, the in-cell fraction to ``[0, 1]``, and the gradient
    is zero there. Methods take ``[..., 2]`` tensors on any device; the
    table is copied to a device once and kept.

    One order of arithmetic serves every method, the lane function
    ``engine_soa.heightgrid_planes_soa`` and the CUDA kernel
    (``csrc/plane_sampler.cu``), see :meth:`plane_xy`. The JAX class's
    ``_use_dot`` / ``_plane_via_dot`` (one-hot matrix products in place
    of gathers, for the TPU) have no counterpart: the table is indexed
    directly.
    """

    data: np.ndarray  # [nx, ny]
    x0: float
    y0: float
    dx: float
    dy: float

    def __post_init__(self):
        if np.asarray(self.data).ndim != 2:
            raise ValueError("HeightGrid data must be [nx, ny]")
        if min(np.asarray(self.data).shape) < 2:
            raise ValueError("HeightGrid needs at least a 2x2 grid")
        object.__setattr__(self, "_tables", {})

    @property
    def shape(self) -> tuple[int, int]:
        nx, ny = np.asarray(self.data).shape
        return int(nx), int(ny)

    def table(self, device) -> torch.Tensor:
        """The float32 ``[nx, ny]`` table on ``device`` (copied once)."""
        key = str(torch.device(device))
        if key not in self._tables:
            self._tables[key] = torch.tensor(
                np.asarray(self.data, np.float32), device=device
            ).contiguous()
        return self._tables[key]

    def _cell(self, x: torch.Tensor, y: torch.Tensor):
        """Heights ``h``, gradients ``gx, gy`` of the interpolant at world
        ``(x, y)`` (any common shape). The order, which the kernel
        repeats: cell coordinates by multiplying with the reciprocal
        spacing (a division by a Python scalar is a true division on the
        CPU and a multiplication on the card; this is the same on both),
        interpolation along x first, then along y."""
        d = self.table(x.device)
        nx, ny = self.shape
        u = (x - self.x0) * (1.0 / self.dx)
        v = (y - self.y0) * (1.0 / self.dy)
        fi = torch.clamp(torch.floor(u), 0.0, float(nx - 2))
        fj = torch.clamp(torch.floor(v), 0.0, float(ny - 2))
        fx = torch.clamp(u - fi, 0.0, 1.0)
        fy = torch.clamp(v - fj, 0.0, 1.0)
        i, j = fi.to(torch.long), fj.to(torch.long)
        h00, h10, h01, h11 = d[i, j], d[i + 1, j], d[i, j + 1], d[i + 1, j + 1]
        wx, wy = 1.0 - fx, 1.0 - fy
        r0 = wx * h00 + fx * h10
        r1 = wx * h01 + fx * h11
        h = wy * r0 + fy * r1
        # Zero gradient on the flat extension beyond the grid (otherwise
        # contacts out there would feel the edge cell's slope).
        in_x = ((u >= 0.0) & (u <= float(nx - 1))).to(u.dtype)
        in_y = ((v >= 0.0) & (v <= float(ny - 1))).to(v.dtype)
        gx = ((wy * (h10 - h00) + fy * (h11 - h01)) * (1.0 / self.dx)) * in_x
        gy = ((r1 - r0) * (1.0 / self.dy)) * in_y
        return h, gx, gy

    def height(self, xy: torch.Tensor) -> torch.Tensor:
        """Bilinear height at world ``xy`` (``[..., 2]`` -> ``[...]``)."""
        return self._cell(xy[..., 0], xy[..., 1])[0]

    def grad(self, xy: torch.Tensor) -> torch.Tensor:
        """Gradient of the interpolant at ``xy`` (``[..., 2]``), zero
        beyond the grid."""
        _, gx, gy = self._cell(xy[..., 0], xy[..., 1])
        return torch.stack([gx, gy], dim=-1)

    def plane_xy(self, x: torch.Tensor, y: torch.Tensor) -> tuple:
        """Local tangent plane ``h = c + gx·x + gy·y`` of the interpolant
        at world ``(x, y)``: three tensors of the inputs' shape."""
        h, gx, gy = self._cell(x, y)
        return h - gx * x - gy * y, gx, gy

    def plane(self, xy: torch.Tensor) -> tuple:
        """:meth:`plane_xy` at ``xy[..., 2]``."""
        return self.plane_xy(xy[..., 0], xy[..., 1])

    def normal(self, xy: torch.Tensor) -> torch.Tensor:
        """Upward unit surface normal at ``xy`` (``[..., 3]``)."""
        g = self.grad(xy)
        n = torch.cat([-g, torch.ones_like(g[..., :1])], dim=-1)
        return n / torch.sqrt(torch.sum(n**2, dim=-1, keepdim=True))

    @staticmethod
    def sample(terrain, extent: float, n: int = 256) -> "HeightGrid":
        """Sample any ``height(xy)`` surface (such as an analytic
        :class:`Terrain`) onto an ``n × n`` grid spanning
        ``[-extent, extent]²``. As in the JAX package, the grid points
        are a float64 ``linspace`` rounded to float32, the heights are
        evaluated in float32, and origin and spacing stay Python floats."""
        xs = np.linspace(-extent, extent, n)
        pts = torch.tensor(xs, dtype=torch.float32)
        gx, gy = torch.meshgrid(pts, pts, indexing="ij")
        grid = terrain.height(torch.stack([gx, gy], dim=-1)).numpy()
        step = float(xs[1] - xs[0])
        return HeightGrid(data=grid, x0=float(xs[0]), y0=float(xs[0]), dx=step, dy=step)


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
