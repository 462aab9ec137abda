"""Data terrain: HeightGrid, the plane sampler and the control-step runner
on a HeightGrid, nnx_ppo_tpu_torch against nnx_ppo_tpu on the same table.

The table is carried across (convert.heightgrid_from_fields), so both
sides interpolate the same float32 heights; the port's own ``sample`` is
held to the JAX one separately. The port computes cell coordinates by
multiplying with the reciprocal spacing and interpolates along x first;
the JAX class divides and sums four weighted corners. Heights are
continuous across cells, so they agree to 1e-6 everywhere; gradients are
piecewise constant along their own axis, so they agree to 1e-5 where both
sides land in the same cell (points at least a hundredth of a cell from a
border) and may differ by one cell's change of slope at a border, which a
test of its own states. The runner follows test_torch_physics.py: qpos
2e-4, qvel 2e-3, normals rtol 5e-3 / atol 5e-2, against the JAX runner
(``vmap(run_one)``) and against the two Pallas kernels in interpret mode.
"""

import ctypes

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nnx_ppo_tpu.physics import engine_soa as jax_soa
from nnx_ppo_tpu.physics import terrain as jax_terrain
from nnx_ppo_tpu.physics.models.quadruped import make_quadruped as jax_make_quadruped
from nnx_ppo_tpu.physics.pallas_step import make_control_step_runner as jax_make_runner
from nnx_ppo_tpu.physics.pallas_step import pallas_plane_sampler
from nnx_ppo_tpu_torch.convert import heightgrid_from_fields
from nnx_ppo_tpu_torch.ops import cuda_build
from nnx_ppo_tpu_torch.physics import engine_soa, terrain
from nnx_ppo_tpu_torch.physics.cuda_step import (
    ControlStepPlan,
    control_step_cuda,
    make_control_step_runner,
    pack_params,
    plane_sampler_cuda,
    plane_sampler_plain,
)
from nnx_ppo_tpu_torch.physics.models.quadruped import default_qpos, make_quadruped
from nnx_ppo_tpu_torch.physics.testing import standing_states

torch.set_num_threads(1)

KP, DT = 60.0, 0.002
ROUGH = dict(seed=2, amplitude=0.03, wavelength=1.5)
TABLES = {
    "rough": lambda m: m.rough_terrain(**ROUGH),
    "inclined": lambda m: m.inclined(0.1, -0.06),
}
N, EXTENT = 32, 6.0


def grids(name, n=N, extent=EXTENT):
    """(JAX HeightGrid, the port's on the same table)."""
    jg = jax_terrain.HeightGrid.sample(TABLES[name](jax_terrain), extent=extent, n=n)
    return jg, heightgrid_from_fields(np.asarray(jg.data), jg.x0, jg.y0, jg.dx, jg.dy)


def points(region, grid, count=40, seed=0):
    """World xy in cell coordinates ``index + fraction`` with the fraction
    in [0.05, 0.95], so that no point lies near a cell border."""
    rng = np.random.RandomState(seed)
    nx, ny = grid.shape
    frac = rng.uniform(0.05, 0.95, (count, 2))
    if region == "inside":
        cell = np.stack([rng.randint(1, nx - 2, count), rng.randint(1, ny - 2, count)], axis=1)
    elif region == "edge":  # the first and the last row and column of cells
        cell = np.stack([rng.choice([0, nx - 2], count), rng.choice([0, ny - 2], count)], axis=1)
    else:  # beyond the grid in x, in y, or in both
        cell = np.stack([rng.choice([-3, 5, nx + 1], count), rng.choice([-2, 7, ny + 2], count)], axis=1)
        cell[0] = [-3, -2]
    uv = cell + frac
    return np.stack([grid.x0 + uv[:, 0] * grid.dx, grid.y0 + uv[:, 1] * grid.dy], axis=1).astype(np.float32)


# -- the class ---------------------------------------------------------------


@pytest.mark.parametrize("region", ["inside", "edge", "outside"])
@pytest.mark.parametrize("table", list(TABLES))
def test_heightgrid_height_grad_plane_normal_match_jax(table, region):
    jg, tg = grids(table)
    xy = points(region, tg)
    jxy, txy = jnp.asarray(xy), torch.tensor(xy)
    np.testing.assert_allclose(tg.height(txy).numpy(), np.asarray(jg.height(jxy)), rtol=0, atol=1e-6)
    np.testing.assert_allclose(tg.grad(txy).numpy(), np.asarray(jg.grad(jxy)), rtol=0, atol=1e-5)
    want_plane = jg.plane(jxy)
    for got, want, name in zip(tg.plane(txy), want_plane, ("c", "gx", "gy")):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5, err_msg=name)
    want_normal = np.asarray(jax.vmap(jg.normal)(jxy))
    np.testing.assert_allclose(tg.normal(txy).numpy(), want_normal, rtol=0, atol=1e-5)
    # Batched over any leading dimensions, as the env's height scan calls it.
    stacked = tg.height(txy.reshape(4, 10, 2))
    assert stacked.shape == (4, 10) and torch.equal(stacked.reshape(-1), tg.height(txy))
    if region == "outside":
        # Flat extension: the height of the clamped point, zero slope along
        # every axis the point is beyond.
        nx, ny = tg.shape
        x_max, y_max = tg.x0 + (nx - 1) * tg.dx, tg.y0 + (ny - 1) * tg.dy
        clamped = torch.stack(
            [txy[:, 0].clamp(tg.x0, x_max), txy[:, 1].clamp(tg.y0, y_max)], dim=1
        )
        np.testing.assert_allclose(tg.height(txy).numpy(), tg.height(clamped).numpy(), rtol=0, atol=1e-6)
        g = tg.grad(txy)
        assert torch.all(g[(txy[:, 0] < tg.x0) | (txy[:, 0] > x_max), 0] == 0)
        assert torch.all(g[(txy[:, 1] < tg.y0) | (txy[:, 1] > y_max), 1] == 0)
        assert g[0].abs().max() == 0  # beyond in both


def test_heightgrid_at_a_cell_border_keeps_the_height_and_takes_a_neighbours_slope():
    """On a border the two sides may land in neighbouring cells: the height
    is the same (the interpolant is continuous), the gradient across the
    border is that of one of the two cells."""
    jg, tg = grids("rough")
    i, j = 11, 17
    on_border = np.array([[tg.x0 + i * tg.dx, tg.y0 + (j + 0.4) * tg.dy]], np.float32)
    left = np.array([[tg.x0 + (i - 0.5) * tg.dx, on_border[0, 1]]], np.float32)
    right = np.array([[tg.x0 + (i + 0.5) * tg.dx, on_border[0, 1]]], np.float32)
    np.testing.assert_allclose(
        tg.height(torch.tensor(on_border)).numpy(), np.asarray(jg.height(jnp.asarray(on_border))),
        rtol=0, atol=1e-6,
    )
    gx = tg.grad(torch.tensor(on_border))[0, 0].item()
    neighbours = [tg.grad(torch.tensor(p))[0, 0].item() for p in (left, right)]
    assert abs(neighbours[0] - neighbours[1]) > 1e-4  # the slope does change here
    assert min(abs(gx - n) for n in neighbours) < 1e-6
    # The low corner of the grid is exact on both sides: inside, with slope.
    corner = np.array([[tg.x0, tg.y0]], np.float32)
    np.testing.assert_allclose(
        tg.grad(torch.tensor(corner)).numpy(), np.asarray(jg.grad(jnp.asarray(corner))), rtol=0, atol=1e-5
    )
    assert tg.grad(torch.tensor(corner)).abs().min() > 0


@pytest.mark.parametrize("table", list(TABLES))
def test_heightgrid_sample_matches_jax(table):
    """float64 linspace rounded to float32, heights evaluated in float32:
    1e-6 on the table, origin and spacing equal."""
    jg = jax_terrain.HeightGrid.sample(TABLES[table](jax_terrain), extent=12.0, n=48)
    tg = terrain.HeightGrid.sample(TABLES[table](terrain), extent=12.0, n=48)
    assert (tg.x0, tg.y0, tg.dx, tg.dy) == (jg.x0, jg.y0, jg.dx, jg.dy)
    assert tg.data.shape == (48, 48) and tg.data.dtype == np.float32
    np.testing.assert_allclose(tg.data, np.asarray(jg.data), rtol=0, atol=1e-6)
    assert tg.table("cpu") is tg.table(torch.device("cpu"))  # copied once


def test_heightgrid_is_checked_and_converted():
    with pytest.raises(ValueError, match=r"\[nx, ny\]"):
        terrain.HeightGrid(np.zeros(4), 0.0, 0.0, 1.0, 1.0)
    with pytest.raises(ValueError, match="2x2"):
        terrain.HeightGrid(np.zeros((1, 4)), 0.0, 0.0, 1.0, 1.0)
    jg, tg = grids("rough")
    assert isinstance(tg, terrain.HeightGrid) and tg.shape == (N, N)
    np.testing.assert_array_equal(tg.data, np.asarray(jg.data))
    assert engine_soa.soa_features_unsupported_reason(terrain=tg) is None
    assert "HeightGrid" in engine_soa.soa_features_unsupported_reason(terrain=object())


# -- the sampler -------------------------------------------------------------


def standing(B, seed, table="rough"):
    tm = make_quadruped()
    return standing_states(
        tm, default_qpos(tm), B, seed, terrain=TABLES[table](terrain), spawn_radius=4.0
    )


def test_heightgrid_planes_soa_matches_jax_lane_function():
    """The port gathers four corners; the JAX lane function multiplies
    one-hot matrices with the table. Same planes to 1e-5."""
    jg, tg = grids("rough")
    jm, tm = jax_make_quadruped(), make_quadruped()
    qpos = standing(8, seed=1)["qpos"]
    jE, jP, _, _, _ = jax_soa._kin_soa(jm, tuple(jnp.asarray(qpos[:, k]) for k in range(19)))
    want = jax_soa.heightgrid_planes_soa(jg, jnp.asarray(np.asarray(jg.data)), jm, jE, jP)
    tE, tP, _, _, _ = engine_soa._kin_soa(tm, tuple(torch.tensor(qpos[:, k]) for k in range(19)))
    got = engine_soa.heightgrid_planes_soa(tg, tm, tE, tP)
    assert len(got) == 8 and all(len(plane) == 3 for plane in got)
    for g in range(8):
        for k in range(3):
            np.testing.assert_allclose(
                got[g][k].numpy(), np.asarray(want[g][k]), rtol=0, atol=1e-5, err_msg=f"geom {g} lane {k}"
            )
    assert max(float(got[g][1].abs().max()) for g in range(8)) > 1e-3


def test_plane_sampler_plain_matches_pallas_kernel_in_interpret_mode():
    """The TPU sampler kernel itself, interpreted on the CPU: [B, 24]
    lanes (c, gx, gy per ground geom), 1e-5."""
    jg, tg = grids("rough")
    qpos = standing(8, seed=2)["qpos"]
    want = pallas_plane_sampler(
        jax_make_quadruped(), jg, jnp.asarray(qpos), jnp.asarray(np.asarray(jg.data)),
        tile=8, interpret=True,
    )
    before = plane_sampler_cuda.launches
    got = plane_sampler_plain(make_quadruped(), tg, torch.tensor(qpos))
    assert plane_sampler_cuda.launches == before
    assert got.shape == (8, 24) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-5)
    with pytest.raises(ValueError, match="CUDA tensors"):
        plane_sampler_cuda(make_quadruped(), tg, torch.tensor(qpos))


# -- the runner --------------------------------------------------------------


def assert_control_step_close(got, want):
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=0, atol=2e-4)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=0, atol=2e-3)
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]), rtol=5e-3, atol=5e-2)


@pytest.mark.parametrize("path", ["vmap_run_one", "pallas_interpret"])
def test_heightgrid_runner_matches_jax_runner(path):
    """Two substeps on frozen planes. ``vmap_run_one`` is what the JAX
    runner does off the TPU (2 envs: it traces the unrolled step);
    ``pallas_interpret`` forces the sampler kernel and the control-step
    kernel, interpreted (8 envs)."""
    jg, tg = grids("rough")
    B = 2 if path == "vmap_run_one" else 8
    s = standing(B, seed=4)
    arrays = [s[k] for k in ("qpos", "qvel", "target")]
    jax_run = jax_make_runner(
        jax_make_quadruped(), KP, DT, 2, terrain=jg, force_pallas=(path == "pallas_interpret")
    )
    want = jax.vmap(jax_run)(*(jnp.asarray(a) for a in arrays))
    run = make_control_step_runner(make_quadruped(), KP, DT, 2, terrain=tg)
    before = (plane_sampler_cuda.launches, control_step_cuda.launches)
    got = run(*(torch.tensor(a) for a in arrays))
    assert (plane_sampler_cuda.launches, control_step_cuda.launches) == before
    assert got[2].shape == (B, 8)
    assert_control_step_close(got, want)
    assert (np.asarray(want[2]) > 0).any()


def test_heightgrid_runner_takes_dr_and_push_lanes_before_the_planes():
    """The caller's extra is [dr..., push]; the runner appends the planes
    (the _split_extra order). Held against the explicit-planes plan."""
    _, tg = grids("rough")
    tm = make_quadruped()
    s = standing_states(tm, default_qpos(tm), 6, 5, terrain=TABLES["rough"](terrain),
                        n_extra_dr=4, has_push=True, spawn_radius=4.0)
    args = [torch.tensor(s[k]) for k in ("qpos", "qvel", "target", "extra")]
    fields = ("mass_scale", "friction", "damping_scale", "gain_scale")
    run = make_control_step_runner(tm, KP, DT, 3, terrain=tg, dr_fields=fields, has_push=True)
    assert (run.n_caller_extra, run.n_extra, run.n_terrain_planes) == (7, 31, 8)
    planes = plane_sampler_plain(tm, tg, args[0])
    explicit = ControlStepPlan(tm, KP, DT, 3, dr_fields=fields, has_push=True, n_terrain_planes=8)
    want = explicit(*args[:3], torch.cat([args[3], planes], dim=1))
    for a, b in zip(run(*args), want):
        assert torch.equal(a, b)
    with pytest.raises(ValueError, match="extra"):
        run(*args[:3])
    with pytest.raises(ValueError, match="extra"):
        run(*args[:3], torch.cat([args[3], planes], dim=1))
    with pytest.raises(ValueError, match="no HeightGrid"):
        explicit.sample_planes_plain(args[0])


def test_inclined_grid_gives_what_the_analytic_plane_gives():
    """The bilinear interpolant of a plane is the plane and its frozen
    tangent plane is exact, so the data path must reproduce the analytic
    inclined() path (the check of tests/test_heightgrid_kernel.py:95-129,
    at its tolerances: qpos 1e-4, qvel 1e-3)."""
    tm = make_quadruped()
    grid = terrain.HeightGrid.sample(terrain.inclined(0.1, -0.06), extent=12.0, n=96)
    s = standing_states(tm, default_qpos(tm), 6, 7, terrain=terrain.inclined(0.1, -0.06),
                        spawn_radius=3.0)
    args = [torch.tensor(s[k]) for k in ("qpos", "qvel", "target")]
    on_grid = make_control_step_runner(tm, KP, DT, 4, terrain=grid)(*args)
    analytic = make_control_step_runner(tm, KP, DT, 4, terrain=terrain.inclined(0.1, -0.06))(*args)
    np.testing.assert_allclose(on_grid[0].numpy(), analytic[0].numpy(), rtol=1e-4, atol=1e-4)
    np.testing.assert_allclose(on_grid[1].numpy(), analytic[1].numpy(), rtol=1e-3, atol=1e-3)
    assert (analytic[2] > 0).any()
    planes = plane_sampler_plain(tm, grid, args[0]).reshape(6, 8, 3)
    np.testing.assert_allclose(planes[..., 0].numpy(), 0.0, atol=2e-5)
    np.testing.assert_allclose(planes[..., 1].numpy(), 0.1, atol=2e-5)
    np.testing.assert_allclose(planes[..., 2].numpy(), -0.06, atol=2e-5)


# -- what the kernels are built from, as far as the CPU reaches -------------------


def test_heightgrid_plan_packs_plane_lanes_and_names_both_libraries():
    _, tg = grids("rough")
    plan = ControlStepPlan(make_quadruped(), KP, DT, 10, terrain=tg, dr_fields=("friction",))
    assert plan.terrain is None and plan.heightgrid is tg
    p = pack_params(plan)
    assert (p.terrain_mode, p.idx_friction, p.idx_push, p.idx_planes, p.n_extra) == (2, 0, -1, 1, 25)
    assert ctypes.sizeof(p) <= 4096
    names = [name for name, _ in plan.kernel_specs]
    assert names == ["control_step", "plane_sampler"]
    control, sampler = (flags for _, flags in plan.kernel_specs)
    assert control == plan.kernel_spec[1] and sampler == plan.sampler_spec[1]
    # The same model sizes and build flags; each library its own lanes per
    # env, so building the sampler leaves the control step's library as it is.
    assert ([f for f in control if not f.startswith("-DCS_G=")]
            == [f for f in sampler if not f.startswith("-DPS_G=")])
    assert f"-DCS_G={plan.group_size}" in control and f"-DPS_G={plan.sampler_group}" in sampler
    assert not any(f.startswith("-DCS_G=") for f in sampler)
    assert plan.sizes["CS_NW"] == 0 and "-fmad=false" in plan.kernel_spec[1]
    flat = ControlStepPlan(make_quadruped(), KP, DT, 10)
    assert [name for name, _ in flat.kernel_specs] == ["control_step"]
    with pytest.raises(ValueError, match="mutually exclusive"):
        ControlStepPlan(make_quadruped(), KP, DT, 10, terrain=tg, n_terrain_planes=8)


def test_library_name_follows_the_shared_header(tmp_path, monkeypatch):
    """A library built before a header changed must not be loaded for the
    new sources: the header's text is part of the name's hash."""
    (tmp_path / "kernel.cu").write_text('#include "shared.cuh"\n')
    (tmp_path / "shared.cuh").write_text("// one\n")
    monkeypatch.setattr(cuda_build, "CSRC_DIR", tmp_path)
    first = cuda_build.library_path("kernel", ("-DX=1",))
    assert first == cuda_build.library_path("kernel", ("-DX=1",))
    assert first != cuda_build.library_path("kernel", ("-DX=2",))
    (tmp_path / "shared.cuh").write_text("// two\n")
    assert cuda_build.library_path("kernel", ("-DX=1",)) != first
    sources = {p.name for p in cuda_build.CSRC_DIR.glob("*")}
    assert sources == {"kernel.cu", "shared.cuh"}
