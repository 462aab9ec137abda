"""Physics parity: the model, terrain, SoA substep and control step of
nnx_ppo_tpu_torch against nnx_ppo_tpu on the same numpy inputs.

Both sides run the same float32 lane arithmetic in the same order (the
port's engine_soa.py is the JAX file with jnp replaced by torch), so they
differ only in how sin, cos, sqrt and division round in the two
libraries. The contact switch (phi > 0) and the 6000 N/m contact
stiffness amplify that, hence the tolerances of the JAX package's own
kernel tests: one substep qpos 2e-5, qvel 2e-4, normals 1e-4 relative
to their size; a control step of a few substeps qpos 2e-4, qvel 2e-3,
normals rtol 5e-3 / atol 5e-2. The JAX side runs eagerly on [B] lanes or
env by env (no jit and no vmap: tracing the unrolled substep costs more
than running it once), and the Pallas kernel in interpret mode.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nnx_ppo_tpu.physics import engine_soa as jax_soa
from nnx_ppo_tpu.physics import terrain as jax_terrain
from nnx_ppo_tpu.physics.models.quadruped import make_quadruped as jax_make_quadruped
from nnx_ppo_tpu.physics.pallas_step import make_control_step_runner as jax_make_runner
from nnx_ppo_tpu.physics.pallas_step import _split_extra as jax_split_extra
from nnx_ppo_tpu.physics.pallas_step import pallas_control_step
from nnx_ppo_tpu_torch.physics import engine_soa, terrain
from nnx_ppo_tpu_torch.physics.cuda_step import (
    ControlStepPlan,
    control_step_cuda,
    control_step_plain,
    make_control_step_runner,
    pack_params,
)
from nnx_ppo_tpu_torch.physics.models.quadruped import default_qpos, make_quadruped
from nnx_ppo_tpu_torch.physics.testing import standing_states

torch.set_num_threads(1)

KP, DT = 60.0, 0.002
DR_FIELDS = ("mass_scale", "friction", "damping_scale", "gain_scale")
MODEL_KW = {
    "plain": {},
    "self_collision": {"self_collision": True},
    "joint_limits": {"joint_limits": True},
}
ROUGH = dict(seed=2, amplitude=0.03, wavelength=1.5)


def jax_lanes(a):
    return tuple(jnp.asarray(a[:, k]) for k in range(a.shape[1]))


def torch_lanes(a):
    return tuple(torch.from_numpy(np.ascontiguousarray(a[:, k])) for k in range(a.shape[1]))


def stacked(lanes):
    return np.stack([np.asarray(x) for x in lanes], axis=1)


# -- (a) model and terrain -------------------------------------------------


@pytest.mark.parametrize("variant", list(MODEL_KW))
def test_quadruped_model_fields_match_jax(variant):
    """The model is numpy on both sides: equal to the bit."""
    want = jax_make_quadruped(**MODEL_KW[variant])
    got = make_quadruped(**MODEL_KW[variant])
    assert (got.n_bodies, got.nq, got.nv, got.nj) == (13, 19, 18, 12)
    for name in (
        "parent", "joint_type", "geom_body", "pair_geom_a", "pair_geom_b", "gravity",
        "contact_stiffness", "contact_damping", "friction", "friction_vel",
        "max_contact_force", "limit_stiffness", "limit_damping",
    ):
        assert getattr(got, name) == getattr(want, name), name
    for name in (
        "joint_axis", "joint_pos", "mass", "com", "inertia", "geom_offset", "geom_radius",
        "damping", "armature", "joint_lower", "joint_upper", "spring_stiffness", "spring_ref",
    ):
        np.testing.assert_array_equal(getattr(got, name), getattr(want, name), err_msg=name)
    assert got.dof_slices() == want.dof_slices()
    np.testing.assert_array_equal(default_qpos(got), default_qpos(want))


TERRAINS = {
    "rough": (lambda m: m.rough_terrain(**ROUGH)),
    "rough_sloped": (lambda m: m.rough_terrain(seed=5, n_waves=4, slope=(0.05, -0.02))),
    "stairs": (lambda m: m.stairs(direction=(1.0, 0.5))),
    "inclined": (lambda m: m.inclined(0.1, -0.2)),
    "flat": (lambda m: m.flat()),
}


@pytest.mark.parametrize("name", list(TERRAINS))
def test_terrain_height_grad_normal_match_jax(name):
    """float32 sums of a few sines: 1e-6 absolute (heights and gradients
    are of order 0.1; the sine arguments reach about 20)."""
    want_t, got_t = TERRAINS[name](jax_terrain), TERRAINS[name](terrain)
    assert got_t == terrain.Terrain(**{f: getattr(want_t, f) for f in (
        "amplitudes", "frequencies", "directions", "phases", "slope")})
    xy = np.random.RandomState(0).uniform(-5, 5, (7, 3, 2)).astype(np.float32)
    flat_xy = jnp.asarray(xy.reshape(-1, 2))
    for method, shape in (("height", (7, 3)), ("grad", (7, 3, 2)), ("normal", (7, 3, 3))):
        want = np.asarray(jax.vmap(getattr(want_t, method))(flat_xy)).reshape(shape)
        got = getattr(got_t, method)(torch.from_numpy(xy)).numpy()
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6, err_msg=method)


def test_heightgrid_is_not_ported():
    """What of HeightGrid stays behind: the TPU's no-gather form (one-hot
    matrix products) has no counterpart; the class itself is ported
    (tests/test_torch_heightgrid.py) and indexes its table directly."""
    grid = terrain.HeightGrid(np.zeros((4, 4)), 0.0, 0.0, 1.0, 1.0)
    assert not hasattr(grid, "_use_dot") and not hasattr(grid, "_plane_via_dot")
    assert hasattr(jax_terrain.HeightGrid, "_plane_via_dot")
    assert float(grid.height(torch.tensor([[1.5, 2.5]]))) == 0.0


# -- shared inputs ------------------------------------------------------------


def states(model, B, seed, terrain_obj=None, full=False):
    return standing_states(
        model, default_qpos(model), B, seed, terrain=terrain_obj,
        n_extra_dr=4 if full else 0, has_push=full,
    )


# -- (b) CRBA + Cholesky ------------------------------------------------------


@pytest.mark.parametrize("scaled", [False, True], ids=["unscaled", "mass_and_damping_scaled"])
def test_crba_chol_matches_jax(scaled):
    """1e-4 relative to the largest factor entry (about 3.5): 171 entries
    built from sums of up to 18 products."""
    B = 6
    s = states(make_quadruped(), B, seed=1, full=True)
    kw_j, kw_t = {}, {}
    if scaled:
        kw_j = dict(mass_scale=jnp.asarray(s["extra"][:, 0]), damping_scale=jnp.asarray(s["extra"][:, 2]))
        kw_t = dict(mass_scale=torch.from_numpy(s["extra"][:, 0].copy()),
                    damping_scale=torch.from_numpy(s["extra"][:, 2].copy()))
    want = jax_soa.crba_chol_soa(jax_make_quadruped(), jax_lanes(s["qpos"]), DT, **kw_j)
    got = engine_soa.crba_chol_soa(make_quadruped(), torch_lanes(s["qpos"]), DT, **kw_t)
    assert len(got) == 18 and [len(row) for row in got] == list(range(1, 19))
    want_flat = stacked([x for row in want for x in row])
    got_flat = stacked([x for row in got for x in row])
    np.testing.assert_allclose(got_flat, want_flat, rtol=0, atol=1e-4 * np.abs(want_flat).max())
    if scaled:
        unscaled = stacked([x for row in engine_soa.crba_chol_soa(
            make_quadruped(), torch_lanes(s["qpos"]), DT) for x in row])
        assert np.abs(got_flat - unscaled).max() > 1e-2


# -- (c) one substep ------------------------------------------------------------

SUBSTEP_CASES = ["flat", "terrain", "terrain_planes", "dr_lanes", "push", "self_collision",
                 "joint_limits", "everything"]


def substep_case(case, mod, lanes, as_lane):
    """(model, state arrays, substep kwargs) of one case for the package
    whose quadruped factory, terrain module and lane makers are given."""
    make, terrain_mod = mod
    model_kw = {}
    if case in ("self_collision", "everything"):
        model_kw["self_collision"] = True
    if case in ("joint_limits", "everything"):
        model_kw["joint_limits"] = True
    model = make(**model_kw)
    port_model = make_quadruped(**model_kw)
    terrain_obj = None
    if case in ("terrain", "everything"):
        terrain_obj = terrain.rough_terrain(**ROUGH)
    s = states(port_model, 8, seed=2, terrain_obj=terrain_obj, full=True)
    if case in ("self_collision", "everything"):
        # Swing the front legs inward until the two front feet overlap
        # (centers 3 cm apart, radii 2.2 cm each).
        s["qpos"][:4, 7:13] = [0.38, 0.8, -1.6, -0.38, 0.8, -1.6]
    if case in ("joint_limits", "everything"):
        s["qpos"][2:6, 9] = -0.7  # knee past its upper stop (-0.89)
    kw = {}
    if terrain_obj is not None:
        kw["terrain"] = terrain_mod.rough_terrain(**ROUGH)
    if case == "terrain_planes":
        rng = np.random.RandomState(9)
        planes = np.concatenate(
            [0.01 * rng.randn(8, 8, 1), 0.1 * rng.randn(8, 8, 2)], axis=-1
        ).astype(np.float32)  # [B, geom, (c, gx, gy)]
        kw["terrain_planes"] = tuple(
            tuple(as_lane(planes[:, g, k]) for k in range(3)) for g in range(8)
        )
    if case in ("dr_lanes", "everything"):
        for i, name in enumerate(DR_FIELDS):
            kw[name] = as_lane(s["extra"][:, i])
    if case in ("push", "everything"):
        push = s["extra"][:, 4:7].copy()
        push[:, 2] = 5.0  # exercise the z lane too
        kw["push"] = tuple(as_lane(push[:, k]) for k in range(3))
    return model, s, kw


@pytest.mark.parametrize("case", SUBSTEP_CASES)
def test_substep_matches_jax(case):
    as_jax = lambda a: jnp.asarray(np.ascontiguousarray(a))
    as_torch = lambda a: torch.from_numpy(np.ascontiguousarray(a))
    jm, s, jkw = substep_case(case, (jax_make_quadruped, jax_terrain), jax_lanes, as_jax)
    tm, _, tkw = substep_case(case, (make_quadruped, terrain), torch_lanes, as_torch)
    crba_j = {k: v for k, v in jkw.items() if k in ("mass_scale", "damping_scale")}
    crba_t = {k: v for k, v in tkw.items() if k in ("mass_scale", "damping_scale")}
    chol_j = jax_soa.crba_chol_soa(jm, jax_lanes(s["qpos"]), DT, **crba_j)
    chol_t = engine_soa.crba_chol_soa(tm, torch_lanes(s["qpos"]), DT, **crba_t)
    want = jax_soa.substep_soa(
        jm, jax_lanes(s["qpos"]), jax_lanes(s["qvel"]), jax_lanes(s["target"]), chol_j, KP, DT, **jkw
    )
    got = engine_soa.substep_soa(
        tm, torch_lanes(s["qpos"]), torch_lanes(s["qvel"]), torch_lanes(s["target"]), chol_t,
        KP, DT, **tkw
    )
    want_qpos, want_qvel, want_normals = (stacked(x) for x in want)
    got_qpos, got_qvel, got_normals = (stacked(x) for x in got)
    np.testing.assert_allclose(got_qpos, want_qpos, rtol=0, atol=2e-5)
    np.testing.assert_allclose(got_qvel, want_qvel, rtol=0, atol=2e-4)
    np.testing.assert_allclose(
        got_normals, want_normals, rtol=0, atol=1e-4 * max(np.abs(want_normals).max(), 1.0)
    )
    n_ground = 8
    assert (want_normals[:, :n_ground] > 0).any(), "no ground contact in this case"
    if case in ("self_collision", "everything"):
        assert want_normals.shape[1] == 12 and (want_normals[:, n_ground:] > 0).any()
    assert np.abs(got_qvel - s["qvel"]).max() > 1e-2  # the step did something


# -- (d) the whole control step ------------------------------------------------


def control_step_pair(exact, full, n_substeps, B=8, model_kw=None):
    model_kw = model_kw or {}
    jm, tm = jax_make_quadruped(**model_kw), make_quadruped(**model_kw)
    kw = dict(dr_fields=DR_FIELDS, has_push=True) if full else {}
    jt = jax_terrain.rough_terrain(**ROUGH) if full else None
    tt = terrain.rough_terrain(**ROUGH) if full else None
    s = states(tm, B, seed=4, terrain_obj=tt, full=full)
    keys = ("qpos", "qvel", "target") + (("extra",) if full else ())
    return jm, tm, jt, tt, kw, [s[k] for k in keys]


def jax_control_step_on_lanes(jm, arrays, n_substeps, exact, jt, kw):
    """The body of the JAX runner's per-env function (run_one,
    pallas_step.py:434-464) on [B] lanes instead of under vmap: the same
    JAX functions on the same values, without the cost of tracing the
    unrolled factor build per call."""
    qp, qv, tgt = (jax_lanes(a) for a in arrays[:3])
    sub_kw, crba_kw = {}, {}
    if len(arrays) == 4:
        sub_kw, crba_kw = jax_split_extra(
            jax_lanes(arrays[3]), kw["dr_fields"], kw["has_push"]
        )
    chol = None if exact else jax_soa.crba_chol_soa(jm, qp, DT, **crba_kw)
    normals = None
    for _ in range(n_substeps):
        if exact:
            chol = jax_soa.crba_chol_soa(jm, qp, DT, **crba_kw)
        qp, qv, normals = jax_soa.substep_soa(jm, qp, qv, tgt, chol, KP, DT, terrain=jt, **sub_kw)
    return stacked(qp), stacked(qv), stacked(normals)


def assert_control_step_close(got, want):
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=0, atol=2e-4)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=0, atol=2e-3)
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]), rtol=5e-3, atol=5e-2)


@pytest.mark.parametrize("exact", [False, True], ids=["held", "exact"])
@pytest.mark.parametrize("full", [True, False], ids=["full_features", "flat_no_extras"])
def test_control_step_plain_matches_jax(exact, full):
    """B = 8, three substeps, held and exact factor, with and without the
    feature lanes."""
    jm, tm, jt, tt, kw, arrays = control_step_pair(exact, full, n_substeps=3)
    want = jax_control_step_on_lanes(jm, arrays, 3, exact, jt, kw)
    run = make_control_step_runner(tm, KP, DT, 3, exact=exact, terrain=tt, **kw)
    before = control_step_cuda.launches
    got = run(*(torch.from_numpy(a) for a in arrays))
    assert control_step_cuda.launches == before  # CPU tensors: the plain version
    assert got[0].shape == (8, 19) and got[1].shape == (8, 18) and got[2].shape == (8, 8)
    assert_control_step_close(got, want)
    assert (want[2] > 0).any()


def test_control_step_plain_matches_jax_runner_per_env():
    """The JAX runner itself, called env by env (its unbatched call is
    run_one, the function it vmaps off the TPU): two substeps, full
    feature set, one env (each call traces the unrolled step anew, about
    ten seconds)."""
    jm, tm, jt, tt, kw, arrays = control_step_pair(False, True, n_substeps=2, B=1)
    jax_run = jax_make_runner(jm, KP, DT, 2, terrain=jt, **kw)
    per_env = [jax_run(*(jnp.asarray(a[b]) for a in arrays)) for b in range(1)]
    want = [np.stack([np.asarray(o[k]) for o in per_env]) for k in range(3)]
    got = make_control_step_runner(tm, KP, DT, 2, terrain=tt, **kw)(
        *(torch.from_numpy(a) for a in arrays)
    )
    assert_control_step_close(got, want)


def test_control_step_plain_matches_pallas_kernel_in_interpret_mode():
    """The TPU kernel itself, interpreted on the CPU: two substeps, the
    full feature set."""
    jm, tm, jt, tt, kw, arrays = control_step_pair(False, True, n_substeps=2)
    want = pallas_control_step(
        jm, *(jnp.asarray(a) for a in arrays[:3]), KP, DT, 2, tile=8, interpret=True,
        terrain=jt, extra=jnp.asarray(arrays[3]), **kw,
    )
    got = control_step_plain(
        tm, *(torch.from_numpy(a) for a in arrays[:3]), KP, DT, 2, terrain=tt,
        extra=torch.from_numpy(arrays[3]), **kw,
    )
    assert got[2].shape == (8, 8)
    assert_control_step_close(got, want)


def test_exact_and_held_factor_differ():
    _, tm, _, _, _, arrays = control_step_pair(False, False, n_substeps=3)
    args = [torch.from_numpy(a) for a in arrays]
    held = control_step_plain(tm, *args, KP, DT, 3)
    exact = control_step_plain(tm, *args, KP, DT, 3, exact=True)
    diff = (held[1] - exact[1]).abs().max().item()
    assert 1e-5 < diff < 0.5


# -- the kernel's wrapper, as far as the CPU reaches --------------------------


def test_kernel_struct_packing_and_build_spec():
    """The struct the kernel takes by value: sizes that name the library,
    members filled from the model, `extra` columns in the env's order."""
    tm = make_quadruped(self_collision=True, joint_limits=True)
    plan = ControlStepPlan(tm, KP, DT, 10, True, terrain=terrain.rough_terrain(**ROUGH),
                           dr_fields=("friction", "gain_scale"), has_push=True)
    assert plan.sizes == {"CS_NB": 13, "CS_NG": 8, "CS_NP": 4, "CS_NW": 6,
                          "CS_G": plan.group_size}
    name, flags = plan.kernel_spec
    assert name == "control_step" and "-DCS_NP=4" in flags and "--use_fast_math" not in flags
    p = pack_params(plan)
    import ctypes
    assert ctypes.sizeof(p) <= 4096 and ctypes.sizeof(p) % 4 == 0
    assert list(p.parent) == list(tm.parent)
    assert (p.idx_mass_scale, p.idx_friction, p.idx_damping_scale, p.idx_gain_scale) == (-1, 0, -1, 1)
    assert (p.idx_push, p.idx_planes, p.n_extra) == (2, -1, 5)
    assert (p.exact, p.terrain_mode, p.has_limits, p.n_substeps) == (1, 1, 1, 10)
    np.testing.assert_allclose(p.lower[2], -2.82, rtol=1e-6)
    assert p.upper[0] == np.float32(0.86) and p.gravity_up == np.float32(9.81)
    np.testing.assert_allclose(list(p.dt_damping)[6:], [DT * 2.0] * 12, rtol=1e-6)
    # Spatial inertia blocks of the trunk: com at the origin.
    np.testing.assert_allclose(list(p.blk_c[:9]), (5.2 * np.eye(3)).reshape(-1), rtol=1e-6)
    flat = pack_params(ControlStepPlan(make_quadruped(), KP, DT, 10))
    assert (flat.terrain_mode, flat.n_extra, flat.has_limits) == (0, 0, 1)
    assert all(np.isinf(flat.lower[j]) for j in range(12))


def test_runner_rejects_what_the_kernel_cannot_take():
    tm = make_quadruped()
    run = make_control_step_runner(tm, KP, DT, 2, dr_fields=DR_FIELDS, has_push=True)
    s = states(tm, 4, seed=0, full=True)
    args = [torch.from_numpy(s[k]) for k in ("qpos", "qvel", "target", "extra")]
    with pytest.raises(ValueError, match="extra"):
        run(*args[:3])
    with pytest.raises(ValueError, match="qvel"):
        run(args[0], args[1][:, :5], args[2], args[3])
    with pytest.raises(ValueError, match="CUDA tensors"):
        run.cuda(*args)
    with pytest.raises(ValueError, match="unknown"):
        make_control_step_runner(tm, KP, DT, 2, dr_fields=("density",))
    with pytest.raises(ValueError, match="free-base"):
        import dataclasses
        fixed = dataclasses.replace(tm, joint_type=("hinge",) * 13)
        make_control_step_runner(fixed, KP, DT, 2)
