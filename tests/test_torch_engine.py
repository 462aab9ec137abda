"""The passed-in-factor physics path: ops/linalg.py, physics/spatial.py,
the factor part of physics/engine.py and the substeps runner of
nnx_ppo_tpu_torch against nnx_ppo_tpu on the same numpy inputs.

Both sides run float32 arithmetic in the same order, batched here and
vmapped there, so they differ by rounding only: 1e-5 absolute on values of
order one (1e-4 relative to the largest entry for the factor, whose
entries come from sums of up to 18 products). The substeps follow the
tolerances of test_torch_physics.py: a few substeps qpos 2e-4, qvel 2e-3,
normals rtol 5e-3 / atol 5e-2 (the contact switch and the 6000 N/m
contact stiffness amplify rounding). The Pallas kernel runs in interpret
mode on a small batch.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nnx_ppo_tpu.ops import linalg as jax_linalg
from nnx_ppo_tpu.physics import engine as jax_engine
from nnx_ppo_tpu.physics import model as jax_model
from nnx_ppo_tpu.physics import spatial as jax_spatial
from nnx_ppo_tpu.physics.models.quadruped import make_quadruped as jax_make_quadruped
from nnx_ppo_tpu.physics.pallas_step import _tri_indices as jax_tri_indices
from nnx_ppo_tpu.physics.pallas_step import pallas_substeps
from nnx_ppo_tpu_torch.ops import linalg
from nnx_ppo_tpu_torch.physics import engine, spatial
from nnx_ppo_tpu_torch.physics import model as port_model
from nnx_ppo_tpu_torch.physics.cuda_step import (
    _tri_indices,
    control_step_plain,
    make_substep_runner,
    pack_factor,
    substeps_cuda,
    substeps_plain,
)
from nnx_ppo_tpu_torch.physics.models.quadruped import default_qpos, make_quadruped
from nnx_ppo_tpu_torch.physics.randomize import DomainParams
from nnx_ppo_tpu_torch.physics.testing import standing_states

torch.set_num_threads(1)

KP, DT = 60.0, 0.002


def t(a):
    return torch.tensor(np.asarray(a))


def spd(n, batch, seed):
    """Well-conditioned symmetric positive-definite matrices."""
    rng = np.random.RandomState(seed)
    A = rng.randn(*batch, n, n)
    return (A @ np.swapaxes(A, -1, -2) + n * np.eye(n)).astype(np.float32)


# -- ops/linalg.py -------------------------------------------------------------

LINALG_CASES = {
    "cholesky_solve_small_unrolled": ("cholesky_solve_small", 5, "M,rhs"),
    "cholesky_solve_small_above_unroll": ("cholesky_solve_small", 12, "M,rhs"),
    "cholesky_factor_blocked": ("cholesky_factor_blocked", 18, "M"),
    "cholesky_backsub": ("cholesky_backsub", 18, "L,rhs"),
    "tri_lower_inverse": ("tri_lower_inverse", 7, "L"),
    "spd_inverse_from_factor": ("spd_inverse_from_factor", 6, "L"),
    "cholesky_solve_blocked": ("cholesky_solve_blocked", 18, "M,rhs"),
}


@pytest.mark.parametrize("case", list(LINALG_CASES))
def test_linalg_matches_jax(case):
    """Batched over two leading dimensions; 1e-5 relative to the largest
    entry of the result."""
    name, n, signature = LINALG_CASES[case]
    M = spd(n, (3, 4), seed=n)
    arrays = {
        "M": M,
        "L": np.linalg.cholesky(M.astype(np.float64)).astype(np.float32),
        "rhs": np.random.RandomState(1).randn(3, 4, n).astype(np.float32),
    }
    args = [arrays[k] for k in signature.split(",")]
    want = np.asarray(getattr(jax_linalg, name)(*(jnp.asarray(a) for a in args)))
    got = getattr(linalg, name)(*(t(a) for a in args)).numpy()
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5 * np.abs(want).max())


def test_linalg_factor_is_the_cholesky_factor_and_checks_shapes():
    M = spd(18, (5,), seed=0)
    L = linalg.cholesky_factor_blocked(t(M))
    assert torch.equal(L, torch.tril(L))
    np.testing.assert_allclose((L @ L.transpose(-1, -2)).numpy(), M, rtol=0, atol=1e-4)
    for fn in (linalg.cholesky_solve_small, linalg.cholesky_backsub, linalg.cholesky_solve_blocked):
        with pytest.raises(ValueError, match="rhs last dim"):
            fn(t(M), torch.zeros(5, 17))


# -- physics/spatial.py --------------------------------------------------------


def _unit(a):
    return (a / np.linalg.norm(a, axis=-1, keepdims=True)).astype(np.float32)


def spatial_inputs():
    rng = np.random.RandomState(3)
    B = 6
    inertia = spd(3, (B,), seed=4) * 0.01
    return {
        "v3": rng.randn(B, 3).astype(np.float32),
        "v6": rng.randn(B, 6).astype(np.float32),
        "R": np.asarray(jax.vmap(jax_spatial.quat_to_rot)(jnp.asarray(_unit(rng.randn(B, 4))))),
        "X": rng.randn(B, 6, 6).astype(np.float32),
        "mass": rng.uniform(0.5, 3.0, B).astype(np.float32),
        "inertia": inertia,
        "q": _unit(rng.randn(B, 4)),
        "q2": _unit(rng.randn(B, 4)),
        "angle": rng.uniform(-3, 3, B).astype(np.float32),
    }


SPATIAL_CASES = {
    "skew": ("v3",),
    "motion_transform": ("R", "v3"),
    "transform_force": ("X", "v6"),
    "spatial_inertia": ("mass", "v3", "inertia"),
    "crm": ("v6",),
    "crf": ("v6",),
    "quat_to_rot": ("q",),
    "quat_mul": ("q", "q2"),
    "quat_integrate": ("q", "v3"),
    "quat_from_axis_angle": ("v3", "angle"),
}


@pytest.mark.parametrize("name", list(SPATIAL_CASES))
def test_spatial_matches_jax(name):
    """The port's batched function against the JAX one under vmap: 1e-5."""
    inputs = spatial_inputs()
    args = [inputs[k] for k in SPATIAL_CASES[name]]
    extra = (0.01,) if name == "quat_integrate" else ()
    want = np.asarray(
        jax.vmap(lambda *a: getattr(jax_spatial, name)(*a, *extra))(*(jnp.asarray(a) for a in args))
    )
    got = getattr(spatial, name)(*(t(a) for a in args), *extra).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
    if name == "quat_integrate":
        still = spatial.quat_integrate(t(inputs["q"]), torch.zeros(6, 3), 0.01)  # sinc(0)
        np.testing.assert_allclose(still.numpy(), inputs["q"], rtol=0, atol=1e-6)


# -- physics/engine.py: kinematics, mass matrix, factor -------------------------


def mixed_model(mod):
    """A free base with a hinge, a slide and a ball joint below it: every
    joint type of fwd_kinematics."""
    b = mod.ModelBuilder()
    b.add_body("base", joint=mod.FREE, mass=3.0, inertia=(0.05, 0.06, 0.07), com=(0.01, 0.0, 0.02))
    b.add_body("arm", parent="base", joint=mod.HINGE, axis=(0.0, 1.0, 0.0), pos=(0.2, 0.0, 0.1),
               mass=0.8, com=(0.0, 0.0, -0.1), inertia=(0.004, 0.004, 0.001), damping=0.5,
               armature=0.01)
    b.add_body("rail", parent="arm", joint=mod.SLIDE, axis=(0.0, 0.0, 1.0), pos=(0.0, 0.0, -0.2),
               mass=0.4, com=(0.02, 0.0, 0.0), inertia=(0.001, 0.002, 0.002), damping=1.0)
    b.add_body("wrist", parent="rail", joint=mod.BALL, pos=(0.05, 0.0, -0.1), mass=0.3,
               com=(0.0, 0.01, -0.03), inertia=(0.0005, 0.0006, 0.0004), damping=0.1,
               armature=0.002)
    b.add_body("finger", parent="base", joint=mod.HINGE, axis=(1.0, 0.0, 0.0), pos=(-0.2, 0.1, 0.0),
               mass=0.2, com=(0.0, 0.05, 0.0), inertia=(0.0003, 0.0001, 0.0003))
    return b.finalize()


def mixed_qpos(B, seed):
    rng = np.random.RandomState(seed)
    qpos = rng.uniform(-0.6, 0.6, (B, 14))
    qpos[:, 3:7] = _unit(rng.randn(B, 4))
    qpos[:, 9:13] = _unit(rng.randn(B, 4))
    return qpos.astype(np.float32)


MODELS = {
    "quadruped": lambda: (jax_make_quadruped(), make_quadruped(),
                          standing_states(make_quadruped(), default_qpos(make_quadruped()), 5, 2)["qpos"]),
    "all_joint_types": lambda: (mixed_model(jax_model), mixed_model(port_model), mixed_qpos(5, 3)),
}


@pytest.mark.parametrize("which", list(MODELS))
def test_fwd_kinematics_and_mass_matrix_match_jax(which):
    """Frames of every body (1e-5; positions are below a metre) and the
    CRBA mass matrix (1e-5 relative to its largest entry)."""
    jm, tm, qpos = MODELS[which]()
    assert (tm.nq, tm.nv) == (jm.nq, jm.nv)
    want_kin = jax.vmap(lambda q: jax_engine.fwd_kinematics(jm, q))(jnp.asarray(qpos))
    got_kin = engine.fwd_kinematics(tm, t(qpos))
    for field in ("X_up", "E", "p"):
        for i in range(tm.n_bodies):
            np.testing.assert_allclose(
                getattr(got_kin, field)[i].numpy(), np.asarray(getattr(want_kin, field)[i]),
                rtol=0, atol=1e-5, err_msg=f"{field}[{i}]",
            )
    for i in range(tm.n_bodies):  # the subspaces are constants
        np.testing.assert_array_equal(got_kin.S[i].numpy(), np.asarray(want_kin.S[i][0]))
    want_M = np.asarray(
        jax.vmap(lambda q: jax_engine.mass_matrix(jm, jax_engine.fwd_kinematics(jm, q)))(
            jnp.asarray(qpos)
        )
    )
    got_M = engine.mass_matrix(tm, got_kin).numpy()
    np.testing.assert_allclose(got_M, want_M, rtol=0, atol=1e-5 * np.abs(want_M).max())
    np.testing.assert_allclose(got_M, np.swapaxes(got_M, -1, -2), rtol=0, atol=1e-6)


@pytest.mark.parametrize("which", list(MODELS))
def test_mass_matrix_factor_matches_jax(which):
    """The factor the substeps kernel is handed: 1e-4 relative to its
    largest entry; the damping term is in it."""
    jm, tm, qpos = MODELS[which]()
    want = np.asarray(jax.vmap(lambda q: jax_engine.mass_matrix_factor(jm, q, dt=DT))(jnp.asarray(qpos)))
    got = engine.mass_matrix_factor(tm, t(qpos), dt=DT).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4 * np.abs(want).max())
    undamped = engine.mass_matrix_factor(tm, t(qpos), dt=0.0).numpy()
    assert np.abs(got - undamped).max() > 1e-5
    for i, inertias in enumerate(engine._body_inertias(tm, "cpu")):
        np.testing.assert_allclose(
            inertias.numpy(), np.asarray(jax_engine._body_inertias(jm)[i]), rtol=0, atol=1e-7
        )


def test_mass_matrix_factor_takes_per_env_scales():
    """Density and damping scales enter as in crba_chol_soa: M scales,
    armature does not, dt·D takes the damping scale."""
    from nnx_ppo_tpu_torch.physics.engine_soa import crba_chol_soa

    tm = make_quadruped()
    qpos = t(standing_states(tm, default_qpos(tm), 4, 1)["qpos"])
    params = DomainParams(mass_scale=torch.tensor([0.8, 1.0, 1.1, 1.2]),
                          damping_scale=torch.tensor([1.0, 0.9, 1.1, 1.05]))
    got = engine.mass_matrix_factor(tm, qpos, dt=DT, params=params)
    lanes = crba_chol_soa(tm, tuple(qpos.unbind(1)), DT, mass_scale=params.mass_scale,
                          damping_scale=params.damping_scale)
    want = torch.zeros_like(got)
    for i, j in _tri_indices(tm.nv):
        want[:, i, j] = lanes[i][j]
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=0, atol=1e-4 * want.abs().max().item())
    np.testing.assert_allclose(
        engine._scaled_damping(tm, "cpu", params)[:, 6:].numpy(),
        2.0 * params.damping_scale[:, None].expand(4, 12).numpy(), rtol=1e-6,
    )


# -- the substeps runner --------------------------------------------------------


@pytest.fixture(scope="module")
def substep_inputs():
    """Eight standing quadrupeds and the JAX package's factor for them."""
    tm = make_quadruped(self_collision=True, joint_limits=True)
    jm = jax_make_quadruped(self_collision=True, joint_limits=True)
    s = standing_states(tm, default_qpos(tm), 8, seed=4)
    chol = np.asarray(
        jax.vmap(lambda q: jax_engine.mass_matrix_factor(jm, q, dt=DT))(jnp.asarray(s["qpos"]))
    )
    return jm, tm, [s[k] for k in ("qpos", "qvel", "target")] + [chol]


def assert_step_close(got, want):
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=0, atol=2e-4)
    np.testing.assert_allclose(got[1].numpy(), np.asarray(want[1]), rtol=0, atol=2e-3)
    np.testing.assert_allclose(got[2].numpy(), np.asarray(want[2]), rtol=5e-3, atol=5e-2)


def test_substeps_plain_matches_pallas_kernel_in_interpret_mode(substep_inputs):
    """The TPU kernel itself, interpreted on the CPU, on the same factor
    (the JAX test's own tolerance: tests/test_physics_soa.py:86-114)."""
    jm, tm, arrays = substep_inputs
    want = pallas_substeps(jm, *(jnp.asarray(a) for a in arrays), KP, DT, 2, tile=8, interpret=True)
    before = substeps_cuda.launches
    got = substeps_plain(tm, *(t(a) for a in arrays), KP, DT, 2)
    assert substeps_cuda.launches == before  # CPU tensors: the plain version
    assert got[0].shape == (8, 19) and got[1].shape == (8, 18) and got[2].shape == (8, 12)
    assert_step_close(got, want)
    assert (np.asarray(want[2]) > 0).any()


def test_substeps_with_outside_factor_stay_close_to_the_control_step(substep_inputs):
    """The factor from outside (generic CRBA on 6x6 spatial matrices) and
    the one the control step builds inside (crba_chol_soa) agree to
    rounding only. Measured gap after ten substeps on these eight states:
    qpos 1.2e-7, qvel 9.8e-6, normals 1.4e-4 N; the bounds leave a factor of
    about twenty."""
    _, tm, arrays = substep_inputs
    args = [t(a) for a in arrays]
    outside = substeps_plain(tm, *args, KP, DT, 10)
    inside = control_step_plain(tm, *args[:3], KP, DT, 10)
    gaps = [(a - b).abs().max().item() for a, b in zip(outside, inside)]
    assert gaps[0] < 2e-6 and gaps[1] < 2e-4 and gaps[2] < 3e-3, gaps
    assert (inside[2] > 0).any()


@pytest.mark.parametrize("per_kernel", [1, 5, 10, 0, -1])
def test_substeps_per_kernel_splits_give_the_same_result(substep_inputs, per_kernel):
    """On the CPU every split runs the same ten substeps: equal to the
    bit. 0 and -1 mean all of them in one launch."""
    _, tm, arrays = substep_inputs
    args = [t(a) for a in arrays]
    run = make_substep_runner(tm, KP, DT, 10, substeps_per_kernel=per_kernel)
    assert run.substeps_per_kernel == (10 if per_kernel in (0, -1) else per_kernel)
    got = run(*args)
    want = substeps_plain(tm, *args, KP, DT, 10)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


def test_substep_runner_refusals(substep_inputs):
    _, tm, arrays = substep_inputs
    args = [t(a) for a in arrays]
    with pytest.raises(ValueError, match="multiple"):
        make_substep_runner(tm, KP, DT, 10, substeps_per_kernel=4)
    run = make_substep_runner(tm, KP, DT, 2)
    with pytest.raises(ValueError, match="chol"):
        run(*args[:3], args[3][:, :17])
    with pytest.raises(ValueError, match="qvel"):
        run(args[0], args[1][:, :5], args[2], args[3])
    with pytest.raises(ValueError, match="CUDA tensors"):
        substeps_cuda(tm, *args, KP, DT, 2)


def test_pack_factor_follows_the_jax_triangle_order():
    assert _tri_indices(18) == jax_tri_indices(18) and len(_tri_indices(18)) == 171
    chol = torch.arange(2 * 18 * 18, dtype=torch.float32).reshape(2, 18, 18)
    packed = pack_factor(chol)
    assert packed.shape == (2, 171) and packed.is_contiguous()
    for k, (i, j) in enumerate(_tri_indices(18)):
        assert packed[1, k] == chol[1, i, j]
        assert k == i * (i + 1) // 2 + j  # the kernel's index
