// The legged-robot physics step on Hopper (sm_90a): two kernels that share
// one substep.
//
// control_step_kernel replaces
// nnx_ppo_tpu/physics/pallas_step.py::pallas_control_step (the Pallas TPU
// kernel whose body is crba_chol_soa + n_substeps x substep_soa of
// nnx_ppo_tpu/physics/engine_soa.py). Per env and launch:
//   * CRBA mass matrix and the packed Cholesky factor of
//     M + armature + dt*D, from the pre-substep qpos (held over the
//     control step), or rebuilt from the current qpos at every substep
//     when `exact` is set;
//   * n_substeps x (kinematics, body velocities, RNEA bias, penalty ground
//     contacts on flat / analytic-wave / per-geom tangent-plane terrain,
//     sphere-sphere pairs, PD torques, joint limits, joint springs, push,
//     two triangular solves, semi-implicit Euler);
//   * outputs qpos', qvel' and the contact normal forces of the LAST
//     substep, computed from its pre-integration state (ground geoms
//     first, then pairs).
//
// substeps_kernel replaces
// nnx_ppo_tpu/physics/pallas_step.py::pallas_substeps: the same substeps
// with the factor of M + dt*D built OUTSIDE and passed in as the packed
// lower triangle chol[b][i (i + 1) / 2 + j] (j <= i); n_substeps of the
// struct is then the number of substeps of one launch. The per-env lanes
// are the identities (no domain randomization, no push) and the caller
// packs a flat-ground struct.
//
// The plain PyTorch versions are control_step_plain and substeps_plain
// (nnx_ppo_tpu_torch/physics/cuda_step.py); this file repeats their
// arithmetic in the same order. It is built without --use_fast_math:
// sinf, cosf, sqrtf and division are the precise ones.
//
// Bound (control step): the function must move (nq + nv + nj + n_extra) * 4
// bytes in and (nq + nv + n_geoms) * 4 bytes out per env: 404 bytes for the
// quadruped with 7 extra lanes, 0.83 MB at B = 2048, 0.25 us at 3.35 TB/s.
// It does some 1e5 float operations per env and control step, a few
// microseconds at the float32 peak, so operations bound it, not bytes.
// The substeps kernel also reads the 171-float factor: 1,060 bytes per
// env, 0.65 us at B = 2048 by bytes, and the same substep operations less
// the factor build. What sets both times in practice is neither: every env
// is one long dependent chain.
//
// Design: one thread per env; nothing but the inputs and outputs touches
// device memory. The model (tree topology, inertias, geoms, gains, terrain
// waves, feature switches) arrives as ONE struct passed by value as a
// __grid_constant__ kernel argument, so the same binary serves every
// model of the same sizes; only the sizes (bodies, geoms, pairs, waves)
// are compile-time macros, because they size the per-thread arrays. The
// per-body arrays (E, P, Rcp, v, a, f), the packed factor
// (nv (nv + 1) / 2 floats) and rhs are per-thread arrays: they are indexed
// through the topology, so they live in local memory (L1-cached), and a
// small block (32 threads) spreads the few thousand envs over as many SMs
// as there are warps. The ragged edge of B is masked. Structural zeros of
// M (dofs on different branches) are plain zeros of the packed triangle.

#include "rigid_body.cuh"

namespace {

// Per-env values that ride in `extra` (defaults are exact identities).
struct Lanes {
  float mass_scale, friction, damping_scale, gain_scale;
  V3 push;
  float planes[3 * CS_AT_LEAST_1(CS_NG)];
};

// Identity lanes: no domain randomization, no push, no planes.
CS_FN Lanes identity_lanes(const Params& p) {
  Lanes lane;
  lane.mass_scale = 1.0f;
  lane.friction = p.friction;
  lane.damping_scale = 1.0f;
  lane.gain_scale = 1.0f;
  lane.push = v3(0.0f, 0.0f, 0.0f);
  for (int k = 0; k < 3 * CS_NG; ++k) lane.planes[k] = 0.0f;
  return lane;
}

// Row b of a [B, n] array into (or out of) a per-thread array.
CS_FN void load_row(float* dst, const float* __restrict__ src, int b, int n) {
  for (int k = 0; k < n; ++k) dst[k] = src[static_cast<size_t>(b) * n + k];
}
CS_FN void store_row(float* __restrict__ dst, const float* src, int b, int n) {
  for (int k = 0; k < n; ++k) dst[static_cast<size_t>(b) * n + k] = src[k];
}

// CRBA mass matrix and in-place Cholesky factor of M + armature + dt*D on
// the packed lower triangle L[i (i + 1) / 2 + j], j <= i.
__device__ __noinline__ void crba_chol(const Params& p, const M3* Rcp,
                                       const Lanes& lane, float* L) {
  M3 Ia[CS_NB], Ib[CS_NB], Ic[CS_NB];
#pragma unroll 1
  for (int i = 0; i < CS_NB; ++i) {
    Ia[i] = m3(p.blk_a[i]);
    Ib[i] = m3(p.blk_b[i]);
    Ic[i] = m3(p.blk_c[i]);
  }
  // Composite inertias, leaves to root: Y = X^T I X with
  // X = [[E, 0], [-U, E]], E = child_R_parent, U = E skew(joint_pos).
#pragma unroll 1
  for (int i = CS_NB - 1; i >= 1; --i) {
    const M3 Ei = Rcp[i];
    const V3 r = v3(p.joint_pos[i]);
    const M3 sk = M3{{0.0f, -r.z, r.y, r.z, 0.0f, -r.x, -r.y, r.x, 0.0f}};
    const M3 U = m3_mul(Ei, sk);
    const M3 A = Ia[i], B = Ib[i], C = Ic[i];
    const M3 Bt = m3_transpose(B);
    const M3 W11 = m3_sub(m3_mul(A, Ei), m3_mul(B, U));
    const M3 W12 = m3_mul(B, Ei);
    const M3 W21 = m3_sub(m3_mul(Bt, Ei), m3_mul(C, U));
    const M3 W22 = m3_mul(C, Ei);
    const M3 Y11 = m3_sub(m3T_mul(Ei, W11), m3T_mul(U, W21));
    const M3 Y12 = m3_sub(m3T_mul(Ei, W12), m3T_mul(U, W22));
    const M3 Y22 = m3T_mul(Ei, W22);
    const int parent = p.parent[i];
    Ia[parent] = m3_add(Ia[parent], Y11);
    Ib[parent] = m3_add(Ib[parent], Y12);
    Ic[parent] = m3_add(Ic[parent], Y22);
  }

#pragma unroll 1
  for (int k = 0; k < CS_NT; ++k) L[k] = 0.0f;
  // Base 6x6 block: [[A0, B0], [B0^T, C0]], lower triangle.
  {
    const M3 A0 = Ia[0], B0 = Ib[0], C0 = Ic[0];
    for (int i = 0; i < 3; ++i)
      for (int j = 0; j <= i; ++j) L[i * (i + 1) / 2 + j] = A0.m[3 * i + j];
    for (int i = 0; i < 3; ++i) {
      const int row = 3 + i;
      for (int j = 0; j < 3; ++j) L[row * (row + 1) / 2 + j] = B0.m[3 * j + i];
      for (int j = 0; j <= i; ++j) L[row * (row + 1) / 2 + 3 + j] = C0.m[3 * i + j];
    }
  }
  // Joint rows: walk each joint's force up the tree.
#pragma unroll 1
  for (int i = 1; i < CS_NB; ++i) {
    const int di = 5 + i;
    const int row = di * (di + 1) / 2;
    const V3 axis = v3(p.joint_axis[i]);
    V6 F = V6{m3_vec(Ia[i], axis), m3T_vec(Ib[i], axis)};  // (A s, B^T s)
    L[row + di] = dot(F.w, axis);
    int j = i;
    while (p.parent[j] >= 0) {
      F = xup_force_T(Rcp[j], v3(p.joint_pos[j]), F);
      j = p.parent[j];
      if (j == 0) {
        L[row + 0] = F.w.x; L[row + 1] = F.w.y; L[row + 2] = F.w.z;
        L[row + 3] = F.l.x; L[row + 4] = F.l.y; L[row + 5] = F.l.z;
      } else {
        L[row + 5 + j] = dot(F.w, v3(p.joint_axis[j]));
      }
    }
  }
  // Density scale on M (not on armature); damping scale on dt*D.
#pragma unroll 1
  for (int k = 0; k < CS_NT; ++k) L[k] = L[k] * lane.mass_scale;
#pragma unroll 1
  for (int k = 0; k < CS_NV; ++k) {
    const int d = k * (k + 1) / 2 + k;
    L[d] = L[d] + p.armature[k];
    L[d] = L[d] + p.dt_damping[k] * lane.damping_scale;
  }
  // Cholesky, row by row, in place.
#pragma unroll 1
  for (int i = 0; i < CS_NV; ++i) {
    const int ri = i * (i + 1) / 2;
#pragma unroll 1
    for (int j = 0; j <= i; ++j) {
      const int rj = j * (j + 1) / 2;
      float s = L[ri + j];
      for (int k = 0; k < j; ++k) s = s - L[ri + k] * L[rj + k];
      L[ri + j] = (i == j) ? sqrtf(s) : s / L[rj + j];
    }
  }
}

CS_FN float contact_normal_force(const Params& p, float phi, float rate) {
  return normal_force(p.contact_stiffness, p.contact_damping, p.max_contact_force, phi, rate);
}

// One substep from (qpos, qvel), in place. E, P, Rcp are this qpos's
// kinematics; L is the factor. `normals` gets the contact normal forces
// of the pre-integration state.
__device__ __noinline__ void substep(const Params& p, float* qpos, float* qvel,
                                     const float* target, const float* L,
                                     const M3* E, const V3* P, const M3* Rcp,
                                     const Lanes& lane, float* normals) {
  const float* jq = qpos + 7;
  const float* jd = qvel + 6;
  const V3 pos = v3(qpos);
  V6 v[CS_NB], f[CS_NB];

  // ---- body velocities, RNEA accelerations and inertial wrenches ----
  {
    V6 a[CS_NB];
    v[0] = V6{v3(qvel), v3(qvel + 3)};
    const V6 a_world = V6{v3(0.0f, 0.0f, 0.0f), v3(0.0f, 0.0f, 0.0f + p.gravity_up)};
    a[0] = xup_motion(m3_transpose(E[0]), pos, a_world);
#pragma unroll 1
    for (int i = 1; i < CS_NB; ++i) {
      const int parent = p.parent[i];
      const V3 axis = v3(p.joint_axis[i]);
      const V3 jp = v3(p.joint_pos[i]);
      const float qd = jd[i - 1];
      V6 vi = xup_motion(Rcp[i], jp, v[parent]);
      vi.w = v3(vi.w.x + axis.x * qd, vi.w.y + axis.y * qd, vi.w.z + axis.z * qd);
      v[i] = vi;
      const V6 ai = xup_motion(Rcp[i], jp, a[parent]);
      const V6 vj = V6{scale(qd, axis), v3(0.0f, 0.0f, 0.0f)};
      a[i] = add(ai, crm_apply(vi, vj));
    }
#pragma unroll 1
    for (int i = 0; i < CS_NB; ++i) {
      const V3 com = v3(p.com[i]);
      const V6 Iv = inertia_apply(p.mass[i], com, p.inertia[i], v[i]);
      const V6 Ia = inertia_apply(p.mass[i], com, p.inertia[i], a[i]);
      f[i] = scale(lane.mass_scale, add(Ia, crf_apply(v[i], Iv)));
    }
  }

  // ---- ground contacts ----
  const float mu = lane.friction;
#pragma unroll 1
  for (int g = 0; g < CS_NG; ++g) {
    const int b = p.geom_body[g];
    const V3 offset = v3(p.geom_offset[g]);
    const float radius = p.geom_radius[g];
    const M3 E_b = E[b];
    const V3 x_w = add(P[b], m3_vec(E_b, offset));
    const V3 wb = v[b].w, lb = v[b].l;
    float fn;
    V3 contact_offset, f_w;
    if (p.terrain_mode == 0) {
      const float phi = radius - x_w.z;
      const V3 down = m3T_vec(E_b, v3(0.0f, 0.0f, 0.0f - 1.0f));
      contact_offset = v3(offset.x + down.x * radius, offset.y + down.y * radius,
                          offset.z + down.z * radius);
      const V3 v_pt = m3_vec(E_b, add(lb, cross(wb, contact_offset)));
      fn = contact_normal_force(p, phi, v_pt.z);
      const float vt_norm = sqrtf(v_pt.x * v_pt.x + v_pt.y * v_pt.y + 1e-6f);
      const float s = -mu * fn / fmaxf(vt_norm, p.friction_vel);
      f_w = v3(s * v_pt.x, s * v_pt.y, fn);
    } else {
      V3 n;
      float h;
      if (p.terrain_mode == 2) {
        const float c_g = lane.planes[3 * g], gx = lane.planes[3 * g + 1],
                    gy = lane.planes[3 * g + 2];
        h = c_g + gx * x_w.x + gy * x_w.y;
        const float inv = 1.0f / sqrtf(gx * gx + gy * gy + 1.0f);
        n = v3(-gx * inv, -gy * inv, inv);
      } else {
        n = terrain_normal(p, x_w.x, x_w.y);
        h = terrain_height(p, x_w.x, x_w.y);
      }
      const float phi = radius - (x_w.z - h) * n.z;
      contact_offset = add(offset, m3T_vec(E_b, scale(-radius, n)));
      const V3 v_pt = m3_vec(E_b, add(lb, cross(wb, contact_offset)));
      const float vn = dot(n, v_pt);
      fn = contact_normal_force(p, phi, vn);
      const V3 vt = sub(v_pt, scale(vn, n));
      const float vt_norm = sqrtf(dot(vt, vt) + 1e-6f);
      const float s = -mu * fn / fmaxf(vt_norm, p.friction_vel);
      f_w = add(scale(fn, n), scale(s, vt));
    }
    normals[g] = fn;
    const V3 f_b = m3T_vec(E_b, f_w);
    f[b] = sub(f[b], V6{cross(contact_offset, f_b), f_b});
  }

  // ---- sphere-sphere pairs: equal and opposite at the midpoint ----
#pragma unroll 1
  for (int k = 0; k < CS_NP; ++k) {
    const int ga = p.pair_a[k], gb = p.pair_b[k];
    const int ba = p.geom_body[ga], bb = p.geom_body[gb];
    const float ra = p.geom_radius[ga], rb = p.geom_radius[gb];
    const V3 xa = add(P[ba], m3_vec(E[ba], v3(p.geom_offset[ga])));
    const V3 xb = add(P[bb], m3_vec(E[bb], v3(p.geom_offset[gb])));
    const V3 d = sub(xb, xa);
    const float dist = sqrtf(dot(d, d) + 1e-12f);
    const V3 n = scale(1.0f / dist, d);  // a -> b
    const float phi = ra + rb - dist;
    const V3 c_w = add(xa, scale(ra - 0.5f * phi, n));
    const V3 r_a = m3T_vec(E[ba], sub(c_w, P[ba]));
    const V3 r_b = m3T_vec(E[bb], sub(c_w, P[bb]));
    const V3 vel_a = m3_vec(E[ba], add(v[ba].l, cross(v[ba].w, r_a)));
    const V3 vel_b = m3_vec(E[bb], add(v[bb].l, cross(v[bb].w, r_b)));
    const V3 v_rel = sub(vel_b, vel_a);
    const float sep = dot(n, v_rel);  // separation rate
    const float fn = contact_normal_force(p, phi, sep);
    const V3 vt = sub(v_rel, scale(sep, n));
    const float vt_norm = sqrtf(dot(vt, vt) + 1e-6f);
    const float s = -mu * fn / fmaxf(vt_norm, p.friction_vel);
    const V3 f_w = add(scale(fn, n), scale(s, vt));
    normals[CS_NG + k] = fn;
    const V3 f_on_b = m3T_vec(E[bb], scale(1.0f, f_w));
    f[bb] = sub(f[bb], V6{cross(r_b, f_on_b), f_on_b});
    const V3 f_on_a = m3T_vec(E[ba], scale(-1.0f, f_w));
    f[ba] = sub(f[ba], V6{cross(r_a, f_on_a), f_on_a});
  }

  // ---- backward pass: generalized bias, contacts included ----
  float rhs[CS_NV];  // holds C first, then the right-hand side
#pragma unroll 1
  for (int i = CS_NB - 1; i >= 1; --i) {
    rhs[5 + i] = dot(v3(p.joint_axis[i]), f[i].w);
    const int parent = p.parent[i];
    f[parent] = add(f[parent], xup_force_T(Rcp[i], v3(p.joint_pos[i]), f[i]));
  }
  rhs[0] = f[0].w.x; rhs[1] = f[0].w.y; rhs[2] = f[0].w.z;
  rhs[3] = f[0].l.x; rhs[4] = f[0].l.y; rhs[5] = f[0].l.z;
#pragma unroll 1
  for (int k = 0; k < CS_NV; ++k)
    if (p.damping[k] != 0.0f) rhs[k] = rhs[k] + (p.damping[k] * lane.damping_scale) * qvel[k];

  // ---- applied torques: PD (P term), limits, springs, push ----
  const float gain = lane.gain_scale * p.kp;
  for (int k = 0; k < 6; ++k) rhs[k] = -rhs[k];
#pragma unroll 1
  for (int j = 0; j < CS_NJ; ++j) rhs[6 + j] = gain * (target[j] - jq[j]) - rhs[6 + j];
  if (p.has_limits) {
#pragma unroll 1
    for (int j = 0; j < CS_NJ; ++j) {
      const float lo = p.lower[j], hi = p.upper[j];
      if (!(isfinite(lo) || isfinite(hi))) continue;
      const float below = isfinite(lo) ? fmaxf(lo - jq[j], 0.0f) : 0.0f;
      const float above = isfinite(hi) ? fmaxf(jq[j] - hi, 0.0f) : 0.0f;
      const float violating = (below + above) > 0.0f ? 1.0f : 0.0f;
      rhs[6 + j] = rhs[6 + j] + (p.limit_stiffness * (below - above) -
                                 p.limit_damping * violating * jd[j]);
    }
  }
  if (p.has_springs) {
#pragma unroll 1
    for (int j = 0; j < CS_NJ; ++j)
      if (p.spring_k[j] > 0.0f)
        rhs[6 + j] = rhs[6 + j] - p.spring_k[j] * (jq[j] - p.spring_ref[j]);
  }
  if (p.idx_push >= 0) {
    const V3 f_b = m3T_vec(E[0], lane.push);
    rhs[3] = rhs[3] + f_b.x;
    rhs[4] = rhs[4] + f_b.y;
    rhs[5] = rhs[5] + f_b.z;
  }

  // ---- L y = rhs, then L^T qacc = y, in place ----
#pragma unroll 1
  for (int i = 0; i < CS_NV; ++i) {
    const int ri = i * (i + 1) / 2;
    float acc = rhs[i];
    for (int k = 0; k < i; ++k) acc = acc - L[ri + k] * rhs[k];
    rhs[i] = acc / L[ri + i];
  }
#pragma unroll 1
  for (int i = CS_NV - 1; i >= 0; --i) {
    float acc = rhs[i];
    for (int k = i + 1; k < CS_NV; ++k) acc = acc - L[k * (k + 1) / 2 + i] * rhs[k];
    rhs[i] = acc / L[i * (i + 1) / 2 + i];
  }

  // ---- semi-implicit Euler ----
  const float dt = p.dt;
#pragma unroll 1
  for (int k = 0; k < CS_NV; ++k) qvel[k] = qvel[k] + dt * rhs[k];
  const V3 w_new = v3(qvel), v_new = v3(qvel + 3);
  const V3 pos_new = add(pos, scale(dt, m3_vec(E[0], v_new)));
  qpos[0] = pos_new.x; qpos[1] = pos_new.y; qpos[2] = pos_new.z;
  quat_integrate(qpos + 3, w_new, dt);
#pragma unroll 1
  for (int j = 0; j < CS_NJ; ++j) qpos[7 + j] = qpos[7 + j] + dt * qvel[6 + j];
}

__global__ void control_step_kernel(const float* __restrict__ qpos_in,
                                    const float* __restrict__ qvel_in,
                                    const float* __restrict__ target_in,
                                    const float* __restrict__ extra,
                                    float* __restrict__ qpos_out,
                                    float* __restrict__ qvel_out,
                                    float* __restrict__ normals_out, int B,
                                    const __grid_constant__ Params p) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;

  float qpos[CS_NQ], qvel[CS_NV], target[CS_NJ];
  float normals[CS_AT_LEAST_1(CS_NN)];
  load_row(qpos, qpos_in, b, CS_NQ);
  load_row(qvel, qvel_in, b, CS_NV);
  load_row(target, target_in, b, CS_NJ);
  for (int k = 0; k < CS_NN; ++k) normals[k] = 0.0f;

  Lanes lane = identity_lanes(p);
  const float* e = extra + static_cast<size_t>(b) * p.n_extra;
  if (p.idx_mass_scale >= 0) lane.mass_scale = e[p.idx_mass_scale];
  if (p.idx_friction >= 0) lane.friction = e[p.idx_friction];
  if (p.idx_damping_scale >= 0) lane.damping_scale = e[p.idx_damping_scale];
  if (p.idx_gain_scale >= 0) lane.gain_scale = e[p.idx_gain_scale];
  if (p.idx_push >= 0) lane.push = v3(e + p.idx_push);
  if (p.idx_planes >= 0)
    for (int k = 0; k < 3 * CS_NG; ++k) lane.planes[k] = e[p.idx_planes + k];

  M3 E[CS_NB], Rcp[CS_NB];
  V3 P[CS_NB];
  float L[CS_NT];
#pragma unroll 1
  for (int s = 0; s < p.n_substeps; ++s) {
    kinematics(p, qpos, E, P, Rcp);
    if (s == 0 || p.exact) crba_chol(p, Rcp, lane, L);
    substep(p, qpos, qvel, target, L, E, P, Rcp, lane, normals);
  }

  store_row(qpos_out, qpos, b, CS_NQ);
  store_row(qvel_out, qvel, b, CS_NV);
  store_row(normals_out, normals, b, CS_NN);
}

__global__ void substeps_kernel(const float* __restrict__ qpos_in,
                                const float* __restrict__ qvel_in,
                                const float* __restrict__ target_in,
                                const float* __restrict__ chol_in,
                                float* __restrict__ qpos_out,
                                float* __restrict__ qvel_out,
                                float* __restrict__ normals_out, int B,
                                const __grid_constant__ Params p) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;

  float qpos[CS_NQ], qvel[CS_NV], target[CS_NJ], L[CS_NT];
  float normals[CS_AT_LEAST_1(CS_NN)];
  load_row(qpos, qpos_in, b, CS_NQ);
  load_row(qvel, qvel_in, b, CS_NV);
  load_row(target, target_in, b, CS_NJ);
  load_row(L, chol_in, b, CS_NT);
  for (int k = 0; k < CS_NN; ++k) normals[k] = 0.0f;
  const Lanes lane = identity_lanes(p);

  M3 E[CS_NB], Rcp[CS_NB];
  V3 P[CS_NB];
#pragma unroll 1
  for (int s = 0; s < p.n_substeps; ++s) {
    kinematics(p, qpos, E, P, Rcp);
    substep(p, qpos, qvel, target, L, E, P, Rcp, lane, normals);
  }

  store_row(qpos_out, qpos, b, CS_NQ);
  store_row(qvel_out, qvel, b, CS_NV);
  store_row(normals_out, normals, b, CS_NN);
}

}  // namespace

// Size of the model struct and the sizes this library was built for, so
// that the caller can check its packing: out = {NB, NG, NP, NW}.
extern "C" int control_step_params_size(int* out) {
  out[0] = CS_NB;
  out[1] = CS_NG;
  out[2] = CS_NP;
  out[3] = CS_NW;
  return static_cast<int>(sizeof(Params));
}

// Launches on `stream` of CUDA device `device` and returns the launch's
// cudaError_t (0 on success). `params` points to a host copy of the
// struct; `extra` may be null when params->n_extra is 0.
extern "C" int control_step_forward(const float* qpos, const float* qvel,
                                    const float* target, const float* extra,
                                    float* qpos_out, float* qvel_out,
                                    float* normals_out, int B,
                                    const Params* params, int threads,
                                    int device, void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const int blocks = (B + threads - 1) / threads;
  control_step_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      qpos, qvel, target, extra, qpos_out, qvel_out, normals_out, B, *params);
  return static_cast<int>(cudaGetLastError());
}

// The same for substeps_kernel; `chol` is the packed factor [B, NT].
extern "C" int substeps_forward(const float* qpos, const float* qvel,
                                const float* target, const float* chol,
                                float* qpos_out, float* qvel_out,
                                float* normals_out, int B, const Params* params,
                                int threads, int device, void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const int blocks = (B + threads - 1) / threads;
  substeps_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      qpos, qvel, target, chol, qpos_out, qvel_out, normals_out, B, *params);
  return static_cast<int>(cudaGetLastError());
}
