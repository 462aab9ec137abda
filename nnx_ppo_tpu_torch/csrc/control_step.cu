// One control step of the legged-robot physics on Hopper (sm_90a).
//
// Replaces nnx_ppo_tpu/physics/pallas_step.py::pallas_control_step (the
// Pallas TPU kernel whose body is crba_chol_soa + n_substeps x substep_soa
// of nnx_ppo_tpu/physics/engine_soa.py). Per env and launch:
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
// The plain PyTorch version is control_step_plain
// (nnx_ppo_tpu_torch/physics/cuda_step.py); this file repeats its
// arithmetic in the same order. It is built without --use_fast_math:
// sinf, cosf, sqrtf and division are the precise ones.
//
// Bound: the function must move (nq + nv + nj + n_extra) * 4 bytes in and
// (nq + nv + n_geoms) * 4 bytes out per env: 404 bytes for the quadruped
// with 7 extra lanes, 0.83 MB at B = 2048, 0.25 us at 3.35 TB/s. It does
// some 1e5 float operations per env and control step, a few microseconds
// at the float32 peak, so operations bound it, not bytes. What sets its
// time in practice is neither: every env is one long dependent chain.
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

#include <cuda_runtime.h>
#include <math.h>

#ifndef CS_NB
#define CS_NB 13  // bodies (free base + hinge joints)
#endif
#ifndef CS_NG
#define CS_NG 8  // ground contact spheres
#endif
#ifndef CS_NP
#define CS_NP 0  // sphere-sphere pairs
#endif
#ifndef CS_NW
#define CS_NW 6  // terrain waves
#endif

#define CS_NJ (CS_NB - 1)
#define CS_NQ (7 + CS_NJ)
#define CS_NV (6 + CS_NJ)
#define CS_NT (CS_NV * (CS_NV + 1) / 2)
#define CS_NN (CS_NG + CS_NP)
#define CS_AT_LEAST_1(n) ((n) > 0 ? (n) : 1)

// Every member is 4 bytes wide; the Python side (cuda_step.py) packs the
// same members in the same order.
struct Params {
  int parent[CS_NB];
  float joint_axis[CS_NB][3];
  float joint_pos[CS_NB][3];
  float mass[CS_NB];
  float com[CS_NB][3];
  float inertia[CS_NB][9];
  // Spatial inertia about the body origin as 3x3 blocks: ang-ang,
  // ang-lin, lin-lin (the lin-ang block is the ang-lin one transposed).
  float blk_a[CS_NB][9];
  float blk_b[CS_NB][9];
  float blk_c[CS_NB][9];
  float damping[CS_NV];
  float dt_damping[CS_NV];
  float armature[CS_NV];
  float lower[CS_NJ];  // -inf = no lower stop
  float upper[CS_NJ];  // +inf = no upper stop
  float spring_k[CS_NJ];
  float spring_ref[CS_NJ];
  int geom_body[CS_AT_LEAST_1(CS_NG)];
  float geom_offset[CS_AT_LEAST_1(CS_NG)][3];
  float geom_radius[CS_AT_LEAST_1(CS_NG)];
  int pair_a[CS_AT_LEAST_1(CS_NP)];
  int pair_b[CS_AT_LEAST_1(CS_NP)];
  float wave_amp[CS_AT_LEAST_1(CS_NW)];
  float wave_freq[CS_AT_LEAST_1(CS_NW)];
  float wave_amp_freq[CS_AT_LEAST_1(CS_NW)];
  float wave_dx[CS_AT_LEAST_1(CS_NW)];
  float wave_dy[CS_AT_LEAST_1(CS_NW)];
  float wave_phase[CS_AT_LEAST_1(CS_NW)];
  float slope[2];
  float gravity_up;  // -gravity, +9.81
  float kp;
  float dt;
  float contact_stiffness;
  float contact_damping;
  float friction;
  float friction_vel;
  float max_contact_force;  // +inf = uncapped
  float limit_stiffness;
  float limit_damping;
  int n_substeps;
  int exact;         // rebuild the factor at every substep
  int terrain_mode;  // 0 flat, 1 analytic waves, 2 per-geom tangent planes
  int has_limits;
  int has_springs;
  // Columns of `extra` (-1 = absent).
  int idx_mass_scale;
  int idx_friction;
  int idx_damping_scale;
  int idx_gain_scale;
  int idx_push;    // 3 columns
  int idx_planes;  // 3 * CS_NG columns (c, gx, gy per ground geom)
  int n_extra;
};

static_assert(sizeof(Params) <= 4096,
              "the model struct no longer fits a kernel argument; move it "
              "to __constant__ memory");

namespace {

struct V3 { float x, y, z; };
struct M3 { float m[9]; };
struct V6 { V3 w, l; };  // angular, linear

#define CS_FN __device__ __forceinline__

CS_FN V3 v3(float x, float y, float z) { return V3{x, y, z}; }
CS_FN V3 v3(const float* p) { return V3{p[0], p[1], p[2]}; }
CS_FN V3 add(V3 a, V3 b) { return v3(a.x + b.x, a.y + b.y, a.z + b.z); }
CS_FN V3 sub(V3 a, V3 b) { return v3(a.x - b.x, a.y - b.y, a.z - b.z); }
CS_FN V3 scale(float s, V3 a) { return v3(s * a.x, s * a.y, s * a.z); }
CS_FN float dot(V3 a, V3 b) { return a.x * b.x + a.y * b.y + a.z * b.z; }
CS_FN V3 cross(V3 a, V3 b) {
  return v3(a.y * b.z - a.z * b.y, a.z * b.x - a.x * b.z, a.x * b.y - a.y * b.x);
}
CS_FN V6 add(V6 a, V6 b) { return V6{add(a.w, b.w), add(a.l, b.l)}; }
CS_FN V6 sub(V6 a, V6 b) { return V6{sub(a.w, b.w), sub(a.l, b.l)}; }
CS_FN V6 scale(float s, V6 a) { return V6{scale(s, a.w), scale(s, a.l)}; }

CS_FN M3 m3(const float* p) {
  M3 r;
  for (int k = 0; k < 9; ++k) r.m[k] = p[k];
  return r;
}
CS_FN V3 m3_vec(const M3& M, V3 v) {
  return v3(M.m[0] * v.x + M.m[1] * v.y + M.m[2] * v.z,
            M.m[3] * v.x + M.m[4] * v.y + M.m[5] * v.z,
            M.m[6] * v.x + M.m[7] * v.y + M.m[8] * v.z);
}
CS_FN V3 m3T_vec(const M3& M, V3 v) {
  return v3(M.m[0] * v.x + M.m[3] * v.y + M.m[6] * v.z,
            M.m[1] * v.x + M.m[4] * v.y + M.m[7] * v.z,
            M.m[2] * v.x + M.m[5] * v.y + M.m[8] * v.z);
}
CS_FN M3 m3_mul(const M3& A, const M3& B) {
  M3 r;
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      r.m[3 * i + j] = A.m[3 * i] * B.m[j] + A.m[3 * i + 1] * B.m[3 + j] +
                       A.m[3 * i + 2] * B.m[6 + j];
  return r;
}
CS_FN M3 m3T_mul(const M3& A, const M3& B) {
  M3 r;
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      r.m[3 * i + j] =
          A.m[i] * B.m[j] + A.m[3 + i] * B.m[3 + j] + A.m[6 + i] * B.m[6 + j];
  return r;
}
CS_FN M3 m3_add(const M3& A, const M3& B) {
  M3 r;
#pragma unroll
  for (int k = 0; k < 9; ++k) r.m[k] = A.m[k] + B.m[k];
  return r;
}
CS_FN M3 m3_sub(const M3& A, const M3& B) {
  M3 r;
#pragma unroll
  for (int k = 0; k < 9; ++k) r.m[k] = A.m[k] - B.m[k];
  return r;
}
CS_FN M3 m3_transpose(const M3& A) {
  return M3{{A.m[0], A.m[3], A.m[6], A.m[1], A.m[4], A.m[7], A.m[2], A.m[5], A.m[8]}};
}

// world_R_body of a unit quaternion (w, x, y, z).
CS_FN M3 quat_to_m3(float w, float x, float y, float z) {
  return M3{{1.0f - 2.0f * (y * y + z * z), 2.0f * (x * y - w * z), 2.0f * (x * z + w * y),
             2.0f * (x * y + w * z), 1.0f - 2.0f * (x * x + z * z), 2.0f * (y * z - w * x),
             2.0f * (x * z - w * y), 2.0f * (y * z + w * x), 1.0f - 2.0f * (x * x + y * y)}};
}

// Active rotation about a constant unit axis by `angle` (Rodrigues).
CS_FN M3 axis_angle_m3(V3 ax, float angle) {
  const float s = sinf(angle), c = cosf(angle);
  const float C = 1.0f - c;
  return M3{{c + (ax.x * ax.x) * C, (ax.x * ax.y) * C - ax.z * s, (ax.x * ax.z) * C + ax.y * s,
             (ax.y * ax.x) * C + ax.z * s, c + (ax.y * ax.y) * C, (ax.y * ax.z) * C - ax.x * s,
             (ax.z * ax.x) * C - ax.y * s, (ax.z * ax.y) * C + ax.x * s, c + (ax.z * ax.z) * C}};
}

// Motion transform [R w; R (l - p x w)] of frame (R = child_R_parent,
// p = child origin in parent coords).
CS_FN V6 xup_motion(const M3& R, V3 p, V6 v) {
  return V6{m3_vec(R, v.w), m3_vec(R, sub(v.l, cross(p, v.w)))};
}
// Its transpose applied to a child-coords spatial force.
CS_FN V6 xup_force_T(const M3& R, V3 p, V6 f) {
  const V3 Rt_n = m3T_vec(R, f.w);
  const V3 Rt_l = m3T_vec(R, f.l);
  return V6{add(Rt_n, cross(p, Rt_l)), Rt_l};
}
CS_FN V6 crm_apply(V6 v, V6 m) {
  return V6{cross(v.w, m.w), add(cross(v.l, m.w), cross(v.w, m.l))};
}
CS_FN V6 crf_apply(V6 v, V6 f) {
  return V6{add(cross(v.w, f.w), cross(v.l, f.l)), cross(v.w, f.l)};
}
// Spatial inertia (mass, com, rotational inertia about the com) applied
// to a motion vector.
CS_FN V6 inertia_apply(float mass, V3 com, const float* I, V6 v) {
  const V3 c_cross_l = cross(com, v.l);
  const V3 c_cross_w = cross(com, v.w);
  const V3 Iw = v3(I[0] * v.w.x + I[1] * v.w.y + I[2] * v.w.z,
                   I[3] * v.w.x + I[4] * v.w.y + I[5] * v.w.z,
                   I[6] * v.w.x + I[7] * v.w.y + I[8] * v.w.z);
  const V3 cc_w = cross(com, cross(com, v.w));
  return V6{v3(Iw.x - mass * cc_w.x + mass * c_cross_l.x,
               Iw.y - mass * cc_w.y + mass * c_cross_l.y,
               Iw.z - mass * cc_w.z + mass * c_cross_l.z),
            v3(mass * (v.l.x - c_cross_w.x), mass * (v.l.y - c_cross_w.y),
               mass * (v.l.z - c_cross_w.z))};
}

// Per-env values that ride in `extra` (defaults are exact identities).
struct Lanes {
  float mass_scale, friction, damping_scale, gain_scale;
  V3 push;
  float planes[3 * CS_AT_LEAST_1(CS_NG)];
};

// Per-body kinematics from qpos: world rotations E, world origins P and
// child_R_parent Rcp (Rcp[0] is unused: the base is handled on its own).
__device__ __noinline__ void kinematics(const Params& p, const float* qpos,
                                        M3* E, V3* P, M3* Rcp) {
  E[0] = quat_to_m3(qpos[3], qpos[4], qpos[5], qpos[6]);
  P[0] = v3(qpos);
#pragma unroll 1
  for (int i = 1; i < CS_NB; ++i) {
    const int parent = p.parent[i];
    const M3 R_j = axis_angle_m3(v3(p.joint_axis[i]), qpos[7 + i - 1]);
    const M3 E_par = E[parent];
    E[i] = m3_mul(E_par, R_j);
    P[i] = add(P[parent], m3_vec(E_par, v3(p.joint_pos[i])));
    Rcp[i] = m3_transpose(R_j);
  }
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

CS_FN float terrain_height(const Params& p, float x, float y) {
  float h = p.slope[0] * x + p.slope[1] * y;
  for (int k = 0; k < CS_NW; ++k)
    h = h + p.wave_amp[k] *
                sinf(p.wave_freq[k] * (p.wave_dx[k] * x + p.wave_dy[k] * y) + p.wave_phase[k]);
  return h;
}

CS_FN V3 terrain_normal(const Params& p, float x, float y) {
  float gx = 0.0f + p.slope[0];
  float gy = 0.0f + p.slope[1];
  for (int k = 0; k < CS_NW; ++k) {
    const float c = p.wave_amp_freq[k] *
                    cosf(p.wave_freq[k] * (p.wave_dx[k] * x + p.wave_dy[k] * y) + p.wave_phase[k]);
    gx = gx + p.wave_dx[k] * c;
    gy = gy + p.wave_dy[k] * c;
  }
  const float inv = 1.0f / sqrtf(gx * gx + gy * gy + 1.0f);
  return v3(-gx * inv, -gy * inv, inv);
}

// Normal force of a penalty contact: spring-damper, active while
// penetrating, never pulling, optionally capped.
CS_FN float normal_force(const Params& p, float phi, float rate) {
  float fn = phi > 0.0f ? fmaxf(p.contact_stiffness * phi - p.contact_damping * rate, 0.0f)
                        : 0.0f;
  if (isfinite(p.max_contact_force)) fn = fminf(fn, p.max_contact_force);
  return fn;
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
      fn = normal_force(p, phi, v_pt.z);
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
      fn = normal_force(p, phi, vn);
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
    const float fn = normal_force(p, phi, sep);
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
  {
    // q <- normalize(q (x) exp(w dt / 2))
    const float angle = sqrtf(dot(w_new, w_new) + 0.0f) * dt;
    const float half = 0.5f * angle;
    const float x = half / 3.14159265358979323846f;
    const float px = 3.14159265358979323846f * x;
    const float sinc = (x == 0.0f) ? 1.0f : sinf(px) / px;
    const float k = (0.5f * dt) * sinc;
    const float aw = qpos[3], ax = qpos[4], ay = qpos[5], az = qpos[6];
    const float bw = cosf(half), bx = k * w_new.x, by = k * w_new.y, bz = k * w_new.z;
    const float ow = aw * bw - ax * bx - ay * by - az * bz;
    const float ox = aw * bx + ax * bw + ay * bz - az * by;
    const float oy = aw * by - ax * bz + ay * bw + az * bx;
    const float oz = aw * bz + ax * by - ay * bx + az * bw;
    const float norm = sqrtf(ow * ow + ox * ox + oy * oy + oz * oz);
    qpos[3] = ow / norm; qpos[4] = ox / norm; qpos[5] = oy / norm; qpos[6] = oz / norm;
  }
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
  for (int k = 0; k < CS_NQ; ++k) qpos[k] = qpos_in[static_cast<size_t>(b) * CS_NQ + k];
  for (int k = 0; k < CS_NV; ++k) qvel[k] = qvel_in[static_cast<size_t>(b) * CS_NV + k];
  for (int k = 0; k < CS_NJ; ++k) target[k] = target_in[static_cast<size_t>(b) * CS_NJ + k];
  for (int k = 0; k < CS_NN; ++k) normals[k] = 0.0f;

  Lanes lane;
  const float* e = extra + static_cast<size_t>(b) * p.n_extra;
  lane.mass_scale = p.idx_mass_scale >= 0 ? e[p.idx_mass_scale] : 1.0f;
  lane.friction = p.idx_friction >= 0 ? e[p.idx_friction] : p.friction;
  lane.damping_scale = p.idx_damping_scale >= 0 ? e[p.idx_damping_scale] : 1.0f;
  lane.gain_scale = p.idx_gain_scale >= 0 ? e[p.idx_gain_scale] : 1.0f;
  lane.push = p.idx_push >= 0 ? v3(e + p.idx_push) : v3(0.0f, 0.0f, 0.0f);
  for (int k = 0; k < 3 * CS_NG; ++k)
    lane.planes[k] = p.idx_planes >= 0 ? e[p.idx_planes + k] : 0.0f;

  M3 E[CS_NB], Rcp[CS_NB];
  V3 P[CS_NB];
  float L[CS_NT];
#pragma unroll 1
  for (int s = 0; s < p.n_substeps; ++s) {
    kinematics(p, qpos, E, P, Rcp);
    if (s == 0 || p.exact) crba_chol(p, Rcp, lane, L);
    substep(p, qpos, qvel, target, L, E, P, Rcp, lane, normals);
  }

  for (int k = 0; k < CS_NQ; ++k) qpos_out[static_cast<size_t>(b) * CS_NQ + k] = qpos[k];
  for (int k = 0; k < CS_NV; ++k) qvel_out[static_cast<size_t>(b) * CS_NV + k] = qvel[k];
  for (int k = 0; k < CS_NN; ++k) normals_out[static_cast<size_t>(b) * CS_NN + k] = normals[k];
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
