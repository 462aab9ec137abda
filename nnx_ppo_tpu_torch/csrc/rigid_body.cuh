// Shared device code of the rigid-body kernels (control_step.cu,
// plane_sampler.cu): the model struct that the kernels take by value,
// small 3-vector / 3x3 / spatial 6-vector arithmetic, and the per-body
// kinematics. The arithmetic repeats nnx_ppo_tpu_torch/physics/soa.py
// and engine_soa.py::_kin_soa operation by operation. Every source that
// includes this file is built with the same -D sizes, and this file's
// text joins the hash that names each library (ops/cuda_build.py).

#pragma once

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

}  // namespace
