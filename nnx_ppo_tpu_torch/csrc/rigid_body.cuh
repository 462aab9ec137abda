// Shared device code of the legged-robot kernels (control_step.cu,
// plane_sampler.cu): the model struct of one free base plus hinges that
// the kernels take by value, with the schedules the host packs into it,
// and its per-body kinematics (engine_soa.py::_kin_soa operation by
// operation), run by a group of lanes level by level. The arithmetic and
// the lane group are in spatial_math.cuh. Every source that includes this
// file is built with the same -D sizes, and this file's text joins the
// hash that names each library (ops/cuda_build.py).

#pragma once

#include "spatial_math.cuh"

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
#ifndef CS_G
#define CS_G 8  // lanes per env in control_step.cu (the plane sampler runs one)
#endif

#define CS_NJ (CS_NB - 1)
#define CS_NQ (7 + CS_NJ)
#define CS_NV (6 + CS_NJ)
#define CS_NT (CS_NV * (CS_NV + 1) / 2)
#define CS_NN (CS_NG + CS_NP)
#define CS_AT_LEAST_1(n) ((n) > 0 ? (n) : 1)
// Contact wrenches: one per ground geom, two per pair (on b, then on a).
#define CS_NC CS_AT_LEAST_1(CS_NG + 2 * CS_NP)

static_assert(CS_G >= 1 && CS_G <= 32 && 32 % CS_G == 0, "CS_G must divide 32");

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
  // Schedules (cuda_step.py::tree_schedule, contact_schedule). Levels:
  // the bodies of depth l are level_body[level_start[l] .. level_start[l +
  // 1]), in index order; level 0 is the base. Children of body i:
  // child_list[child_start[i] .. child_start[i + 1]), in descending index
  // order. Contact wrenches on body i: contact_slot[contact_start[i] ..
  // contact_start[i + 1]), in the plain version's order (its ground geoms,
  // then each pair's side on it, b before a); slot g is ground geom g,
  // slots NG + 2 k and NG + 2 k + 1 pair k's force on its b and a bodies.
  int level_start[CS_NB + 1];
  int level_body[CS_NB];
  int child_start[CS_NB + 1];
  int child_list[CS_NB];
  int contact_start[CS_NB + 1];
  int contact_slot[CS_NC];
  int n_levels;
  static constexpr int kWaves = CS_NW;  // for terrain_height / terrain_normal
};

static_assert(sizeof(Params) <= 4096,
              "the model struct no longer fits a kernel argument; move it "
              "to __constant__ memory");

namespace {

// Per-body kinematics from qpos: world rotations E, world origins P and
// child_R_parent Rcp (Rcp[0] is unused: the base is handled on its own).
// Level by level from the base, the bodies of a level across the group's
// lanes; each body's arithmetic is the plain version's.
__device__ void kinematics(const Params& p, const float* qpos, M3* E, V3* P, M3* Rcp,
                           const LaneGroup& g) {
  if (g.active && g.lane == 0) {
    E[0] = quat_to_m3(qpos[3], qpos[4], qpos[5], qpos[6]);
    P[0] = v3(qpos);
  }
  g.sync();
#pragma unroll 1
  for (int l = 1; l < p.n_levels; ++l) {
    if (g.active) {
#pragma unroll 1
      for (int k = p.level_start[l] + g.lane; k < p.level_start[l + 1]; k += g.size) {
        const int i = p.level_body[k];
        const int parent = p.parent[i];
        const M3 R_j = axis_angle_m3(v3(p.joint_axis[i]), qpos[7 + i - 1]);
        const M3 E_par = E[parent];
        E[i] = m3_mul(E_par, R_j);
        P[i] = add(P[parent], m3_vec(E_par, v3(p.joint_pos[i])));
        Rcp[i] = m3_transpose(R_j);
      }
    }
    g.sync();
  }
}

}  // namespace
