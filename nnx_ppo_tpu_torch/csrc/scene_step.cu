// The manipulation-scene control step on Hopper (sm_90a).
//
// scene_step_kernel replaces
// nnx_ppo_tpu/physics/pallas_step.py::pallas_scene_step (the Pallas TPU
// kernel whose body is n_substeps x scene_substep_soa of
// nnx_ppo_tpu/physics/engine_soa_general.py). A scene is a few kinematic
// trees (FREE joints at roots, BALL, HINGE and SLIDE joints anywhere) whose
// states are concatenated: qpos[B, sum nq], qvel[B, sum nv], tau[B, sum nv].
// Per env and launch, n_substeps times:
//   * kinematics and body velocities of every tree;
//   * RNEA accelerations and inertial wrenches;
//   * penalty ground contacts (flat ground or analytic waves), sphere-sphere
//     pairs inside a tree and across trees (equal and opposite at the
//     midpoint of the penetration axis; a cross pair's parameters are the
//     means of its two trees');
//   * per tree: the CRBA mass matrix and the Cholesky factor of
//     M + armature + dt*D rebuilt from the current qpos (exact dynamics),
//     the generalized bias, joint limits and springs on 1-dof joints, two
//     triangular solves, semi-implicit Euler with the quaternion
//     exponential map for FREE and BALL joints.
// Outputs qpos', qvel' and the contact normal forces of the LAST substep,
// from its pre-integration state: per tree (ground geoms, then the tree's
// own pairs) in tree order, then the cross pairs; one zero column when the
// scene has no contact at all.
//
// The plain PyTorch version is scene_step_plain
// (nnx_ppo_tpu_torch/physics/cuda_scene_step.py) on the lane functions of
// engine_soa_general.py. Those prune zeros, ones, identity rotations and the
// world frame while the expression is built; this file loops at run time
// and multiplies by the 0 and 1 entries instead, which changes no float32
// value (x + 0 * y == x, 1 * x == x without fused multiply-adds). Where the
// plain version folds two model constants in float64 before the first
// float32 operation (a leaf body's rows of M, pair radius sums, mean pair
// parameters, outer products of hinge axes, dt * damping), the host packs
// the folded constant. Built without --use_fast_math and with -fmad=false.
//
// Bound: the function must move (2 sum nq + 3 sum nv + n_normals) * 4 bytes
// per env (228 bytes for the arm-and-ball scene, 0.9 MB at B = 4096, 0.28 us
// at 3.35 TB/s) and does some 2,800 float operations per env and substep
// there (45 thousand per control step of 16 substeps, 2.8 us at 67 TFLOP/s
// for 4096 envs), so operations bound it. What holds it back is neither:
// each env is one long dependent chain, and a few thousand envs at one
// thread each leave most of the card's schedulers without a warp.
//
// Design for Hopper: a group of SS_G lanes per env (a -D size that divides
// 32). The lanes share out independent scalars; each scalar is still
// computed by one lane with the plain version's operations in its order, so
// the kernel stays equal to the bit with it (-fmad=false): kinematics,
// velocities, accelerations and inertial wrenches level by level from the
// roots, one body per lane; each ground geom's and pair's contact on its own
// lane, their wrenches then subtracted per body in the plain order; then the
// trees side by side, one tree per lane: its CRBA, factor, backward pass,
// solves and integration read only its own slices, and the frames and
// wrenches are complete before them. Each env's state (qpos, qvel, tau, the
// frames, v, a, f, the contact wrenches, the composite inertias, each tree's
// packed factor and rhs) lives in shared memory, once per env; the scene
// struct, a __grid_constant__ argument, is copied into shared memory at
// block start. No per-thread array is indexed through the topology; the host
// packs the schedules (levels, contact slots) into the struct. Barriers are
// __syncwarp over the whole warp, whose lanes all run the same sequence of
// them; __syncthreads only after the struct copy. The lanes of an env past B
// run every barrier and do no work.
//
// Not used, and why: wgmma, mma.sync and TF32 (a tree's matrices are at most
// SS_MV x SS_MV float32 and must stay equal to the bit with a float32 plain
// version); TMA and cp.async (the bytes bound is 0.28 us). What Hopper
// offers here is warps per SM to hide the chain's latency, shared memory for
// the envs' state, and warp-level barriers.

#include "spatial_math.cuh"

#ifndef SS_NT
#define SS_NT 2  // trees
#endif
#ifndef SS_NB
#define SS_NB 3  // bodies of all trees
#endif
#ifndef SS_NQ
#define SS_NQ 12  // sum of the trees' nq
#endif
#ifndef SS_NV
#define SS_NV 10  // sum of the trees' nv
#endif
#ifndef SS_MV
#define SS_MV 6  // the largest tree's nv
#endif
#ifndef SS_NG
#define SS_NG 2  // ground contact spheres of all trees
#endif
#ifndef SS_NP
#define SS_NP 1  // sphere-sphere pairs: the trees' own, then the cross pairs
#endif
#ifndef SS_NW
#define SS_NW 0  // terrain waves
#endif
#ifndef SS_G
#define SS_G 2  // lanes per env
#endif

#define SS_AT_LEAST_1(n) ((n) > 0 ? (n) : 1)
// Contact wrenches: one per ground geom, two per pair (on b, then on a).
#define SS_NC SS_AT_LEAST_1(SS_NG + 2 * SS_NP)
// Entries of the largest tree's packed factor.
#define SS_NTRI (SS_MV * (SS_MV + 1) / 2)

static_assert(SS_G >= 1 && SS_G <= 32 && 32 % SS_G == 0, "SS_G must divide 32");

enum JointType { JOINT_FREE = 0, JOINT_BALL = 1, JOINT_HINGE = 2, JOINT_SLIDE = 3 };

// Every member is 4 bytes wide; the Python side (cuda_scene_step.py) packs
// the same members in the same order. Body, dof, geom and qpos indices are
// global (into the concatenated scene).
struct SceneParams {
  // -- trees --
  int tree_body_start[SS_NT];
  int tree_body_end[SS_NT];
  int tree_v_start[SS_NT];
  int tree_nv[SS_NT];
  float gravity_up[SS_NT];  // -gravity
  float contact_stiffness[SS_NT];
  float contact_damping[SS_NT];
  float friction[SS_NT];
  float friction_vel[SS_NT];
  float max_contact_force[SS_NT];  // +inf = uncapped
  float limit_stiffness[SS_NT];
  float limit_damping[SS_NT];
  int has_limits[SS_NT];
  int has_springs[SS_NT];
  // -- bodies --
  int body_tree[SS_NB];
  int parent[SS_NB];  // -1 = world
  int joint_type[SS_NB];
  int q_start[SS_NB];
  int v_start[SS_NB];
  int n_dof[SS_NB];
  int is_leaf[SS_NB];  // no children: its rows of M are constants
  int fold_c[SS_NB];   // its lin-lin block is already in the parent's blk_c
  float joint_axis[SS_NB][3];
  float axis_outer[SS_NB][9];  // axis axis^T, folded in float64
  float joint_pos[SS_NB][3];
  float mass[SS_NB];
  float com[SS_NB][3];
  float inertia[SS_NB][9];
  // Spatial inertia about the body origin as 3x3 blocks: ang-ang,
  // ang-lin, lin-lin (the lin-ang block is the ang-lin one transposed).
  float blk_a[SS_NB][9];
  float blk_b[SS_NB][9];
  float blk_c[SS_NB][9];
  // -- dofs --
  float s_col[SS_NV][6];   // motion-subspace column (angular, linear)
  float leaf_f[SS_NV][6];  // leaf bodies: I s
  float leaf_m[SS_NV][6];  // leaf bodies: row of the diagonal block of
                           // M + armature + dt*D, up to the diagonal
  float damping[SS_NV];
  float dt_damping[SS_NV];
  float armature[SS_NV];
  float lower[SS_NV];  // -inf = no lower stop
  float upper[SS_NV];  // +inf = no upper stop
  float spring_k[SS_NV];
  float spring_ref[SS_NV];
  // -- ground geoms --
  int geom_body[SS_AT_LEAST_1(SS_NG)];
  int geom_tree[SS_AT_LEAST_1(SS_NG)];
  int geom_slot[SS_AT_LEAST_1(SS_NG)];  // column of the normals output
  float geom_offset[SS_AT_LEAST_1(SS_NG)][3];
  float geom_radius[SS_AT_LEAST_1(SS_NG)];
  // -- pairs --
  int pair_a[SS_AT_LEAST_1(SS_NP)];  // geoms
  int pair_b[SS_AT_LEAST_1(SS_NP)];
  int pair_slot[SS_AT_LEAST_1(SS_NP)];
  float pair_radius_sum[SS_AT_LEAST_1(SS_NP)];
  float pair_stiffness[SS_AT_LEAST_1(SS_NP)];
  float pair_damping[SS_AT_LEAST_1(SS_NP)];
  float pair_friction[SS_AT_LEAST_1(SS_NP)];
  float pair_friction_vel[SS_AT_LEAST_1(SS_NP)];
  float pair_max_force[SS_AT_LEAST_1(SS_NP)];  // +inf = uncapped
  // -- terrain --
  float wave_amp[SS_AT_LEAST_1(SS_NW)];
  float wave_freq[SS_AT_LEAST_1(SS_NW)];
  float wave_amp_freq[SS_AT_LEAST_1(SS_NW)];
  float wave_dx[SS_AT_LEAST_1(SS_NW)];
  float wave_dy[SS_AT_LEAST_1(SS_NW)];
  float wave_phase[SS_AT_LEAST_1(SS_NW)];
  float slope[2];
  float dt;
  int n_substeps;
  int terrain_mode;  // 0 flat, 1 analytic waves
  int n_normals;     // columns of the normals output (at least 1)
  // Schedules (cuda_step.py::tree_schedule, contact_schedule). Levels: the
  // bodies of depth l are level_body[level_start[l] .. level_start[l + 1]),
  // in index order; level 0 holds the roots of every tree. Contact wrenches
  // on body i: contact_slot[contact_start[i] .. contact_start[i + 1]), in
  // the plain version's order; slot g is ground geom g, slots NG + 2 j and
  // NG + 2 j + 1 pair j's force on its b and a bodies.
  int level_start[SS_NB + 1];
  int level_body[SS_NB];
  int contact_start[SS_NB + 1];
  int contact_slot[SS_NC];
  int n_levels;
  static constexpr int kWaves = SS_NW;  // for terrain_height / terrain_normal
};

static_assert(sizeof(SceneParams) <= 4096,
              "the scene struct no longer fits a kernel argument; move it "
              "to __constant__ memory");

namespace {

CS_FN V6 v6(const float* p) { return V6{v3(p), v3(p + 3)}; }

// Rodrigues with the axis' outer product folded on the host
// (soa.axis_angle_m3: ax * ay is one constant there).
CS_FN M3 axis_angle_m3(V3 ax, const float* o, float angle) {
  const float s = sinf(angle), c = cosf(angle);
  const float C = 1.0f - c;
  return M3{{c + o[0] * C, o[1] * C - ax.z * s, o[2] * C + ax.y * s,
             o[3] * C + ax.z * s, c + o[4] * C, o[5] * C - ax.x * s,
             o[6] * C - ax.y * s, o[7] * C + ax.x * s, c + o[8] * C}};
}

// col^T f of a motion-subspace column and a spatial force.
CS_FN float sdot(const float* col, V6 f) {
  float acc = 0.0f;
  acc = acc + col[0] * f.w.x;
  acc = acc + col[1] * f.w.y;
  acc = acc + col[2] * f.w.z;
  acc = acc + col[3] * f.l.x;
  acc = acc + col[4] * f.l.y;
  acc = acc + col[5] * f.l.z;
  return acc;
}

// Per-body frames of one qpos: world rotation E, world origin P, and the
// motion transform from the parent frame (Rcp = child_R_parent, r = child
// origin in parent coordinates; the world pose for a FREE root).
struct Frames {
  M3 E[SS_NB], Rcp[SS_NB];
  V3 P[SS_NB], r[SS_NB];
};

// One env's state in shared memory.
struct SceneEnv {
  float qpos[SS_NQ], qvel[SS_NV], tau[SS_NV];
  float normals[SS_NG + SS_NP + 1];
  Frames k;
  V6 v[SS_NB], a[SS_NB], f[SS_NB];
  V6 contact[SS_NC];  // contact wrenches, to be subtracted from f
  M3 Ia[SS_NB], Ib[SS_NB], Ic[SS_NB];
  float L[SS_NT][SS_NTRI];  // each tree's packed factor
  float rhs[SS_NT][SS_AT_LEAST_1(SS_MV)];
};

// Words between two envs in shared memory: odd, so that the envs of a
// warp that read the same member fall on different banks.
constexpr int kSceneEnvWords = static_cast<int>(sizeof(SceneEnv) / 4) | 1;

// Dynamic shared memory of a block of `threads` threads.
constexpr long long scene_block_smem_bytes(int threads) {
  return 4LL * (model_words<SceneParams>() +
                static_cast<long long>(threads / SS_G) * kSceneEnvWords);
}

// Body i's frame from qpos (its parent's, if any, is complete).
__device__ void body_frame(const SceneParams& p, const float* qpos, Frames& k, int i) {
  const float* q = qpos + p.q_start[i];
  const int type = p.joint_type[i];
  if (type == JOINT_FREE) {
    k.E[i] = quat_to_m3(q[3], q[4], q[5], q[6]);
    k.P[i] = v3(q);
    k.Rcp[i] = m3_transpose(k.E[i]);
    k.r[i] = k.P[i];
    return;
  }
  M3 R_j;  // parent_R_child
  V3 r = v3(p.joint_pos[i]);
  if (type == JOINT_BALL) {
    R_j = quat_to_m3(q[0], q[1], q[2], q[3]);
  } else if (type == JOINT_HINGE) {
    R_j = axis_angle_m3(v3(p.joint_axis[i]), p.axis_outer[i], q[0]);
  } else {  // SLIDE: the origin slides along the axis
    R_j = M3{{1.0f, 0.0f, 0.0f, 0.0f, 1.0f, 0.0f, 0.0f, 0.0f, 1.0f}};
    const V3 axis = v3(p.joint_axis[i]);
    r = v3(r.x + axis.x * q[0], r.y + axis.y * q[0], r.z + axis.z * q[0]);
  }
  k.Rcp[i] = m3_transpose(R_j);
  k.r[i] = r;
  const int parent = p.parent[i];
  if (parent < 0) {
    k.E[i] = R_j;
    k.P[i] = r;
  } else {
    const M3 E_par = k.E[parent];
    k.E[i] = m3_mul(E_par, R_j);
    k.P[i] = add(k.P[parent], m3_vec(E_par, r));
  }
}

// Frames of every body, level by level from the roots.
__device__ void kinematics(const SceneParams& p, SceneEnv& s, const LaneGroup& g) {
#pragma unroll 1
  for (int l = 0; l < p.n_levels; ++l) {
    if (g.active) {
#pragma unroll 1
      for (int n = p.level_start[l] + g.lane; n < p.level_start[l + 1]; n += g.size)
        body_frame(p, s.qpos, s.k, p.level_body[n]);
    }
    g.sync();
  }
}

// World velocity of the point c_w of body b, and its body-frame lever arm.
CS_FN V3 point_velocity(const Frames& k, const V6* v, int b, V3 c_w, V3* r_loc) {
  *r_loc = m3T_vec(k.E[b], sub(c_w, k.P[b]));
  return m3_vec(k.E[b], add(v[b].l, cross(v[b].w, *r_loc)));
}

// The wrench on body b of the world force f_w at body-frame lever arm
// r_loc, as it is subtracted from b's bias-force accumulator (so rhs = tau
// - C carries it positively).
CS_FN V6 point_wrench(const Frames& k, int b, V3 r_loc, V3 f_w) {
  const V3 f_b = m3T_vec(k.E[b], f_w);
  return V6{cross(r_loc, f_b), f_b};
}

// Ground geom gi's or pair j's contact: its normal force into s.normals
// and its wrenches into s.contact.
__device__ void contact(const SceneParams& p, SceneEnv& s, int n) {
  const Frames& k = s.k;
  const V6* v = s.v;
  if (n < SS_NG) {
    const int gi = n;
    const int b = p.geom_body[gi], t = p.geom_tree[gi];
    const V3 offset = v3(p.geom_offset[gi]);
    const float radius = p.geom_radius[gi];
    const M3 E_b = k.E[b];
    const V3 x_w = add(k.P[b], m3_vec(E_b, offset));
    const V3 wb = v[b].w, lb = v[b].l;
    const float mu = p.friction[t];
    float fn;
    V3 contact_offset, f_w;
    if (p.terrain_mode == 0) {
      const float phi = radius - x_w.z;
      const V3 down = m3T_vec(E_b, v3(0.0f, 0.0f, 0.0f - 1.0f));
      contact_offset = v3(offset.x + down.x * radius, offset.y + down.y * radius,
                          offset.z + down.z * radius);
      const V3 v_pt = m3_vec(E_b, add(lb, cross(wb, contact_offset)));
      fn = normal_force(p.contact_stiffness[t], p.contact_damping[t], p.max_contact_force[t],
                        phi, v_pt.z);
      const float vt_norm = sqrtf(v_pt.x * v_pt.x + v_pt.y * v_pt.y + 1e-6f);
      const float sc = -mu * fn / fmaxf(vt_norm, p.friction_vel[t]);
      f_w = v3(sc * v_pt.x, sc * v_pt.y, fn);
    } else {
      const V3 nrm = terrain_normal(p, x_w.x, x_w.y);
      const float h = terrain_height(p, x_w.x, x_w.y);
      const float phi = radius - (x_w.z - h) * nrm.z;
      contact_offset = add(offset, m3T_vec(E_b, scale(-radius, nrm)));
      const V3 v_pt = m3_vec(E_b, add(lb, cross(wb, contact_offset)));
      const float vn = dot(nrm, v_pt);
      fn = normal_force(p.contact_stiffness[t], p.contact_damping[t], p.max_contact_force[t],
                        phi, vn);
      const V3 vt = sub(v_pt, scale(vn, nrm));
      const float vt_norm = sqrtf(dot(vt, vt) + 1e-6f);
      const float sc = -mu * fn / fmaxf(vt_norm, p.friction_vel[t]);
      f_w = add(scale(fn, nrm), scale(sc, vt));
    }
    s.normals[p.geom_slot[gi]] = fn;
    const V3 f_b = m3T_vec(E_b, f_w);
    s.contact[gi] = V6{cross(contact_offset, f_b), f_b};
    return;
  }
  // Sphere-sphere pair, inside a tree or across trees.
  const int j = n - SS_NG;
  const int ga = p.pair_a[j], gb = p.pair_b[j];
  const int ba = p.geom_body[ga], bb = p.geom_body[gb];
  const float ra = p.geom_radius[ga];
  const V3 xa = add(k.P[ba], m3_vec(k.E[ba], v3(p.geom_offset[ga])));
  const V3 xb = add(k.P[bb], m3_vec(k.E[bb], v3(p.geom_offset[gb])));
  const V3 d = sub(xb, xa);
  const float dist = sqrtf(dot(d, d) + 1e-12f);
  const V3 nrm = scale(1.0f / dist, d);  // a -> b
  const float phi = p.pair_radius_sum[j] - dist;
  const V3 c_w = add(xa, scale(ra - 0.5f * phi, nrm));
  V3 r_a, r_b;
  const V3 vel_b = point_velocity(k, v, bb, c_w, &r_b);
  const V3 vel_a = point_velocity(k, v, ba, c_w, &r_a);
  const V3 v_rel = sub(vel_b, vel_a);
  const float sep = dot(nrm, v_rel);  // separation rate
  const float fn = normal_force(p.pair_stiffness[j], p.pair_damping[j], p.pair_max_force[j],
                                phi, sep);
  const V3 vt = sub(v_rel, scale(sep, nrm));
  const float vt_norm = sqrtf(dot(vt, vt) + 1e-6f);
  const float sc = -p.pair_friction[j] * fn / fmaxf(vt_norm, p.pair_friction_vel[j]);
  const V3 f_w = add(scale(fn, nrm), scale(sc, vt));
  s.normals[p.pair_slot[j]] = fn;
  s.contact[SS_NG + 2 * j] = point_wrench(k, bb, r_b, f_w);
  s.contact[SS_NG + 2 * j + 1] = point_wrench(k, ba, r_a, scale(-1.0f, f_w));
}

// Body velocities v, then the inertial wrenches f less every contact
// force; s.normals gets the contact normal forces.
__device__ void wrenches(const SceneParams& p, SceneEnv& s, const LaneGroup& g) {
  const Frames& k = s.k;
#pragma unroll 1
  for (int l = 0; l < p.n_levels; ++l) {
    if (g.active) {
#pragma unroll 1
      for (int n = p.level_start[l] + g.lane; n < p.level_start[l + 1]; n += g.size) {
        const int i = p.level_body[n];
        const int vs = p.v_start[i];
        float sq[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};  // S qd
        for (int d = 0; d < p.n_dof[i]; ++d)
          for (int c = 0; c < 6; ++c) sq[c] = sq[c] + p.s_col[vs + d][c] * s.qvel[vs + d];
        const V6 vj = v6(sq);
        const int parent = p.parent[i];
        V6 vi, a_par;
        if (parent < 0) {
          vi = vj;
          // Gravity as an upward acceleration of the world.
          a_par = V6{v3(0.0f, 0.0f, 0.0f), v3(0.0f, 0.0f, p.gravity_up[p.body_tree[i]])};
        } else {
          vi = add(xup_motion(k.Rcp[i], k.r[i], s.v[parent]), vj);
          a_par = s.a[parent];
        }
        s.v[i] = vi;
        const V6 ai = add(xup_motion(k.Rcp[i], k.r[i], a_par), crm_apply(vi, vj));
        s.a[i] = ai;
        const V3 com = v3(p.com[i]);
        const V6 Iv = inertia_apply(p.mass[i], com, p.inertia[i], vi);
        const V6 Ia = inertia_apply(p.mass[i], com, p.inertia[i], ai);
        s.f[i] = add(Ia, crf_apply(vi, Iv));
      }
    }
    g.sync();
  }
  if (g.active) {
#pragma unroll 1
    for (int n = g.lane; n < SS_NG + SS_NP; n += g.size) contact(p, s, n);
  }
  g.sync();
  // Each body's contact wrenches, subtracted in the plain order.
  if (g.active) {
#pragma unroll 1
    for (int i = g.lane; i < SS_NB; i += g.size) {
      V6 F = s.f[i];
#pragma unroll 1
      for (int q = p.contact_start[i]; q < p.contact_start[i + 1]; ++q)
        F = sub(F, s.contact[p.contact_slot[q]]);
      s.f[i] = F;
    }
  }
  g.sync();
}

// CRBA mass matrix of tree t and the in-place Cholesky factor of
// M + armature + dt*D on the packed lower triangle s.L[t][i (i + 1) / 2 +
// j], j <= i, over the tree's own dofs.
__device__ void crba_chol(const SceneParams& p, int t, SceneEnv& s) {
  const Frames& k = s.k;
  M3* Ia = s.Ia;
  M3* Ib = s.Ib;
  M3* Ic = s.Ic;
  float* L = s.L[t];
  const int b0 = p.tree_body_start[t], b1 = p.tree_body_end[t];
  const int v0 = p.tree_v_start[t], nv = p.tree_nv[t];
#pragma unroll 1
  for (int i = b0; i < b1; ++i) {
    Ia[i] = m3(p.blk_a[i]);
    Ib[i] = m3(p.blk_b[i]);
    Ic[i] = m3(p.blk_c[i]);
  }
  // Composite inertias, leaves to root: Y = X^T I X with
  // X = [[R, 0], [-U, R]], R = child_R_parent, U = R skew(r).
#pragma unroll 1
  for (int i = b1 - 1; i >= b0; --i) {
    const int parent = p.parent[i];
    if (parent < 0) continue;
    const M3 Ri = k.Rcp[i];
    const V3 r = k.r[i];
    const M3 sk = M3{{0.0f, -r.z, r.y, r.z, 0.0f, -r.x, -r.y, r.x, 0.0f}};
    const M3 U = m3_mul(Ri, sk);
    const M3 A = Ia[i], B = Ib[i], C = Ic[i];
    const M3 Bt = m3_transpose(B);
    const M3 W11 = m3_sub(m3_mul(A, Ri), m3_mul(B, U));
    const M3 W12 = m3_mul(B, Ri);
    const M3 W21 = m3_sub(m3_mul(Bt, Ri), m3_mul(C, U));
    const M3 W22 = m3_mul(C, Ri);
    const M3 Y11 = m3_sub(m3T_mul(Ri, W11), m3T_mul(U, W21));
    const M3 Y12 = m3_sub(m3T_mul(Ri, W12), m3T_mul(U, W22));
    Ia[parent] = m3_add(Ia[parent], Y11);
    Ib[parent] = m3_add(Ib[parent], Y12);
    if (!p.fold_c[i]) Ic[parent] = m3_add(Ic[parent], m3T_mul(Ri, W22));
  }

#pragma unroll 1
  for (int n = 0; n < nv * (nv + 1) / 2; ++n) L[n] = 0.0f;
  // Rows of M: each dof's force, walked up the tree.
#pragma unroll 1
  for (int i = b0; i < b1; ++i) {
    const int si = p.v_start[i] - v0;
#pragma unroll 1
    for (int a = 0; a < p.n_dof[i]; ++a) {
      const int dof = p.v_start[i] + a;
      const int row = (si + a) * (si + a + 1) / 2;
      V6 F;
      if (p.is_leaf[i]) {
        F = v6(p.leaf_f[dof]);
        for (int b = 0; b <= a; ++b) L[row + si + b] = p.leaf_m[dof][b];
      } else {
        const V3 w = v3(p.s_col[dof]), l = v3(p.s_col[dof] + 3);
        F = V6{add(m3_vec(Ia[i], w), m3_vec(Ib[i], l)), add(m3T_vec(Ib[i], w), m3_vec(Ic[i], l))};
        for (int b = 0; b <= a; ++b) L[row + si + b] = sdot(p.s_col[p.v_start[i] + b], F);
        const int d = row + si + a;
        L[d] = L[d] + p.armature[dof];
        if (p.damping[dof] != 0.0f) L[d] = L[d] + p.dt_damping[dof];
      }
      int j = i;
#pragma unroll 1
      while (p.parent[j] >= 0) {
        F = xup_force_T(k.Rcp[j], k.r[j], F);
        j = p.parent[j];
        const int sj = p.v_start[j] - v0;
        for (int b = 0; b < p.n_dof[j]; ++b) L[row + sj + b] = sdot(p.s_col[p.v_start[j] + b], F);
      }
    }
  }
  // Cholesky, row by row, in place; unrolled over the largest tree's
  // size, so that the loads of a sum start ahead of its chain of
  // subtractions (which keeps its order).
#pragma unroll
  for (int i = 0; i < SS_MV; ++i) {
    if (i >= nv) break;
    const int ri = i * (i + 1) / 2;
#pragma unroll
    for (int j = 0; j <= i; ++j) {
      const int rj = j * (j + 1) / 2;
      float acc = L[ri + j];
#pragma unroll
      for (int n = 0; n < j; ++n) acc = acc - L[ri + n] * L[rj + n];
      L[ri + j] = (i == j) ? sqrtf(acc) : acc / L[rj + j];
    }
  }
}

// Tree t from the wrenches s.f to its integrated qpos and qvel, in place.
__device__ void solve_and_integrate(const SceneParams& p, int t, SceneEnv& s) {
  const Frames& k = s.k;
  V6* f = s.f;
  const float* L = s.L[t];
  float* rhs = s.rhs[t];  // holds C first, then the right-hand side, then qacc
  float* qpos = s.qpos;
  float* qvel = s.qvel;
  const int b0 = p.tree_body_start[t], b1 = p.tree_body_end[t];
  const int v0 = p.tree_v_start[t], nv = p.tree_nv[t];

  // ---- backward pass: generalized bias, contacts included ----
#pragma unroll 1
  for (int i = b1 - 1; i >= b0; --i) {
    const int vs = p.v_start[i];
    for (int d = 0; d < p.n_dof[i]; ++d) rhs[vs - v0 + d] = sdot(p.s_col[vs + d], f[i]);
    const int parent = p.parent[i];
    if (parent >= 0) f[parent] = add(f[parent], xup_force_T(k.Rcp[i], k.r[i], f[i]));
  }
#pragma unroll 1
  for (int n = 0; n < nv; ++n) {
    const int dof = v0 + n;
    float C = rhs[n];
    if (p.damping[dof] != 0.0f) C = C + p.damping[dof] * qvel[dof];
    rhs[n] = s.tau[dof] - C;
  }

  // ---- joint limits and springs of the 1-dof joints ----
#pragma unroll 1
  for (int i = b0; i < b1; ++i) {
    const int type = p.joint_type[i];
    if (type != JOINT_HINGE && type != JOINT_SLIDE) continue;
    const int dof = p.v_start[i], n = dof - v0;
    const float q_j = qpos[p.q_start[i]], qd_j = qvel[dof];
    const float lo = p.lower[dof], hi = p.upper[dof];
    if (p.has_limits[t] && (isfinite(lo) || isfinite(hi))) {
      const float below = isfinite(lo) ? fmaxf(lo - q_j, 0.0f) : 0.0f;
      const float above = isfinite(hi) ? fmaxf(q_j - hi, 0.0f) : 0.0f;
      const float violating = (below + above) > 0.0f ? 1.0f : 0.0f;
      rhs[n] = rhs[n] + (p.limit_stiffness[t] * (below - above) -
                         p.limit_damping[t] * violating * qd_j);
    }
  }
#pragma unroll 1
  for (int i = b0; i < b1; ++i) {
    const int type = p.joint_type[i];
    if (type != JOINT_HINGE && type != JOINT_SLIDE) continue;
    const int dof = p.v_start[i], n = dof - v0;
    if (p.has_springs[t] && p.spring_k[dof] > 0.0f)
      rhs[n] = rhs[n] - p.spring_k[dof] * (qpos[p.q_start[i]] - p.spring_ref[dof]);
  }

  // ---- L y = rhs, then L^T qacc = y, in place (unrolled as above) ----
#pragma unroll
  for (int i = 0; i < SS_MV; ++i) {
    if (i >= nv) break;
    const int ri = i * (i + 1) / 2;
    float acc = rhs[i];
#pragma unroll
    for (int n = 0; n < i; ++n) acc = acc - L[ri + n] * rhs[n];
    rhs[i] = acc / L[ri + i];
  }
#pragma unroll
  for (int m = SS_MV - 1; m >= 0; --m) {
    if (m >= nv) continue;
    const int i = m;
    float acc = rhs[i];
#pragma unroll
    for (int n = i + 1; n < SS_MV; ++n) {
      if (n >= nv) break;
      acc = acc - L[n * (n + 1) / 2 + i] * rhs[n];
    }
    rhs[i] = acc / L[i * (i + 1) / 2 + i];
  }

  // ---- semi-implicit Euler; FREE positions with the old orientation ----
  const float dt = p.dt;
#pragma unroll 1
  for (int n = 0; n < nv; ++n) qvel[v0 + n] = qvel[v0 + n] + dt * rhs[n];
#pragma unroll 1
  for (int i = b0; i < b1; ++i) {
    float* q = qpos + p.q_start[i];
    const float* qd = qvel + p.v_start[i];
    const int type = p.joint_type[i];
    if (type == JOINT_FREE) {
      const V3 pos_new = add(v3(q), scale(dt, m3_vec(k.E[i], v3(qd + 3))));
      q[0] = pos_new.x; q[1] = pos_new.y; q[2] = pos_new.z;
      quat_integrate(q + 3, v3(qd), dt);
    } else if (type == JOINT_BALL) {
      quat_integrate(q, v3(qd), dt);
    } else {
      q[0] = q[0] + dt * qd[0];
    }
  }
}

__global__ void scene_step_kernel(const float* __restrict__ qpos_in,
                                  const float* __restrict__ qvel_in,
                                  const float* __restrict__ tau_in,
                                  float* __restrict__ qpos_out, float* __restrict__ qvel_out,
                                  float* __restrict__ normals_out, int B,
                                  const __grid_constant__ SceneParams p_arg) {
  extern __shared__ float4 ss_smem[];
  float* envs = copy_model_to_shared(p_arg, reinterpret_cast<float*>(ss_smem));
  const SceneParams& p = *reinterpret_cast<const SceneParams*>(ss_smem);
  int env;
  const LaneGroup g = lane_group(SS_G, B, &env);
  SceneEnv& s = *reinterpret_cast<SceneEnv*>(
      envs + static_cast<int>(threadIdx.x / SS_G) * kSceneEnvWords);

  if (g.active) {
    load_row(s.qpos, qpos_in, env, SS_NQ, g);
    load_row(s.qvel, qvel_in, env, SS_NV, g);
    load_row(s.tau, tau_in, env, SS_NV, g);
    for (int n = g.lane; n < SS_NG + SS_NP + 1; n += g.size) s.normals[n] = 0.0f;
  }
  g.sync();

#pragma unroll 1
  for (int step = 0; step < p.n_substeps; ++step) {
    kinematics(p, s, g);
    wrenches(p, s, g);
    // The trees side by side, one per lane.
    if (g.active) {
#pragma unroll 1
      for (int t = g.lane; t < SS_NT; t += g.size) {
        crba_chol(p, t, s);
        solve_and_integrate(p, t, s);
      }
    }
    g.sync();
  }

  if (g.active) {
    store_row(qpos_out, s.qpos, env, SS_NQ, g);
    store_row(qvel_out, s.qvel, env, SS_NV, g);
    store_row(normals_out, s.normals, env, p.n_normals, g);
  }
}

}  // namespace

// Size of the scene struct and the sizes this library was built for, so
// that the caller can check its packing:
// out = {NT, NB, NQ, NV, MV, NG, NP, NW, G}.
extern "C" int scene_step_params_size(int* out) {
  out[0] = SS_NT;
  out[1] = SS_NB;
  out[2] = SS_NQ;
  out[3] = SS_NV;
  out[4] = SS_MV;
  out[5] = SS_NG;
  out[6] = SS_NP;
  out[7] = SS_NW;
  out[8] = SS_G;
  return static_cast<int>(sizeof(SceneParams));
}

// Dynamic shared memory of one block of `threads` threads, in bytes.
extern "C" long long scene_step_smem_bytes(int threads) { return scene_block_smem_bytes(threads); }

// Launches on `stream` of CUDA device `device` and returns the launch's
// cudaError_t (0 on success), or that of setting the kernel's shared-memory
// limit. `params` points to a host copy of the struct; `threads` (per
// block) is a multiple of 32; each env takes SS_G of them.
extern "C" int scene_step_forward(const float* qpos, const float* qvel, const float* tau,
                                  float* qpos_out, float* qvel_out, float* normals_out, int B,
                                  const SceneParams* params, int threads, int device,
                                  void* stream) {
  if (threads <= 0 || threads % 32 != 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const long long smem = scene_block_smem_bytes(threads);
  if (smem > 48 * 1024) {
    const cudaError_t attr = cudaFuncSetAttribute(
        scene_step_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (attr != cudaSuccess) return static_cast<int>(attr);
  }
  const long long lanes = static_cast<long long>(B) * SS_G;
  const int blocks = static_cast<int>((lanes + threads - 1) / threads);
  scene_step_kernel<<<blocks, threads, static_cast<size_t>(smem),
                      static_cast<cudaStream_t>(stream)>>>(qpos, qvel, tau, qpos_out, qvel_out,
                                                           normals_out, B, *params);
  return static_cast<int>(cudaGetLastError());
}
