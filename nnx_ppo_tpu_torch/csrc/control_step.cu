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
// It does some 1e5 float operations per env and control step, 3 us at the
// float32 peak for 2048 envs, so operations bound it, not bytes. The
// substeps kernel also reads the 171-float factor: 1,060 bytes per env,
// 0.65 us at B = 2048 by bytes, and the same substep operations less the
// factor build. What holds both back is neither: each env is one long
// dependent chain (precise sqrtf, division, sinf and cosf in it), and a
// few thousand envs at one thread each leave most of the card's 528
// schedulers without a warp to switch to.
//
// Design for Hopper: a group of CS_G lanes per env (a -D size that divides
// 32; a warp holds 32 / CS_G envs, a block several warps). The lanes share
// out independent scalars; each scalar is still computed by one lane with
// the plain version's operations in its order, so the kernel stays equal to
// the bit with it (built with -fmad=false): kinematics, velocities,
// accelerations and inertial wrenches level by level from the base, one body
// per lane; every ground geom's and pair's contact on its own lane, their
// wrenches then subtracted per body in the plain order; the backward pass
// and the composite inertias level by level from the deepest, each body
// adding its children in descending index order as the plain loop does; one
// row of M, of the Cholesky factor and of the forward solve per lane (row r
// on lane r % CS_G), column by column: the factor with one barrier per
// column, the forward solve with each row's running sum in a register and
// each y_k sent to the group's lanes by a shuffle; the backward solve, whose
// sums run in ascending order, on one lane. The loops of the factor and the
// solves run over compile-time bounds and are unrolled, so that loads start
// ahead of the chains. Each env's state (qpos, qvel, targets, lanes, E, P,
// Rcp, v, a, f, the composite inertias, the packed factor, rhs) lives in
// shared memory, once per env, and the model struct, a __grid_constant__
// argument, is copied into shared memory at block start, so that lanes that
// read different bodies' entries at once do not serialise on parameter
// space. No per-thread array is indexed through the topology; the host packs
// the schedules (levels, children, contact slots) into the struct. Barriers
// are __syncwarp over the whole warp, whose lanes all run the same sequence
// of them (so the warp's envs reconverge there); __syncthreads only after
// the model copy. The lanes of an env past B run every barrier and do no
// work.
//
// Not used, and why: wgmma, mma.sync and TF32 (the per-env matrices are at
// most 18 x 18 float32 and must stay equal to the bit with a float32 plain
// version; TF32 keeps about 3 digits); TMA and cp.async (the bytes bound is
// 0.25 us: loading is not what holds the kernel back). What Hopper offers
// here is warps per SM to hide the chain's latency, 227 KB of shared memory
// per block for the envs' state, and warp-level barriers.

#include "rigid_body.cuh"

namespace {

// Per-env values that ride in `extra` (defaults are exact identities).
struct Lanes {
  float mass_scale, friction, damping_scale, gain_scale;
  V3 push;
  float planes[3 * CS_AT_LEAST_1(CS_NG)];
};

// Scratch of the factor build and of a substep, which never overlap.
struct CrbaScratch {
  M3 Ia[CS_NB], Ib[CS_NB], Ic[CS_NB];     // composite inertias
  M3 Y11[CS_NB], Y12[CS_NB], Y22[CS_NB];  // X^T I X, to be added to the parent's
};
struct DynamicsScratch {
  V6 v[CS_NB], a[CS_NB], f[CS_NB];
  V6 up[CS_NB];          // X^T f of a body, to be added to its parent's f
  V6 contact[CS_NC];     // contact wrenches, to be subtracted from f
};

// One env's state in shared memory.
struct Env {
  float qpos[CS_NQ], qvel[CS_NV], target[CS_NJ];
  float normals[CS_AT_LEAST_1(CS_NN)];
  float rhs[CS_NV];  // holds C first, then the right-hand side, then qacc
  float L[CS_NT];    // packed factor: L[i (i + 1) / 2 + j], j <= i
  Lanes lane;
  M3 E[CS_NB], Rcp[CS_NB];
  V3 P[CS_NB];
  union {
    CrbaScratch crba;
    DynamicsScratch dyn;
  };
};

// Words between two envs in shared memory: odd, so that the envs of a
// warp that read the same member fall on different banks.
constexpr int kEnvWords = static_cast<int>(sizeof(Env) / 4) | 1;

// Dynamic shared memory of a block of `threads` threads.
constexpr long long block_smem_bytes(int threads) {
  return 4LL * (model_words<Params>() + static_cast<long long>(threads / CS_G) * kEnvWords);
}

// The first of rows after..CS_NV-1 that lane `lane` owns (row r on lane
// r % size).
CS_FN int first_owned_row(int after, const LaneGroup& g) {
  return after + ((g.lane - after % g.size) + g.size) % g.size;
}

// CRBA mass matrix and in-place Cholesky factor of M + armature + dt*D on
// the packed lower triangle s.L.
__device__ void crba_chol(const Params& p, Env& s, const LaneGroup& g) {
  CrbaScratch& c = s.crba;
  // Composite inertias, leaves to root, level by level: Y = X^T I X with
  // X = [[E, 0], [-U, E]], E = child_R_parent, U = E skew(joint_pos).
#pragma unroll 1
  for (int l = p.n_levels - 1; l >= 1; --l) {
    if (g.active) {
#pragma unroll 1
      for (int k = p.level_start[l] + g.lane; k < p.level_start[l + 1]; k += g.size) {
        const int i = p.level_body[k];
        M3 A = m3(p.blk_a[i]), B = m3(p.blk_b[i]), C = m3(p.blk_c[i]);
#pragma unroll 1
        for (int q = p.child_start[i]; q < p.child_start[i + 1]; ++q) {
          const int ch = p.child_list[q];
          A = m3_add(A, c.Y11[ch]);
          B = m3_add(B, c.Y12[ch]);
          C = m3_add(C, c.Y22[ch]);
        }
        c.Ia[i] = A;
        c.Ib[i] = B;
        c.Ic[i] = C;
        const M3 Ei = s.Rcp[i];
        const V3 r = v3(p.joint_pos[i]);
        const M3 sk = M3{{0.0f, -r.z, r.y, r.z, 0.0f, -r.x, -r.y, r.x, 0.0f}};
        const M3 U = m3_mul(Ei, sk);
        const M3 Bt = m3_transpose(B);
        const M3 W11 = m3_sub(m3_mul(A, Ei), m3_mul(B, U));
        const M3 W12 = m3_mul(B, Ei);
        const M3 W21 = m3_sub(m3_mul(Bt, Ei), m3_mul(C, U));
        const M3 W22 = m3_mul(C, Ei);
        c.Y11[i] = m3_sub(m3T_mul(Ei, W11), m3T_mul(U, W21));
        c.Y12[i] = m3_sub(m3T_mul(Ei, W12), m3T_mul(U, W22));
        c.Y22[i] = m3T_mul(Ei, W22);
      }
    }
    g.sync();
  }
  if (g.active && g.lane == 0) {
    M3 A = m3(p.blk_a[0]), B = m3(p.blk_b[0]), C = m3(p.blk_c[0]);
#pragma unroll 1
    for (int q = p.child_start[0]; q < p.child_start[1]; ++q) {
      const int ch = p.child_list[q];
      A = m3_add(A, c.Y11[ch]);
      B = m3_add(B, c.Y12[ch]);
      C = m3_add(C, c.Y22[ch]);
    }
    c.Ia[0] = A;
    c.Ib[0] = B;
    c.Ic[0] = C;
  }
  g.sync();

  // Rows of M + armature + dt*D, one per lane: the base 6x6 block
  // [[A0, B0], [B0^T, C0]], or joint i's force walked up the tree; then
  // the density scale on M (not on armature) and the damping scale on
  // dt*D.
  if (g.active) {
    const float mass_scale = s.lane.mass_scale, damping_scale = s.lane.damping_scale;
#pragma unroll 1
    for (int di = g.lane; di < CS_NV; di += g.size) {
      const int row = di * (di + 1) / 2;
      float* Lr = s.L + row;
#pragma unroll 1
      for (int k = 0; k <= di; ++k) Lr[k] = 0.0f;
      if (di < 3) {
        for (int j = 0; j <= di; ++j) Lr[j] = c.Ia[0].m[3 * di + j];
      } else if (di < 6) {
        const int i = di - 3;
        for (int j = 0; j < 3; ++j) Lr[j] = c.Ib[0].m[3 * j + i];
        for (int j = 0; j <= i; ++j) Lr[3 + j] = c.Ic[0].m[3 * i + j];
      } else {
        const int i = di - 5;
        const V3 axis = v3(p.joint_axis[i]);
        V6 F = V6{m3_vec(c.Ia[i], axis), m3T_vec(c.Ib[i], axis)};  // (A s, B^T s)
        Lr[di] = dot(F.w, axis);
        int j = i;
#pragma unroll 1
        while (p.parent[j] >= 0) {
          F = xup_force_T(s.Rcp[j], v3(p.joint_pos[j]), F);
          j = p.parent[j];
          if (j == 0) {
            Lr[0] = F.w.x; Lr[1] = F.w.y; Lr[2] = F.w.z;
            Lr[3] = F.l.x; Lr[4] = F.l.y; Lr[5] = F.l.z;
          } else {
            Lr[5 + j] = dot(F.w, v3(p.joint_axis[j]));
          }
        }
      }
#pragma unroll 1
      for (int k = 0; k <= di; ++k) Lr[k] = Lr[k] * mass_scale;
      Lr[di] = Lr[di] + p.armature[di];
      Lr[di] = Lr[di] + p.dt_damping[di] * damping_scale;
    }
  }
  g.sync();

  // Cholesky in place, column by column: entry (i, j) is the plain row-by-
  // row loop's, s = L[i][j] - sum over k < j, ascending, of L[i][k] L[j][k],
  // then sqrtf on the diagonal or division by L[j][j]. Row i's lane, having
  // finished L[i][j] with j = i - 1, finishes the diagonal L[i][i] too.
  // The loops over columns and over k run over compile-time bounds and are
  // unrolled, so that the loads of a sum start ahead of its chain of
  // subtractions (which keeps its order).
  float* L = s.L;
  if (g.active && g.lane == 0) L[0] = sqrtf(L[0]);
  g.sync();
#pragma unroll
  for (int j = 0; j + 1 < CS_NV; ++j) {
    if (g.active) {
      const int rj = j * (j + 1) / 2;
#pragma unroll 1
      for (int i = first_owned_row(j + 1, g); i < CS_NV; i += g.size) {
        const int ri = i * (i + 1) / 2;
        float acc = L[ri + j];
#pragma unroll
        for (int k = 0; k < j; ++k) acc = acc - L[ri + k] * L[rj + k];
        L[ri + j] = acc / L[rj + j];
        if (i == j + 1) {
          float d = L[ri + i];
#pragma unroll
          for (int k = 0; k < j + 1; ++k) d = d - L[ri + k] * L[ri + k];
          L[ri + i] = sqrtf(d);
        }
      }
    }
    g.sync();
  }
}

CS_FN float contact_normal_force(const Params& p, float phi, float rate) {
  return normal_force(p.contact_stiffness, p.contact_damping, p.max_contact_force, phi, rate);
}

// One substep of env s from (qpos, qvel), in place. s.E, s.P, s.Rcp are
// this qpos's kinematics; s.L is the factor. s.normals gets the contact
// normal forces of the pre-integration state.
__device__ void substep(const Params& p, Env& s, const LaneGroup& g) {
  DynamicsScratch& d = s.dyn;
  const float* jq = s.qpos + 7;
  const float* jd = s.qvel + 6;
  const V3 pos = v3(s.qpos);

  // ---- body velocities, RNEA accelerations and inertial wrenches ----
  if (g.active && g.lane == 0) {
    d.v[0] = V6{v3(s.qvel), v3(s.qvel + 3)};
    const V6 a_world = V6{v3(0.0f, 0.0f, 0.0f), v3(0.0f, 0.0f, 0.0f + p.gravity_up)};
    d.a[0] = xup_motion(m3_transpose(s.E[0]), pos, a_world);
    const V3 com = v3(p.com[0]);
    const V6 Iv = inertia_apply(p.mass[0], com, p.inertia[0], d.v[0]);
    const V6 Ia = inertia_apply(p.mass[0], com, p.inertia[0], d.a[0]);
    d.f[0] = scale(s.lane.mass_scale, add(Ia, crf_apply(d.v[0], Iv)));
  }
  g.sync();
#pragma unroll 1
  for (int l = 1; l < p.n_levels; ++l) {
    if (g.active) {
#pragma unroll 1
      for (int k = p.level_start[l] + g.lane; k < p.level_start[l + 1]; k += g.size) {
        const int i = p.level_body[k];
        const int parent = p.parent[i];
        const V3 axis = v3(p.joint_axis[i]);
        const V3 jp = v3(p.joint_pos[i]);
        const float qd = jd[i - 1];
        V6 vi = xup_motion(s.Rcp[i], jp, d.v[parent]);
        vi.w = v3(vi.w.x + axis.x * qd, vi.w.y + axis.y * qd, vi.w.z + axis.z * qd);
        d.v[i] = vi;
        const V6 ai0 = xup_motion(s.Rcp[i], jp, d.a[parent]);
        const V6 vj = V6{scale(qd, axis), v3(0.0f, 0.0f, 0.0f)};
        const V6 ai = add(ai0, crm_apply(vi, vj));
        d.a[i] = ai;
        const V3 com = v3(p.com[i]);
        const V6 Iv = inertia_apply(p.mass[i], com, p.inertia[i], vi);
        const V6 Ia = inertia_apply(p.mass[i], com, p.inertia[i], ai);
        d.f[i] = scale(s.lane.mass_scale, add(Ia, crf_apply(vi, Iv)));
      }
    }
    g.sync();
  }

  // ---- contacts, one ground geom or sphere pair per lane ----
  const float mu = s.lane.friction;
  if (g.active) {
#pragma unroll 1
    for (int n = g.lane; n < CS_NN; n += g.size) {
      if (n < CS_NG) {
        const int gi = n;
        const int b = p.geom_body[gi];
        const V3 offset = v3(p.geom_offset[gi]);
        const float radius = p.geom_radius[gi];
        const M3 E_b = s.E[b];
        const V3 x_w = add(s.P[b], m3_vec(E_b, offset));
        const V3 wb = d.v[b].w, lb = d.v[b].l;
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
          const float sc = -mu * fn / fmaxf(vt_norm, p.friction_vel);
          f_w = v3(sc * v_pt.x, sc * v_pt.y, fn);
        } else {
          V3 nrm;
          float h;
          if (p.terrain_mode == 2) {
            const float c_g = s.lane.planes[3 * gi], gx = s.lane.planes[3 * gi + 1],
                        gy = s.lane.planes[3 * gi + 2];
            h = c_g + gx * x_w.x + gy * x_w.y;
            const float inv = 1.0f / sqrtf(gx * gx + gy * gy + 1.0f);
            nrm = v3(-gx * inv, -gy * inv, inv);
          } else {
            nrm = terrain_normal(p, x_w.x, x_w.y);
            h = terrain_height(p, x_w.x, x_w.y);
          }
          const float phi = radius - (x_w.z - h) * nrm.z;
          contact_offset = add(offset, m3T_vec(E_b, scale(-radius, nrm)));
          const V3 v_pt = m3_vec(E_b, add(lb, cross(wb, contact_offset)));
          const float vn = dot(nrm, v_pt);
          fn = contact_normal_force(p, phi, vn);
          const V3 vt = sub(v_pt, scale(vn, nrm));
          const float vt_norm = sqrtf(dot(vt, vt) + 1e-6f);
          const float sc = -mu * fn / fmaxf(vt_norm, p.friction_vel);
          f_w = add(scale(fn, nrm), scale(sc, vt));
        }
        s.normals[gi] = fn;
        const V3 f_b = m3T_vec(E_b, f_w);
        d.contact[gi] = V6{cross(contact_offset, f_b), f_b};
      } else {
        // Sphere-sphere pair: equal and opposite at the midpoint.
        const int k = n - CS_NG;
        const int ga = p.pair_a[k], gb = p.pair_b[k];
        const int ba = p.geom_body[ga], bb = p.geom_body[gb];
        const float ra = p.geom_radius[ga], rb = p.geom_radius[gb];
        const V3 xa = add(s.P[ba], m3_vec(s.E[ba], v3(p.geom_offset[ga])));
        const V3 xb = add(s.P[bb], m3_vec(s.E[bb], v3(p.geom_offset[gb])));
        const V3 dv = sub(xb, xa);
        const float dist = sqrtf(dot(dv, dv) + 1e-12f);
        const V3 nrm = scale(1.0f / dist, dv);  // a -> b
        const float phi = ra + rb - dist;
        const V3 c_w = add(xa, scale(ra - 0.5f * phi, nrm));
        const V3 r_a = m3T_vec(s.E[ba], sub(c_w, s.P[ba]));
        const V3 r_b = m3T_vec(s.E[bb], sub(c_w, s.P[bb]));
        const V3 vel_a = m3_vec(s.E[ba], add(d.v[ba].l, cross(d.v[ba].w, r_a)));
        const V3 vel_b = m3_vec(s.E[bb], add(d.v[bb].l, cross(d.v[bb].w, r_b)));
        const V3 v_rel = sub(vel_b, vel_a);
        const float sep = dot(nrm, v_rel);  // separation rate
        const float fn = contact_normal_force(p, phi, sep);
        const V3 vt = sub(v_rel, scale(sep, nrm));
        const float vt_norm = sqrtf(dot(vt, vt) + 1e-6f);
        const float sc = -mu * fn / fmaxf(vt_norm, p.friction_vel);
        const V3 f_w = add(scale(fn, nrm), scale(sc, vt));
        s.normals[CS_NG + k] = fn;
        const V3 f_on_b = m3T_vec(s.E[bb], scale(1.0f, f_w));
        d.contact[CS_NG + 2 * k] = V6{cross(r_b, f_on_b), f_on_b};
        const V3 f_on_a = m3T_vec(s.E[ba], scale(-1.0f, f_w));
        d.contact[CS_NG + 2 * k + 1] = V6{cross(r_a, f_on_a), f_on_a};
      }
    }
  }
  g.sync();
  // Each body's contact wrenches, subtracted in the plain order.
  if (g.active) {
#pragma unroll 1
    for (int i = g.lane; i < CS_NB; i += g.size) {
      V6 F = d.f[i];
#pragma unroll 1
      for (int q = p.contact_start[i]; q < p.contact_start[i + 1]; ++q)
        F = sub(F, d.contact[p.contact_slot[q]]);
      d.f[i] = F;
    }
  }
  g.sync();

  // ---- backward pass, deepest level first: generalized bias ----
#pragma unroll 1
  for (int l = p.n_levels - 1; l >= 1; --l) {
    if (g.active) {
#pragma unroll 1
      for (int k = p.level_start[l] + g.lane; k < p.level_start[l + 1]; k += g.size) {
        const int i = p.level_body[k];
        V6 F = d.f[i];
#pragma unroll 1
        for (int q = p.child_start[i]; q < p.child_start[i + 1]; ++q)
          F = add(F, d.up[p.child_list[q]]);
        s.rhs[5 + i] = dot(v3(p.joint_axis[i]), F.w);
        d.up[i] = xup_force_T(s.Rcp[i], v3(p.joint_pos[i]), F);
      }
    }
    g.sync();
  }
  if (g.active && g.lane == 0) {
    V6 F = d.f[0];
#pragma unroll 1
    for (int q = p.child_start[0]; q < p.child_start[1]; ++q) F = add(F, d.up[p.child_list[q]]);
    s.rhs[0] = F.w.x; s.rhs[1] = F.w.y; s.rhs[2] = F.w.z;
    s.rhs[3] = F.l.x; s.rhs[4] = F.l.y; s.rhs[5] = F.l.z;
  }
  g.sync();

  // ---- right-hand side per dof: damping, then the base's sign and push,
  // or the joint's PD (P term), limits and springs ----
  if (g.active) {
    const float gain = s.lane.gain_scale * p.kp;
#pragma unroll 1
    for (int k = g.lane; k < CS_NV; k += g.size) {
      float r = s.rhs[k];
      if (p.damping[k] != 0.0f) r = r + (p.damping[k] * s.lane.damping_scale) * s.qvel[k];
      if (k < 6) {
        r = -r;
        if (p.idx_push >= 0 && k >= 3) {
          const V3 f_b = m3T_vec(s.E[0], s.lane.push);
          r = r + (k == 3 ? f_b.x : (k == 4 ? f_b.y : f_b.z));
        }
      } else {
        const int j = k - 6;
        r = gain * (s.target[j] - jq[j]) - r;
        if (p.has_limits) {
          const float lo = p.lower[j], hi = p.upper[j];
          if (isfinite(lo) || isfinite(hi)) {
            const float below = isfinite(lo) ? fmaxf(lo - jq[j], 0.0f) : 0.0f;
            const float above = isfinite(hi) ? fmaxf(jq[j] - hi, 0.0f) : 0.0f;
            const float violating = (below + above) > 0.0f ? 1.0f : 0.0f;
            r = r + (p.limit_stiffness * (below - above) - p.limit_damping * violating * jd[j]);
          }
        }
        if (p.has_springs && p.spring_k[j] > 0.0f)
          r = r - p.spring_k[j] * (jq[j] - p.spring_ref[j]);
      }
      s.rhs[k] = r;
    }
  }
  g.sync();

  // ---- L y = rhs by columns: row i's running sum in a register of lane
  // i % CS_G; each y_k, once divided out by its row's lane, goes to every
  // lane by a shuffle. The loops run over compile-time bounds. ----
  const float* L = s.L;
  {
    constexpr int kRows = (CS_NV + CS_G - 1) / CS_G;  // rows per lane, at most
    float acc[kRows];
#pragma unroll
    for (int q = 0; q < kRows; ++q) {
      const int i = g.lane + q * CS_G;
      acc[q] = (g.active && i < CS_NV) ? s.rhs[i] : 0.0f;
    }
#pragma unroll
    for (int k = 0; k < CS_NV; ++k) {
      float y = 0.0f;
      if (g.lane == k % CS_G) {
        y = acc[k / CS_G] / L[k * (k + 1) / 2 + k];
        acc[k / CS_G] = y;
      }
      y = g.broadcast(y, k % CS_G);
#pragma unroll
      for (int q = 0; q < kRows; ++q) {
        const int i = g.lane + q * CS_G;
        if (i > k && i < CS_NV) acc[q] = acc[q] - L[i * (i + 1) / 2 + k] * y;
      }
    }
    if (g.active) {
#pragma unroll
      for (int q = 0; q < kRows; ++q) {
        const int i = g.lane + q * CS_G;
        if (i < CS_NV) s.rhs[i] = acc[q];
      }
    }
  }
  g.sync();
  // ---- L^T qacc = y on one lane: its sums run in ascending k ----
  if (g.active && g.lane == 0) {
    float* rhs = s.rhs;
#pragma unroll
    for (int i = CS_NV - 1; i >= 0; --i) {
      float acc = rhs[i];
#pragma unroll
      for (int k = i + 1; k < CS_NV; ++k) acc = acc - L[k * (k + 1) / 2 + i] * rhs[k];
      rhs[i] = acc / L[i * (i + 1) / 2 + i];
    }
  }
  g.sync();

  // ---- semi-implicit Euler ----
  const float dt = p.dt;
  if (g.active) {
#pragma unroll 1
    for (int k = g.lane; k < CS_NV; k += g.size) {
      s.qvel[k] = s.qvel[k] + dt * s.rhs[k];
      if (k >= 6) s.qpos[k + 1] = s.qpos[k + 1] + dt * s.qvel[k];
    }
  }
  g.sync();
  if (g.active && g.lane == 0) {
    const V3 w_new = v3(s.qvel), v_new = v3(s.qvel + 3);
    const V3 pos_new = add(pos, scale(dt, m3_vec(s.E[0], v_new)));
    s.qpos[0] = pos_new.x; s.qpos[1] = pos_new.y; s.qpos[2] = pos_new.z;
    quat_integrate(s.qpos + 3, w_new, dt);
  }
  g.sync();
}

// The group's env in the block's shared memory, after the model copy.
__device__ Env& env_in_shared(float* envs) {
  return *reinterpret_cast<Env*>(envs + static_cast<int>(threadIdx.x / CS_G) * kEnvWords);
}

// Identity lanes (no domain randomization, no push, no planes), then the
// env's own from `extra` where the struct names a column; on lane 0.
__device__ void load_lanes(const Params& p, const float* extra, int env, Lanes& lane) {
  lane.mass_scale = 1.0f;
  lane.friction = p.friction;
  lane.damping_scale = 1.0f;
  lane.gain_scale = 1.0f;
  lane.push = v3(0.0f, 0.0f, 0.0f);
  for (int k = 0; k < 3 * CS_NG; ++k) lane.planes[k] = 0.0f;
  if (extra == nullptr) return;
  const float* e = extra + static_cast<size_t>(env) * p.n_extra;
  if (p.idx_mass_scale >= 0) lane.mass_scale = e[p.idx_mass_scale];
  if (p.idx_friction >= 0) lane.friction = e[p.idx_friction];
  if (p.idx_damping_scale >= 0) lane.damping_scale = e[p.idx_damping_scale];
  if (p.idx_gain_scale >= 0) lane.gain_scale = e[p.idx_gain_scale];
  if (p.idx_push >= 0) lane.push = v3(e + p.idx_push);
  if (p.idx_planes >= 0)
    for (int k = 0; k < 3 * CS_NG; ++k) lane.planes[k] = e[p.idx_planes + k];
}

// The control step: either the factor is built here (control_step_kernel:
// `extra` holds the per-env lanes, `chol_in` is null) or it comes in packed
// (substeps_kernel: `chol_in` [B, NT], identity lanes).
__device__ void control_step_body(const float* __restrict__ qpos_in,
                                  const float* __restrict__ qvel_in,
                                  const float* __restrict__ target_in,
                                  const float* __restrict__ extra,
                                  const float* __restrict__ chol_in,
                                  float* __restrict__ qpos_out, float* __restrict__ qvel_out,
                                  float* __restrict__ normals_out, int B, const Params& p_arg) {
  extern __shared__ float4 cs_smem[];
  float* envs = copy_model_to_shared(p_arg, reinterpret_cast<float*>(cs_smem));
  const Params& p = *reinterpret_cast<const Params*>(cs_smem);
  int env;
  const LaneGroup g = lane_group(CS_G, B, &env);
  Env& s = env_in_shared(envs);

  if (g.active) {
    load_row(s.qpos, qpos_in, env, CS_NQ, g);
    load_row(s.qvel, qvel_in, env, CS_NV, g);
    load_row(s.target, target_in, env, CS_NJ, g);
    if (chol_in != nullptr) load_row(s.L, chol_in, env, CS_NT, g);
    for (int k = g.lane; k < CS_NN; k += g.size) s.normals[k] = 0.0f;
    if (g.lane == 0) load_lanes(p, extra, env, s.lane);
  }
  g.sync();

#pragma unroll 1
  for (int step = 0; step < p.n_substeps; ++step) {
    kinematics(p, s.qpos, s.E, s.P, s.Rcp, g);
    if (chol_in == nullptr && (step == 0 || p.exact)) crba_chol(p, s, g);
    substep(p, s, g);
  }

  if (g.active) {
    store_row(qpos_out, s.qpos, env, CS_NQ, g);
    store_row(qvel_out, s.qvel, env, CS_NV, g);
    store_row(normals_out, s.normals, env, CS_NN, g);
  }
}

__global__ void control_step_kernel(const float* __restrict__ qpos_in,
                                    const float* __restrict__ qvel_in,
                                    const float* __restrict__ target_in,
                                    const float* __restrict__ extra,
                                    float* __restrict__ qpos_out,
                                    float* __restrict__ qvel_out,
                                    float* __restrict__ normals_out, int B,
                                    const __grid_constant__ Params p) {
  control_step_body(qpos_in, qvel_in, target_in, p.n_extra > 0 ? extra : nullptr, nullptr,
                    qpos_out, qvel_out, normals_out, B, p);
}

__global__ void substeps_kernel(const float* __restrict__ qpos_in,
                                const float* __restrict__ qvel_in,
                                const float* __restrict__ target_in,
                                const float* __restrict__ chol_in,
                                float* __restrict__ qpos_out,
                                float* __restrict__ qvel_out,
                                float* __restrict__ normals_out, int B,
                                const __grid_constant__ Params p) {
  control_step_body(qpos_in, qvel_in, target_in, nullptr, chol_in, qpos_out, qvel_out,
                    normals_out, B, p);
}

template <class Kernel>
int launch(Kernel kernel, const float* qpos, const float* qvel, const float* target,
           const float* fourth, float* qpos_out, float* qvel_out, float* normals_out, int B,
           const Params* params, int threads, int device, void* stream) {
  if (threads <= 0 || threads % 32 != 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const long long smem = block_smem_bytes(threads);
  if (smem > 48 * 1024) {
    const cudaError_t attr = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (attr != cudaSuccess) return static_cast<int>(attr);
  }
  const long long lanes = static_cast<long long>(B) * CS_G;
  const int blocks = static_cast<int>((lanes + threads - 1) / threads);
  kernel<<<blocks, threads, static_cast<size_t>(smem), static_cast<cudaStream_t>(stream)>>>(
      qpos, qvel, target, fourth, qpos_out, qvel_out, normals_out, B, *params);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Size of the model struct and the sizes this library was built for, so
// that the caller can check its packing: out = {NB, NG, NP, NW, G}.
extern "C" int control_step_params_size(int* out) {
  out[0] = CS_NB;
  out[1] = CS_NG;
  out[2] = CS_NP;
  out[3] = CS_NW;
  out[4] = CS_G;
  return static_cast<int>(sizeof(Params));
}

// Dynamic shared memory of one block of `threads` threads, in bytes.
extern "C" long long control_step_smem_bytes(int threads) { return block_smem_bytes(threads); }

// Launches on `stream` of CUDA device `device` and returns the launch's
// cudaError_t (0 on success), or that of setting the kernel's shared-memory
// limit. `params` points to a host copy of the struct; `extra` may be null
// when params->n_extra is 0. `threads` (per block) is a multiple of 32;
// each env takes CS_G of them.
extern "C" int control_step_forward(const float* qpos, const float* qvel,
                                    const float* target, const float* extra,
                                    float* qpos_out, float* qvel_out,
                                    float* normals_out, int B,
                                    const Params* params, int threads,
                                    int device, void* stream) {
  return launch(control_step_kernel, qpos, qvel, target, extra, qpos_out, qvel_out,
                normals_out, B, params, threads, device, stream);
}

// The same for substeps_kernel; `chol` is the packed factor [B, NT].
extern "C" int substeps_forward(const float* qpos, const float* qvel,
                                const float* target, const float* chol,
                                float* qpos_out, float* qvel_out,
                                float* normals_out, int B, const Params* params,
                                int threads, int device, void* stream) {
  return launch(substeps_kernel, qpos, qvel, target, chol, qpos_out, qvel_out, normals_out,
                B, params, threads, device, stream);
}
