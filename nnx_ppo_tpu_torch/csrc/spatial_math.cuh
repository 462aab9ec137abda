// Shared device arithmetic of the rigid-body kernels (control_step.cu,
// plane_sampler.cu, scene_step.cu): 3-vectors, 3x3 matrices, spatial
// 6-vectors, the quaternion exponential map, the analytic-wave terrain,
// the penalty normal force, and the group of lanes that shares one env. It
// repeats nnx_ppo_tpu_torch/physics/soa.py and the terrain lanes of
// engine_soa.py operation by operation. The model
// structs live with their kernels (rigid_body.cuh, scene_step.cu). This
// file's text joins the hash that names each library (ops/cuda_build.py).

#pragma once

#include <cuda_runtime.h>
#include <math.h>

namespace {

struct V3 { float x, y, z; };
struct M3 { float m[9]; };
struct V6 { V3 w, l; };  // angular, linear

#define CS_FN __device__ __forceinline__

// The lanes that share one env: `lane` in [0, size), and a barrier over
// `mask`, the lanes that run the same sequence of barriers. `active` is
// false for the lanes of an env past the batch: they reach every barrier
// and do no work, so no lane returns before a barrier that others wait at.
struct LaneGroup {
  int lane, size;
  unsigned mask;
  bool active;
  CS_FN void sync() const { __syncwarp(mask); }
  // `value` of the group's lane `src`, to every lane of the group.
  CS_FN float broadcast(float value, int src) const { return __shfl_sync(mask, value, src, size); }
};

// Lane group of `size` lanes (a divisor of 32) for thread threadIdx.x of a
// block whose size is a multiple of 32; its env is returned in `env`. Every
// lane of a warp runs the same barriers, so a barrier spans the whole warp
// and the warp's envs reconverge at it.
CS_FN LaneGroup lane_group(int size, int n_envs, int* env) {
  const long long t = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  *env = static_cast<int>(t / size);
  LaneGroup g;
  g.lane = static_cast<int>(threadIdx.x) % size;
  g.size = size;
  g.mask = 0xffffffffu;
  g.active = *env < n_envs;
  return g;
}

// Row `env` of a [B, n] array into (or out of) an env's shared array,
// across the group's lanes.
CS_FN void load_row(float* dst, const float* __restrict__ src, int env, int n,
                    const LaneGroup& g) {
  for (int k = g.lane; k < n; k += g.size) dst[k] = src[static_cast<size_t>(env) * n + k];
}
CS_FN void store_row(float* __restrict__ dst, const float* src, int env, int n,
                     const LaneGroup& g) {
  for (int k = g.lane; k < n; k += g.size) dst[static_cast<size_t>(env) * n + k] = src[k];
}

// Words of shared memory that a model struct's copy takes, rounded up to a
// multiple of 4 (16 bytes), so that what follows it stays aligned.
template <class Model>
__host__ __device__ constexpr int model_words() {
  return static_cast<int>((sizeof(Model) / 4 + 3) / 4 * 4);
}

// The block's copy of a model struct in shared memory: every thread copies
// a share of its 4-byte words, then the whole block waits. Returns the
// first float after the copy, rounded up to 16 bytes.
template <class Model>
__device__ float* copy_model_to_shared(const Model& src, float* smem) {
  static_assert(sizeof(Model) % 4 == 0, "the model struct is made of 4-byte members");
  const int* from = reinterpret_cast<const int*>(&src);
  int* to = reinterpret_cast<int*>(smem);
  for (int k = static_cast<int>(threadIdx.x); k < static_cast<int>(sizeof(Model) / 4);
       k += static_cast<int>(blockDim.x))
    to[k] = from[k];
  __syncthreads();
  return smem + model_words<Model>();
}

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

// q <- normalize(q (x) exp(w dt / 2)), q = (w, x, y, z) in place
// (soa.quat_integrate; sinc(x) as sin(pi x) / (pi x)).
CS_FN void quat_integrate(float* q, V3 w, float dt) {
  const float angle = sqrtf(dot(w, w) + 0.0f) * dt;
  const float half = 0.5f * angle;
  const float x = half / 3.14159265358979323846f;
  const float px = 3.14159265358979323846f * x;
  const float sinc = (x == 0.0f) ? 1.0f : sinf(px) / px;
  const float k = (0.5f * dt) * sinc;
  const float aw = q[0], ax = q[1], ay = q[2], az = q[3];
  const float bw = cosf(half), bx = k * w.x, by = k * w.y, bz = k * w.z;
  const float ow = aw * bw - ax * bx - ay * by - az * bz;
  const float ox = aw * bx + ax * bw + ay * bz - az * by;
  const float oy = aw * by - ax * bz + ay * bw + az * bx;
  const float oz = aw * bz + ax * by - ay * bx + az * bw;
  const float norm = sqrtf(ow * ow + ox * ox + oy * oy + oz * oz);
  q[0] = ow / norm; q[1] = ox / norm; q[2] = oy / norm; q[3] = oz / norm;
}

// Analytic terrain: a plane plus a sum of sine waves. `Waves` is any model
// struct with the members slope, wave_amp, wave_freq, wave_amp_freq,
// wave_dx, wave_dy, wave_phase and the constant kWaves.
template <class Waves>
CS_FN float terrain_height(const Waves& p, float x, float y) {
  float h = p.slope[0] * x + p.slope[1] * y;
  for (int k = 0; k < Waves::kWaves; ++k)
    h = h + p.wave_amp[k] *
                sinf(p.wave_freq[k] * (p.wave_dx[k] * x + p.wave_dy[k] * y) + p.wave_phase[k]);
  return h;
}

template <class Waves>
CS_FN V3 terrain_normal(const Waves& p, float x, float y) {
  float gx = 0.0f + p.slope[0];
  float gy = 0.0f + p.slope[1];
  for (int k = 0; k < Waves::kWaves; ++k) {
    const float c = p.wave_amp_freq[k] *
                    cosf(p.wave_freq[k] * (p.wave_dx[k] * x + p.wave_dy[k] * y) + p.wave_phase[k]);
    gx = gx + p.wave_dx[k] * c;
    gy = gy + p.wave_dy[k] * c;
  }
  const float inv = 1.0f / sqrtf(gx * gx + gy * gy + 1.0f);
  return v3(-gx * inv, -gy * inv, inv);
}

// Normal force of a penalty contact: spring-damper, active while
// penetrating, never pulling, capped unless the cap is +inf.
CS_FN float normal_force(float stiffness, float damping, float max_force, float phi,
                         float rate) {
  float fn = phi > 0.0f ? fmaxf(stiffness * phi - damping * rate, 0.0f) : 0.0f;
  if (isfinite(max_force)) fn = fminf(fn, max_force);
  return fn;
}

}  // namespace
