// Tangent planes of a height table under every ground geom, on Hopper
// (sm_90a).
//
// Replaces nnx_ppo_tpu/physics/pallas_step.py::pallas_plane_sampler (the
// Pallas TPU kernel whose body is _kin_soa + heightgrid_planes_soa of
// nnx_ppo_tpu/physics/engine_soa.py). Per env: the kinematics of qpos,
// then for each ground geom the world xy of its sphere centre, the cell of
// the [nx, ny] table it lies in, and the local plane h = c + gx x + gy y of
// the bilinear interpolant there, written as (c, gx, gy) into
// out[b][3 g .. 3 g + 2]. The control-step kernel takes these lanes as
// frozen terrain for one control step. Outside the grid the edge heights
// extend flat (zero gradient).
//
// The TPU kernel has no gather and reads the table through one-hot matrix
// products; here each geom loads its four corner heights directly. The
// plain PyTorch version is plane_sampler_plain
// (nnx_ppo_tpu_torch/physics/cuda_step.py, on HeightGrid.plane_xy of
// physics/terrain.py); this file repeats its arithmetic in the same order:
// cell coordinates by multiplication with the reciprocal spacings that the
// caller passes, interpolation along x first and then along y, every
// product and sum rounded on its own (built with -fmad=false).
//
// Bound: (nq + 3 n_geoms) * 4 bytes per env plus at most 16 bytes of table
// per geom: 300 bytes per env for the quadruped, 0.6 MB at B = 2048, some
// 0.2 us at 3.35 TB/s; the operations (kinematics of 12 hinges and 8
// lookups, about 1.6e3 per env) take less, so bytes bound it. The table
// (256 KB at 256 x 256) stays in L2.
//
// Design for Hopper, as control_step.cu's: a group of PS_G lanes per env
// (a -D size that divides 32; 8 by default, one lane per ground geom of
// the quadruped), blocks of several warps.
//   * The model struct lives in global memory (the caller uploads it once)
//     and the block's qpos rows are one contiguous run of it: both are
//     staged into shared memory by cp.async (async_copy.cuh), all copies
//     in flight at once, then one wait and one __syncthreads(). Lanes that
//     read different bodies' entries then read shared memory, not the
//     serialising parameter space. Each env's E, P and Rcp live in shared
//     memory too (no per-thread arrays, so no local-memory stack).
//   * The kinematics run level by level across the group's lanes
//     (rigid_body.cuh), each body's arithmetic the plain version's.
//   * Lane l takes geoms l, l + PS_G, ...; each starts its four corner
//     loads together.
//   * The block's [envs, 3 n_geoms] planes are staged in shared memory and
//     written out as one contiguous, coalesced run.
// The lanes of an env past B run every barrier and do no work.

#include "async_copy.cuh"
#include "rigid_body.cuh"

#ifndef PS_G
#define PS_G 8  // lanes per env
#endif

static_assert(PS_G >= 1 && PS_G <= 32 && 32 % PS_G == 0, "PS_G must divide 32");

namespace {

// One env's kinematics in shared memory (Rcp is the kinematics' third
// output, which the planes do not read).
struct SamplerEnv {
  M3 E[CS_NB], Rcp[CS_NB];
  V3 P[CS_NB];
};

// Words between two envs: odd, so that the envs of a warp that read the
// same member fall on different banks.
constexpr int kSamplerEnvWords = static_cast<int>(sizeof(SamplerEnv) / 4) | 1;
constexpr int kPlaneWords = 3 * CS_AT_LEAST_1(CS_NG);

// `n` words rounded up to a multiple of 4 (16 bytes).
__host__ __device__ constexpr int round_up_4(int n) { return (n + 3) / 4 * 4; }

// Dynamic shared memory of a block of `threads` threads: the model, the
// block's qpos rows, its planes and each env's kinematics.
constexpr long long block_smem_bytes(int threads) {
  return 4LL * (model_words<Params>() + round_up_4(threads / PS_G * CS_NQ) +
                round_up_4(threads / PS_G * kPlaneWords) +
                static_cast<long long>(threads / PS_G) * kSamplerEnvWords);
}

__global__ void plane_sampler_kernel(const float* __restrict__ qpos_in,
                                     const float* __restrict__ table,
                                     float* __restrict__ planes_out, int B,
                                     int nx, int ny, float x0, float y0,
                                     float inv_dx, float inv_dy,
                                     const Params* __restrict__ model) {
  extern __shared__ float4 ps_smem[];
  float* smem = reinterpret_cast<float*>(ps_smem);
  const Params& p = *reinterpret_cast<const Params*>(smem);
  const int per_block = static_cast<int>(blockDim.x) / PS_G;
  const long long first = static_cast<long long>(blockIdx.x) * per_block;
  const int n_here = static_cast<int>(B - first < per_block ? B - first : per_block);
  float* qpos_rows = smem + model_words<Params>();
  float* plane_rows = qpos_rows + round_up_4(per_block * CS_NQ);
  float* envs = plane_rows + round_up_4(per_block * kPlaneWords);

  // The model and the block's qpos rows, copied together.
  stage_async(smem, model, 4LL * model_words<Params>());
  stage_async(qpos_rows, qpos_in + first * CS_NQ, 4LL * n_here * CS_NQ);
  copy_async_wait();
  __syncthreads();

  int env;
  const LaneGroup g = lane_group(PS_G, B, &env);
  const int local = static_cast<int>(threadIdx.x) / PS_G;
  SamplerEnv& s = *reinterpret_cast<SamplerEnv*>(envs + local * kSamplerEnvWords);
  kinematics(p, qpos_rows + local * CS_NQ, s.E, s.P, s.Rcp, g);

  if (g.active) {
    float* out = plane_rows + local * kPlaneWords;
    for (int gi = g.lane; gi < CS_NG; gi += PS_G) {
      const int body = p.geom_body[gi];
      const V3 x_w = add(s.P[body], m3_vec(s.E[body], v3(p.geom_offset[gi])));
      const float u = (x_w.x - x0) * inv_dx;
      const float v = (x_w.y - y0) * inv_dy;
      const float fi = fminf(fmaxf(floorf(u), 0.0f), static_cast<float>(nx - 2));
      const float fj = fminf(fmaxf(floorf(v), 0.0f), static_cast<float>(ny - 2));
      const float fx = fminf(fmaxf(u - fi, 0.0f), 1.0f);
      const float fy = fminf(fmaxf(v - fj, 0.0f), 1.0f);
      const int i = static_cast<int>(fi), j = static_cast<int>(fj);
      const float* row = table + static_cast<size_t>(i) * ny + j;
      const float h00 = row[0];
      const float h01 = row[1];
      const float h10 = row[ny];
      const float h11 = row[ny + 1];
      const float wx = 1.0f - fx, wy = 1.0f - fy;
      const float r0 = wx * h00 + fx * h10;
      const float r1 = wx * h01 + fx * h11;
      const float h = wy * r0 + fy * r1;
      const float in_x = (u >= 0.0f && u <= static_cast<float>(nx - 1)) ? 1.0f : 0.0f;
      const float in_y = (v >= 0.0f && v <= static_cast<float>(ny - 1)) ? 1.0f : 0.0f;
      const float gx = ((wy * (h10 - h00) + fy * (h11 - h01)) * inv_dx) * in_x;
      const float gy = ((r1 - r0) * inv_dy) * in_y;
      out[3 * gi] = h - gx * x_w.x - gy * x_w.y;
      out[3 * gi + 1] = gx;
      out[3 * gi + 2] = gy;
    }
  }
  __syncthreads();

  // The block's planes, one contiguous run.
  for (int k = static_cast<int>(threadIdx.x); k < n_here * kPlaneWords;
       k += static_cast<int>(blockDim.x))
    planes_out[first * kPlaneWords + k] = plane_rows[k];
}

}  // namespace

// Size of the model struct and the sizes this library was built for, so
// that the caller can check its packing: out = {NB, NG, NP, NW, PS_G}.
extern "C" int plane_sampler_params_size(int* out) {
  out[0] = CS_NB;
  out[1] = CS_NG;
  out[2] = CS_NP;
  out[3] = CS_NW;
  out[4] = PS_G;
  return static_cast<int>(sizeof(Params));
}

// Dynamic shared memory of one block of `threads` threads, in bytes.
extern "C" long long plane_sampler_smem_bytes(int threads) { return block_smem_bytes(threads); }

// Launches on `stream` of CUDA device `device` and returns the launch's
// cudaError_t (0 on success), or that of setting the kernel's shared-memory
// limit. `params` points to the struct in device memory, padded with zeros
// to a multiple of 16 bytes; `table` is the row-major [nx, ny] height table
// on the device. `threads` (per block) is a multiple of 32; each env takes
// PS_G of them.
extern "C" int plane_sampler_forward(const float* qpos, const float* table,
                                     float* planes_out, int B, int nx, int ny,
                                     float x0, float y0, float inv_dx,
                                     float inv_dy, const Params* params,
                                     int threads, int device, void* stream) {
  if (threads <= 0 || threads > 1024 || threads % 32 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const long long smem = block_smem_bytes(threads);
  if (smem > 48 * 1024) {
    const cudaError_t attr = cudaFuncSetAttribute(
        plane_sampler_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
    if (attr != cudaSuccess) return static_cast<int>(attr);
  }
  const long long lanes = static_cast<long long>(B) * PS_G;
  const int blocks = static_cast<int>((lanes + threads - 1) / threads);
  plane_sampler_kernel<<<blocks, threads, static_cast<size_t>(smem),
                         static_cast<cudaStream_t>(stream)>>>(
      qpos, table, planes_out, B, nx, ny, x0, y0, inv_dx, inv_dy, params);
  return static_cast<int>(cudaGetLastError());
}
