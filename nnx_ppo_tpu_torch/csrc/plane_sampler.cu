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
// lookups, about 1e3 per env) take less, so bytes bound it. The table
// (256 KB at 256 x 256) stays in L2. One thread per env; it shares
// control_step.cu's struct and its kinematics, which it runs as a group of
// one lane.

#include "rigid_body.cuh"

namespace {

__global__ void plane_sampler_kernel(const float* __restrict__ qpos_in,
                                     const float* __restrict__ table,
                                     float* __restrict__ planes_out, int B,
                                     int nx, int ny, float x0, float y0,
                                     float inv_dx, float inv_dy,
                                     const __grid_constant__ Params p) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= B) return;

  float qpos[CS_NQ];
  for (int k = 0; k < CS_NQ; ++k) qpos[k] = qpos_in[static_cast<size_t>(b) * CS_NQ + k];
  M3 E[CS_NB], Rcp[CS_NB];
  V3 P[CS_NB];
  // The control step's kinematics, run by a group of one lane.
  const LaneGroup solo{0, 1, 1u << (threadIdx.x & 31u), true};
  kinematics(p, qpos, E, P, Rcp, solo);

  float* out = planes_out + static_cast<size_t>(b) * (3 * CS_NG);
#pragma unroll 1
  for (int g = 0; g < CS_NG; ++g) {
    const int body = p.geom_body[g];
    const V3 x_w = add(P[body], m3_vec(E[body], v3(p.geom_offset[g])));
    const float u = (x_w.x - x0) * inv_dx;
    const float v = (x_w.y - y0) * inv_dy;
    const float fi = fminf(fmaxf(floorf(u), 0.0f), static_cast<float>(nx - 2));
    const float fj = fminf(fmaxf(floorf(v), 0.0f), static_cast<float>(ny - 2));
    const float fx = fminf(fmaxf(u - fi, 0.0f), 1.0f);
    const float fy = fminf(fmaxf(v - fj, 0.0f), 1.0f);
    const int i = static_cast<int>(fi), j = static_cast<int>(fj);
    const float h00 = table[static_cast<size_t>(i) * ny + j];
    const float h10 = table[static_cast<size_t>(i + 1) * ny + j];
    const float h01 = table[static_cast<size_t>(i) * ny + j + 1];
    const float h11 = table[static_cast<size_t>(i + 1) * ny + j + 1];
    const float wx = 1.0f - fx, wy = 1.0f - fy;
    const float r0 = wx * h00 + fx * h10;
    const float r1 = wx * h01 + fx * h11;
    const float h = wy * r0 + fy * r1;
    const float in_x = (u >= 0.0f && u <= static_cast<float>(nx - 1)) ? 1.0f : 0.0f;
    const float in_y = (v >= 0.0f && v <= static_cast<float>(ny - 1)) ? 1.0f : 0.0f;
    const float gx = ((wy * (h10 - h00) + fy * (h11 - h01)) * inv_dx) * in_x;
    const float gy = ((r1 - r0) * inv_dy) * in_y;
    out[3 * g] = h - gx * x_w.x - gy * x_w.y;
    out[3 * g + 1] = gx;
    out[3 * g + 2] = gy;
  }
}

}  // namespace

// Size of the model struct and the sizes this library was built for, so
// that the caller can check its packing: out = {NB, NG, NP, NW, G}; G is
// the control step's group size, which this kernel does not use.
extern "C" int plane_sampler_params_size(int* out) {
  out[0] = CS_NB;
  out[1] = CS_NG;
  out[2] = CS_NP;
  out[3] = CS_NW;
  out[4] = CS_G;
  return static_cast<int>(sizeof(Params));
}

// Launches on `stream` of CUDA device `device` and returns the launch's
// cudaError_t (0 on success). `params` points to a host copy of the
// struct; `table` is the row-major [nx, ny] height table on the device.
extern "C" int plane_sampler_forward(const float* qpos, const float* table,
                                     float* planes_out, int B, int nx, int ny,
                                     float x0, float y0, float inv_dx,
                                     float inv_dy, const Params* params,
                                     int threads, int device, void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const int blocks = (B + threads - 1) / threads;
  plane_sampler_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      qpos, table, planes_out, B, nx, ny, x0, y0, inv_dx, inv_dy, *params);
  return static_cast<int>(cudaGetLastError());
}
