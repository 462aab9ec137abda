// The step form of a Mamba-2 mixer's state update (the selective
// state-space layer of Dao & Gu, arXiv:2405.21060), for every env and head
// in one launch on Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package has no state-space layer. It was
// added for the hybrid trunk (networks/hybrid.py), whose rollout runs this
// update once per Mamba layer and control step. Per env e and head h, with
// the head's state s[P, N] (head_dim P, d_state N):
//   dA      = exp(dt[e, h] * A[h])
//   s'[p,n] = dA * s[p,n] + (dt[e, h] * x[e, h, p]) * B[e, n]
//   y[p]    = sum_n s'[p,n] * C[e, n] + D[h] * x[e, h, p]
// In eager PyTorch the same update is about five passes over the state
// (2 MB an env and layer at the published sizes); here the state is read
// once and the new one written once.
//
// Bound: the bytes. Per launch the state is read and written (8 P N bytes
// per env and head) beside x, dt, B, C and y, a few KB an env; at 64 envs,
// 64 heads of 64 and d_state 128 that is 268 MB, about 80 us at 3.35 TB/s,
// against some 5 operations per state element.
//
// Design: one block per (head, env), one thread per state column n
// (d_state threads, a multiple of 32), so that each of the P rows of the
// head's state is one coalesced 4-byte-per-thread load and store. The
// output y[p] is a sum over the block's threads: each warp folds its 32
// columns with a butterfly of shuffles and leaves one partial per row in
// shared memory; after one barrier the first threads add the warps'
// partials and D x. Each product and sum of the new state is rounded on
// its own (__fmul_rn / __fadd_rn, no fused multiply-add) in the order of
// the plain PyTorch version (ops/ssm_step.py::ssm_step_plain), so the two
// agree to the bit there; y sums in another order than torch.sum.

namespace {

__global__ void ssm_step_kernel(const float* __restrict__ state, const float* __restrict__ x,
                                const float* __restrict__ dt, const float* __restrict__ A,
                                const float* __restrict__ B, const float* __restrict__ C,
                                const float* __restrict__ D, float* __restrict__ new_state,
                                float* __restrict__ y, int heads, int head_dim, int d_state) {
  extern __shared__ float partial[];  // [warps][head_dim]
  const int h = blockIdx.x;
  const long long e = blockIdx.y;
  const int n = threadIdx.x;
  const int lane = n & 31, warp = n >> 5, warps = blockDim.x >> 5;
  const long long eh = e * heads + h;
  const float dt_h = dt[eh];
  const float dA = expf(__fmul_rn(dt_h, A[h]));
  const float b = B[e * d_state + n];
  const float c = C[e * d_state + n];
  const float* xs = x + eh * head_dim;
  const float* s_in = state + eh * head_dim * d_state;
  float* s_out = new_state + eh * head_dim * d_state;
  for (int p = 0; p < head_dim; ++p) {
    const float xp = xs[p];
    const float s = __fadd_rn(__fmul_rn(dA, s_in[p * d_state + n]),
                              __fmul_rn(__fmul_rn(dt_h, xp), b));
    s_out[p * d_state + n] = s;
    float v = __fmul_rn(s, c);
    for (int o = 16; o > 0; o >>= 1) v = __fadd_rn(v, __shfl_sync(0xffffffffu, v, lane ^ o));
    if (lane == 0) partial[warp * head_dim + p] = v;
  }
  __syncthreads();
  for (int p = n; p < head_dim; p += blockDim.x) {
    float sum = partial[p];
    for (int w = 1; w < warps; ++w) sum = __fadd_rn(sum, partial[w * head_dim + p]);
    y[eh * head_dim + p] = __fadd_rn(sum, __fmul_rn(D[h], xs[p]));
  }
}

}  // namespace

// One launch on `stream` of CUDA device `device` for `n_env` envs; returns
// the launch's cudaError_t (0 on success). Every array is contiguous
// float32: state and new_state [n_env, heads, head_dim, d_state], x and y
// [n_env, heads, head_dim], dt [n_env, heads], A and D [heads], B and C
// [n_env, d_state]. new_state must not overlap state. d_state is a multiple
// of 32 up to 1024 (the block's threads).
extern "C" int ssm_step_forward(const float* state, const float* x, const float* dt,
                                const float* A, const float* B, const float* C, const float* D,
                                float* new_state, float* y, int n_env, int heads, int head_dim,
                                int d_state, int device, void* stream) {
  if (n_env < 1 || n_env > 65535 || heads < 1 || head_dim < 1 || d_state < 32 ||
      d_state > 1024 || d_state % 32 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaSetDevice(device);
  const size_t smem = static_cast<size_t>(d_state / 32) * head_dim * sizeof(float);
  if (smem > 48 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  ssm_step_kernel<<<dim3(heads, n_env), d_state, smem, static_cast<cudaStream_t>(stream)>>>(
      state, x, dt, A, B, C, D, new_state, y, heads, head_dim, d_state);
  return static_cast<int>(cudaGetLastError());
}
