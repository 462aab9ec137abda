// Reverse-time Generalized Advantage Estimation on Hopper (sm_90a), for
// every reward key of a minibatch in one launch.
//
// Replaces nnx_ppo_tpu/ops/gae.py::gae_pallas (the Pallas TPU kernel
// _gae_kernel), with the same semantics:
//   * the bootstrap value is zeroed where done,
//   * the one-step TD error is zeroed where truncated,
//   * the accumulated tail passes through (1 - done) * gamma * lambda.
// The result is stop-gradient by construction (no backward exists).
//
// Bound: per key the kernel must move rewards, values and the output as
// float32 [T, B], done and truncated at [T, B] in their own dtype (1 byte
// for bool, 4 for float32), and last_value [B]: (3 * 4 + 2 * 4) T B + 4 B
// bytes with float flags, about 155 KB at [T=30, B=256], under 0.05 us at
// 3.35 TB/s, and some 8 flops per element. Its time is latency: T
// dependent steps per column.
//
// Design for Hopper:
//   * One launch for up to kMaxKeys reward keys: a __grid_constant__
//     struct holds each key's pointers and row strides, and blockIdx.y is
//     the key. `done` and `truncation` are read in the dtype they come in
//     (bool as bytes, or float32; a template over the two), so the caller
//     casts nothing.
//   * Narrow blocks of `columns` threads (a multiple of 16; 32 by
//     default), one column each, so that [30, 256] spreads over 8 SMs and
//     [20, 512] x 2 keys over 32.
//   * Each block first stages its [rows, columns] tiles of rewards,
//     values, done and truncation, and the last_value row, in shared
//     memory: all copies started at once with cp.async (async_copy.cuh; 16
//     bytes each where the rows are 16-byte aligned, else 4-byte copies
//     for float32 and plain loads for bytes), then one wait and one
//     __syncthreads(). Only then does each thread run its column's reverse
//     recurrence out of shared memory, so no global load sits on the serial
//     chain. Stores go out row by row, neighbouring threads on neighbouring
//     columns. (Unrolling the recurrence by 8, or loading 8 rows into
//     registers before their arithmetic, measured no faster on the H100;
//     see PERF.md.)
//   * Rows are tiled from the end when T rows of a block's tiles would not
//     fit its shared memory (48 KB: 95 rows at 32 columns and float flags);
//     the carried advantage and value stay in registers between tiles.
// Each product and sum is rounded on its own (__fmul_rn / __fadd_rn /
// __fsub_rn, no fused multiply-add) in the order of the plain PyTorch
// version, so the two agree to the bit for every key.

#include "async_copy.cuh"

namespace {

constexpr int kMaxKeys = 8;
constexpr int kSmemBytes = 48 * 1024;  // no opt-in attribute needed

// One reward key: input and output pointers, and the row strides (in
// elements) of the [T, B] inputs; columns are contiguous.
struct GaeKey {
  const float* rewards;
  const float* values;
  const float* last_value;
  const void* done;
  const void* truncation;
  float* out;
  long long ld_rewards, ld_values, ld_done, ld_truncation;
};

struct GaeArgs {
  GaeKey key[kMaxKeys];
  int T, B, tile_rows;
  float gamma, lambda;
};

__device__ __forceinline__ int min_int(int a, int b) { return a < b ? a : b; }

// Start the copies of rows [t0, t0 + rows) x columns [b0, b0 + w) of
// `src` (row stride `ld`) into `dst` (row stride `columns`), across the
// block's threads: 16-byte copies when every row segment is 16-byte
// aligned and a multiple of 16 bytes long, else one element per copy.
template <class E>
__device__ void stage_tile(E* dst, const E* src, long long ld, int t0, int rows, int b0, int w,
                           int columns, int B) {
  const unsigned long long misaligned =
      reinterpret_cast<unsigned long long>(src) |
      static_cast<unsigned long long>(ld * static_cast<long long>(sizeof(E))) |
      static_cast<unsigned long long>(static_cast<long long>(B) * static_cast<long long>(sizeof(E)));
  const int chunk = misaligned % 16 == 0 ? 16 : static_cast<int>(sizeof(E));
  const int per_row = w * static_cast<int>(sizeof(E)) / chunk;
  for (int k = static_cast<int>(threadIdx.x); k < rows * per_row;
       k += static_cast<int>(blockDim.x)) {
    const int r = k / per_row, j = k - r * per_row;
    copy_async(reinterpret_cast<char*>(dst + static_cast<long long>(r) * columns) + j * chunk,
               reinterpret_cast<const char*>(src + (t0 + r) * ld + b0) + j * chunk, chunk);
  }
}

template <class Done, class Trunc>
__global__ void gae_kernel(const __grid_constant__ GaeArgs a) {
  extern __shared__ float4 gae_smem[];
  const GaeKey& key = a.key[blockIdx.y];
  const int columns = static_cast<int>(blockDim.x);
  const int b0 = static_cast<int>(blockIdx.x) * columns;
  const int w = min_int(columns, a.B - b0);
  const int c = static_cast<int>(threadIdx.x);
  const int R = a.tile_rows;
  // [R][columns] tiles, then the last_value row; every part starts on a
  // 16-byte boundary since columns is a multiple of 16.
  float* s_rewards = reinterpret_cast<float*>(gae_smem);
  float* s_values = s_rewards + R * columns;
  float* s_last = s_values + R * columns;
  Done* s_done = reinterpret_cast<Done*>(s_last + columns);
  Trunc* s_trunc = reinterpret_cast<Trunc*>(s_done + R * columns);
  const Done* done = static_cast<const Done*>(key.done);
  const Trunc* truncation = static_cast<const Trunc*>(key.truncation);

  float next_advantage = 0.0f;
  float next_value = 0.0f;
  for (int t_hi = a.T; t_hi > 0;) {
    const int t_lo = t_hi - min_int(R, t_hi);
    const int rows = t_hi - t_lo;
    stage_tile(s_rewards, key.rewards, key.ld_rewards, t_lo, rows, b0, w, columns, a.B);
    stage_tile(s_values, key.values, key.ld_values, t_lo, rows, b0, w, columns, a.B);
    stage_tile(s_done, done, key.ld_done, t_lo, rows, b0, w, columns, a.B);
    stage_tile(s_trunc, truncation, key.ld_truncation, t_lo, rows, b0, w, columns, a.B);
    if (t_hi == a.T) stage_tile(s_last, key.last_value, 0, 0, 1, b0, w, columns, a.B);
    copy_async_wait();
    __syncthreads();
    if (c < w) {
      if (t_hi == a.T) next_value = s_last[c];
      for (int r = rows - 1; r >= 0; --r) {
        const int i = r * columns + c;
        const float d = static_cast<float>(s_done[i]);
        const float old_value = s_values[i];
        const float bootstrap = d != 0.0f ? 0.0f : next_value;
        // (reward + gamma * bootstrap) - old_value
        float advantage =
            __fsub_rn(__fadd_rn(s_rewards[i], __fmul_rn(a.gamma, bootstrap)), old_value);
        if (static_cast<float>(s_trunc[i]) != 0.0f) advantage = 0.0f;
        // advantage + (((1 - done) * gamma) * lambda) * next_advantage
        const float gate = __fmul_rn(__fmul_rn(__fsub_rn(1.0f, d), a.gamma), a.lambda);
        next_advantage = __fadd_rn(advantage, __fmul_rn(gate, next_advantage));
        key.out[static_cast<long long>(t_lo + r) * a.B + b0 + c] = next_advantage;
        next_value = old_value;
      }
    }
    __syncthreads();  // the next tile overwrites these
    t_hi = t_lo;
  }
}

// Shared memory of one block at `rows` rows.
int block_smem_bytes(int rows, int columns, int done_bytes, int trunc_bytes) {
  return (rows * (8 + done_bytes + trunc_bytes) + 4) * columns;
}

template <class Done, class Trunc>
int launch(const GaeArgs& args, int n_keys, int columns, int device, void* stream) {
  const cudaError_t set = cudaSetDevice(device);
  if (set != cudaSuccess) return static_cast<int>(set);
  const int smem = block_smem_bytes(args.tile_rows, columns, static_cast<int>(sizeof(Done)),
                                    static_cast<int>(sizeof(Trunc)));
  const dim3 grid(static_cast<unsigned>((args.B + columns - 1) / columns),
                  static_cast<unsigned>(n_keys));
  const auto kernel = gae_kernel<Done, Trunc>;
  kernel<<<grid, columns, static_cast<size_t>(smem), static_cast<cudaStream_t>(stream)>>>(args);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// The most reward keys one launch takes.
extern "C" int gae_max_keys() { return kMaxKeys; }

// GAE of `n_keys` reward keys in one launch on `stream` of CUDA device
// `device`; returns the launch's cudaError_t (0 on success). `words`
// holds 10 entries per key: the addresses of rewards, values, last_value,
// done, truncation and out, then the row strides (in elements) of
// rewards, values, done and truncation. The flags are bool (1 byte) where
// `done_is_bool` / `truncation_is_bool` is set, else float32. `columns`
// (threads per block) is a multiple of 16 up to 1024; `tile_rows` bounds
// the rows staged at once (0: as many as fit 48 KB).
extern "C" int gae_forward(const long long* words, int n_keys, int T, int B, float gamma,
                           float lambda, int done_is_bool, int truncation_is_bool, int columns,
                           int tile_rows, int device, void* stream) {
  if (n_keys < 1 || n_keys > kMaxKeys || T < 1 || B < 1 || columns < 16 || columns > 1024 ||
      columns % 16 != 0 || tile_rows < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  GaeArgs args{};
  for (int k = 0; k < n_keys; ++k) {
    const long long* w = words + 10 * k;
    GaeKey& key = args.key[k];
    key.rewards = reinterpret_cast<const float*>(w[0]);
    key.values = reinterpret_cast<const float*>(w[1]);
    key.last_value = reinterpret_cast<const float*>(w[2]);
    key.done = reinterpret_cast<const void*>(w[3]);
    key.truncation = reinterpret_cast<const void*>(w[4]);
    key.out = reinterpret_cast<float*>(w[5]);
    key.ld_rewards = w[6];
    key.ld_values = w[7];
    key.ld_done = w[8];
    key.ld_truncation = w[9];
  }
  const int done_bytes = done_is_bool ? 1 : 4, trunc_bytes = truncation_is_bool ? 1 : 4;
  const int fit = (kSmemBytes / columns - 4) / (8 + done_bytes + trunc_bytes);
  int rows = tile_rows > 0 ? tile_rows : fit;
  if (rows > fit) rows = fit;
  if (rows > T) rows = T;
  if (rows < 1) return static_cast<int>(cudaErrorInvalidValue);
  args.T = T;
  args.B = B;
  args.tile_rows = rows;
  args.gamma = gamma;
  args.lambda = lambda;
  if (done_is_bool && truncation_is_bool)
    return launch<unsigned char, unsigned char>(args, n_keys, columns, device, stream);
  if (done_is_bool) return launch<unsigned char, float>(args, n_keys, columns, device, stream);
  if (truncation_is_bool) return launch<float, unsigned char>(args, n_keys, columns, device, stream);
  return launch<float, float>(args, n_keys, columns, device, stream);
}
