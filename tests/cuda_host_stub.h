// A stand-in for the CUDA runtime under which g++ compiles the port's
// kernels (nnx_ppo_tpu_torch/csrc/*.cu) for the host, so that their lane
// groups can be run and held to the plain versions without a GPU
// (tests/test_torch_kernel_schedule.py). The test copies this file to
// cuda_runtime.h in a build directory and rewrites two constructs of the
// kernel source that C++ has no spelling for: a launch
// `kernel<<<blocks, threads, smem, stream>>>(args)` becomes
// `stub_launch(kernel, blocks, threads, smem, stream, args)`, and
// `extern __shared__ T name[];` becomes a pointer to the block's shared
// memory.
//
// It also defines CUDA_HOST_STUB, under which a kernel source leaves out
// its inline-PTX helpers (cp.async) for the plain definitions here.
//
// A launch runs its blocks one after another; each block runs its threads
// as std::threads over one shared-memory buffer, filled with NaN bytes so
// that a read before any write shows in the results. __syncthreads() is a
// barrier of the block's threads, __syncwarp(mask) one of the mask's
// lanes of the caller's warp, and __shfl_sync an exchange between two such
// barriers, so a lane that misses a barrier that others wait at hangs the
// run (the test runs it under a time limit).

#pragma once

#include <math.h>

#include <condition_variable>
#include <cstddef>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <map>
#include <memory>
#include <mutex>
#include <thread>
#include <vector>

#define __device__
#define __global__
#define __host__
#define __forceinline__ inline
#define __noinline__
#define __grid_constant__

#define CUDA_HOST_STUB 1

struct dim3 {
  constexpr dim3(unsigned x_ = 1, unsigned y_ = 1, unsigned z_ = 1) : x(x_), y(y_), z(z_) {}
  unsigned x, y, z;
};
struct alignas(16) float4 {
  float x, y, z, w;
};

inline thread_local dim3 threadIdx;
inline thread_local dim3 blockIdx;
inline dim3 blockDim;
inline dim3 gridDim;

typedef int cudaError_t;
typedef void* cudaStream_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };

inline cudaError_t stub_last_error = cudaSuccess;
inline cudaError_t cudaSetDevice(int) { return cudaSuccess; }
inline cudaError_t cudaGetLastError() {
  const cudaError_t err = stub_last_error;
  stub_last_error = cudaSuccess;
  return err;
}
// The H100's limit of dynamic shared memory per block.
constexpr int kStubMaxSharedBytes = 232448;
template <class Kernel>
cudaError_t cudaFuncSetAttribute(Kernel, cudaFuncAttribute, int bytes) {
  return bytes <= kStubMaxSharedBytes ? cudaSuccess : cudaErrorInvalidValue;
}

// A reusable barrier of `count` threads.
class StubBarrier {
 public:
  explicit StubBarrier(int count) : count_(count) {}
  void wait() {
    std::unique_lock<std::mutex> lock(mutex_);
    const long generation = generation_;
    if (++waiting_ == count_) {
      waiting_ = 0;
      ++generation_;
      cv_.notify_all();
      return;
    }
    cv_.wait(lock, [&] { return generation_ != generation; });
  }

 private:
  std::mutex mutex_;
  std::condition_variable cv_;
  const int count_;
  int waiting_ = 0;
  long generation_ = 0;
};

// The exchange slots of __shfl_sync, per warp and mask.
struct StubShuffle {
  float slots[32];
};

// The running block: its shared memory, its barriers and its exchanges.
struct StubBlock {
  std::vector<float4> shared;
  std::unique_ptr<StubBarrier> block_barrier;
  std::mutex warp_mutex;
  std::map<std::pair<unsigned, unsigned>, std::unique_ptr<StubBarrier>> warp_barriers;
  std::map<std::pair<unsigned, unsigned>, std::unique_ptr<StubShuffle>> shuffles;
};
inline StubBlock stub_block;

inline void* stub_shared_memory() { return stub_block.shared.data(); }

// Rounded float32 arithmetic (the test compiles with -ffp-contract=off).
inline float __fadd_rn(float a, float b) { return a + b; }
inline float __fsub_rn(float a, float b) { return a - b; }
inline float __fmul_rn(float a, float b) { return a * b; }

// cp.async and its wait: a plain copy, complete when it returns.
inline void copy_async(void* smem, const void* gmem, int bytes) { std::memcpy(smem, gmem, bytes); }
inline void copy_async_wait() {}

inline void __syncthreads() { stub_block.block_barrier->wait(); }

inline void __syncwarp(unsigned mask = 0xffffffffu) {
  const unsigned lane = threadIdx.x & 31u;
  if (!(mask >> lane & 1u)) {
    std::fprintf(stderr, "__syncwarp: lane %u is not in mask %08x\n", lane, mask);
    std::abort();
  }
  StubBarrier* barrier;
  {
    std::lock_guard<std::mutex> lock(stub_block.warp_mutex);
    auto& slot = stub_block.warp_barriers[{threadIdx.x / 32u, mask}];
    if (!slot) slot = std::make_unique<StubBarrier>(__builtin_popcount(mask));
    barrier = slot.get();
  }
  barrier->wait();
}

inline float __shfl_sync(unsigned mask, float value, int src, int width = 32) {
  const unsigned lane = threadIdx.x & 31u;
  StubShuffle* exchange;
  {
    std::lock_guard<std::mutex> lock(stub_block.warp_mutex);
    auto& slot = stub_block.shuffles[{threadIdx.x / 32u, mask}];
    if (!slot) slot = std::make_unique<StubShuffle>();
    exchange = slot.get();
  }
  exchange->slots[lane] = value;
  __syncwarp(mask);  // every lane has written
  const float out = exchange->slots[(lane & ~static_cast<unsigned>(width - 1)) + src];
  __syncwarp(mask);  // every lane has read
  return out;
}

template <class Kernel, class... Args>
void stub_launch(Kernel kernel, dim3 grid, int threads, size_t shared_bytes, cudaStream_t,
                 Args... args) {
  if (grid.x == 0 || grid.y == 0 || grid.z != 1 || threads <= 0 || threads > 1024 ||
      shared_bytes > static_cast<size_t>(kStubMaxSharedBytes)) {
    stub_last_error = cudaErrorInvalidValue;
    return;
  }
  blockDim.x = static_cast<unsigned>(threads);
  gridDim = grid;
  for (unsigned by = 0; by < grid.y; ++by)
  for (unsigned b = 0; b < grid.x; ++b) {
    stub_block.shared.assign(shared_bytes / sizeof(float4) + 1, float4{});
    std::memset(stub_block.shared.data(), 0xff, stub_block.shared.size() * sizeof(float4));
    stub_block.block_barrier = std::make_unique<StubBarrier>(threads);
    stub_block.warp_barriers.clear();
    stub_block.shuffles.clear();
    std::vector<std::thread> pool;
    pool.reserve(threads);
    for (int t = 0; t < threads; ++t)
      pool.emplace_back([=] {
        blockIdx.x = b;
        blockIdx.y = by;
        threadIdx.x = static_cast<unsigned>(t);
        kernel(args...);
      });
    for (auto& thread : pool) thread.join();
  }
}
template <class Kernel, class... Args>
void stub_launch(Kernel kernel, int blocks, int threads, size_t shared_bytes, cudaStream_t stream,
                 Args... args) {
  if (blocks <= 0) {
    stub_last_error = cudaErrorInvalidValue;
    return;
  }
  stub_launch(kernel, dim3(static_cast<unsigned>(blocks)), threads, shared_bytes, stream, args...);
}

// File helpers of the test's host program.
inline std::vector<char> stub_read(const char* path) {
  std::vector<char> data;
  FILE* f = std::fopen(path, "rb");
  if (f == nullptr) return data;
  std::fseek(f, 0, SEEK_END);
  data.resize(static_cast<size_t>(std::ftell(f)));
  std::fseek(f, 0, SEEK_SET);
  if (!data.empty() && std::fread(data.data(), 1, data.size(), f) != data.size()) std::abort();
  std::fclose(f);
  return data;
}
inline void stub_write(const char* path, const void* data, size_t bytes) {
  FILE* f = std::fopen(path, "wb");
  if (f == nullptr || std::fwrite(data, 1, bytes, f) != bytes) std::abort();
  std::fclose(f);
}
