// Asynchronous copies from global to shared memory (cp.async, sm_80 and
// later), for the kernels that stage their inputs before computing
// (gae.cu, plane_sampler.cu). A thread starts its copies, then
// copy_async_wait() completes them; a __syncthreads() after that makes
// every thread's copies visible to the block. Under CUDA_HOST_STUB (the
// host rehearsal of tests/cuda_host_stub.h) the stub defines copy_async
// and copy_async_wait as a plain copy. This file's text joins the hash
// that names each library (ops/cuda_build.py).

#pragma once

#include <cuda_runtime.h>

namespace {

#ifndef CUDA_HOST_STUB
// Copy `bytes` (16, 4 or 1) from global to shared memory: 16 and 4 bytes
// as an asynchronous copy, 1 byte as a plain load.
__device__ __forceinline__ void copy_async(void* smem, const void* gmem, int bytes) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  if (bytes == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst), "l"(gmem) : "memory");
  } else if (bytes == 4) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst), "l"(gmem) : "memory");
  } else {
    *static_cast<unsigned char*>(smem) = *static_cast<const unsigned char*>(gmem);
  }
}

// Commit the thread's copies as one group and wait for all of them.
__device__ __forceinline__ void copy_async_wait() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}
#endif

// Start the copies of `bytes` (a multiple of 4) from global `src` to
// shared `dst` across the block's threads: 16 bytes a copy where both
// addresses and the length are multiples of 16, else 4.
__device__ __forceinline__ void stage_async(void* dst, const void* src, long long bytes) {
  const unsigned long long all = reinterpret_cast<unsigned long long>(dst) |
                                 reinterpret_cast<unsigned long long>(src) |
                                 static_cast<unsigned long long>(bytes);
  const int chunk = all % 16 == 0 ? 16 : 4;
  for (long long k = threadIdx.x; k < bytes / chunk; k += blockDim.x)
    copy_async(static_cast<char*>(dst) + k * chunk, static_cast<const char*>(src) + k * chunk,
               chunk);
}

}  // namespace
