// Launch plumbing shared by the kernel sources. Under nvcc a launch is
// kernel<<<grid, block, smem, stream>>>; a host C++ compiler builds the same
// source against host_emulation.h, which runs each launch thread by thread,
// or, for kernels with shared memory and barriers, block by block with the
// threads as fibers (tests/test_torch_kernels_host.py).
#pragma once

#include <stdint.h>
#include <string.h>

#if defined(__CUDACC__)
#include <cuda_runtime.h>
#define WICCA_LAUNCH(kernel, grid, block, stream, ...) kernel<<<grid, block, 0, stream>>>(__VA_ARGS__)
#define WICCA_LAUNCH_SMEM(kernel, grid, block, smem, stream, ...) \
  kernel<<<grid, block, smem, stream>>>(__VA_ARGS__)
// the block's dynamic shared memory, 16-byte aligned
#define WICCA_SMEM(name)                                         \
  extern __shared__ __align__(16) unsigned char wicca_smem_[]; \
  unsigned char* name = wicca_smem_
#define WICCA_D __device__ __forceinline__
#else
#include "host_emulation.h"
#define WICCA_LAUNCH(kernel, grid, block, stream, ...) \
  wicca_emulate_launch(grid, block, [&] { kernel(__VA_ARGS__); })
#define WICCA_LAUNCH_SMEM(kernel, grid, block, smem, stream, ...) \
  wicca_emulate_block_launch(grid, block, smem, [&] { kernel(__VA_ARGS__); })
#define WICCA_SMEM(name) unsigned char* name = wicca_dyn_smem
#define WICCA_D inline
#endif

namespace wicca {

constexpr int kBlockX = 32;
constexpr int kBlockY = 8;

// kBlockX x kBlockY blocks over (cols, rows), planes on z; y and z are capped
// at 65535 and the kernels stride over the rest.
inline dim3 grid_for(int64_t planes, int64_t rows, int64_t cols) {
  const int64_t gx = (cols + kBlockX - 1) / kBlockX;
  const int64_t gy = (rows + kBlockY - 1) / kBlockY;
  return dim3(static_cast<unsigned>(gx), static_cast<unsigned>(gy < 65535 ? gy : 65535),
              static_cast<unsigned>(planes < 65535 ? planes : 65535));
}

// N = 4, 8 or 16 bytes from device memory into shared memory without
// passing through registers (cp.async; 16 bytes cached in L2 only, 4 and 8
// in L1 too). Both addresses N-byte aligned. The memory clobber keeps the
// compiler from moving this thread's earlier reads of the destination below
// the copy.
template <int N>
WICCA_D void copy_async(void* smem, const void* gmem) {
#if defined(__CUDA_ARCH__)
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  if constexpr (N == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(gmem) : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2;\n" ::"r"(s), "l"(gmem), "n"(N) : "memory");
#elif !defined(__CUDACC__)  // the host build (host_emulation.h)
  wicca_copy_async(smem, gmem, N);
#endif
}

// Close this thread's group of copy_async calls; async_wait<N> waits until
// at most N of its groups are still in flight. A __syncthreads() must follow
// before other threads read what the group copied.
WICCA_D void async_commit() {
#if defined(__CUDA_ARCH__)
  asm volatile("cp.async.commit_group;\n" ::: "memory");
#elif !defined(__CUDACC__)  // the host build (host_emulation.h)
  wicca_async_commit();
#endif
}

template <int N>
WICCA_D void async_wait() {
#if defined(__CUDA_ARCH__)
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
#elif !defined(__CUDACC__)  // the host build (host_emulation.h)
  wicca_async_wait(N);
#endif
}

}  // namespace wicca
