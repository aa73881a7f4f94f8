// The little of CUDA that the kernel sources use, emulated on the host, so
// that a host C++ compiler builds the same kernels into a CPU library:
//
//   g++ -std=c++17 -O2 -ffp-contract=off -shared -fPIC -x c++ haar_kernels.cu lifting_kernels.cu -o libhost.so
//
// The tests (tests/test_torch_kernels_host.py) hold that library against the
// plain PyTorch twins, so the kernels' indexing and arithmetic are checked
// without a card. A launch runs every thread of the grid in turn; the
// kernels use no shared memory, no barriers and no atomics, so the order of
// threads cannot change a result. Nothing here is used on the card.
#pragma once

#include <stdint.h>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline

struct dim3 {
  unsigned x, y, z;
  constexpr dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
struct uint3 {
  unsigned x, y, z;
};

inline thread_local uint3 blockIdx, threadIdx;
inline thread_local dim3 blockDim, gridDim;

typedef void* cudaStream_t;
enum cudaError_t { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
inline cudaError_t cudaGetLastError() { return cudaSuccess; }

template <typename F>
void wicca_emulate_launch(dim3 grid, dim3 block, F&& thread) {
  gridDim = grid;
  blockDim = block;
  for (unsigned bz = 0; bz < grid.z; ++bz)
    for (unsigned by = 0; by < grid.y; ++by)
      for (unsigned bx = 0; bx < grid.x; ++bx)
        for (unsigned tz = 0; tz < block.z; ++tz)
          for (unsigned ty = 0; ty < block.y; ++ty)
            for (unsigned tx = 0; tx < block.x; ++tx) {
              blockIdx = {bx, by, bz};
              threadIdx = {tx, ty, tz};
              thread();
            }
}
