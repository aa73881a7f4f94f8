// Launch plumbing shared by the kernel sources. Under nvcc a launch is
// kernel<<<grid, block, 0, stream>>>; a host C++ compiler builds the same
// source against host_emulation.h, which runs each launch thread by thread
// (tests/test_torch_kernels_host.py).
#pragma once

#include <stdint.h>

#if defined(__CUDACC__)
#include <cuda_runtime.h>
#define WICCA_LAUNCH(kernel, grid, block, stream, ...) kernel<<<grid, block, 0, stream>>>(__VA_ARGS__)
#else
#include "host_emulation.h"
#define WICCA_LAUNCH(kernel, grid, block, stream, ...) \
  wicca_emulate_launch(grid, block, [&] { kernel(__VA_ARGS__); })
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

}  // namespace wicca
