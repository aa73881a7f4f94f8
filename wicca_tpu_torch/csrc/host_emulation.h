// The little of CUDA that the kernel sources use, emulated on the host, so
// that a host C++ compiler builds the same kernels into a CPU library:
//
//   g++ -std=c++17 -O2 -ffp-contract=off -shared -fPIC -x c++ haar_kernels.cu lifting_kernels.cu ... -o libhost.so
//
// The tests (tests/test_torch_kernels_host.py) hold that library against the
// plain PyTorch twins, so the kernels' indexing and arithmetic are checked
// without a card. Nothing here is used on the card.
//
// Two launches:
//   wicca_emulate_launch        kernels without shared memory or barriers
//                               (K1-K7): every thread of the grid in turn.
//   wicca_emulate_block_launch  kernels with dynamic shared memory and
//                               __syncthreads() (K8/K9): the blocks one
//                               after another, each on one buffer of
//                               shared memory, and the threads of a block as
//                               fibers (64 KB stacks) that switch
//                               at every __syncthreads(). Between two
//                               barriers the fibers run in turn, in thread
//                               order after an even number of barriers and
//                               in reverse order after an odd one, so a
//                               missing barrier changes a result. A block
//                               whose threads do not all meet the same
//                               barriers aborts.
// cp.async (copy_async, async_commit, async_wait) is deferred as on the
// card, where a copy lands at some time before the wait that covers it: each
// thread keeps its copies, grouped by commit, and performs a group only when
// an async_wait<N> leaves fewer than N+1 groups pending (or when the thread
// ends), so shared memory read before the right wait still holds what was
// there before, and a test fails. The occupancy queries describe a card of 2
// SMs that hold 2 blocks each, so persistent blocks walk several units.
#pragma once

#include <stdint.h>
#include <stdio.h>
#include <stdlib.h>
#include <string.h>
#include <ucontext.h>

#include <vector>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __shared__ static
#define __launch_bounds__(...)
#define __grid_constant__

struct dim3 {
  unsigned x, y, z;
  constexpr dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
struct uint3 {
  unsigned x, y, z;
};

inline thread_local uint3 blockIdx, threadIdx;
inline thread_local dim3 blockDim, gridDim;

// The launches run one thread at a time (fibers switch only at barriers), so
// an atomic is a plain read-modify-write.
inline int atomicMax(int* a, int v) {
  const int old = *a;
  if (v > old) *a = v;
  return old;
}

typedef void* cudaStream_t;
enum cudaError_t { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
enum cudaFuncAttribute { cudaFuncAttributeMaxDynamicSharedMemorySize = 8 };
enum cudaDeviceAttr { cudaDevAttrMultiProcessorCount = 16 };
inline cudaError_t cudaGetLastError() { return cudaSuccess; }
template <typename K>
cudaError_t cudaFuncSetAttribute(K, cudaFuncAttribute, int) {
  return cudaSuccess;
}
// A small card: 2 SMs of 2 blocks, so persistent blocks walk several units.
inline cudaError_t cudaGetDevice(int* dev) {
  *dev = 0;
  return cudaSuccess;
}
inline cudaError_t cudaDeviceGetAttribute(int* v, cudaDeviceAttr, int) {
  *v = 2;
  return cudaSuccess;
}
template <typename K>
cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(int* n, K, int, size_t) {
  *n = 2;
  return cudaSuccess;
}

// The cp.async copies of one thread: the open group, then the committed
// groups, oldest first.
struct WiccaAsync {
  struct Copy {
    void* dst;
    const void* src;
    size_t n;
  };
  std::vector<Copy> open;
  std::vector<std::vector<Copy>> groups;

  void perform(size_t keep) {  // every committed group but the newest keep
    while (groups.size() > keep) {
      for (const Copy& c : groups.front()) memcpy(c.dst, c.src, c.n);
      groups.erase(groups.begin());
    }
  }
  void finish() {
    groups.push_back(open);
    open.clear();
    perform(0);
  }
};

inline thread_local WiccaAsync* wicca_async = nullptr;  // the running thread's

inline void wicca_copy_async(void* dst, const void* src, size_t n) { wicca_async->open.push_back({dst, src, n}); }
inline void wicca_async_commit() {
  wicca_async->groups.push_back(wicca_async->open);
  wicca_async->open.clear();
}
inline void wicca_async_wait(size_t keep) { wicca_async->perform(keep); }

template <typename F>
void wicca_emulate_launch(dim3 grid, dim3 block, F&& thread) {
  WiccaAsync* outer = wicca_async;
  WiccaAsync copies;
  wicca_async = &copies;
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
              copies.finish();
            }
  wicca_async = outer;
}

// Fibers. On x86-64 a switch saves the callee-saved registers on the
// running stack and swaps stack pointers (no system call; glibc's
// swapcontext saves the signal mask with one on every switch); elsewhere
// ucontext does it.
#if defined(__x86_64__)
__attribute__((naked, noinline)) static void wicca_switch(void** /*save_sp*/, void* /*to_sp*/) {
  asm volatile(
      "pushq %rbp\n pushq %rbx\n pushq %r12\n pushq %r13\n pushq %r14\n pushq %r15\n"
      "movq %rsp, (%rdi)\n movq %rsi, %rsp\n"
      "popq %r15\n popq %r14\n popq %r13\n popq %r12\n popq %rbx\n popq %rbp\n ret\n");
}
#endif

// The block being run: its fibers, and the dynamic shared memory.
struct WiccaBlock {
  static constexpr size_t kStack = 64 * 1024;
  std::vector<char> stacks;
  std::vector<char> done;
  std::vector<WiccaAsync> copies;  // each thread's cp.async copies
  unsigned cur = 0;
  void (*body)(void*) = nullptr;
  void* arg = nullptr;
#if defined(__x86_64__)
  void* sched_sp = nullptr;
  std::vector<void*> sp;
#else
  ucontext_t sched;
  std::vector<ucontext_t> ctx;
#endif
};

inline thread_local WiccaBlock* wicca_block = nullptr;
inline thread_local unsigned char* wicca_dyn_smem = nullptr;

inline void wicca_yield(WiccaBlock* b) {
#if defined(__x86_64__)
  wicca_switch(&b->sp[b->cur], b->sched_sp);
#else
  swapcontext(&b->ctx[b->cur], &b->sched);
#endif
}

inline void wicca_resume(WiccaBlock* b, unsigned t) {
  b->cur = t;
  wicca_async = &b->copies[t];
#if defined(__x86_64__)
  wicca_switch(&b->sched_sp, b->sp[t]);
#else
  swapcontext(&b->sched, &b->ctx[t]);
#endif
}

inline void __syncthreads() {
  WiccaBlock* b = wicca_block;
  if (b == nullptr) {
    fprintf(stderr, "__syncthreads() outside wicca_emulate_block_launch\n");
    abort();
  }
  wicca_yield(b);
}

inline void wicca_fiber_entry() {
  WiccaBlock* b = wicca_block;
  b->body(b->arg);
  b->done[b->cur] = 1;
  wicca_yield(b);  // never resumed
  abort();
}

// A fresh fiber for thread t that starts in wicca_fiber_entry.
inline void wicca_fiber_init(WiccaBlock* b, unsigned t) {
  char* stack = b->stacks.data() + t * WiccaBlock::kStack;
#if defined(__x86_64__)
  // from the top: an unused word, the entry address at a 16-byte boundary
  // (so the entry starts with rsp = 8 mod 16, as after a call), and six
  // callee-saved registers for the first switch to pop
  uintptr_t top = (reinterpret_cast<uintptr_t>(stack) + WiccaBlock::kStack) / 16 * 16;
  void** slot = reinterpret_cast<void**>(top - 16);
  slot[1] = nullptr;
  slot[0] = reinterpret_cast<void*>(&wicca_fiber_entry);
  for (int r = 1; r <= 6; ++r) slot[-r] = nullptr;
  b->sp[t] = slot - 6;
#else
  getcontext(&b->ctx[t]);
  b->ctx[t].uc_stack.ss_sp = stack;
  b->ctx[t].uc_stack.ss_size = WiccaBlock::kStack;
  b->ctx[t].uc_link = nullptr;
  makecontext(&b->ctx[t], wicca_fiber_entry, 0);
#endif
}

template <typename F>
void wicca_emulate_block_launch(dim3 grid, dim3 block, size_t smem_bytes, F&& thread) {
  const unsigned nt = block.x * block.y * block.z;
  thread_local WiccaBlock b;
#if defined(__x86_64__)
  b.sp.resize(nt);
#else
  b.ctx.resize(nt);
#endif
  b.stacks.resize(nt * WiccaBlock::kStack);
  b.done.assign(nt, 0);
  b.copies.assign(nt, WiccaAsync());
  b.body = [](void* f) { (*static_cast<F*>(f))(); };
  b.arg = &thread;
  std::vector<unsigned char> smem(smem_bytes + 16);
  unsigned char* aligned = smem.data() + (16 - reinterpret_cast<uintptr_t>(smem.data()) % 16) % 16;
  WiccaBlock* outer = wicca_block;
  unsigned char* outer_smem = wicca_dyn_smem;
  WiccaAsync* outer_async = wicca_async;
  wicca_block = &b;
  wicca_dyn_smem = aligned;
  gridDim = grid;
  blockDim = block;
  for (unsigned bz = 0; bz < grid.z; ++bz)
    for (unsigned by = 0; by < grid.y; ++by)
      for (unsigned bx = 0; bx < grid.x; ++bx) {
        blockIdx = {bx, by, bz};
        memset(aligned, 0xA5, smem_bytes);  // shared memory starts undefined
        for (unsigned t = 0; t < nt; ++t) {
          wicca_fiber_init(&b, t);
          b.done[t] = 0;
        }
        for (unsigned round = 0;; ++round) {
          for (unsigned k = 0; k < nt; ++k) {
            const unsigned t = round % 2 ? nt - 1 - k : k;
            if (b.done[t]) continue;
            threadIdx = {t % block.x, t / block.x % block.y, t / (block.x * block.y)};
            wicca_resume(&b, t);
          }
          unsigned finished = 0;
          for (unsigned t = 0; t < nt; ++t) {
            if (b.done[t]) b.copies[t].finish();
            finished += b.done[t];
          }
          if (finished == nt) break;
          if (finished != 0) {
            fprintf(stderr, "block (%u, %u, %u): %u of %u threads returned while the others wait at a barrier\n",
                    bx, by, bz, finished, nt);
            abort();
          }
        }
      }
  wicca_block = outer;
  wicca_dyn_smem = outer_smem;
  wicca_async = outer_async;
}
