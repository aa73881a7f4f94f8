// Hand-written Hopper kernels for the lossy float-lifting codec: tile-local
// CDF 9/7 and db2 levels with the deadzone quantizer fused in, forward (K8)
// and inverse (K9), for the float filters of lifting_kernels.cuh, and the
// irreversible color transform (ICT) folded into the first forward and the
// last inverse level.
//
// Replaces (wicca_tpu/ops/dwt97_pallas.py):
//   K8  dwt97_multilevel_quant_pallas    -> _dwt97_kernel
//   K9  idwt97_multilevel_dequant_pallas -> _idwt97_kernel
// and, in the first and last launch of a pass, the jnp ICT of
// wicca_tpu/codec/pipeline.py:181-185 and :466-470 (core/color.py's ict_fwd
// with the chroma product; the chroma product, ict_inv and the clip to
// uint8 of _undo_color and _emit_native).
//
// Semantics: those of K6/K7 (lifting_kernels.cu) in float32. A pass's input
// is cut into (512, 1024) tiles (or one tile per dimension that fits); level
// l works on the tile halved l-1 times, lifts horizontally first, then
// vertically, and clamps every lifting step's signal at that tile's edges.
// The forward quantizes each detail band in its epilogue:
// int16(trunc(clip(band * f32(1/step), -32767, 32767))); the LL stays
// float32. The inverse dequantizes in its prologue,
// (q + f32(offset) * sign(q)) * f32(step), and emits float32, or uint8
// (clip to [0, 255], truncate). A partial pass of a progressive decode
// passes the coarse tile of the full pass (orig_k). With the ICT (color 1)
// the forward takes each image's R, G, B planes and lifts
// ((m0 r + m1 g) + m2 b) * f32(1/gain) (gain 1 for Y), the inverse
// reconstructs the three planes and emits ((m0 y + m1 cb') + m2 cr') with
// cb' = cb * f32(gain): core/color.py's _mix in PyTorch's order. An RGBA
// image's alpha plane is lifted as it is.
//
// What bounds them on an H100: device-memory bytes. A 9/7 level needs about
// 16 float operations per input sample; levels 1-3 of a 3x8704x6144 frame
// move 486 MB from uint8 (0.145 ms at 3.35 TB/s) while their operations
// take about 0.05 ms at 67 TFLOP/s.
//
// What the design does about it. Work comes in units: a region of
// RB x CB = 16 x 64 coefficient positions of one tile (never crossing a
// seam) of one plane, or with the ICT of an image's three colour planes.
// Blocks of 320 threads are persistent, as many as fit on the card, each
// walking units b, b + G, ..., and hold a unit's window in shared memory:
// the region plus the L + R positions each of the four chained steps needs
// (2 + 2 for 9/7, 1 + 1 for db2), 40 x 136 samples for a 9/7 forward one.
//   1. Staging: the window's rows are copied with 16-byte cp.async into one
//      of two buffers while the block lifts the unit before (a row's edge
//      clamps are a clamped index into the staged span, never a load).
//   2. K8 lifts the rows (into Y), then the region's columns (into X); K9
//      the window's columns (dequantizing the staged codes as it reads them,
//      into X), then the region's rows (into Y). A thread lifts a run of 8
//      positions of one line in registers from its window of 8 + L + R
//      positions (the filters' fwd/inv, with clamp_edges only for runs that
//      reach past a tile edge), consecutive threads on consecutive lines of
//      odd stride (no bank conflicts). One barrier per pass.
//   3. Stores: K8 quantizes in its epilogue and stores 16-byte rows of the
//      LL and the three code planes; K9 stores its samples (float32 or
//      uint8, after the inverse ICT) from Y as coalesced 16-byte pieces.
//   4. ICT: K8 stages an image's R, G, B windows at once and mixes them
//      into X for each of Y, Cb, Cr; K9 lifts Y, Cb, Cr of a region in turn,
//      each thread keeping its run of Y and Cb in registers for the mix.
// Shared memory per block, 9/7 (db2): K8 56.7 KB (50.5) from uint8, 84.8 KB
// (75.8) from uint8 with the ICT, 86.7 KB (77.5) from float32, 174.8 KB
// (156.8) from float32 with the ICT; K9 64.9 KB (61.3). Registers: at most
// 96 a thread (__launch_bounds__(320, 2): two blocks per SM; nvcc -Xptxas
// -v in build.log). Measured on the H100 (PERF.md), the passes run at
// 11-29% of their byte bound: a block's fixed work per unit (tables,
// shared-memory passes, barriers) takes most of the time; loads, stores
// and lifting each add less (experiments/k89_variants.py). The first
// design (a thread per 2 x 4 strip loading its whole window from device
// memory, 192 loads for 8 positions, 255 registers for K9) was 1.4-1.7x
// slower. Levels stay one launch each, with float32 LL scratch
// between them.
//
// Interface: plain C, bound with ctypes; the wrapper is
// wicca_tpu_torch/ops/dwt97_cuda.py. Each entry point launches one level on
// the stream it is given and returns the first CUDA error it meets.

#include <type_traits>

#include "haar_kernels.cuh"
#include "launch.cuh"
#include "lifting_kernels.cuh"

namespace wicca {
namespace {

constexpr int kThreads = 320;
constexpr int kRB = 16, kCB = 64;  // a block's region, in coefficient positions
constexpr int kRun = 8;            // positions a thread lifts at once along a line

WICCA_HD float widen(uint8_t v) { return static_cast<float>(static_cast<int32_t>(v)); }
WICCA_HD float widen(float v) { return v; }

WICCA_HD float dequantize(int16_t q, float offset, float step) {
  return mul_rn(bin_point(static_cast<float>(q), offset), step);
}

// Staging. Elements e0 .. e1 of a row of device memory land in a staged row
// of CAP elements at index e - e0 + lead(row, e0), where lead in [1, V]
// puts every 16-byte boundary of the row on a 16-byte boundary of the staged
// row (V elements per 16 bytes); CAP >= e1 - e0 + 1 + V.
template <typename T>
WICCA_HD int lead(const T* row, int64_t e0) {
  constexpr int V = 16 / int(sizeof(T));
  const int mis = static_cast<int>(reinterpret_cast<uintptr_t>(row + e0) % 16 / sizeof(T));
  return mis ? mis : V;
}

// Start copying `rows` staged rows, row r from row_of(r), into dst + r * CAP:
// every 16-byte piece of the row that holds an element of [e0, e1], by
// cp.async, so the copies run while the block lifts the region before. A
// piece at the ragged ends also reads neighbours of the span, from the same
// 16-byte-aligned piece of the tensor's allocation (the host build copies
// only the span). The caller commits and waits (async_commit, async_wait).
template <int NT, typename T, int CAP, class RowOf>
WICCA_D void stage_rows(T* dst, int rows, int64_t e0, int64_t e1, RowOf row_of, int tid) {
  constexpr int V = 16 / int(sizeof(T)), SLOTS = CAP / V;
  static_assert(CAP % V == 0, "staged rows hold whole 16-byte pieces");
  for (int t = tid; t < rows * SLOTS; t += NT) {
    const int r = t / SLOTS, k = t % SLOTS;
    const T* row = row_of(r);
    const int64_t lo = e0 - lead(row, e0) + int64_t(k) * V;  // element at staged index k * V
    if (lo > e1 || lo + V - 1 < e0) continue;
    T* d = dst + r * CAP + k * V;
#if defined(__CUDA_ARCH__)
    copy_async<16>(d, row + lo);
#else
    for (int u = 0; u < V; ++u)
      if (lo + u >= e0 && lo + u <= e1) d[u] = row[lo + u];
#endif
  }
}

// A run of kRun positions of one line, lifted in registers: the tile-edge
// clamps are needed only where the run's window of P positions, starting at
// tile position p0, reaches past an edge of the tile of m positions.
WICCA_HD bool interior(int64_t p0, int P, int64_t m) { return p0 >= 0 && p0 + P <= m; }

template <class F>
WICCA_HD void fwd_run(const float* w, int64_t p0, int64_t m, float* lo, float* hi) {
  if (interior(p0, kRun + F::L + F::R, m))
    F::template fwd<kRun, false>(w, p0, m, lo, hi);
  else
    F::template fwd<kRun, true>(w, p0, m, lo, hi);
}

template <class F>
WICCA_HD void inv_run(const float* s, const float* d, int64_t p0, int64_t m, float* x) {
  if (interior(p0, kRun + F::L + F::R, m))
    F::template inv<kRun, false>(s, d, p0, m, x);
  else
    F::template inv<kRun, true>(s, d, p0, m, x);
}

// Store n <= N elements; one row of 16-byte accesses when all N go and dst
// is aligned for them.
template <typename T, int N>
WICCA_HD void store_part(T* dst, const T* v, int n) {
  constexpr int A = int(sizeof(T)) * N > 16 ? 16 : int(sizeof(T)) * N;
  if (n == N && reinterpret_cast<uintptr_t>(dst) % A == 0) {
    store_row<T, N>(dst, v);
  } else {
    for (int e = 0; e < n; ++e) dst[e] = v[e];
  }
}

// The planes a unit lifts: one plane, or with the ICT an image's three
// colour planes (nin 3), or its alpha plane (nin 1); g runs over these
// groups: per image one (RGB) or two (RGBA).
struct Group {
  int first, nin;
};

template <bool MIX>
WICCA_HD Group group_of(int g, int cin) {
  if (!MIX) return {g, 1};
  const int per = cin == 4 ? 2 : 1;
  const bool alpha = g % per != 0;
  return {g / per * cin + (alpha ? 3 : 0), alpha ? 1 : 3};
}

// A unit of work: one region (kRB x kCB positions of one tile) of one group
// of planes. Blocks are persistent: block b takes units b, b + G, b + 2G, ...
// (G blocks), neighbouring regions side by side, and stages the next unit's
// window while it lifts the current one. Counts and band coordinates fit
// 32 bits (the launch checks the unit count); element offsets are 64-bit.
struct Region {
  Group grp;
  int ti0, nr0, tj0, nc0;  // tile origin and the region's offset in it (band coordinates)
  int nrows, ncols;        // the region's positions inside the tile
};

template <bool MIX>
WICCA_HD Region region_of(int u, int cin, int hb, int wb, int th, int tw) {
  const int nrx = (tw + kCB - 1) / kCB, nry = (th + kRB - 1) / kRB;
  const int nbx = wb / tw * nrx, nby = hb / th * nry;
  const int bx = u % nbx, by = u / nbx % nby, g = u / (nbx * nby);
  Region r;
  r.grp = group_of<MIX>(g, cin);
  r.tj0 = bx / nrx * tw, r.nc0 = bx % nrx * kCB;
  r.ti0 = by / nry * th, r.nr0 = by % nry * kRB;
  r.ncols = tw - r.nc0 < kCB ? tw - r.nc0 : kCB;
  r.nrows = th - r.nr0 < kRB ? th - r.nr0 : kRB;
  return r;
}

WICCA_HD int64_t units_of(int64_t groups, int64_t hb, int64_t wb, int64_t th, int64_t tw) {
  return groups * (hb / th * ((th + kRB - 1) / kRB)) * (wb / tw * ((tw + kCB - 1) / kCB));
}

// ---------------------------------------------------------------------------
// K8: one forward level. x (planes, h, w) is read as if edge-padded to the
// band grid (2 hb, 2 wb); th x tw is the tile in band coordinates (pairs).
// With the ICT, X first holds the window's mixed samples. The row pass
// writes the (low, high) pairs of each window row's region columns to Y,
// the column pass ll/lh (even rows) and hl/hh (odd rows) from Y to X. Two
// staging buffers alternate.
// ---------------------------------------------------------------------------

template <class F, typename In, bool MIX>
struct FwdGeom {
  static constexpr int PR = kRB + F::L + F::R, PC = kCB + F::L + F::R;  // window positions
  static constexpr int WR = 2 * PR, WC = 2 * PC;                        // window samples
  static constexpr int S = WC + 1;  // X's row stride, odd: no bank conflicts
  // staged row length: whole 16-byte pieces, a word stride of 4 x odd (threads on
  // consecutive rows then read 8 different groups of banks)
  static constexpr int V = 16 / int(sizeof(In)), CAP0 = (WC + V + V - 1) / V * V, NIN = MIX ? 3 : 1;
  static constexpr int CAP = CAP0 * int(sizeof(In)) / 4 % 8 == 0 ? CAP0 + V : CAP0;
  static constexpr int SY = 2 * kCB + 1;  // Y's row stride, odd
  static constexpr size_t X_BYTES = size_t(WR) * S * 4;
  static constexpr size_t Y_BYTES = size_t(WR) * SY * 4;
  static constexpr size_t R_BYTES = (size_t(NIN) * WR * CAP * sizeof(In) + 15) / 16 * 16;  // one buffer
  static constexpr size_t BYTES = X_BYTES + Y_BYTES + 2 * R_BYTES + 2 * 4 * (NIN * WR + WC);
};

template <class F, typename In, bool MIX>
__global__ void __launch_bounds__(kThreads, 2)
    lift97_fwd_level_kernel(const In* __restrict__ x, int64_t groups, int cin, int64_t h, int64_t w, int64_t hb,
                            int64_t wb, int64_t th, int64_t tw, float* __restrict__ ll, int16_t* __restrict__ lh,
                            int16_t* __restrict__ hl, int16_t* __restrict__ hh, float inv_lh, float inv_hl,
                            float inv_hh, float inv_gain) {
  using Gm = FwdGeom<F, In, MIX>;
  constexpr int L = F::L, P = kRun + F::L + F::R, WR = Gm::WR, WC = Gm::WC, S = Gm::S, SY = Gm::SY, CAP = Gm::CAP;
  constexpr int NIN = Gm::NIN, RUNS_H = kCB / kRun, RUNS_V = kRB / kRun;
  static_assert(WR * RUNS_H <= kThreads && 2 * kCB * RUNS_V <= kThreads, "one run per thread and pass");
  constexpr float QMAX = 32767.0f;
  WICCA_SMEM(smem);
  float* X = reinterpret_cast<float*>(smem);
  float* Y = reinterpret_cast<float*>(smem + Gm::X_BYTES);
  In* staged0 = reinterpret_cast<In*>(smem + Gm::X_BYTES + Gm::Y_BYTES);
  int* tables0 = reinterpret_cast<int*>(smem + Gm::X_BYTES + Gm::Y_BYTES + 2 * Gm::R_BYTES);
  // per buffer b: staged rows, row_at (staged row + lead) and col_at (col(c) - e0)
  auto staged = [&](int b) { return staged0 + b * (Gm::R_BYTES / sizeof(In)); };
  auto row_at = [&](int b) { return tables0 + b * (NIN * WR + WC); };
  auto col_at = [&](int b) { return tables0 + b * (NIN * WR + WC) + NIN * WR; };
  const int tid = threadIdx.x;
  const int64_t total = units_of(groups, hb, wb, th, tw);
  auto region = [&](int64_t v) {
    return region_of<MIX>(static_cast<int>(v), cin, static_cast<int>(hb), static_cast<int>(wb), static_cast<int>(th),
                          static_cast<int>(tw));
  };
  auto col = [&](const Region& r, int c) {
    return min64(2 * (r.tj0 + clamp64(r.nc0 - L + c / 2, 0, tw - 1)) + (c & 1), w - 1);
  };
  auto row_of = [&](const Region& rg, int r) {
    const int a = r % WR;
    const int64_t sr = min64(2 * (rg.ti0 + clamp64(rg.nr0 - L + a / 2, 0, th - 1)) + (a & 1), h - 1);
    return x + ((int64_t(rg.grp.first) + r / WR) * h + sr) * w;
  };
  auto prefetch = [&](const Region& rg, int b) {
    const int64_t e0 = col(rg, 0), e1 = col(rg, WC - 1);
    for (int c = tid; c < WC; c += kThreads) col_at(b)[c] = static_cast<int>(col(rg, c) - e0);
    for (int r = tid; r < rg.grp.nin * WR; r += kThreads) row_at(b)[r] = r * CAP + lead(row_of(rg, r), e0);
    stage_rows<kThreads, In, CAP>(staged(b), rg.grp.nin * WR, e0, e1, [&](int r) { return row_of(rg, r); }, tid);
    async_commit();
  };
  int64_t u = blockIdx.x;
  if (u >= total) return;
  Region cur = region(u);
  prefetch(cur, 0);
  for (int b = 0; u < total; u += gridDim.x, b ^= 1) {
    const bool more = u + gridDim.x < total;
    Region nxt = cur;
    if (more) {
      nxt = region(u + gridDim.x);
      prefetch(nxt, b ^ 1);
      async_wait<1>();
    } else {
      async_wait<0>();
    }
    __syncthreads();
    const In* st = staged(b);
    const int* ra = row_at(b);
    const int* ca = col_at(b);
    for (int q = 0; q < cur.grp.nin; ++q) {
      // With the ICT, the window's mixed samples first go to X, consecutive threads on
      // consecutive columns of a staged row (three reads each, free of bank conflicts).
      if (MIX && cur.grp.nin == 3) {
        for (int t = tid; t < WR * WC; t += kThreads) {
          const int a = t / WC, c = ca[t % WC];
          const float r = widen(st[ra[a] + c]), g = widen(st[ra[WR + a] + c]), bl = widen(st[ra[2 * WR + a] + c]);
          X[a * S + t % WC] = mul_rn(ict_fwd_plane(q, r, g, bl), q ? inv_gain : 1.0f);
        }
        __syncthreads();
      }
      // rows into Y: thread (window row a, run k), consecutive threads on consecutive rows;
      // without the ICT the samples come straight from the staged rows
      if (tid < WR * RUNS_H) {
        const int a = tid % WR, i0 = tid / WR * kRun;
        float win[2 * P];
        if (MIX && cur.grp.nin == 3) {
#pragma unroll
          for (int v = 0; v < 2 * P; ++v) win[v] = X[a * S + 2 * i0 + v];
        } else {
          const int* cr = ca + 2 * i0;
          const In* sr = st + ra[q * WR + a];
          if (cr[2 * P - 1] - cr[0] == 2 * P - 1) {  // contiguous in the staged row
#pragma unroll
            for (int v = 0; v < 2 * P; ++v) win[v] = widen(sr[cr[0] + v]);
          } else {
#pragma unroll
            for (int v = 0; v < 2 * P; ++v) win[v] = widen(sr[cr[v]]);
          }
        }
        float lo[kRun], hi[kRun];
        fwd_run<F>(win, cur.nc0 - L + i0, tw, lo, hi);
        float* dst = Y + a * SY + 2 * i0;
#pragma unroll
        for (int v = 0; v < kRun; ++v) dst[2 * v] = lo[v], dst[2 * v + 1] = hi[v];
      }
      __syncthreads();
      // columns of the region, from Y into X: thread (column c, run k)
      if (tid < 2 * kCB * RUNS_V) {
        const int c = tid % (2 * kCB), i0 = tid / (2 * kCB) * kRun;
        float win[2 * P];
#pragma unroll
        for (int v = 0; v < 2 * P; ++v) win[v] = Y[(2 * i0 + v) * SY + c];
        float lo[kRun], hi[kRun];
        fwd_run<F>(win, cur.nr0 - L + i0, th, lo, hi);
        float* dst = X + 2 * (L + i0) * S + c;
#pragma unroll
        for (int v = 0; v < kRun; ++v) dst[2 * v * S] = lo[v], dst[(2 * v + 1) * S] = hi[v];
      }
      __syncthreads();
      const int64_t plane = int64_t(cur.grp.first) + q;
      for (int t = tid; t < kRB * (kCB / 8); t += kThreads) {
        const int r = t / (kCB / 8), c0 = t % (kCB / 8) * 8;
        if (r >= cur.nrows || c0 >= cur.ncols) continue;
        float o_ll[8];
        int16_t o_lh[8], o_hl[8], o_hh[8];
#pragma unroll
        for (int v = 0; v < 8; ++v) {
          const float* e = X + 2 * (r + L) * S + 2 * (c0 + v);  // (ll, lh / hl, hh)
          o_ll[v] = e[0];
          o_lh[v] = static_cast<int16_t>(quantize(e[1], inv_lh, QMAX));
          o_hl[v] = static_cast<int16_t>(quantize(e[S], inv_hl, QMAX));
          o_hh[v] = static_cast<int16_t>(quantize(e[S + 1], inv_hh, QMAX));
        }
        const int64_t o = (plane * hb + cur.ti0 + cur.nr0 + r) * wb + cur.tj0 + cur.nc0 + c0;
        const int n = cur.ncols - c0 < 8 ? cur.ncols - c0 : 8;
        store_part<float, 8>(ll + o, o_ll, n);
        store_part<int16_t, 8>(lh + o, o_lh, n);
        store_part<int16_t, 8>(hl + o, o_hl, n);
        store_part<int16_t, 8>(hh + o, o_hh, n);
      }
      __syncthreads();
    }
    cur = nxt;
  }
}

// ---------------------------------------------------------------------------
// K9: one inverse level. The band grid is hb x wb (tile th x tw); the LL
// (planes, llh, llw) and the codes (planes, bh, bw) are read as if
// edge-padded (or cropped) to it. out is (planes, 2 hb, 2 wb), float32 or
// uint8. The column pass reads the staged coefficients and writes X: for
// each of the region's kRB positions, its even then its odd sample row
// (X row pr kRB + i), each row the low half (PC columns) then the high half.
// The row pass turns each X row into a row of 2 kCB output samples in Y,
// which go to device memory as coalesced 16-byte pieces (with the ICT,
// after the region's third plane, each thread keeping its run of the first
// two in registers). A unit is one plane of a region; two staging buffers
// alternate.
// ---------------------------------------------------------------------------

template <class F, bool MIX>
struct InvGeom {
  static constexpr int PR = kRB + F::L + F::R, PC = kCB + F::L + F::R;  // window positions
  static constexpr int ROW = 2 * PC + 1;                                // odd: no bank conflicts
  static constexpr int CAPF = (PC + 4 + 3) / 4 * 4, CAPH = (PC + 8 + 7) / 8 * 8;
  static constexpr int SY = 2 * kCB + 1;  // Y's row stride, odd
  static constexpr size_t X_BYTES = size_t(2) * kRB * ROW * 4 + size_t(2) * kRB * SY * 4;  // X, then Y
  static constexpr size_t RL_BYTES = size_t(PR) * CAPF * 4;                       // one buffer
  static constexpr size_t RH_BYTES = (size_t(3) * PR * CAPH * 2 + 15) / 16 * 16;  // one buffer
  static constexpr int TABLE = 4 * PR + 2 * PC;
  static constexpr size_t BYTES = X_BYTES + 2 * (RL_BYTES + RH_BYTES) + 2 * 4 * TABLE;
};

template <class F, bool EMIT_U8, bool MIX>
__global__ void __launch_bounds__(kThreads, 2)
    lift97_inv_level_kernel(const float* __restrict__ ll, int64_t llh, int64_t llw, const int16_t* __restrict__ lh,
                            const int16_t* __restrict__ hl, const int16_t* __restrict__ hh, int64_t bh, int64_t bw,
                            int64_t groups, int cin, int64_t hb, int64_t wb, int64_t th, int64_t tw, float s_lh,
                            float s_hl, float s_hh, float offset, float gain, void* __restrict__ out) {
  using Gm = InvGeom<F, MIX>;
  using Out = typename std::conditional<EMIT_U8, uint8_t, float>::type;
  constexpr int L = F::L, P = kRun + F::L + F::R, PR = Gm::PR, PC = Gm::PC, ROW = Gm::ROW;
  constexpr int CAPF = Gm::CAPF, CAPH = Gm::CAPH, RUNS_V = kRB / kRun, RUNS_H = kCB / kRun;
  constexpr int GO = 16 / int(sizeof(Out));  // output samples per 16-byte store
  constexpr int SY = Gm::SY;
  static_assert(2 * PC * RUNS_V <= kThreads && 2 * kRB * RUNS_H <= kThreads, "one run per thread and pass");
  WICCA_SMEM(smem);
  float* X = reinterpret_cast<float*>(smem);
  float* Y = X + 2 * kRB * ROW;
  // per buffer b: staged LL rows, staged band rows (lh, hl, hh), and the tables row_at
  // (4 PR: staged row + lead, LL then bands) and col_l, col_h (column j -> offset)
  auto stl = [&](int b) { return reinterpret_cast<float*>(smem + Gm::X_BYTES + b * Gm::RL_BYTES); };
  auto sth = [&](int b) {
    return reinterpret_cast<int16_t*>(smem + Gm::X_BYTES + 2 * Gm::RL_BYTES + b * Gm::RH_BYTES);
  };
  auto table = [&](int b) {
    return reinterpret_cast<int*>(smem + Gm::X_BYTES + 2 * (Gm::RL_BYTES + Gm::RH_BYTES)) + b * Gm::TABLE;
  };
  const int tid = threadIdx.x;
  const int64_t total = units_of(groups, hb, wb, th, tw);
  auto region = [&](int64_t v) {
    return region_of<MIX>(static_cast<int>(v), cin, static_cast<int>(hb), static_cast<int>(wb), static_cast<int>(th),
                          static_cast<int>(tw));
  };
  auto col = [&](const Region& r, int j) { return r.tj0 + clamp64(r.nc0 - L + j, 0, tw - 1); };
  auto src_of = [&](const Region& rg, int q, int r) -> const void* {  // staged row r: LL, then lh, hl, hh
    const int64_t plane = int64_t(rg.grp.first) + q, sr = rg.ti0 + clamp64(rg.nr0 - L + r % PR, 0, th - 1);
    if (r < PR) return ll + (plane * llh + min64(sr, llh - 1)) * llw;
    const int16_t* b = r < 2 * PR ? lh : (r < 3 * PR ? hl : hh);
    return b + (plane * bh + min64(sr, bh - 1)) * bw;
  };
  auto prefetch = [&](const Region& rg, int q, int b) {
    const int64_t e0l = min64(col(rg, 0), llw - 1), e1l = min64(col(rg, PC - 1), llw - 1);
    const int64_t e0h = min64(col(rg, 0), bw - 1), e1h = min64(col(rg, PC - 1), bw - 1);
    int* t = table(b);
    for (int j = tid; j < PC; j += kThreads) {
      t[4 * PR + j] = static_cast<int>(min64(col(rg, j), llw - 1) - e0l);
      t[4 * PR + PC + j] = static_cast<int>(min64(col(rg, j), bw - 1) - e0h);
    }
    for (int r = tid; r < 4 * PR; r += kThreads)
      t[r] = r < PR ? r * CAPF + lead(static_cast<const float*>(src_of(rg, q, r)), e0l)
                    : (r - PR) * CAPH + lead(static_cast<const int16_t*>(src_of(rg, q, r)), e0h);
    stage_rows<kThreads, float, CAPF>(stl(b), PR, e0l, e1l,
                                      [&](int r) { return static_cast<const float*>(src_of(rg, q, r)); }, tid);
    stage_rows<kThreads, int16_t, CAPH>(
        sth(b), 3 * PR, e0h, e1h, [&](int r) { return static_cast<const int16_t*>(src_of(rg, q, PR + r)); }, tid);
    async_commit();
  };
  Out* o = static_cast<Out*>(out);
  int64_t u = blockIdx.x;
  if (u >= total) return;
  Region cur = region(u);
  int q = 0;
  prefetch(cur, 0, 0);
  float kept_y[2 * kRun], kept_cb[2 * kRun];  // with the ICT: this thread's Y and Cb run of the region
  for (int b = 0; u < total; b ^= 1) {
    // the next unit: the region's next plane, or the block's next region
    Region nxt = cur;
    int64_t un = u;
    int qn = q + 1;
    if (qn == cur.grp.nin) {
      un = u + gridDim.x, qn = 0;
      if (un < total) nxt = region(un);
    }
    if (un < total) {
      prefetch(nxt, qn, b ^ 1);
      async_wait<1>();
    } else {
      async_wait<0>();
    }
    __syncthreads();
    const bool mixed = MIX && cur.grp.nin == 3;
    const float* sl = stl(b);
    const int16_t* sh = sth(b);
    const int* ra = table(b);
    const int* cl = ra + 4 * PR;
    const int* ch = cl + PC;
    // columns of the window (low half, then high half): thread (column c, run k),
    // dequantizing as it reads
    if (tid < 2 * PC * RUNS_V) {
      const int c = tid % (2 * PC), i0 = tid / (2 * PC) * kRun, j = c % PC;
      float s[P], d[P];
      if (c < PC) {  // (ll, hl)
#pragma unroll
        for (int v = 0; v < P; ++v) {
          s[v] = sl[ra[i0 + v] + cl[j]];
          d[v] = dequantize(sh[ra[2 * PR + i0 + v] + ch[j]], offset, s_hl);
        }
      } else {  // (lh, hh)
#pragma unroll
        for (int v = 0; v < P; ++v) {
          s[v] = dequantize(sh[ra[PR + i0 + v] + ch[j]], offset, s_lh);
          d[v] = dequantize(sh[ra[3 * PR + i0 + v] + ch[j]], offset, s_hh);
        }
      }
      float xs[2 * kRun];
      inv_run<F>(s, d, cur.nr0 - L + i0, th, xs);
      float* dst = X + i0 * ROW + c;
#pragma unroll
      for (int v = 0; v < kRun; ++v) dst[v * ROW] = xs[2 * v], dst[(kRB + v) * ROW] = xs[2 * v + 1];
    }
    __syncthreads();
    // the region's 2 kRB sample rows: thread (X row t, run k) -> 2 kRun output samples of
    // row R = 2 (t % kRB) + t / kRB, at Y[t][C]
    {
      const int t = tid % (2 * kRB), i0 = tid / (2 * kRB) * kRun;
      const bool on = tid < 2 * kRB * RUNS_H;
      float xs[2 * kRun];
      if (on) {
        float s[P], d[P];
#pragma unroll
        for (int v = 0; v < P; ++v) s[v] = X[t * ROW + i0 + v], d[v] = X[t * ROW + PC + i0 + v];
        inv_run<F>(s, d, cur.nc0 - L + i0, tw, xs);
        if (mixed && q == 0) {
#pragma unroll
          for (int v = 0; v < 2 * kRun; ++v) kept_y[v] = xs[v];
        } else if (mixed && q == 1) {
#pragma unroll
          for (int v = 0; v < 2 * kRun; ++v) kept_cb[v] = xs[v];
        } else if (!mixed) {
#pragma unroll
          for (int v = 0; v < 2 * kRun; ++v) Y[t * SY + 2 * i0 + v] = xs[v];
        }
      }
      // with the ICT, after Cr: R, G, B one after another through Y
      for (int k = 0; k < (mixed ? (q == 2 ? 3 : 0) : 1); ++k) {
        if (mixed) {
          if (on) {
#pragma unroll
            for (int v = 0; v < 2 * kRun; ++v)
              Y[t * SY + 2 * i0 + v] =
                  ict_inv_plane(k, mul_rn(kept_y[v], 1.0f), mul_rn(kept_cb[v], gain), mul_rn(xs[v], gain));
          }
        }
        __syncthreads();
        // coalesced stores: consecutive threads on consecutive 16-byte pieces of a row
        const int64_t plane = int64_t(cur.grp.first) + (mixed ? k : q);
        for (int c = tid; c < 2 * kRB * (2 * kCB / GO); c += kThreads) {
          const int R = c / (2 * kCB / GO), C0 = c % (2 * kCB / GO) * GO;
          if (R >= 2 * cur.nrows || C0 >= 2 * cur.ncols) continue;
          const float* src = Y + ((R & 1) * kRB + R / 2) * SY + C0;
          Out px[GO];
#pragma unroll
          for (int v = 0; v < GO; ++v) {
            if constexpr (EMIT_U8)
              px[v] = to_u8(src[v]);
            else
              px[v] = src[v];
          }
          const int n = 2 * cur.ncols - C0 < GO ? 2 * cur.ncols - C0 : GO;
          store_part<Out, GO>(o + (plane * 2 * hb + 2 * (cur.ti0 + cur.nr0) + R) * (2 * wb) + 2 * (cur.tj0 + cur.nc0) + C0,
                              px, n);
        }
        __syncthreads();
      }
    }
    __syncthreads();
    u = un, q = qn, cur = nxt;
  }
}

// The kernel's shared memory above 48 KB is allowed once per kernel; the
// result of that call is every launch's first check.
template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
}

// Persistent blocks: as many as fit on the card at once, at most one per unit.
template <typename K>
cudaError_t persistent_grid(K kernel, size_t smem, int64_t units, dim3* grid) {
  int dev = 0, sms = 0, per_sm = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess) e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (e == cudaSuccess) e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, smem);
  if (e != cudaSuccess) return e;
  if (units >= (int64_t(1) << 31)) return cudaErrorInvalidValue;
  const int64_t n = int64_t(sms) * (per_sm > 0 ? per_sm : 1);
  *grid = dim3(static_cast<unsigned>(units < n ? units : n));
  return cudaSuccess;
}

template <class F, typename In, bool MIX>
cudaError_t launch_fwd(const In* x, int64_t groups, int cin, int64_t h, int64_t w, int64_t hb, int64_t wb, int64_t th,
                       int64_t tw, float* ll, int16_t* lh, int16_t* hl, int16_t* hh, float inv_lh, float inv_hl,
                       float inv_hh, float inv_gain, cudaStream_t st) {
  auto* kernel = lift97_fwd_level_kernel<F, In, MIX>;
  constexpr size_t smem = FwdGeom<F, In, MIX>::BYTES;
  static const cudaError_t allowed = allow_smem(kernel, smem);
  if (allowed != cudaSuccess) return allowed;
  dim3 grid;
  const cudaError_t e = persistent_grid(kernel, smem, units_of(groups, hb, wb, th, tw), &grid);
  if (e != cudaSuccess) return e;
  WICCA_LAUNCH_SMEM(kernel, grid, dim3(kThreads), smem, st, x, groups, cin, h, w, hb, wb, th, tw, ll, lh, hl, hh,
                    inv_lh, inv_hl, inv_hh, inv_gain);
  return cudaGetLastError();
}

template <class F>
cudaError_t launch_fwd_any(const void* x, int from_u8, int color, int64_t groups, int cin, int64_t h, int64_t w,
                           int64_t hb, int64_t wb, int64_t th, int64_t tw, float* ll, int16_t* lh, int16_t* hl,
                           int16_t* hh, float inv_lh, float inv_hl, float inv_hh, float inv_gain, cudaStream_t st) {
  const uint8_t* u = static_cast<const uint8_t*>(x);
  const float* f = static_cast<const float*>(x);
  if (from_u8 && color)
    return launch_fwd<F, uint8_t, true>(u, groups, cin, h, w, hb, wb, th, tw, ll, lh, hl, hh, inv_lh, inv_hl, inv_hh,
                                        inv_gain, st);
  if (from_u8)
    return launch_fwd<F, uint8_t, false>(u, groups, cin, h, w, hb, wb, th, tw, ll, lh, hl, hh, inv_lh, inv_hl, inv_hh,
                                         inv_gain, st);
  if (color)
    return launch_fwd<F, float, true>(f, groups, cin, h, w, hb, wb, th, tw, ll, lh, hl, hh, inv_lh, inv_hl, inv_hh,
                                      inv_gain, st);
  return launch_fwd<F, float, false>(f, groups, cin, h, w, hb, wb, th, tw, ll, lh, hl, hh, inv_lh, inv_hl, inv_hh,
                                     inv_gain, st);
}

template <class F, bool EMIT_U8, bool MIX>
cudaError_t launch_inv(const float* ll, int64_t llh, int64_t llw, const int16_t* lh, const int16_t* hl,
                       const int16_t* hh, int64_t bh, int64_t bw, int64_t groups, int cin, int64_t hb, int64_t wb,
                       int64_t th, int64_t tw, float s_lh, float s_hl, float s_hh, float offset, float gain, void* out,
                       cudaStream_t st) {
  auto* kernel = lift97_inv_level_kernel<F, EMIT_U8, MIX>;
  constexpr size_t smem = InvGeom<F, MIX>::BYTES;
  static const cudaError_t allowed = allow_smem(kernel, smem);
  if (allowed != cudaSuccess) return allowed;
  dim3 grid;
  const cudaError_t e = persistent_grid(kernel, smem, units_of(groups, hb, wb, th, tw), &grid);
  if (e != cudaSuccess) return e;
  WICCA_LAUNCH_SMEM(kernel, grid, dim3(kThreads), smem, st, ll, llh, llw, lh, hl, hh, bh, bw, groups, cin, hb, wb,
                    th, tw, s_lh, s_hl, s_hh, offset, gain, out);
  return cudaGetLastError();
}

template <class F>
cudaError_t launch_inv_any(int emit_u8, int color, const float* ll, int64_t llh, int64_t llw, const int16_t* lh,
                           const int16_t* hl, const int16_t* hh, int64_t bh, int64_t bw, int64_t groups, int cin,
                           int64_t hb, int64_t wb, int64_t th, int64_t tw, float s_lh, float s_hl, float s_hh,
                           float offset, float gain, void* out, cudaStream_t st) {
  if (emit_u8 && color)
    return launch_inv<F, true, true>(ll, llh, llw, lh, hl, hh, bh, bw, groups, cin, hb, wb, th, tw, s_lh, s_hl, s_hh,
                                     offset, gain, out, st);
  if (emit_u8)
    return launch_inv<F, true, false>(ll, llh, llw, lh, hl, hh, bh, bw, groups, cin, hb, wb, th, tw, s_lh, s_hl, s_hh,
                                      offset, gain, out, st);
  if (color)
    return launch_inv<F, false, true>(ll, llh, llw, lh, hl, hh, bh, bw, groups, cin, hb, wb, th, tw, s_lh, s_hl, s_hh,
                                      offset, gain, out, st);
  return launch_inv<F, false, false>(ll, llh, llw, lh, hl, hh, bh, bw, groups, cin, hb, wb, th, tw, s_lh, s_hl, s_hh,
                                     offset, gain, out, st);
}

// Groups of planes a launch runs on z (group_of): every plane, or with the
// ICT one or two per image of cin planes.
int64_t groups_of(int64_t planes, int color, int cin) {
  return color ? planes / cin * (cin == 4 ? 2 : 1) : planes;
}

}  // namespace
}  // namespace wicca

using namespace wicca;

extern "C" {

// K8, one level: x (planes, h, w) uint8 (from_u8) or float32, read as if
// edge-padded to (2 hb, 2 wb) -> ll (planes, hb, wb) float32 and lh, hl, hh
// (planes, hb, wb) int16 codes, each band multiplied by its f32(1/step).
// (th, tw): the level's tile in band coordinates. filt: 0 CDF 9/7, 1 db2.
// color 1: the planes are images of cin (3 or 4) planes, and the ICT, with
// the chroma planes multiplied by inv_gain, comes before the lifting.
int wicca_lift97_fwd_level(const void* x, int from_u8, int filt, int64_t planes, int64_t h, int64_t w, int64_t hb,
                           int64_t wb, int64_t th, int64_t tw, void* ll, void* lh, void* hl, void* hh, float inv_lh,
                           float inv_hl, float inv_hh, int color, int cin, float inv_gain, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(ll);
  int16_t *a = static_cast<int16_t*>(lh), *b = static_cast<int16_t*>(hl), *c = static_cast<int16_t*>(hh);
  const int64_t groups = groups_of(planes, color, cin);
  switch (filt) {
    case 0:
      return launch_fwd_any<Cdf97>(x, from_u8, color, groups, cin, h, w, hb, wb, th, tw, l, a, b, c, inv_lh, inv_hl,
                                   inv_hh, inv_gain, st);
    case 1:
      return launch_fwd_any<Db2>(x, from_u8, color, groups, cin, h, w, hb, wb, th, tw, l, a, b, c, inv_lh, inv_hl,
                                 inv_hh, inv_gain, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// K9, one level: ll (planes, llh, llw) float32 and lh, hl, hh (planes, bh,
// bw) int16 codes, read as if edge-padded or cropped to the band grid
// (hb, wb) with tile (th, tw); each code dequantized with its f32 step and
// the reconstruction offset -> out (planes, 2 hb, 2 wb), float32 or uint8
// (emit_u8). filt as for K8. color 1: the planes are images of cin planes,
// and the chroma product by gain and the inverse ICT come before the emit.
int wicca_lift97_inv_level(const void* ll, int64_t llh, int64_t llw, const void* lh, const void* hl, const void* hh,
                           int64_t bh, int64_t bw, int filt, int64_t planes, int64_t hb, int64_t wb, int64_t th,
                           int64_t tw, float s_lh, float s_hl, float s_hh, float offset, void* out, int emit_u8,
                           int color, int cin, float gain, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(ll);
  const int16_t *a = static_cast<const int16_t*>(lh), *b = static_cast<const int16_t*>(hl),
                *c = static_cast<const int16_t*>(hh);
  const int64_t groups = groups_of(planes, color, cin);
  switch (filt) {
    case 0:
      return launch_inv_any<Cdf97>(emit_u8, color, l, llh, llw, a, b, c, bh, bw, groups, cin, hb, wb, th, tw, s_lh,
                                   s_hl, s_hh, offset, gain, out, st);
    case 1:
      return launch_inv_any<Db2>(emit_u8, color, l, llh, llw, a, b, c, bh, bw, groups, cin, hb, wb, th, tw, s_lh,
                                 s_hl, s_hh, offset, gain, out, st);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
