// Hand-written Hopper kernels for the Haar paths: the icon (K1), the fused
// multi-level DWT + deadzone quantization (K2), the fused dequantization +
// multi-level inverse (K3), and the single-level pair K4/K5.
//
// Replaces (wicca_tpu/ops/dwt_pallas.py):
//   K1  icon_pallas                    -> _icon_pass_kernel
//   K2  dwt_multilevel_quant_pallas    -> _dwt_multi_kernel
//   K3  idwt_multilevel_dequant_pallas -> _idwt_multi_kernel
//   K4  dwt_level_quant_pallas         -> _dwt_quant_kernel
//   K5  idwt_level_dequant_pallas      -> _idwt_dequant_kernel
//
// What bounds them on an H100: device-memory bytes. Each does a handful of
// integer or float operations per byte (the depth-5 roundtrip of a
// 3x8704x6144 uint8 frame moves ~0.68 GB, ~0.2 ms at 3.35 TB/s; its
// operations take a few microseconds at the card's 67 TFLOP/s float32).
//
// What the design does about it: every kernel reads each input byte once
// and writes each output byte once, with nothing in between in device
// memory. In K1 and K2 one thread owns one pixel of the pass's coarsest grid
// and keeps its whole 2^k x 2^k input block in registers, so the k fused
// levels need no shared memory and no barrier; K3 gives a thread at most a
// 4x8 output tile (see idwt_dequant_kernel); K4 and K5, one level each, give a
// thread one 2x2 block and read the reference's tile padding as an index
// clamp instead of a padded copy. A warp's 32 threads own 32 neighbouring
// blocks, so every row access of the warp is one contiguous span, issued as
// loads/stores of up to 16 bytes. Element offsets are 64-bit (a batched
// input passes 2^31 elements easily).
//
// Interface: plain C, bound with ctypes. The kernels allocate nothing and
// never synchronise; each entry point launches on the stream it is given and
// returns cudaGetLastError(). Every base pointer must be 16-byte aligned.
//
// A host C++ compiler builds this same file against host_emulation.h, which
// runs each launch thread by thread on the CPU; the tests hold that build
// against the plain PyTorch twins (tests/test_torch_kernels_host.py).

#include <type_traits>

#include "launch.cuh"
#include "haar_kernels.cuh"

namespace wicca {
namespace {

// ---------------------------------------------------------------------------
// K1: icon. Pass 1 reads uint8 and forms exact int32 sums over the whole
// 2^m x 2^m support (m <= 6: sums < 2^24, so one multiply by 0.25^m is the
// float chain's exact value). Depths past 6 continue from the float32
// depth-6 value with <= 3 float levels per pass, in the reference
// association.
// ---------------------------------------------------------------------------

template <int M, bool F32_OUT>
__global__ void icon_u8_kernel(const uint8_t* __restrict__ x, void* __restrict__ out, int64_t planes,
                               int64_t ho, int64_t wo, float scale) {
  constexpr int S = 1 << M;
  const int64_t w = wo * S;
  const int64_t j = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
  if (j >= wo) return;
  for (int64_t p = blockIdx.z; p < planes; p += gridDim.z) {
    for (int64_t i = blockIdx.y * static_cast<int64_t>(blockDim.y) + threadIdx.y; i < ho;
         i += static_cast<int64_t>(gridDim.y) * blockDim.y) {
      const uint8_t* src = x + (p * ho + i) * S * w + j * S;
      int32_t sum = 0;
#pragma unroll 4
      for (int r = 0; r < S; ++r) {
        uint8_t row[S];
        load_row<uint8_t, S>(src + r * w, row);
#pragma unroll
        for (int c = 0; c < S; ++c) sum += row[c];
      }
      const float v = mul_rn(static_cast<float>(sum), scale);
      const int64_t o = (p * ho + i) * wo + j;
      if (F32_OUT)
        static_cast<float*>(out)[o] = v;
      else
        static_cast<uint8_t*>(out)[o] = to_u8(v);
    }
  }
}

template <int K, bool F32_OUT>
__global__ void icon_f32_kernel(const float* __restrict__ x, void* __restrict__ out, int64_t planes,
                                int64_t ho, int64_t wo) {
  constexpr int S = 1 << K;
  const int64_t w = wo * S;
  const int64_t j = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
  if (j >= wo) return;
  for (int64_t p = blockIdx.z; p < planes; p += gridDim.z) {
    for (int64_t i = blockIdx.y * static_cast<int64_t>(blockDim.y) + threadIdx.y; i < ho;
         i += static_cast<int64_t>(gridDim.y) * blockDim.y) {
      const float* src = x + (p * ho + i) * S * w + j * S;
      float v[S * S];
#pragma unroll
      for (int r = 0; r < S; ++r) load_row<float, S>(src + r * w, v + r * S);
      // level by level, in place: output (a, b) of a level only reads
      // entries at or after index a * n + b
#pragma unroll
      for (int n = S / 2; n >= 1; n /= 2) {
#pragma unroll
        for (int a = 0; a < n; ++a) {
#pragma unroll
          for (int b = 0; b < n; ++b) {
            const float* q = v + (2 * a) * (2 * n) + 2 * b;
            v[a * n + b] = icon_level(q[0], q[1], q[2 * n], q[2 * n + 1]);
          }
        }
      }
      const int64_t o = (p * ho + i) * wo + j;
      if (F32_OUT)
        static_cast<float*>(out)[o] = v[0];
      else
        static_cast<uint8_t*>(out)[o] = to_u8(v[0]);
    }
  }
}

// ---------------------------------------------------------------------------
// K2: k <= 3 fused forward levels + deadzone quantization.
// From uint8, levels run on exact int32 sums and each band is
// f32(raw) * 0.25^lvl; from float32, every level scales by 0.25.
// ---------------------------------------------------------------------------

struct DwtArgs {
  void* det[9];    // lh, hl, hh of level 1, then level 2, ... (fine -> coarse)
  float* ll;       // coarsest LL, float32
  float inv[9];    // f32(1/step) per band
  float qmax[3];   // 127 or 32767 per level
  int is16[3];     // code dtype per level: 0 int8, 1 int16
};

template <typename C, int N>
__device__ __forceinline__ void store_codes(void* plane, int64_t off, const float* band, float inv,
                                            float qmax) {
  C c[N];
#pragma unroll
  for (int b = 0; b < N; ++b) c[b] = static_cast<C>(quantize(band[b], inv, qmax));
  store_row<C, N>(static_cast<C*>(plane) + off, c);
}

template <int K, int L, bool FROM_U8, typename T>
__device__ __forceinline__ void dwt_level(T* v, const DwtArgs& a, int64_t p, int64_t i, int64_t j,
                                          int64_t hc, int64_t wc) {
  constexpr int n = (1 << K) >> L;  // this thread's patch side at level L
  const int64_t hl = hc << (K - L), wl = wc << (K - L);
  const int64_t base = (p * hl + i * n) * wl + j * n;
  const float sc = FROM_U8 ? quarter_pow(L) : 0.25f;
  const int is16 = a.is16[L - 1];
  const float qmax = a.qmax[L - 1];
#pragma unroll
  for (int r = 0; r < n; ++r) {
    float band[3][n];
#pragma unroll
    for (int c = 0; c < n; ++c) {
      const T* q = v + (2 * r) * (2 * n) + 2 * c;
      const Quad<T> d = haar_fwd_raw(q[0], q[1], q[2 * n], q[2 * n + 1]);
      // in place: entry r * n + c is at or before every entry still unread
      if constexpr (FROM_U8)
        v[r * n + c] = d.ll;  // raw sums stay exact; the scale is applied per band
      else
        v[r * n + c] = mul_rn(d.ll, 0.25f);
      band[0][c] = mul_rn(static_cast<float>(d.lh), sc);
      band[1][c] = mul_rn(static_cast<float>(d.hl), sc);
      band[2][c] = mul_rn(static_cast<float>(d.hh), sc);
    }
#pragma unroll
    for (int s = 0; s < 3; ++s) {
      const int slot = (L - 1) * 3 + s;
      if (is16)
        store_codes<int16_t, n>(a.det[slot], base + r * wl, band[s], a.inv[slot], qmax);
      else
        store_codes<int8_t, n>(a.det[slot], base + r * wl, band[s], a.inv[slot], qmax);
    }
  }
}

template <int K, bool FROM_U8>
__global__ void dwt_quant_kernel(const void* __restrict__ xin, int64_t planes, int64_t hc, int64_t wc,
                                 DwtArgs a) {
  using In = typename std::conditional<FROM_U8, uint8_t, float>::type;
  using T = typename std::conditional<FROM_U8, int32_t, float>::type;
  constexpr int S = 1 << K;
  const int64_t w = wc * S;
  const int64_t j = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
  if (j >= wc) return;
  for (int64_t p = blockIdx.z; p < planes; p += gridDim.z) {
    for (int64_t i = blockIdx.y * static_cast<int64_t>(blockDim.y) + threadIdx.y; i < hc;
         i += static_cast<int64_t>(gridDim.y) * blockDim.y) {
      const In* src = static_cast<const In*>(xin) + (p * hc + i) * S * w + j * S;
      T v[S * S];
#pragma unroll
      for (int r = 0; r < S; ++r) {
        In row[S];
        load_row<In, S>(src + r * w, row);
#pragma unroll
        for (int c = 0; c < S; ++c) v[r * S + c] = static_cast<T>(row[c]);
      }
      dwt_level<K, 1, FROM_U8>(v, a, p, i, j, hc, wc);
      if constexpr (K >= 2) dwt_level<K, 2, FROM_U8>(v, a, p, i, j, hc, wc);
      if constexpr (K >= 3) dwt_level<K, 3, FROM_U8>(v, a, p, i, j, hc, wc);
      const int64_t o = (p * hc + i) * wc + j;
      if constexpr (FROM_U8)
        a.ll[o] = mul_rn(static_cast<float>(v[0]), quarter_pow(K));
      else
        a.ll[o] = v[0];
    }
  }
}

// ---------------------------------------------------------------------------
// K3: dequantization + k <= 3 fused inverse levels, float32 or uint8 out.
// ---------------------------------------------------------------------------

struct IdwtArgs {
  const void* det[9];  // lh, hl, hh of level 1, then level 2, ... (fine -> coarse)
  float step[9];       // f32 dequantization step per band
};

// The code dtype of each level is a template bit (MASK16 bit l-1 set: level l
// is int16), not a runtime branch: with a branch around every code load the
// thread waited out each load in turn, and the fine pass ran at a quarter of
// its byte bound (PERF.md).
template <int MASK16, int L>
using CodeT = typename std::conditional<((MASK16 >> (L - 1)) & 1) != 0, int16_t, int8_t>::type;

template <typename C, int N>
__device__ __forceinline__ void load_bin_points(const void* plane, int64_t off, float* dst, float offset) {
  C c[N];
  load_row<C, N>(static_cast<const C*>(plane) + off, c);
#pragma unroll
  for (int b = 0; b < N; ++b) dst[b] = bin_point(static_cast<float>(c[b]), offset);
}

// Dequantize and invert level L on this thread's NR x NC patch of level-L
// coefficients (NR = 2^(G-L), NC = NR * TW), held in v with row stride NC;
// v becomes the 2NR x 2NC patch of level L-1. (hg, wg) are the level-G plane
// dims, (i, jj) the thread's row and column-group on that grid.
template <int G, int L, int TW, int MASK16>
__device__ __forceinline__ void idwt_level(float* v, const IdwtArgs& a, float offset, int64_t p, int64_t i,
                                           int64_t jj, int64_t hg, int64_t wg) {
  constexpr int NR = 1 << (G - L), NC = NR * TW;
  const int64_t hl = hg << (G - L), wl = wg << (G - L);
  const int64_t base = (p * hl + i * NR) * wl + jj * NC;
  // backwards, in place: outputs of (r, c) land at or after index r * NC + c,
  // where every coefficient has already been read
#pragma unroll
  for (int r = NR - 1; r >= 0; --r) {
    float u[3][NC];
#pragma unroll
    for (int s = 0; s < 3; ++s)
      load_bin_points<CodeT<MASK16, L>, NC>(a.det[(L - 1) * 3 + s], base + r * wl, u[s], offset);
    const float s_lh = a.step[(L - 1) * 3], s_hl = a.step[(L - 1) * 3 + 1], s_hh = a.step[(L - 1) * 3 + 2];
#pragma unroll
    for (int c = NC - 1; c >= 0; --c) {
      const float ll = v[r * NC + c];
      float* q = v + (2 * r) * (2 * NC) + 2 * c;
      haar_inv_dequant(ll, u[0][c], u[1][c], u[2][c], s_lh, s_hl, s_hh, q[0], q[1], q[2 * NC], q[2 * NC + 1]);
    }
  }
}

// A thread expands TW neighbouring coefficients of the level-G grid,
// G = min(K, 2), into a 2^G x (2^G * TW) output tile in registers. For K = 3,
// TW = 2: the thread's two level-2 coefficients share one level-3 quad,
// which it recomputes (two threads share it), and its rows of level-1 codes
// are 4 bytes, so a warp reads 128 contiguous bytes of each plane per row.
// (A thread per level-3 pixel, an 8x8 tile, held 117-119 registers; PERF.md.)
template <int K, bool EMIT_U8, int MASK16>
__global__ void idwt_dequant_kernel(const float* __restrict__ ll, void* __restrict__ out, int64_t planes,
                                    int64_t hc, int64_t wc, float offset, IdwtArgs a) {
  constexpr int G = K < 2 ? K : 2;
  constexpr int TW = K > G ? 2 : 1;
  constexpr int S = 1 << G;  // output rows per thread; columns are S * TW
  const int64_t hg = hc << (K - G), wg = wc << (K - G);
  const int64_t w = wg * S;
  const int64_t jj = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
  if (jj >= wg / TW) return;
  for (int64_t p = blockIdx.z; p < planes; p += gridDim.z) {
    for (int64_t i = blockIdx.y * static_cast<int64_t>(blockDim.y) + threadIdx.y; i < hg;
         i += static_cast<int64_t>(gridDim.y) * blockDim.y) {
      float v[S * S * TW];
      if constexpr (K == G) {
        v[0] = ll[(p * hc + i) * wc + jj];
      } else {
        // level-3 pixel (i / 2, jj); this thread takes row i % 2 of its quad
        const int64_t o = (p * hc + (i >> 1)) * wc + jj;
        float u[3];
#pragma unroll
        for (int s = 0; s < 3; ++s) {
          const auto* codes = static_cast<const CodeT<MASK16, K>*>(a.det[(K - 1) * 3 + s]);
          u[s] = bin_point(static_cast<float>(codes[o]), offset);
        }
        float o00, o01, o10, o11;
        haar_inv_dequant(ll[o], u[0], u[1], u[2], a.step[(K - 1) * 3], a.step[(K - 1) * 3 + 1],
                         a.step[(K - 1) * 3 + 2], o00, o01, o10, o11);
        v[0] = (i & 1) ? o10 : o00;
        v[1] = (i & 1) ? o11 : o01;
      }
      if constexpr (G >= 2) idwt_level<G, 2, TW, MASK16>(v, a, offset, p, i, jj, hg, wg);
      idwt_level<G, 1, TW, MASK16>(v, a, offset, p, i, jj, hg, wg);
      const int64_t base = (p * hg + i) * S * w + jj * S * TW;
#pragma unroll
      for (int r = 0; r < S; ++r) {
        if (EMIT_U8) {
          uint8_t row[S * TW];
#pragma unroll
          for (int c = 0; c < S * TW; ++c) row[c] = to_u8(v[r * S * TW + c]);
          store_row<uint8_t, S * TW>(static_cast<uint8_t*>(out) + base + r * w, row);
        } else {
          store_row<float, S * TW>(static_cast<float*>(out) + base + r * w, v + r * S * TW);
        }
      }
    }
  }
}

// ---------------------------------------------------------------------------
// K4: one Haar level from float32, details quantized (int8/int16 codes) or
// kept float32. The reference pads a large input to (512, 1024) tile
// multiples by edge replication; here that padding is an index clamp on the
// read (H and W are even, so a padded pair has both members on the edge).
// One thread per output coefficient: a float2 from each of its two rows.
// ---------------------------------------------------------------------------

enum DetailMode { kCodes8 = 0, kCodes16 = 1, kFloat = 2 };

template <int MODE>
using DetailT = typename std::conditional<MODE == kCodes8, int8_t,
                                          typename std::conditional<MODE == kCodes16, int16_t, float>::type>::type;

template <int MODE>
__global__ void haar_level_fwd_kernel(const float* __restrict__ x, int64_t planes, int64_t h, int64_t w, int64_t ho,
                                 int64_t wo, float* __restrict__ ll, void* __restrict__ lh, void* __restrict__ hl,
                                 void* __restrict__ hh, float inv, float qmax) {
  using D = DetailT<MODE>;
  const int64_t j = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
  if (j >= wo) return;
  for (int64_t p = blockIdx.z; p < planes; p += gridDim.z) {
    for (int64_t i = blockIdx.y * static_cast<int64_t>(blockDim.y) + threadIdx.y; i < ho;
         i += static_cast<int64_t>(gridDim.y) * blockDim.y) {
      const int64_t r = 2 * i < h ? 2 * i : h - 2;  // rows r, r+1 (both h-1 past the edge)
      float top[2], bot[2];
      if (2 * j < w) {
        load_row<float, 2>(x + (p * h + r) * w + 2 * j, top);
        load_row<float, 2>(x + (p * h + r + 1) * w + 2 * j, bot);
      } else {
        top[0] = top[1] = x[(p * h + r) * w + w - 1];
        bot[0] = bot[1] = x[(p * h + r + 1) * w + w - 1];
      }
      if (2 * i >= h) {
        top[0] = bot[0];
        top[1] = bot[1];
      }
      const Quad<float> d = haar_fwd_raw(top[0], top[1], bot[0], bot[1]);
      const int64_t o = (p * ho + i) * wo + j;
      ll[o] = mul_rn(d.ll, 0.25f);
      const float band[3] = {mul_rn(d.lh, 0.25f), mul_rn(d.hl, 0.25f), mul_rn(d.hh, 0.25f)};
      void* dst[3] = {lh, hl, hh};
#pragma unroll
      for (int s = 0; s < 3; ++s) {
        if constexpr (MODE == kFloat)
          static_cast<D*>(dst[s])[o] = band[s];
        else
          static_cast<D*>(dst[s])[o] = static_cast<D>(quantize(band[s], inv, qmax));
      }
    }
  }
}

// ---------------------------------------------------------------------------
// K5: dequantize (q + 0.5 sign q) * f32(step) — or take float bands as they
// are — and invert one Haar level. Bands of (h, w) are read as if edge-padded
// to the (hp, wp) grid; one thread per grid point writes its 2x2 outputs.
// ---------------------------------------------------------------------------

template <int MODE>
__global__ void haar_level_inv_kernel(const float* __restrict__ ll, const void* __restrict__ lh,
                                  const void* __restrict__ hl, const void* __restrict__ hh, int64_t planes,
                                  int64_t h, int64_t w, int64_t hp, int64_t wp, float step,
                                  float* __restrict__ out) {
  using D = DetailT<MODE>;
  const int64_t j = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
  if (j >= wp) return;
  const int64_t jc = j < w ? j : w - 1;
  for (int64_t p = blockIdx.z; p < planes; p += gridDim.z) {
    for (int64_t i = blockIdx.y * static_cast<int64_t>(blockDim.y) + threadIdx.y; i < hp;
         i += static_cast<int64_t>(gridDim.y) * blockDim.y) {
      const int64_t s = (p * h + (i < h ? i : h - 1)) * w + jc;
      const float l = ll[s];
      const float b_lh = static_cast<float>(static_cast<const D*>(lh)[s]);
      const float b_hl = static_cast<float>(static_cast<const D*>(hl)[s]);
      const float b_hh = static_cast<float>(static_cast<const D*>(hh)[s]);
      float o[4];
      if constexpr (MODE == kFloat)
        haar_inv(l, b_lh, b_hl, b_hh, o[0], o[1], o[2], o[3]);
      else
        haar_inv_dequant(l, bin_point(b_lh, 0.5f), bin_point(b_hl, 0.5f), bin_point(b_hh, 0.5f), step, step, step,
                         o[0], o[1], o[2], o[3]);
      float* dst = out + (p * 2 * hp + 2 * i) * (2 * wp) + 2 * j;
      store_row<float, 2>(dst, o);
      store_row<float, 2>(dst + 2 * wp, o + 2);
    }
  }
}

template <int M>
void launch_icon_u8(const uint8_t* x, void* out, int f32_out, int64_t planes, int64_t ho, int64_t wo,
                    float scale, cudaStream_t st) {
  auto* kernel = f32_out ? icon_u8_kernel<M, true> : icon_u8_kernel<M, false>;
  WICCA_LAUNCH(kernel, grid_for(planes, ho, wo), dim3(kBlockX, kBlockY), st, x, out, planes, ho, wo, scale);
}

template <int K>
void launch_icon_f32(const float* x, void* out, int f32_out, int64_t planes, int64_t ho, int64_t wo,
                     cudaStream_t st) {
  auto* kernel = f32_out ? icon_f32_kernel<K, true> : icon_f32_kernel<K, false>;
  WICCA_LAUNCH(kernel, grid_for(planes, ho, wo), dim3(kBlockX, kBlockY), st, x, out, planes, ho, wo);
}

template <int K>
void launch_dwt(const void* x, int from_u8, int64_t planes, int64_t hc, int64_t wc, const DwtArgs& a,
                cudaStream_t st) {
  auto* kernel = from_u8 ? dwt_quant_kernel<K, true> : dwt_quant_kernel<K, false>;
  WICCA_LAUNCH(kernel, grid_for(planes, hc, wc), dim3(kBlockX, kBlockY), st, x, planes, hc, wc, a);
}

// Launch the instance for this pass's code-dtype mask (searched at compile
// time from M upwards).
template <int K, int M = 0>
void launch_idwt(const float* ll, void* out, int emit_u8, int mask16, int64_t planes, int64_t hc, int64_t wc,
                 float offset, const IdwtArgs& a, cudaStream_t st) {
  if constexpr (M < (1 << K)) {
    if (mask16 != M) {
      launch_idwt<K, M + 1>(ll, out, emit_u8, mask16, planes, hc, wc, offset, a, st);
      return;
    }
    constexpr int G = K < 2 ? K : 2, TW = K > G ? 2 : 1;  // thread grid: level-G rows, TW-column groups
    const dim3 grid = grid_for(planes, hc << (K - G), (wc << (K - G)) / TW);
    auto* kernel = emit_u8 ? idwt_dequant_kernel<K, true, M> : idwt_dequant_kernel<K, false, M>;
    WICCA_LAUNCH(kernel, grid, dim3(kBlockX, kBlockY), st, ll, out, planes, hc, wc, offset, a);
  }
}

template <int MODE>
void launch_dwt_level(const float* x, int64_t planes, int64_t h, int64_t w, int64_t ho, int64_t wo, float* ll,
                      void* lh, void* hl, void* hh, float inv, float qmax, cudaStream_t st) {
  WICCA_LAUNCH(haar_level_fwd_kernel<MODE>, grid_for(planes, ho, wo), dim3(kBlockX, kBlockY), st, x, planes, h, w, ho,
               wo, ll, lh, hl, hh, inv, qmax);
}

template <int MODE>
void launch_idwt_level(const float* ll, const void* lh, const void* hl, const void* hh, int64_t planes, int64_t h,
                       int64_t w, int64_t hp, int64_t wp, float step, float* out, cudaStream_t st) {
  WICCA_LAUNCH(haar_level_inv_kernel<MODE>, grid_for(planes, hp, wp), dim3(kBlockX, kBlockY), st, ll, lh, hl, hh,
               planes, h, w, hp, wp, step, out);
}

}  // namespace
}  // namespace wicca

using namespace wicca;

extern "C" {

// K1 pass 1: x (planes, ho * 2^m, wo * 2^m) uint8 -> out (planes, ho, wo),
// uint8 (final pass) or float32 (depth > 6). scale = f32(0.25^m), 1 <= m <= 6.
int wicca_icon_u8(const void* x, void* out, int f32_out, int64_t planes, int64_t ho, int64_t wo, int m,
                  float scale, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint8_t* xu = static_cast<const uint8_t*>(x);
  switch (m) {
    case 1: launch_icon_u8<1>(xu, out, f32_out, planes, ho, wo, scale, st); break;
    case 2: launch_icon_u8<2>(xu, out, f32_out, planes, ho, wo, scale, st); break;
    case 3: launch_icon_u8<3>(xu, out, f32_out, planes, ho, wo, scale, st); break;
    case 4: launch_icon_u8<4>(xu, out, f32_out, planes, ho, wo, scale, st); break;
    case 5: launch_icon_u8<5>(xu, out, f32_out, planes, ho, wo, scale, st); break;
    case 6: launch_icon_u8<6>(xu, out, f32_out, planes, ho, wo, scale, st); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// K1 later passes: x (planes, ho * 2^k, wo * 2^k) float32 -> k float levels.
int wicca_icon_f32(const void* x, void* out, int f32_out, int64_t planes, int64_t ho, int64_t wo, int k,
                   void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  switch (k) {
    case 1: launch_icon_f32<1>(xf, out, f32_out, planes, ho, wo, st); break;
    case 2: launch_icon_f32<2>(xf, out, f32_out, planes, ho, wo, st); break;
    case 3: launch_icon_f32<3>(xf, out, f32_out, planes, ho, wo, st); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// K2: x (planes, hc * 2^k, wc * 2^k) uint8 or float32 -> det[3k] code planes
// (level l: (planes, hc << (k-l), wc << (k-l)), int8 or int16 per is16[l-1])
// and ll (planes, hc, wc) float32.
int wicca_dwt_quant(const void* x, int from_u8, int64_t planes, int64_t hc, int64_t wc, int k,
                    void* const* det, void* ll, const float* inv, const int* is16, void* stream) {
  if (k < 1 || k > 3) return static_cast<int>(cudaErrorInvalidValue);
  DwtArgs a{};
  for (int s = 0; s < 3 * k; ++s) {
    a.det[s] = det[s];
    a.inv[s] = inv[s];
  }
  for (int l = 0; l < k; ++l) {
    a.is16[l] = is16[l];
    a.qmax[l] = is16[l] ? 32767.0f : 127.0f;
  }
  a.ll = static_cast<float*>(ll);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (k) {
    case 1: launch_dwt<1>(x, from_u8, planes, hc, wc, a, st); break;
    case 2: launch_dwt<2>(x, from_u8, planes, hc, wc, a, st); break;
    default: launch_dwt<3>(x, from_u8, planes, hc, wc, a, st); break;
  }
  return static_cast<int>(cudaGetLastError());
}

// K3: ll (planes, hc, wc) float32 + det[3k] code planes laid out as K2 writes
// them -> out (planes, hc * 2^k, wc * 2^k), float32 or uint8 (emit_u8).
int wicca_idwt_dequant(const void* ll, const void* const* det, const int* is16, const float* step,
                       float offset, int k, int64_t planes, int64_t hc, int64_t wc, void* out, int emit_u8,
                       void* stream) {
  if (k < 1 || k > 3) return static_cast<int>(cudaErrorInvalidValue);
  IdwtArgs a{};
  for (int s = 0; s < 3 * k; ++s) {
    a.det[s] = det[s];
    a.step[s] = step[s];
  }
  int mask16 = 0;
  for (int l = 0; l < k; ++l) mask16 |= (is16[l] ? 1 : 0) << l;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* llf = static_cast<const float*>(ll);
  switch (k) {
    case 1: launch_idwt<1>(llf, out, emit_u8, mask16, planes, hc, wc, offset, a, st); break;
    case 2: launch_idwt<2>(llf, out, emit_u8, mask16, planes, hc, wc, offset, a, st); break;
    default: launch_idwt<3>(llf, out, emit_u8, mask16, planes, hc, wc, offset, a, st); break;
  }
  return static_cast<int>(cudaGetLastError());
}

// K4: x (planes, h, w) float32, h and w even -> ll (planes, ho, wo) float32
// and lh, hl, hh (planes, ho, wo), (ho, wo) >= (h/2, w/2) the tile-padded
// band dims. mode: 0 int8 codes, 1 int16 codes, 2 float32 details.
int wicca_dwt_level(const void* x, int64_t planes, int64_t h, int64_t w, int64_t ho, int64_t wo, void* ll,
                    void* lh, void* hl, void* hh, int mode, float inv, float qmax, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* xf = static_cast<const float*>(x);
  float* llf = static_cast<float*>(ll);
  switch (mode) {
    case kCodes8: launch_dwt_level<kCodes8>(xf, planes, h, w, ho, wo, llf, lh, hl, hh, inv, qmax, st); break;
    case kCodes16: launch_dwt_level<kCodes16>(xf, planes, h, w, ho, wo, llf, lh, hl, hh, inv, qmax, st); break;
    case kFloat: launch_dwt_level<kFloat>(xf, planes, h, w, ho, wo, llf, lh, hl, hh, inv, qmax, st); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// K5: ll float32 and lh, hl, hh (planes, h, w), read edge-padded to
// (hp, wp) -> out (planes, 2 hp, 2 wp) float32. mode as for K4; step is the
// float32 dequantization step (unused for mode 2).
int wicca_idwt_level(const void* ll, const void* lh, const void* hl, const void* hh, int64_t planes, int64_t h,
                     int64_t w, int64_t hp, int64_t wp, int mode, float step, void* out, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* llf = static_cast<const float*>(ll);
  float* o = static_cast<float*>(out);
  switch (mode) {
    case kCodes8: launch_idwt_level<kCodes8>(llf, lh, hl, hh, planes, h, w, hp, wp, step, o, st); break;
    case kCodes16: launch_idwt_level<kCodes16>(llf, lh, hl, hh, planes, h, w, hp, wp, step, o, st); break;
    case kFloat: launch_idwt_level<kFloat>(llf, lh, hl, hh, planes, h, w, hp, wp, step, o, st); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
