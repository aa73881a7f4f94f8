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
// (but K3's float32 tiles, which read LL3 and the level-3 codes twice) and
// writes each output byte once, with nothing in between in device memory.
// In K1 and K2 one thread owns one pixel of the pass's coarsest grid and
// keeps its whole 2^k x 2^k input block in registers, so the k fused levels
// need no shared memory and no barrier; K3 gives a thread an output tile of
// 8 x 16 for uint8 and 4 x 8 for float32 at k = 3 (see
// idwt_dequant_kernel_quads); K4 and K5, one level each, give a thread one
// 2x2 block and read the reference's tile padding as an index clamp instead
// of a padded copy. A warp's 32 threads own 32 neighbouring blocks, so every
// row access of the warp is one contiguous span, issued as loads/stores of
// up to 16 bytes. Element offsets are 64-bit (a batched input passes 2^31
// elements easily).
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

// k <= 2. Dequantize and invert level L on this thread's N x N patch of
// level-L coefficients (N = 2^(K-L)), held in v with row stride N; v becomes
// the 2N x 2N patch of level L-1. (hk, wk) are the level-K plane dims, (i, j)
// the thread's pixel on that grid.
template <int K, int L, int MASK16>
__device__ __forceinline__ void idwt_level(float* v, const IdwtArgs& a, float offset, int64_t p, int64_t i,
                                           int64_t j, int64_t hk, int64_t wk) {
  constexpr int N = 1 << (K - L);
  const int64_t hl = hk << (K - L), wl = wk << (K - L);
  const int64_t base = (p * hl + i * N) * wl + j * N;
  // backwards, in place: outputs of (r, c) land at or after index r * N + c,
  // where every coefficient has already been read
#pragma unroll
  for (int r = N - 1; r >= 0; --r) {
    float u[3][N];
#pragma unroll
    for (int s = 0; s < 3; ++s)
      load_bin_points<CodeT<MASK16, L>, N>(a.det[(L - 1) * 3 + s], base + r * wl, u[s], offset);
    const float s_lh = a.step[(L - 1) * 3], s_hl = a.step[(L - 1) * 3 + 1], s_hh = a.step[(L - 1) * 3 + 2];
#pragma unroll
    for (int c = N - 1; c >= 0; --c) {
      const float ll = v[r * N + c];
      float* q = v + (2 * r) * (2 * N) + 2 * c;
      haar_inv_dequant(ll, u[0][c], u[1][c], u[2][c], s_lh, s_hl, s_hh, q[0], q[1], q[2 * N], q[2 * N + 1]);
    }
  }
}

// k <= 2: a thread expands one pixel of the level-k grid into its
// 2^k x 2^k output tile in registers.
template <int K, bool EMIT_U8, int MASK16>
__global__ void idwt_dequant_kernel(const float* __restrict__ ll, void* __restrict__ out, int64_t planes,
                                    int64_t hc, int64_t wc, float offset, IdwtArgs a) {
  static_assert(K >= 1 && K <= 2, "k = 3 is idwt_dequant_kernel_quads");
  constexpr int S = 1 << K;
  const int64_t w = wc * S;
  const int64_t j = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
  if (j >= wc) return;
  for (int64_t p = blockIdx.z; p < planes; p += gridDim.z) {
    for (int64_t i = blockIdx.y * static_cast<int64_t>(blockDim.y) + threadIdx.y; i < hc;
         i += static_cast<int64_t>(gridDim.y) * blockDim.y) {
      float v[S * S];
      v[0] = ll[(p * hc + i) * wc + j];
      if constexpr (K >= 2) idwt_level<K, 2, MASK16>(v, a, offset, p, i, j, hc, wc);
      idwt_level<K, 1, MASK16>(v, a, offset, p, i, j, hc, wc);
      const int64_t base = (p * hc + i) * S * w + j * S;
#pragma unroll
      for (int r = 0; r < S; ++r) {
        if (EMIT_U8) {
          uint8_t row[S];
#pragma unroll
          for (int c = 0; c < S; ++c) row[c] = to_u8(v[r * S + c]);
          store_row<uint8_t, S>(static_cast<uint8_t*>(out) + base + r * w, row);
        } else {
          store_row<float, S>(static_cast<float*>(out) + base + r * w, v + r * S);
        }
      }
    }
  }
}

// k = 3 (idwt_dequant_kernel_quads). A thread owns a tile: Q level-3
// coefficients side by side in one row, and H of the two level-2 rows of
// their quads, so a 4H x 8Q output tile. uint8 output takes Q = H = 2 (8 x
// 16: an output row is one 16-byte store, a warp's row 512 contiguous
// bytes); float32 takes Q = H = 1 (4 x 8, half a quad: two threads read the
// same LL3 value and level-3 codes). The thread alone reads its tile's other
// inputs, in loads issued together at its start: LL3 as Q floats, the
// level-3 codes as Q per band, the level-2 codes as H rows of 2Q, the
// level-1 codes as 2H rows of 4Q (twice the bytes for int16), a warp's row
// of a plane one contiguous span. It then rebuilds its quads coarse to fine
// and stores each pair of output rows as soon as it is made, so that its
// registers hold the packed codes and a pair of quads' level-1 LL, never
// the tile. Codes become floats, and results uint8, by float additions on
// their bits, not by the conversion unit, which issues a quarter as many
// results per clock: two conversions an output pixel held the pass near its
// byte bound by themselves. Measured against other tiles (PERF.md): four
// quads a thread (8 x 32, 16-byte code loads, as the first design of this
// kernel had it) held 102-255 registers and ran at 45-50% of the bound, one
// quad at 78%, two at 85%.
//
// VEC is the alignment the level-3 width wc allows, in level-3 columns: with
// wc a multiple of Q every row of every plane starts aligned to its tile
// row (VEC = Q); otherwise (VEC = 1) each access covers one level-3 column
// and the last tile of a row is masked to the wc % Q columns that exist.

// Elements per access to a tile's row of F * Q elements of T (F: the level's
// columns per level-3 column), which starts F * VEC-element aligned.
template <typename T, int F, int VEC>
WICCA_HDC int access_of() {
  return int(sizeof(T)) * F * VEC < 16 ? F * VEC : 16 / int(sizeof(T));
}

// Read LL3's row of the tile; accesses past its nv level-3 columns read
// nothing and give zeros.
template <int Q, int VEC>
WICCA_D void load_ll_row(const float* src, float* dst, int nv) {
  constexpr int E = access_of<float, 1, VEC>();
#pragma unroll
  for (int c = 0; c < Q; c += E) {
    if (VEC == Q || c < nv) {
      const Vec<float, E> t = *reinterpret_cast<const Vec<float, E>*>(src + c);
#pragma unroll
      for (int e = 0; e < E; ++e) dst[c + e] = t.v[e];
    } else {
#pragma unroll
      for (int e = 0; e < E; ++e) dst[c + e] = 0.0f;
    }
  }
}

// Read a tile's row of F * Q codes C into packed 32-bit words, as they lie
// in memory; accesses past its nv level-3 columns read nothing and give zero
// codes.
template <typename C, int F, int Q, int VEC>
WICCA_D void load_code_row(const C* src, uint32_t* w, int nv) {
  constexpr int N = F * Q, E = access_of<C, F, VEC>(), B = int(sizeof(C));
  if constexpr (E * B >= 4) {
    constexpr int EW = E * B / 4;  // words per access
#pragma unroll
    for (int c = 0; c < N; c += E) {
      if (VEC == Q || c < nv * F) {
        const Vec<uint32_t, EW> t = *reinterpret_cast<const Vec<uint32_t, EW>*>(src + c);
#pragma unroll
        for (int e = 0; e < EW; ++e) w[c * B / 4 + e] = t.v[e];
      } else {
#pragma unroll
        for (int e = 0; e < EW; ++e) w[c * B / 4 + e] = 0;
      }
    }
  } else {  // accesses narrower than a word: the words are assembled
    using U = typename std::conditional<B == 1, uint8_t, uint16_t>::type;
#pragma unroll
    for (int e = 0; e < (N * B + 3) / 4; ++e) w[e] = 0;
#pragma unroll
    for (int c = 0; c < N; c += E) {
      if (VEC == Q || c < nv * F) {
        const Vec<U, E> t = *reinterpret_cast<const Vec<U, E>*>(src + c);
#pragma unroll
        for (int e = 0; e < E; ++e) w[(c + e) * B / 4] |= uint32_t(t.v[e]) << (8 * ((c + e) * B % 4));
      }
    }
  }
}

// One access of output, marked evict-first (st.global.cs): the pass writes
// each output byte once and reads none back, so the lines need not stay in
// the caches.
template <typename T, int E>
WICCA_D void store_once(T* dst, const Vec<T, E>& t) {
#if defined(__CUDA_ARCH__)
  if constexpr (sizeof(t) == 16)
    __stcs(reinterpret_cast<int4*>(dst), *reinterpret_cast<const int4*>(&t));
  else if constexpr (sizeof(t) == 8)
    __stcs(reinterpret_cast<int2*>(dst), *reinterpret_cast<const int2*>(&t));
  else
    *reinterpret_cast<Vec<T, E>*>(dst) = t;
#else
  *reinterpret_cast<Vec<T, E>*>(dst) = t;
#endif
}

// Write N elements from a quad boundary in accesses of E; `valid` of them
// exist.
template <typename T, int N, int E, bool MASKED>
WICCA_D void store_tile_row(T* dst, const T* src, int valid) {
#pragma unroll
  for (int c = 0; c < N; c += E) {
    if (!MASKED || c < valid) {
      Vec<T, E> t;
#pragma unroll
      for (int e = 0; e < E; ++e) t.v[e] = src[c + e];
      store_once<T, E>(dst + c, t);
    }
  }
}

WICCA_HD uint32_t float_bits(float v) {
#if defined(__CUDA_ARCH__)
  return __float_as_uint(v);
#else
  uint32_t b;
  memcpy(&b, &v, 4);
  return b;
#endif
}

WICCA_HD float bits_float(uint32_t b) {
#if defined(__CUDA_ARCH__)
  return __uint_as_float(b);
#else
  float v;
  memcpy(&v, &b, 4);
  return v;
#endif
}

// Byte n of the result is byte s[4n+2 : 4n] of the eight bytes (x, y).
WICCA_HD uint32_t byte_perm(uint32_t x, uint32_t y, uint32_t s) {
#if defined(__CUDA_ARCH__)
  return __byte_perm(x, y, s);
#else
  const uint64_t xy = (uint64_t(y) << 32) | x;
  uint32_t r = 0;
  for (int n = 0; n < 4; ++n) r |= uint32_t((xy >> (8 * ((s >> (4 * n)) & 7))) & 0xFF) << (8 * n);
  return r;
#endif
}

// Code i of the packed words, exactly, as float32: its bytes with the sign
// bit flipped, under the exponent of 2^23, are the float 2^23 + 2^(b-1) + q.
template <typename C>
WICCA_D float code_float(const uint32_t* w, int i) {
  if constexpr (sizeof(C) == 1) {
    const uint32_t b = byte_perm(w[i >> 2] ^ 0x80808080u, 0x4B000000u, 0x7540u | (i & 3));
    return add_rn(bits_float(b), -8388736.0f);  // 2^23 + 2^7
  } else {
    const uint32_t k = (i & 1) * 2;
    const uint32_t b = byte_perm(w[i >> 1] ^ 0x80008000u, 0x4B000000u, 0x7500u | ((k + 1) << 4) | k);
    return add_rn(bits_float(b), -8421376.0f);  // 2^23 + 2^15
  }
}

// The bin point (bin_point) of code i of the packed words.
template <typename C>
WICCA_D float code_point(const uint32_t* w, int i, float offset) {
  return bin_point_int(code_float<C>(w, i), offset);
}

// to_u8(mul_rn(t, 0.5f)) in the low byte: t clipped to [0, 510] and halved
// exactly, plus 2^23 rounded down, is 2^23 + the truncated value.
WICCA_D uint32_t u8_bits_half(float t) {
  t = fminf(fmaxf(t, 0.0f), 510.0f);
#if defined(__CUDA_ARCH__)
  return float_bits(__fmaf_rd(t, 0.5f, 8388608.0f));
#else
  return float_bits(floorf(t * 0.5f) + 8388608.0f);
#endif
}

// The low bytes of four words, in order, as one word.
WICCA_D uint32_t pack_low_bytes(uint32_t a, uint32_t b, uint32_t c, uint32_t d) {
  return byte_perm(byte_perm(a, b, 0x0040u), byte_perm(c, d, 0x0040u), 0x5410u);
}

template <int Q, int H, int MASK16, int VEC>
struct QuadTile {
  using C1 = CodeT<MASK16, 1>;
  using C2 = CodeT<MASK16, 2>;
  using C3 = CodeT<MASK16, 3>;
  int64_t r, j;  // level-3 row over all planes (plane * hc + row), first level-3 column
  int h0;        // the quads' first level-2 row of the tile: 0, or 0 or 1 where H = 1
  int nv;        // level-3 columns of the tile that exist
  float ll[Q];
  // the codes as packed words: [band][row][word]
  uint32_t c3[3][(Q * sizeof(C3) + 3) / 4];
  uint32_t c2[3][H][(2 * Q * sizeof(C2) + 3) / 4];
  uint32_t c1[3][2 * H][(4 * Q * sizeof(C1) + 3) / 4];

  // Tile (t, jt) of a plane wc level-3 columns wide: t counts H level-2
  // rows over all planes, jt counts Q level-3 columns.
  WICCA_D void place(int64_t t, int64_t jt, int64_t wc) {
    r = H == 2 ? t : t >> 1;
    h0 = H == 2 ? 0 : static_cast<int>(t & 1);
    j = jt * Q;
    nv = VEC == Q ? Q : static_cast<int>(wc - j < Q ? wc - j : Q);
  }

  WICCA_D void load(const float* __restrict__ llp, const IdwtArgs& a, int64_t wc) {
    const int64_t o = r * wc + j;
#pragma unroll
    for (int s = 0; s < 3; ++s) {
#pragma unroll
      for (int q = 0; q < 2 * H; ++q)
        load_code_row<C1, 4, Q, VEC>(static_cast<const C1*>(a.det[s]) + (4 * r + 2 * h0 + q) * (4 * wc) + 4 * j,
                                     c1[s][q], nv);
#pragma unroll
      for (int q = 0; q < H; ++q)
        load_code_row<C2, 2, Q, VEC>(static_cast<const C2*>(a.det[3 + s]) + (2 * r + h0 + q) * (2 * wc) + 2 * j,
                                     c2[s][q], nv);
      load_code_row<C3, 1, Q, VEC>(static_cast<const C3*>(a.det[6 + s]) + o, c3[s], nv);
    }
    load_ll_row<Q, VEC>(llp + o, ll, nv);
  }
};

template <bool EMIT_U8, int Q, int H, int MASK16, int VEC>
WICCA_D void rebuild_tile(const QuadTile<Q, H, MASK16, VEC>& t, void* __restrict__ out, int64_t wc, float offset,
                          const IdwtArgs& a) {
  using Tile = QuadTile<Q, H, MASK16, VEC>;
  using C1 = typename Tile::C1;
  using C2 = typename Tile::C2;
  using C3 = typename Tile::C3;
  constexpr int P = Q < 2 ? Q : 2;  // quads rebuilt together
  constexpr bool MASKED = VEC != Q;
  const int64_t w = wc * 8;
#pragma unroll
  for (int pq = 0; pq < Q; pq += P) {
    if (MASKED && pq >= t.nv) break;
    float l1[P][2 * H][4];  // the tile's level-1 LL of quads pq ...
#pragma unroll
    for (int h = 0; h < P; ++h) {
      const int q = pq + h;
      float l2[4];  // the quad's 2 x 2 level-2 LL
      haar_inv_dequant(t.ll[q], code_point<C3>(t.c3[0], q, offset), code_point<C3>(t.c3[1], q, offset),
                       code_point<C3>(t.c3[2], q, offset), a.step[6], a.step[7], a.step[8], l2[0], l2[1], l2[2],
                       l2[3]);
#pragma unroll
      for (int rr = 0; rr < H; ++rr) {
#pragma unroll
        for (int cc = 0; cc < 2; ++cc) {
          const int k = 2 * q + cc;
          const float lv = H == 2 ? l2[2 * rr + cc] : (t.h0 ? l2[2 + cc] : l2[cc]);
          haar_inv_dequant(lv, code_point<C2>(t.c2[0][rr], k, offset), code_point<C2>(t.c2[1][rr], k, offset),
                           code_point<C2>(t.c2[2][rr], k, offset), a.step[3], a.step[4], a.step[5],
                           l1[h][2 * rr][2 * cc], l1[h][2 * rr][2 * cc + 1], l1[h][2 * rr + 1][2 * cc],
                           l1[h][2 * rr + 1][2 * cc + 1]);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < 2 * H; ++r) {
      float row[2][8 * P];  // output rows 2r and 2r + 1 of the tile, before the last step's multiply by 0.5
#pragma unroll
      for (int h = 0; h < P; ++h) {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int k = 4 * (pq + h) + c, o = 8 * h + 2 * c;
          haar_inv_dequant_x2(l1[h][r][c], code_point<C1>(t.c1[0][r], k, offset),
                              code_point<C1>(t.c1[1][r], k, offset), code_point<C1>(t.c1[2][r], k, offset), a.step[0],
                              a.step[1], a.step[2], row[0][o], row[0][o + 1], row[1][o], row[1][o + 1]);
        }
      }
      const int64_t at = (8 * t.r + 4 * t.h0 + 2 * r) * w + 8 * (t.j + pq);
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        if constexpr (EMIT_U8) {
          uint32_t words[2 * P];  // a word is 4 output columns
#pragma unroll
          for (int m = 0; m < 2 * P; ++m)
            words[m] = pack_low_bytes(u8_bits_half(row[e][4 * m]), u8_bits_half(row[e][4 * m + 1]),
                                      u8_bits_half(row[e][4 * m + 2]), u8_bits_half(row[e][4 * m + 3]));
          store_tile_row<uint32_t, 2 * P, access_of<uint8_t, 8, VEC>() / 4, MASKED>(
              reinterpret_cast<uint32_t*>(static_cast<uint8_t*>(out) + at + e * w), words, 2 * (t.nv - pq));
        } else {
#pragma unroll
          for (int m = 0; m < 8 * P; ++m) row[e][m] = mul_rn(row[e][m], 0.5f);
          store_tile_row<float, 8 * P, access_of<float, 8, VEC>(), MASKED>(static_cast<float*>(out) + at + e * w,
                                                                           row[e], 8 * (t.nv - pq));
        }
      }
    }
  }
}

// The tile of a thread: Q level-3 columns by H of each quad's two level-2
// rows, an 4H x 8Q output tile.
template <bool EMIT_U8>
struct TileOf {
  static constexpr int Q = EMIT_U8 ? 2 : 1;
  static constexpr int H = EMIT_U8 ? 2 : 1;
};

// Blocks of 32 x 8 threads over the tiles' columns and rows, and the blocks
// an SM is to hold, which bound the registers a thread: four for uint8 from
// int8 codes (64 registers; the compiler took 126 where it was asked for
// one block and ran at 76% of the byte bound, against 85%), three for the
// rest (85; float32 with no bound held 40 registers, read the codes one
// after another and took 0.44 ms against 0.35; PERF.md).
constexpr int kTileBlockX = 32, kTileBlockY = 8;

template <bool EMIT_U8, int MASK16>
constexpr int kTileBlocksPerSm = EMIT_U8 ? (MASK16 == 0 ? 4 : 3) : 2;

// rows: level-3 rows over all planes (planes * hc); wc: level-3 columns.
template <bool EMIT_U8, int MASK16, int VEC>
__global__ void __launch_bounds__(kTileBlockX * kTileBlockY, (kTileBlocksPerSm<EMIT_U8, MASK16>))
    idwt_dequant_kernel_quads(const float* __restrict__ ll, void* __restrict__ out, int64_t rows, int64_t wc,
                              float offset, IdwtArgs a) {
  constexpr int Q = TileOf<EMIT_U8>::Q, H = TileOf<EMIT_U8>::H;
  const int64_t jt = blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x;
  if (jt * Q >= wc) return;
  for (int64_t t = blockIdx.y * static_cast<int64_t>(blockDim.y) + threadIdx.y; t < rows * (2 / H);
       t += static_cast<int64_t>(gridDim.y) * blockDim.y) {
    QuadTile<Q, H, MASK16, VEC> tile;
    tile.place(t, jt, wc);
    tile.load(ll, a, wc);
    rebuild_tile<EMIT_U8, Q, H, MASK16, VEC>(tile, out, wc, offset, a);
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

// k = 3: rows level-3 rows over all planes, wc level-3 columns.
template <bool EMIT_U8, int MASK16, int VEC>
void launch_quads(const float* ll, void* out, int64_t rows, int64_t wc, float offset, const IdwtArgs& a,
                  cudaStream_t st) {
  constexpr int Q = TileOf<EMIT_U8>::Q, H = TileOf<EMIT_U8>::H;
  const int64_t gx = ((wc + Q - 1) / Q + kTileBlockX - 1) / kTileBlockX;
  const int64_t gy = (rows * (2 / H) + kTileBlockY - 1) / kTileBlockY;
  auto* kernel = idwt_dequant_kernel_quads<EMIT_U8, MASK16, VEC>;
  WICCA_LAUNCH(kernel, dim3(static_cast<unsigned>(gx), static_cast<unsigned>(gy < 65535 ? gy : 65535)),
               dim3(kTileBlockX, kTileBlockY), st, ll, out, rows, wc, offset, a);
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
    if constexpr (K == 3) {
      constexpr int Q8 = TileOf<true>::Q, Q32 = TileOf<false>::Q;
      auto* launch = emit_u8 ? (wc % Q8 == 0 ? launch_quads<true, M, Q8> : launch_quads<true, M, 1>)
                             : (wc % Q32 == 0 ? launch_quads<false, M, Q32> : launch_quads<false, M, 1>);
      launch(ll, out, planes * hc, wc, offset, a, st);
    } else {
      auto* kernel = emit_u8 ? idwt_dequant_kernel<K, true, M> : idwt_dequant_kernel<K, false, M>;
      WICCA_LAUNCH(kernel, grid_for(planes, hc, wc), dim3(kBlockX, kBlockY), st, ll, out, planes, hc, wc, offset, a);
    }
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
