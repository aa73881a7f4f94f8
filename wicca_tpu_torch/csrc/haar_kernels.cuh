// Per-pixel arithmetic of the Haar kernels (haar_kernels.cu).
//
// Everything here is plain C++ marked __host__ __device__ under nvcc, so a
// host compiler takes the same header. The float operations are written one
// rounding at a time in the association order of the JAX reference
// (wicca_tpu/ops/dwt_pallas.py): __fadd_rn/__fmul_rn on the device, which
// the compiler never contracts, and the library is built with -fmad=false.
// The only fused multiply-adds are the explicit ones of haar_inv_dequant,
// where the reference itself rounds once.
#pragma once

#include <math.h>
#include <stdint.h>

#if defined(__CUDACC__)
#define WICCA_HD __host__ __device__ __forceinline__
#define WICCA_HDC __host__ __device__ constexpr
#else
#define WICCA_HD inline
#define WICCA_HDC constexpr
#endif

namespace wicca {

#if defined(__CUDA_ARCH__)
WICCA_HD float add_rn(float a, float b) { return __fadd_rn(a, b); }
WICCA_HD float mul_rn(float a, float b) { return __fmul_rn(a, b); }
WICCA_HD float fma_rn(float a, float b, float c) { return __fmaf_rn(a, b, c); }
#else
WICCA_HD float add_rn(float a, float b) { return a + b; }
WICCA_HD float mul_rn(float a, float b) { return a * b; }
WICCA_HD float fma_rn(float a, float b, float c) { return fmaf(a, b, c); }
#endif

// 0.25**l, exact in float32 for every level used here.
WICCA_HDC float quarter_pow(int l) { return l == 0 ? 1.0f : 0.25f * quarter_pow(l - 1); }

// N elements aligned to their total size, so that one access moves them all.
template <typename T, int N>
struct alignas(sizeof(T) * N) Vec {
  T v[N];
};

// Copy a row of N elements in accesses of at most 16 bytes. The address must
// be aligned to min(16, N * sizeof(T)) bytes.
template <typename T, int N>
WICCA_HD void load_row(const T* src, T* dst) {
  constexpr int C = (int(sizeof(T)) * N > 16) ? 16 / int(sizeof(T)) : N;
#pragma unroll
  for (int c = 0; c < N; c += C) {
    const Vec<T, C> t = *reinterpret_cast<const Vec<T, C>*>(src + c);
#pragma unroll
    for (int e = 0; e < C; ++e) dst[c + e] = t.v[e];
  }
}

template <typename T, int N>
WICCA_HD void store_row(T* dst, const T* src) {
  constexpr int C = (int(sizeof(T)) * N > 16) ? 16 / int(sizeof(T)) : N;
#pragma unroll
  for (int c = 0; c < N; c += C) {
    Vec<T, C> t;
#pragma unroll
    for (int e = 0; e < C; ++e) t.v[e] = src[c + e];
    *reinterpret_cast<Vec<T, C>*>(dst + c) = t;
  }
}

// One icon level on a 2x2 block (a b / c d): vertical pairs first, then the
// horizontal pair, then the scale — the reference association.
WICCA_HD float icon_level(float a, float b, float c, float d) {
  return mul_rn(add_rn(add_rn(a, c), add_rn(b, d)), 0.25f);
}

// Clip to [0, 255], then truncate toward zero (jnp: clip -> int32 -> uint8).
WICCA_HD uint8_t to_u8(float v) {
  v = fminf(fmaxf(v, 0.0f), 255.0f);
  return static_cast<uint8_t>(static_cast<int>(v));
}

// Unscaled forward Haar of a 2x2 block (a b / c d) with (a, c) the vertical
// pair: ll = (a+c)+(b+d), lh = (a+c)-(b+d), hl = (a-c)+(b-d), hh = (a-c)-(b-d).
template <typename T>
struct Quad {
  T ll, lh, hl, hh;
};

template <typename T>
WICCA_HD Quad<T> haar_fwd_raw(T a, T b, T c, T d) {
  const T rs_e = a + c, rs_o = b + d;
  const T rd_e = a - c, rd_o = b - d;
  return {rs_e + rs_o, rs_e - rs_o, rd_e + rd_o, rd_e - rd_o};
}

// Deadzone code: trunc(clip(band * inv, -qmax, qmax)), inv = f32(1/step)
// rounded on the host from float64 (never a device division).
WICCA_HD int quantize(float band, float inv, float qmax) {
  float v = mul_rn(band, inv);
  v = fminf(fmaxf(v, -qmax), qmax);
  return static_cast<int>(v);
}

// The bin position of a code before its step: u = q + offset * sign(q).
WICCA_HD float bin_point(float q, float offset) {
  const float s = q > 0.0f ? 1.0f : (q < 0.0f ? -1.0f : 0.0f);
  return add_rn(q, mul_rn(offset, s));
}

// bin_point for an integer-valued q, in one rounding: offset * sign(q) is
// exact, so the fused multiply-add rounds the same sum.
WICCA_HD float bin_point_int(float q, float offset) {
  return fma_rn(offset, fminf(fmaxf(q, -1.0f), 1.0f), q);
}

// haar_inv_dequant's 2x2 block before its last rounding step, the multiply
// by 0.5 (exact but for results in the subnormal range).
WICCA_HD void haar_inv_dequant_x2(float ll, float u_lh, float u_hl, float u_hh, float s_lh, float s_hl,
                                  float s_hh, float& t00, float& t01, float& t10, float& t11) {
  const float d_hh = mul_rn(u_hh, s_hh);
  const float rs_e = mul_rn(fma_rn(u_lh, s_lh, ll), 2.0f), rs_o = mul_rn(fma_rn(-u_lh, s_lh, ll), 2.0f);
  const float rd_e = mul_rn(fma_rn(u_hl, s_hl, d_hh), 2.0f), rd_o = mul_rn(fma_rn(u_hl, s_hl, -d_hh), 2.0f);
  t00 = add_rn(rs_e, rd_e);
  t01 = add_rn(rs_o, rd_o);
  t10 = add_rn(rs_e, -rd_e);
  t11 = add_rn(rs_o, -rd_o);
}

// Dequantize (band = u * step) and invert one Haar level into the 2x2 block
// (o00 o01 / o10 o11). The roundings are the JAX kernel's as XLA compiles
// it: the LH product enters ll +- lh and the HL product enters hl +- hh as
// fused multiply-adds, one rounding each; the HH product is rounded alone.
WICCA_HD void haar_inv_dequant(float ll, float u_lh, float u_hl, float u_hh, float s_lh, float s_hl,
                               float s_hh, float& o00, float& o01, float& o10, float& o11) {
  haar_inv_dequant_x2(ll, u_lh, u_hl, u_hh, s_lh, s_hl, s_hh, o00, o01, o10, o11);
  o00 = mul_rn(o00, 0.5f);
  o01 = mul_rn(o01, 0.5f);
  o10 = mul_rn(o10, 0.5f);
  o11 = mul_rn(o11, 0.5f);
}

// Invert one Haar level of float bands (no dequantization).
WICCA_HD void haar_inv(float ll, float lh, float hl, float hh, float& o00, float& o01, float& o10, float& o11) {
  const float rs_e = mul_rn(add_rn(ll, lh), 2.0f), rs_o = mul_rn(add_rn(ll, -lh), 2.0f);
  const float rd_e = mul_rn(add_rn(hl, hh), 2.0f), rd_o = mul_rn(add_rn(hl, -hh), 2.0f);
  o00 = mul_rn(add_rn(rs_e, rd_e), 0.5f);
  o01 = mul_rn(add_rn(rs_o, rd_o), 0.5f);
  o10 = mul_rn(add_rn(rs_e, -rd_e), 0.5f);
  o11 = mul_rn(add_rn(rs_o, -rd_o), 0.5f);
}

}  // namespace wicca
