// The reversible lifting filters of lifting_kernels.cu, one struct each, so
// that a kernel takes its filter as a template parameter.
//
// A filter lifts a strip of N neighbouring polyphase pairs, n0 .. n0+N-1, of
// a tile-local signal of 2m samples whose ends replicate (index clamp), as
// wicca_tpu/core/lifting.py does at every tile edge of
// wicca_tpu/ops/dwt53_pallas.py:
//
//   fwd_taps<N>(n0, m, t)      the 2N+3 sample positions the strip needs,
//                              each in [0, 2m)
//   fwd<N>(w, first, s, d)     its low and high coefficients from the
//                              samples w[] at those positions (first: n0 == 0)
//   inv_taps<N>(n0, m, t)      the N+2 coefficient positions that samples
//                              2n0 .. 2n0+2N-1 need, each in [0, m)
//   inv<N>(s, d, last, x)      those 2N samples from the coefficients at
//                              those positions (last: n0 + N == m)
//
// Positions a filter does not read are still valid indices, so loading them
// is harmless, and the compiler drops those loads. The value type V is
// int32_t, or I2 to carry two signals through the same steps (the vertical
// pass lifts the horizontal low and high bands at once). Integer arithmetic
// only; >> is an arithmetic shift (floor), as in jnp.
#pragma once

#include "haar_kernels.cuh"

namespace wicca {

struct I2 {
  int32_t a, b;
};

WICCA_HD I2 operator+(I2 x, I2 y) { return {x.a + y.a, x.b + y.b}; }
WICCA_HD I2 operator-(I2 x, I2 y) { return {x.a - y.a, x.b - y.b}; }
WICCA_HD I2 operator+(I2 x, int32_t c) { return {x.a + c, x.b + c}; }
WICCA_HD I2 operator>>(I2 x, int s) { return {x.a >> s, x.b >> s}; }

// LeGall 5/3 (JPEG2000 reversible):
//   d[n] = o[n] - ((e[n] + e[n+1]) >> 1)
//   s[n] = e[n] + ((d[n-1] + d[n] + 2) >> 2)
// with e[m] -> e[m-1] and d[-1] -> d[0] at the tile's ends.
struct Legall53 {
  // o[n0-1], e[n0-1] (unread when n0 == 0), the strip's 2N samples, e[n0+N]
  template <int N>
  static WICCA_HD void fwd_taps(int64_t n0, int64_t m, int64_t* t) {
    t[0] = n0 > 0 ? 2 * n0 - 2 : 0;
    t[1] = n0 > 0 ? 2 * n0 - 1 : 1;
#pragma unroll
    for (int u = 0; u < 2 * N; ++u) t[2 + u] = 2 * n0 + u;
    t[2 * N + 2] = n0 + N < m ? 2 * (n0 + N) : 2 * m - 2;
  }

  template <int N, typename V>
  static WICCA_HD void fwd(const V* w, bool first, V* s, V* d) {
#pragma unroll
    for (int q = 0; q < N; ++q) d[q] = w[3 + 2 * q] - ((w[2 + 2 * q] + w[4 + 2 * q]) >> 1);
    V prev = first ? d[0] : w[1] - ((w[0] + w[2]) >> 1);
#pragma unroll
    for (int q = 0; q < N; ++q) {
      s[q] = w[2 + 2 * q] + ((prev + d[q] + 2) >> 2);
      prev = d[q];
    }
  }

  // coefficients n0-1 .. n0+N, clamped to [0, m)
  template <int N>
  static WICCA_HD void inv_taps(int64_t n0, int64_t m, int64_t* t) {
    t[0] = n0 > 0 ? n0 - 1 : 0;
#pragma unroll
    for (int u = 0; u < N; ++u) t[1 + u] = n0 + u;
    t[N + 1] = n0 + N < m ? n0 + N : m - 1;
  }

  template <int N, typename V>
  static WICCA_HD void inv(const V* s, const V* d, bool last, V* x) {
    V e[N + 1];
#pragma unroll
    for (int u = 0; u < N; ++u) e[u] = s[1 + u] - ((d[u] + d[1 + u] + 2) >> 2);
    e[N] = last ? e[N - 1] : s[N + 1] - ((d[N] + d[N + 1] + 2) >> 2);
#pragma unroll
    for (int u = 0; u < N; ++u) {
      x[2 * u] = e[u];
      x[2 * u + 1] = d[1 + u] + ((e[u] + e[u + 1]) >> 1);
    }
  }
};

// Integer Haar (S-transform): d = o - e ; s = e + (d >> 1). Pair-local: only
// the strip's own samples and coefficients are read.
struct HaarInt {
  template <int N>
  static WICCA_HD void fwd_taps(int64_t n0, int64_t, int64_t* t) {
    t[0] = t[1] = t[2 * N + 2] = 2 * n0;
#pragma unroll
    for (int u = 0; u < 2 * N; ++u) t[2 + u] = 2 * n0 + u;
  }

  template <int N, typename V>
  static WICCA_HD void fwd(const V* w, bool, V* s, V* d) {
#pragma unroll
    for (int q = 0; q < N; ++q) {
      d[q] = w[3 + 2 * q] - w[2 + 2 * q];
      s[q] = w[2 + 2 * q] + (d[q] >> 1);
    }
  }

  template <int N>
  static WICCA_HD void inv_taps(int64_t n0, int64_t, int64_t* t) {
    t[0] = t[N + 1] = n0;
#pragma unroll
    for (int u = 0; u < N; ++u) t[1 + u] = n0 + u;
  }

  template <int N, typename V>
  static WICCA_HD void inv(const V* s, const V* d, bool, V* x) {
#pragma unroll
    for (int u = 0; u < N; ++u) {
      x[2 * u] = s[1 + u] - (d[1 + u] >> 1);
      x[2 * u + 1] = d[1 + u] + x[2 * u];
    }
  }
};

}  // namespace wicca
