// The lifting filters of the tile-local kernels, one struct each, so that a
// kernel takes its filter as a template parameter.
//
// Reversible filters (lifting_kernels.cu, K6/K7). A filter is its two
// lifting steps, each on neighbouring polyphase samples of a tile-local
// signal of 2m samples whose ends replicate (index clamp), as
// wicca_tpu/core/lifting.py does at every tile edge of
// wicca_tpu/ops/dwt53_pallas.py:
//
//   predict(e, o, e1)    d[n] from e[n], o[n], e[n+1]
//   update(e, dp, d)     s[n] from e[n], d[n-1], d[n]
//   unupdate(s, dp, d)   e[n] from s[n], d[n-1], d[n]
//   unpredict(e, d, e1)  o[n] from e[n], d[n], e[n+1]
//
// with e[m] -> e[m-1] and d[-1] -> d[0] at the tile's ends (the callers
// pass those). kHalo: whether the steps read a neighbouring pair at all.
// The value type V is int32_t, or I2 to carry two signals through the same
// steps (a vertical step lifts the horizontal low and high bands at once).
// Integer arithmetic only; >> is an arithmetic shift (floor), as in jnp.
//
// Float filters (lifting_float_kernels.cu, K8/K9): CDF 9/7 and db2 in the
// arithmetic of wicca_tpu/ops/dwt97_pallas.py, see below.
#pragma once

#include "haar_kernels.cuh"

namespace wicca {

WICCA_HD int64_t min64(int64_t a, int64_t b) { return a < b ? a : b; }
WICCA_HD int64_t clamp64(int64_t v, int64_t lo, int64_t hi) { return v < lo ? lo : (v > hi ? hi : v); }

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
struct Legall53 {
  static constexpr bool kHalo = true;
  template <typename V>
  static WICCA_HD V predict(V e, V o, V e1) { return o - ((e + e1) >> 1); }
  template <typename V>
  static WICCA_HD V update(V e, V dp, V d) { return e + ((dp + d + 2) >> 2); }
  template <typename V>
  static WICCA_HD V unupdate(V s, V dp, V d) { return s - ((dp + d + 2) >> 2); }
  template <typename V>
  static WICCA_HD V unpredict(V e, V d, V e1) { return d + ((e + e1) >> 1); }
};

// Integer Haar (S-transform): d = o - e ; s = e + (d >> 1). Pair-local.
struct HaarInt {
  static constexpr bool kHalo = false;
  template <typename V>
  static WICCA_HD V predict(V e, V o, V) { return o - e; }
  template <typename V>
  static WICCA_HD V update(V e, V, V d) { return e + (d >> 1); }
  template <typename V>
  static WICCA_HD V unupdate(V s, V, V d) { return s - (d >> 1); }
  template <typename V>
  static WICCA_HD V unpredict(V e, V d, V) { return d + e; }
};

// One lifting level along a line, for a run of N pairs n0 .. n0+N-1:
//
//   lift_run<F, N>(x, first, s, d)        x: samples 2n0-2 .. 2n0+2N (2N+3),
//                                         the three outside the run at
//                                         tile-clamped positions; first:
//                                         n0 == 0 (d[-1] -> d[0])
//   unlift_run<F, N>(s, d, last, x)       s, d: coefficients n0-1 .. n0+N
//                                         (N+2) at tile-clamped positions;
//                                         last: n0 + N == m (e[m] -> e[m-1]);
//                                         x: samples 2n0 .. 2n0+2N-1
template <class F, int N, typename V>
WICCA_HD void lift_run(const V* x, bool first, V* s, V* d) {
#pragma unroll
  for (int q = 0; q < N; ++q) d[q] = F::predict(x[2 + 2 * q], x[3 + 2 * q], x[4 + 2 * q]);
  V dp = first ? d[0] : F::predict(x[0], x[1], x[2]);
#pragma unroll
  for (int q = 0; q < N; ++q) {
    s[q] = F::update(x[2 + 2 * q], dp, d[q]);
    dp = d[q];
  }
}

template <class F, int N, typename V>
WICCA_HD void unlift_run(const V* s, const V* d, bool last, V* x) {
  V e[N + 1];
#pragma unroll
  for (int u = 0; u < N; ++u) e[u] = F::unupdate(s[1 + u], d[u], d[1 + u]);
  e[N] = last ? e[N - 1] : F::unupdate(s[N + 1], d[N], d[N + 1]);
#pragma unroll
  for (int u = 0; u < N; ++u) {
    x[2 * u] = e[u];
    x[2 * u + 1] = F::unpredict(e[u], d[1 + u], e[u + 1]);
  }
}

// The reversible color transform (core/color.py's rct_fwd / rct_inv):
// plane q (Y, U, V) from r, g, b, and r, g, b from y, u, v.
WICCA_HD int32_t rct_fwd_plane(int q, int32_t r, int32_t g, int32_t b) {
  return q == 0 ? (r + 2 * g + b) >> 2 : (q == 1 ? b - g : r - g);
}

WICCA_HD void rct_inv_px(int32_t y, int32_t u, int32_t v, int32_t& r, int32_t& g, int32_t& b) {
  g = y - ((u + v) >> 2);
  r = v + g;
  b = u + g;
}

// ---------------------------------------------------------------------------
// Float filters (K8/K9 lift each line of their shared-memory window in runs
// of N positions, a run per thread). Each lifting step clamps the signal it
// reads at the tile's edges (wicca_tpu/ops/dwt97_pallas.py:40-53: _next/_prev of the step's own
// input), so a strip evaluates every intermediate signal over a window of
// positions and, after each step, gives the entries outside [0, m) the value
// at the nearest tile edge. A window holds positions p0 .. p0+P-1, with
// p0 = n0 - L: L positions before the strip and R after it.
//
//   fwd<N, CLAMP>(w, p0, m, s, d)  low and high coefficients n0 .. n0+N-1
//                                  from the samples w[2i], w[2i+1] (even,
//                                  odd) of window position i, loaded at
//                                  clamped positions
//   inv<N, CLAMP>(s, d, p0, m, x)  samples 2n0 .. 2n0+2N-1 from the
//                                  coefficients s[i], d[i] of window
//                                  position i, loaded at clamped positions
//
// CLAMP false skips the clamps, for a window that lies inside the tile.
//
// The arithmetic is the Pallas kernel's, one rounding per operation in its
// association order (the library is built with -fmad=false, the host build
// with -ffp-contract=off): every constant is the Python double rounded once
// to float32, and a scale by 1/c is a multiplication by f32(1/c). The
// reference's own XLA build contracts some of these products into fused
// multiply-adds depending on the shape, so the port agrees with it within a
// stated tolerance, and with its plain twins bit for bit.
// ---------------------------------------------------------------------------

// After a step has written v[LO .. HI), give each entry whose position
// p0 + i lies outside [0, m) the value at the nearest edge (the edges' own
// entries lie inside [LO, HI) for every strip that starts inside the tile;
// its positions past the tile's end, if any, are never stored).
template <int LO, int HI, typename V>
WICCA_HD void clamp_edges(V* v, int64_t p0, int64_t m) {
#pragma unroll
  for (int i = HI - 2; i >= LO; --i)
    if (p0 + i < 0) v[i] = v[i + 1];
#pragma unroll
  for (int i = LO + 1; i < HI; ++i)
    if (p0 + i >= m) v[i] = v[i - 1];
}

// CDF 9/7 (JPEG2000 irreversible), _lift97_rows / _unlift97_rows:
//   d = o + A (e + e[n+1]);  s = e + B (d[n-1] + d);
//   d = d + G (s + s[n+1]);  s = s + D (d[n-1] + d);  s *= f32(1/K), d *= K
struct Cdf97 {
  static constexpr int L = 2, R = 2;
  static constexpr float A = -0x1.960ce6p+0f;     // f32(-1.586134342059924)
  static constexpr float B = -0x1.b2035cp-5f;     // f32(-0.052980118572961)
  static constexpr float G = 0x1.c40cecp-1f;      // f32(0.882911075530934)
  static constexpr float D = 0x1.c626aap-2f;      // f32(0.443506852043971)
  static constexpr float K = 0x1.3aecb0p+0f;      // f32(1.230174104914001)
  static constexpr float INV_K = 0x1.a03386p-1f;  // f32(1 / 1.230174104914001)

  template <int N, bool CLAMP = true, typename V>
  static WICCA_HD void fwd(const V* w, int64_t p0, int64_t m, V* s, V* d) {
    constexpr int P = N + L + R;
    V e[P], o[P], d1[P], s1[P], d2[P];
#pragma unroll
    for (int i = 0; i < P; ++i) e[i] = w[2 * i], o[i] = w[2 * i + 1];
#pragma unroll
    for (int i = 0; i < P - 1; ++i) d1[i] = o[i] + A * (e[i] + e[i + 1]);
    if constexpr (CLAMP) clamp_edges<0, P - 1>(d1, p0, m);
#pragma unroll
    for (int i = 1; i < P - 1; ++i) s1[i] = e[i] + B * (d1[i - 1] + d1[i]);
    if constexpr (CLAMP) clamp_edges<1, P - 1>(s1, p0, m);
#pragma unroll
    for (int i = 1; i < P - 2; ++i) d2[i] = d1[i] + G * (s1[i] + s1[i + 1]);
    if constexpr (CLAMP) clamp_edges<1, P - 2>(d2, p0, m);
#pragma unroll
    for (int q = 0; q < N; ++q) {
      s[q] = INV_K * (s1[q + L] + D * (d2[q + L - 1] + d2[q + L]));
      d[q] = K * d2[q + L];
    }
  }

  template <int N, bool CLAMP = true, typename V>
  static WICCA_HD void inv(const V* s, const V* d, int64_t p0, int64_t m, V* x) {
    constexpr int P = N + L + R;
    V sk[P], dk[P], s3[P], d3[P], s4[P];
#pragma unroll
    for (int i = 0; i < P; ++i) sk[i] = K * s[i], dk[i] = INV_K * d[i];
#pragma unroll
    for (int i = 1; i < P; ++i) s3[i] = sk[i] - D * (dk[i - 1] + dk[i]);
    if constexpr (CLAMP) clamp_edges<1, P>(s3, p0, m);
#pragma unroll
    for (int i = 1; i < P - 1; ++i) d3[i] = dk[i] - G * (s3[i] + s3[i + 1]);
    if constexpr (CLAMP) clamp_edges<1, P - 1>(d3, p0, m);
#pragma unroll
    for (int i = 2; i < P - 1; ++i) s4[i] = s3[i] - B * (d3[i - 1] + d3[i]);
    if constexpr (CLAMP) clamp_edges<2, P - 1>(s4, p0, m);
#pragma unroll
    for (int q = 0; q < N; ++q) {
      x[2 * q] = s4[q + L];
      x[2 * q + 1] = d3[q + L] - A * (s4[q + L] + s4[q + L + 1]);
    }
  }
};

// db2 (D4, Daubechies-Sweldens factorization, DC gain 1), _lift_db2_rows /
// _unlift_db2_rows:
//   s1 = e + SQ3 o;  d1 = o - C1 s1 - C2 s1[n-1];  s = SS (s1 - d1[n+1]);
//   d = SD d1, with C1 = sqrt3/4, C2 = (sqrt3-2)/4
struct Db2 {
  static constexpr int L = 1, R = 1;
  static constexpr float SQ3 = 0x1.bb67aep+0f;     // f32(sqrt(3))
  static constexpr float C1 = 0x1.bb67aep-2f;      // f32(sqrt(3) / 4)
  static constexpr float C2 = -0x1.126146p-4f;     // f32((sqrt(3) - 2) / 4)
  static constexpr float SS = 0x1.76cf5ep-2f;      // f32(_D4_SCALE_S)
  static constexpr float SD = 0x1.5db3d8p+0f;      // f32(_D4_SCALE_D)
  static constexpr float INV_SS = 0x1.5db3d8p+1f;  // f32(1 / _D4_SCALE_S)
  static constexpr float INV_SD = 0x1.76cf5ep-1f;  // f32(1 / _D4_SCALE_D)

  template <int N, bool CLAMP = true, typename V>
  static WICCA_HD void fwd(const V* w, int64_t p0, int64_t m, V* s, V* d) {
    constexpr int P = N + L + R;
    V s1[P], d1[P];
#pragma unroll
    for (int i = 0; i < P; ++i) s1[i] = w[2 * i] + SQ3 * w[2 * i + 1];
    if constexpr (CLAMP) clamp_edges<0, P>(s1, p0, m);
#pragma unroll
    for (int i = 1; i < P; ++i) d1[i] = (w[2 * i + 1] - C1 * s1[i]) - C2 * s1[i - 1];
    if constexpr (CLAMP) clamp_edges<1, P>(d1, p0, m);
#pragma unroll
    for (int q = 0; q < N; ++q) {
      s[q] = SS * (s1[q + L] - d1[q + L + 1]);
      d[q] = SD * d1[q + L];
    }
  }

  template <int N, bool CLAMP = true, typename V>
  static WICCA_HD void inv(const V* s, const V* d, int64_t p0, int64_t m, V* x) {
    constexpr int P = N + L + R;
    V d1[P], s1[P];
#pragma unroll
    for (int i = 0; i < P; ++i) d1[i] = INV_SD * d[i];
#pragma unroll
    for (int i = 0; i < P - 1; ++i) s1[i] = INV_SS * s[i] + d1[i + 1];
    if constexpr (CLAMP) clamp_edges<0, P - 1>(s1, p0, m);
#pragma unroll
    for (int q = 0; q < N; ++q) {
      const V o = (d1[q + L] + C1 * s1[q + L]) + C2 * s1[q + L - 1];
      x[2 * q] = s1[q + L] - SQ3 * o;
      x[2 * q + 1] = o;
    }
  }
};

// BT.601 ICT (core/color.py's _ICT and _ICT_INV): one output plane of _mix,
// (m0 a + m1 b) + m2 c, each m the Python double rounded once to float32, as
// PyTorch multiplies a float32 plane by a Python scalar.
WICCA_HD float mix3(float m0, float m1, float m2, float a, float b, float c) {
  return add_rn(add_rn(mul_rn(m0, a), mul_rn(m1, b)), mul_rn(m2, c));
}

// Plane q (Y, Cb, Cr) of ict_fwd from r, g, b.
WICCA_HD float ict_fwd_plane(int q, float r, float g, float b) {
  switch (q) {
    case 0: return mix3(0x1.322d0ep-2f, 0x1.2c8b44p-1f, 0x1.d2f1aap-4f, r, g, b);
    case 1: return mix3(-0x1.599242p-3f, -0x1.5336dep-2f, 0x1.0p-1f, r, g, b);
    default: return mix3(0x1.0p-1f, -0x1.acbc8cp-2f, -0x1.4d0dd0p-4f, r, g, b);
  }
}

// Plane k (R, G, B) of ict_inv from y, cb, cr.
WICCA_HD float ict_inv_plane(int k, float y, float cb, float cr) {
  switch (k) {
    case 0: return mix3(0x1.0p+0f, 0.0f, 0x1.66e978p+0f, y, cb, cr);
    case 1: return mix3(0x1.0p+0f, -0x1.606530p-2f, -0x1.6da33cp-1f, y, cb, cr);
    default: return mix3(0x1.0p+0f, 0x1.c5a1cap+0f, 0.0f, y, cb, cr);
  }
}

}  // namespace wicca
