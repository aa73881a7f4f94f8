// Host-side Haar levels (forward and inverse) and tile-local 5/3 inverse
// lifting for the host routes of the folder pipeline
// (wicca_tpu_torch/codec/host_encode.py, host_decode.py).
//
// This is the port's own copy of wicca_tpu/native/idwt.cpp, built by
// wicca_tpu_torch/native/idwt.py with -ffp-contract=off. The numpy mirrors
// in host_encode.py/host_decode.py are the reference; these functions match
// them bit for bit (tests/test_torch_host_codec.py).
//
// Build rule: no value-changing float optimizations. -ffp-contract=off
// keeps every float32 product and sum rounded on its own, as numpy rounds
// them. (The reference's Pallas decode, as XLA compiles it for the CPU,
// fuses the LH/HL dequantization products into fused multiply-adds; the two
// routes agree wherever those products are exact, see host_decode.py.)
//
// Float association contract (the reference Pallas kernel's order,
// wicca_tpu/ops/dwt_pallas.py _idwt_multi_kernel, every operation rounded):
//   deq(q)  = (float(q) + offset*sign(q)) * step
//   rs_e = (ll + lh)*2 ; rs_o = (ll - lh)*2 ; rd_e = (hl + hh)*2 ; rd_o = ...
//   out[2i][2j]   = (rs_e + rd_e)*0.5    out[2i][2j+1]   = (rs_o + rd_o)*0.5
//   out[2i+1][2j] = (rs_e - rd_e)*0.5    out[2i+1][2j+1] = (rs_o - rd_o)*0.5
//   u8 emit: clip(v, 0, 255) -> (int32) -> uint8   (truncate toward zero)
//
// Integer Haar (S-transform) contract (= core/lifting idwt2_level_lifting):
//   vertical:   e = s - (d >> 1) ; o = d + e     (int32 arithmetic shifts)
//   horizontal: same, on the vertically reconstructed rows.
//
// ABI: plain C + ctypes (pybind11 unavailable; same pattern as entropy.cpp).
// All planes are passed with explicit element strides so Python can hand
// over sliced views without copying.

#include <cstdint>
#include <cstddef>
#include <thread>
#include <vector>

namespace {

inline float fsign(float v) { return v > 0.0f ? 1.0f : (v < 0.0f ? -1.0f : 0.0f); }

struct Plane {
  const void* p;
  size_t rs;  // row stride, elements
  size_t cs;  // channel stride, elements
};

template <typename Q>
inline float deq(const Q* row, size_t j, float step, float off) {
  float q = static_cast<float>(row[j]);
  return (q + off * fsign(q)) * step;
}

// One fused float-Haar synthesis level over rows [h0, h1) of every channel.
// out is (C, 2H, 2W) f32 or u8.
template <typename Q, bool EMIT_U8>
void haar_f32_rows(const float* ll, size_t ll_rs, size_t ll_cs,
                   Plane lh, Plane hl, Plane hh,
                   float s_lh, float s_hl, float s_hh, float off,
                   size_t C, size_t H, size_t W,
                   void* out, size_t o_rs, size_t o_cs,
                   size_t h0, size_t h1) {
  (void)H;
  for (size_t c = 0; c < C; ++c) {
    const float* llc = ll + c * ll_cs;
    const Q* lhc = static_cast<const Q*>(lh.p) + c * lh.cs;
    const Q* hlc = static_cast<const Q*>(hl.p) + c * hl.cs;
    const Q* hhc = static_cast<const Q*>(hh.p) + c * hh.cs;
    for (size_t i = h0; i < h1; ++i) {
      const float* llr = llc + i * ll_rs;
      const Q* lhr = lhc + i * lh.rs;
      const Q* hlr = hlc + i * hl.rs;
      const Q* hhr = hhc + i * hh.rs;
      float* e_row = nullptr; float* o_row = nullptr;
      uint8_t* e_row8 = nullptr; uint8_t* o_row8 = nullptr;
      if (EMIT_U8) {
        uint8_t* oc = static_cast<uint8_t*>(out) + c * o_cs;
        e_row8 = oc + (2 * i) * o_rs;
        o_row8 = oc + (2 * i + 1) * o_rs;
      } else {
        float* oc = static_cast<float*>(out) + c * o_cs;
        e_row = oc + (2 * i) * o_rs;
        o_row = oc + (2 * i + 1) * o_rs;
      }
      for (size_t j = 0; j < W; ++j) {
        float llv = llr[j];
        float lhv = deq<Q>(lhr, j, s_lh, off);
        float hlv = deq<Q>(hlr, j, s_hl, off);
        float hhv = deq<Q>(hhr, j, s_hh, off);
        float rs_e = (llv + lhv) * 2.0f;
        float rs_o = (llv - lhv) * 2.0f;
        float rd_e = (hlv + hhv) * 2.0f;
        float rd_o = (hlv - hhv) * 2.0f;
        float a = (rs_e + rd_e) * 0.5f;
        float b = (rs_o + rd_o) * 0.5f;
        float d = (rs_e - rd_e) * 0.5f;
        float e = (rs_o - rd_o) * 0.5f;
        if (EMIT_U8) {
          e_row8[2 * j] = static_cast<uint8_t>(static_cast<int32_t>(a < 0.f ? 0.f : (a > 255.f ? 255.f : a)));
          e_row8[2 * j + 1] = static_cast<uint8_t>(static_cast<int32_t>(b < 0.f ? 0.f : (b > 255.f ? 255.f : b)));
          o_row8[2 * j] = static_cast<uint8_t>(static_cast<int32_t>(d < 0.f ? 0.f : (d > 255.f ? 255.f : d)));
          o_row8[2 * j + 1] = static_cast<uint8_t>(static_cast<int32_t>(e < 0.f ? 0.f : (e > 255.f ? 255.f : e)));
        } else {
          e_row[2 * j] = a;
          e_row[2 * j + 1] = b;
          o_row[2 * j] = d;
          o_row[2 * j + 1] = e;
        }
      }
    }
  }
}

// One fused integer-Haar (S-transform) synthesis level, int32 LL + Q codes.
// out is (C, 2H, 2W) int32 or u8.
template <typename Q, bool EMIT_U8>
void haar_int_rows(const int32_t* ll, size_t ll_rs, size_t ll_cs,
                   Plane lh, Plane hl, Plane hh,
                   size_t C, size_t H, size_t W,
                   void* out, size_t o_rs, size_t o_cs,
                   size_t h0, size_t h1, std::vector<int32_t>& scratch) {
  (void)H;
  // scratch: 4 rows (lo_e, lo_o, hi_e, hi_o) of W int32
  scratch.resize(4 * W);
  int32_t* lo_e = scratch.data();
  int32_t* lo_o = lo_e + W;
  int32_t* hi_e = lo_o + W;
  int32_t* hi_o = hi_e + W;
  for (size_t c = 0; c < C; ++c) {
    const int32_t* llc = ll + c * ll_cs;
    const Q* lhc = static_cast<const Q*>(lh.p) + c * lh.cs;
    const Q* hlc = static_cast<const Q*>(hl.p) + c * hl.cs;
    const Q* hhc = static_cast<const Q*>(hh.p) + c * hh.cs;
    for (size_t i = h0; i < h1; ++i) {
      const int32_t* s_row = llc + i * ll_rs;
      const Q* lh_row = lhc + i * lh.rs;
      const Q* hl_row = hlc + i * hl.rs;
      const Q* hh_row = hhc + i * hh.rs;
      // vertical inverse: lo rows from (ll, hl), hi rows from (lh, hh)
      for (size_t j = 0; j < W; ++j) {
        int32_t d = static_cast<int32_t>(hl_row[j]);
        int32_t e = s_row[j] - (d >> 1);
        lo_e[j] = e;
        lo_o[j] = d + e;
        int32_t d2 = static_cast<int32_t>(hh_row[j]);
        int32_t e2 = static_cast<int32_t>(lh_row[j]) - (d2 >> 1);
        hi_e[j] = e2;
        hi_o[j] = d2 + e2;
      }
      // horizontal inverse on each of the two output rows
      const int32_t* los[2] = {lo_e, lo_o};
      const int32_t* his[2] = {hi_e, hi_o};
      for (int r = 0; r < 2; ++r) {
        size_t oi = 2 * i + r;
        if (EMIT_U8) {
          uint8_t* orow = static_cast<uint8_t*>(out) + c * o_cs + oi * o_rs;
          for (size_t j = 0; j < W; ++j) {
            int32_t d = his[r][j];
            int32_t e = los[r][j] - (d >> 1);
            int32_t o = d + e;
            orow[2 * j] = static_cast<uint8_t>(e < 0 ? 0 : (e > 255 ? 255 : e));
            orow[2 * j + 1] = static_cast<uint8_t>(o < 0 ? 0 : (o > 255 ? 255 : o));
          }
        } else {
          int32_t* orow = static_cast<int32_t*>(out) + c * o_cs + oi * o_rs;
          for (size_t j = 0; j < W; ++j) {
            int32_t d = his[r][j];
            int32_t e = los[r][j] - (d >> 1);
            orow[2 * j] = e;
            orow[2 * j + 1] = d + e;
          }
        }
      }
    }
  }
}

// Split [0, H) items across threads. `min_split` is the small-work cutoff in
// ITEMS: callers iterating rows keep the default 64; callers iterating
// coarser units (e.g. clamp GROUPS of hundreds of rows each in
// wicca_unlift53_v) must pass a smaller cutoff or they silently serialize —
// a 53 MP plane is only ~13 vertical tile groups.
template <typename F>
void run_rows(size_t H, int nthreads, F&& body, size_t min_split = 64) {
  if (nthreads <= 1 || H < min_split) {
    body(0, H, 0);
    return;
  }
  size_t nt = static_cast<size_t>(nthreads);
  if (nt > H) nt = H;
  std::vector<std::thread> ts;
  ts.reserve(nt);
  size_t chunk = (H + nt - 1) / nt;
  for (size_t t = 0; t < nt; ++t) {
    size_t h0 = t * chunk;
    size_t h1 = h0 + chunk < H ? h0 + chunk : H;
    if (h0 >= h1) break;
    ts.emplace_back([&, h0, h1, t] { body(h0, h1, t); });
  }
  for (auto& th : ts) th.join();
}

}  // namespace

extern "C" {

// Float-Haar synthesis level. q16: 0 = int8 codes, 1 = int16. emit: 0 = f32
// out, 1 = uint8 out. Strides in ELEMENTS of the respective dtype.
void wicca_idwt_haar_f32_level(
    const float* ll, size_t ll_rs, size_t ll_cs,
    const void* lh, size_t lh_rs, size_t lh_cs,
    const void* hl, size_t hl_rs, size_t hl_cs,
    const void* hh, size_t hh_rs, size_t hh_cs,
    int q16, float s_lh, float s_hl, float s_hh, float off,
    size_t C, size_t H, size_t W,
    void* out, size_t o_rs, size_t o_cs, int emit_u8, int nthreads) {
  Plane plh{lh, lh_rs, lh_cs}, phl{hl, hl_rs, hl_cs}, phh{hh, hh_rs, hh_cs};
  run_rows(H, nthreads, [&](size_t h0, size_t h1, size_t) {
    if (q16) {
      if (emit_u8)
        haar_f32_rows<int16_t, true>(ll, ll_rs, ll_cs, plh, phl, phh, s_lh, s_hl, s_hh, off, C, H, W, out, o_rs, o_cs, h0, h1);
      else
        haar_f32_rows<int16_t, false>(ll, ll_rs, ll_cs, plh, phl, phh, s_lh, s_hl, s_hh, off, C, H, W, out, o_rs, o_cs, h0, h1);
    } else {
      if (emit_u8)
        haar_f32_rows<int8_t, true>(ll, ll_rs, ll_cs, plh, phl, phh, s_lh, s_hl, s_hh, off, C, H, W, out, o_rs, o_cs, h0, h1);
      else
        haar_f32_rows<int8_t, false>(ll, ll_rs, ll_cs, plh, phl, phh, s_lh, s_hl, s_hh, off, C, H, W, out, o_rs, o_cs, h0, h1);
    }
  });
}

// Integer-Haar (S-transform) synthesis level. int32 LL; q16 selects code
// width; emit 0 = int32 out, 1 = uint8 out (clip 0..255).
void wicca_idwt_haar_int_level(
    const int32_t* ll, size_t ll_rs, size_t ll_cs,
    const void* lh, size_t lh_rs, size_t lh_cs,
    const void* hl, size_t hl_rs, size_t hl_cs,
    const void* hh, size_t hh_rs, size_t hh_cs,
    int q16, size_t C, size_t H, size_t W,
    void* out, size_t o_rs, size_t o_cs, int emit_u8, int nthreads) {
  Plane plh{lh, lh_rs, lh_cs}, phl{hl, hl_rs, hl_cs}, phh{hh, hh_rs, hh_cs};
  run_rows(H, nthreads, [&](size_t h0, size_t h1, size_t) {
    std::vector<int32_t> scratch;
    if (q16) {
      if (emit_u8)
        haar_int_rows<int16_t, true>(ll, ll_rs, ll_cs, plh, phl, phh, C, H, W, out, o_rs, o_cs, h0, h1, scratch);
      else
        haar_int_rows<int16_t, false>(ll, ll_rs, ll_cs, plh, phl, phh, C, H, W, out, o_rs, o_cs, h0, h1, scratch);
    } else {
      if (emit_u8)
        haar_int_rows<int8_t, true>(ll, ll_rs, ll_cs, plh, phl, phh, C, H, W, out, o_rs, o_cs, h0, h1, scratch);
      else
        haar_int_rows<int8_t, false>(ll, ll_rs, ll_cs, plh, phl, phh, C, H, W, out, o_rs, o_cs, h0, h1, scratch);
    }
  });
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Tile-local reversible 5/3 / S-transform inverse lifting for the host
// decode of lossless streams (codec/host_decode.py numpy mirror is the
// reference; integer ops, so equality is exact by construction — still
// pinned by tests/test_host_decode.py::test_native53_matches_numpy).
// Clamp groups of `group` rows/cols reproduce the independent-tile edges.
// ---------------------------------------------------------------------------

namespace {

// vertical inverse over row pairs: s, d (C, R, W) -> out (C, 2R, W);
// neighbor taps clamp at every `group` rows (tile boundaries).
template <bool HAAR>
void unlift_v_rows(const int32_t* s, size_t s_rs, size_t s_cs,
                   const int32_t* d, size_t d_rs, size_t d_cs,
                   int32_t* out, size_t o_rs, size_t o_cs,
                   size_t C, size_t R, size_t W, size_t group,
                   size_t r0, size_t r1) {
  for (size_t c = 0; c < C; ++c) {
    const int32_t* sc = s + c * s_cs;
    const int32_t* dc = d + c * d_cs;
    int32_t* oc = out + c * o_cs;
    // pass 1: e rows (need d[n-1] clamped at the tile top)
    for (size_t n = r0; n < r1; ++n) {
      const int32_t* srow = sc + n * s_rs;
      const int32_t* drow = dc + n * d_rs;
      int32_t* erow = oc + (2 * n) * o_rs;
      if (HAAR) {
        for (size_t j = 0; j < W; ++j) erow[j] = srow[j] - (drow[j] >> 1);
      } else {
        size_t top = n - (n % group);
        const int32_t* dprev = dc + (n > top ? n - 1 : n) * d_rs;
        for (size_t j = 0; j < W; ++j)
          erow[j] = srow[j] - ((dprev[j] + drow[j] + 2) >> 2);
      }
    }
    // pass 2: o rows (need e[n+1] clamped at the tile bottom)
    for (size_t n = r0; n < r1; ++n) {
      const int32_t* drow = dc + n * d_rs;
      const int32_t* erow = oc + (2 * n) * o_rs;
      int32_t* orow = oc + (2 * n + 1) * o_rs;
      if (HAAR) {
        for (size_t j = 0; j < W; ++j) orow[j] = drow[j] + erow[j];
      } else {
        size_t bot = n - (n % group) + group - 1;
        if (bot >= R) bot = R - 1;
        const int32_t* enext = oc + (2 * (n < bot ? n + 1 : n)) * o_rs;
        for (size_t j = 0; j < W; ++j)
          orow[j] = drow[j] + ((erow[j] + enext[j]) >> 1);
      }
    }
  }
}

// horizontal inverse over column pairs: s, d (C, H, WW) -> out (C, H, 2WW);
// neighbor taps clamp at every `group` columns.
template <bool HAAR>
void unlift_h_rows(const int32_t* s, size_t s_rs, size_t s_cs,
                   const int32_t* d, size_t d_rs, size_t d_cs,
                   int32_t* out, size_t o_rs, size_t o_cs,
                   size_t C, size_t H, size_t WW, size_t group,
                   size_t r0, size_t r1, std::vector<int32_t>& scratch) {
  scratch.resize(WW);
  int32_t* e = scratch.data();
  for (size_t c = 0; c < C; ++c) {
    const int32_t* sc = s + c * s_cs;
    const int32_t* dc = d + c * d_cs;
    int32_t* oc = out + c * o_cs;
    for (size_t n = r0; n < r1; ++n) {
      const int32_t* srow = sc + n * s_rs;
      const int32_t* drow = dc + n * d_rs;
      int32_t* orow = oc + n * o_rs;
      if (HAAR) {
        for (size_t j = 0; j < WW; ++j) {
          int32_t ev = srow[j] - (drow[j] >> 1);
          orow[2 * j] = ev;
          orow[2 * j + 1] = drow[j] + ev;
        }
      } else {
        for (size_t j = 0; j < WW; ++j) {
          size_t left = j - (j % group);
          int32_t dprev = drow[j > left ? j - 1 : j];
          e[j] = srow[j] - ((dprev + drow[j] + 2) >> 2);
        }
        for (size_t j = 0; j < WW; ++j) {
          size_t right = j - (j % group) + group - 1;
          if (right >= WW) right = WW - 1;
          int32_t enext = e[j < right ? j + 1 : j];
          orow[2 * j] = e[j];
          orow[2 * j + 1] = drow[j] + ((e[j] + enext) >> 1);
        }
      }
    }
  }
}

}  // namespace

extern "C" {

// filt: 0 = legall5.3, 1 = haar_int (S-transform). Strides in int32
// ELEMENTS. Threads split on complete clamp groups so the e[n+1] tap never
// crosses a thread boundary mid-tile.
void wicca_unlift53_v(const int32_t* s, size_t s_rs, size_t s_cs,
                      const int32_t* d, size_t d_rs, size_t d_cs,
                      int32_t* out, size_t o_rs, size_t o_cs,
                      size_t C, size_t R, size_t W, size_t group,
                      int filt_haar, int nthreads) {
  if (group == 0 || group > R) group = R;
  size_t ngroups = (R + group - 1) / group;
  // small-work cutoff on ROWS (not groups): a realistic plane has only a
  // handful of 512-row tile groups, so the default cutoff would serialize it
  run_rows(ngroups, R < 64 ? 1 : nthreads, [&](size_t g0, size_t g1, size_t) {
    size_t r0 = g0 * group;
    size_t r1 = g1 * group < R ? g1 * group : R;
    if (filt_haar)
      unlift_v_rows<true>(s, s_rs, s_cs, d, d_rs, d_cs, out, o_rs, o_cs, C, R, W, group, r0, r1);
    else
      unlift_v_rows<false>(s, s_rs, s_cs, d, d_rs, d_cs, out, o_rs, o_cs, C, R, W, group, r0, r1);
  }, /*min_split=*/2);
}

void wicca_unlift53_h(const int32_t* s, size_t s_rs, size_t s_cs,
                      const int32_t* d, size_t d_rs, size_t d_cs,
                      int32_t* out, size_t o_rs, size_t o_cs,
                      size_t C, size_t H, size_t WW, size_t group,
                      int filt_haar, int nthreads) {
  if (group == 0 || group > WW) group = WW;
  run_rows(H, nthreads, [&](size_t r0, size_t r1, size_t) {
    std::vector<int32_t> scratch;
    if (filt_haar)
      unlift_h_rows<true>(s, s_rs, s_cs, d, d_rs, d_cs, out, o_rs, o_cs, C, H, WW, group, r0, r1, scratch);
    else
      unlift_h_rows<false>(s, s_rs, s_cs, d, d_rs, d_cs, out, o_rs, o_cs, C, H, WW, group, r0, r1, scratch);
  });
}

}  // extern "C"

// ---------------------------------------------------------------------------
// Forward fused Haar level + deadzone quantize for the host ENCODE path
// (codec/host_encode.py). Exactness: for uint8 sources every value in the
// cascade is an integer raw sum scaled by an exact power of two, so
// float(raw) * scale is exact and the only rounding is the final
// band * (1/step) multiply — the same single rounding the device kernel
// performs (ops/dwt_pallas._quant_band). u8 emit of q uses the same
// clip-then-truncate cast.
// ---------------------------------------------------------------------------

namespace {

template <typename IN, typename Q>
void haar_fwd_rows(const IN* x, size_t x_rs, size_t x_cs,
                   int32_t* ll, size_t ll_rs, size_t ll_cs,
                   Q* lh, size_t lh_rs, size_t lh_cs,
                   Q* hl, size_t hl_rs, size_t hl_cs,
                   Q* hh, size_t hh_rs, size_t hh_cs,
                   float scale, float r_lh, float r_hl, float r_hh, int qmax,
                   size_t C, size_t HH, size_t WW, size_t h0, size_t h1) {
  float fq = static_cast<float>(qmax);
  auto quant = [&](int32_t v, float recip) -> Q {
    float band = static_cast<float>(v) * scale;
    float qf = band * recip;
    if (qf > fq) qf = fq;
    if (qf < -fq) qf = -fq;
    return static_cast<Q>(static_cast<int32_t>(qf));
  };
  for (size_t c = 0; c < C; ++c) {
    const IN* xc = x + c * x_cs;
    int32_t* llc = ll + c * ll_cs;
    Q* lhc = lh + c * lh_cs;
    Q* hlc = hl + c * hl_cs;
    Q* hhc = hh + c * hh_cs;
    for (size_t i = h0; i < h1; ++i) {
      const IN* r0 = xc + (2 * i) * x_rs;
      const IN* r1 = xc + (2 * i + 1) * x_rs;
      int32_t* llr = llc + i * ll_rs;
      Q* lhr = lhc + i * lh_rs;
      Q* hlr = hlc + i * hl_rs;
      Q* hhr = hhc + i * hh_rs;
      for (size_t j = 0; j < WW; ++j) {
        int32_t a = static_cast<int32_t>(r0[2 * j]);
        int32_t b = static_cast<int32_t>(r0[2 * j + 1]);
        int32_t cc = static_cast<int32_t>(r1[2 * j]);
        int32_t dd = static_cast<int32_t>(r1[2 * j + 1]);
        int32_t rs_e = a + cc;  // row-pair sums (vertical), even/odd columns
        int32_t rs_o = b + dd;
        int32_t rd_e = a - cc;
        int32_t rd_o = b - dd;
        llr[j] = rs_e + rs_o;
        lhr[j] = quant(rs_e - rs_o, r_lh);
        hlr[j] = quant(rd_e + rd_o, r_hl);
        hhr[j] = quant(rd_e - rd_o, r_hh);
      }
    }
  }
  (void)HH;
}

}  // namespace

extern "C" {

// in_u8: 1 = uint8 input, 0 = int32 raw input. q16: 0 = int8 codes, 1 =
// int16. Output raw LL is int32 (scale applies at the NEXT level's
// emission; the final LL scale happens in Python). Strides in elements.
void wicca_dwt_haar_fwd_level(
    const void* x, size_t x_rs, size_t x_cs, int in_u8,
    int32_t* ll, size_t ll_rs, size_t ll_cs,
    void* lh, size_t lh_rs, size_t lh_cs,
    void* hl, size_t hl_rs, size_t hl_cs,
    void* hh, size_t hh_rs, size_t hh_cs,
    int q16, float scale, float r_lh, float r_hl, float r_hh, int qmax,
    size_t C, size_t HH, size_t WW, int nthreads) {
  run_rows(HH, nthreads, [&](size_t h0, size_t h1, size_t) {
    if (in_u8) {
      if (q16)
        haar_fwd_rows<uint8_t, int16_t>(static_cast<const uint8_t*>(x), x_rs, x_cs, ll, ll_rs, ll_cs,
            static_cast<int16_t*>(lh), lh_rs, lh_cs, static_cast<int16_t*>(hl), hl_rs, hl_cs,
            static_cast<int16_t*>(hh), hh_rs, hh_cs, scale, r_lh, r_hl, r_hh, qmax, C, HH, WW, h0, h1);
      else
        haar_fwd_rows<uint8_t, int8_t>(static_cast<const uint8_t*>(x), x_rs, x_cs, ll, ll_rs, ll_cs,
            static_cast<int8_t*>(lh), lh_rs, lh_cs, static_cast<int8_t*>(hl), hl_rs, hl_cs,
            static_cast<int8_t*>(hh), hh_rs, hh_cs, scale, r_lh, r_hl, r_hh, qmax, C, HH, WW, h0, h1);
    } else {
      if (q16)
        haar_fwd_rows<int32_t, int16_t>(static_cast<const int32_t*>(x), x_rs, x_cs, ll, ll_rs, ll_cs,
            static_cast<int16_t*>(lh), lh_rs, lh_cs, static_cast<int16_t*>(hl), hl_rs, hl_cs,
            static_cast<int16_t*>(hh), hh_rs, hh_cs, scale, r_lh, r_hl, r_hh, qmax, C, HH, WW, h0, h1);
      else
        haar_fwd_rows<int32_t, int8_t>(static_cast<const int32_t*>(x), x_rs, x_cs, ll, ll_rs, ll_cs,
            static_cast<int8_t*>(lh), lh_rs, lh_cs, static_cast<int8_t*>(hl), hl_rs, hl_cs,
            static_cast<int8_t*>(hh), hh_rs, hh_cs, scale, r_lh, r_hl, r_hh, qmax, C, HH, WW, h0, h1);
    }
  });
}

}  // extern "C"
