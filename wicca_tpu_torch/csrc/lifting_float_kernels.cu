// Hand-written Hopper kernels for the lossy float-lifting codec: tile-local
// CDF 9/7 and db2 levels with the deadzone quantizer fused in, forward (K8)
// and inverse (K9), for the float filters of lifting_kernels.cuh.
//
// Replaces (wicca_tpu/ops/dwt97_pallas.py):
//   K8  dwt97_multilevel_quant_pallas    -> _dwt97_kernel
//   K9  idwt97_multilevel_dequant_pallas -> _idwt97_kernel
//
// Semantics: those of K6/K7 (lifting_kernels.cu) in float32. A pass's input
// is cut into (512, 1024) tiles (or one tile per dimension that fits); level
// l works on the tile halved l-1 times, lifts horizontally first, then
// vertically, and clamps every lifting step's signal at that tile's edges.
// The forward quantizes each detail band in its epilogue:
// int16(trunc(clip(band * f32(1/step), -32767, 32767))); the LL stays
// float32. The inverse dequantizes in its prologue,
// (q + f32(offset) * sign(q)) * f32(step), and emits float32, or uint8
// (clip to [0, 255], truncate) on the finest level. A partial pass of a
// progressive decode passes the coarse tile of the full pass (orig_k).
//
// What bounds them on an H100: device-memory bytes. A 9/7 level needs about
// 16 float operations per input sample (a strip executes about 40, as it
// recomputes the overlap of its neighbours' windows); levels 1-3 of a
// 3x8704x6144 frame move 486 MB from uint8 (968 MB from float32),
// 0.15-0.29 ms at 3.35 TB/s, while the operations they need take about
// 0.05 ms at 67 TFLOP/s.
//
// What the design does about it: K6/K7's. One launch per level, float32 LL
// scratch between the levels of a pass, and each thread owns a strip of
// 2 x 4 coefficient positions (1 x 1 where a tile's extents are not
// multiples of 2 and 4) that never crosses a tile seam. It loads from device
// memory the window its four chained lifting steps need at clamped
// tile-local indices (12 x 16 samples for a 9/7 forward strip, 6 x 8 per
// band for an inverse one; the neighbouring strips' overlap hits L1) and
// evaluates every intermediate signal over that window, clamping it at the
// tile's edges after each step. No shared memory and no barrier, so the host
// build (host_emulation.h) runs the same code. The window is about twice the
// 5/3 one, so the load instructions that bound K6 bound these too; a fused
// pass with shared-memory halos is later work.
//
// Interface: plain C, bound with ctypes; the wrapper is
// wicca_tpu_torch/ops/dwt97_cuda.py. Each entry point launches one level on
// the stream it is given and returns cudaGetLastError().

#include "haar_kernels.cuh"
#include "launch.cuh"
#include "lifting_kernels.cuh"

namespace wicca {
namespace {

WICCA_HD float widen(uint8_t v) { return static_cast<float>(static_cast<int32_t>(v)); }
WICCA_HD float widen(float v) { return v; }

WICCA_HD float dequantize(int16_t q, float offset, float step) {
  return mul_rn(bin_point(static_cast<float>(q), offset), step);
}

// ---------------------------------------------------------------------------
// K8: one forward level. x (planes, h, w) is read as if edge-padded to the
// band grid (2 hb, 2 wb); th x tw is the tile in band coordinates (pairs).
// A thread computes an NR x NC strip of coefficient positions, which never
// crosses a tile seam (NR divides th, NC divides tw).
// ---------------------------------------------------------------------------

template <class F, typename In, int NR, int NC>
__global__ void lift97_fwd_level_kernel(const In* __restrict__ x, int64_t planes, int64_t h, int64_t w, int64_t hb,
                                        int64_t wb, int64_t th, int64_t tw, float* __restrict__ ll,
                                        int16_t* __restrict__ lh, int16_t* __restrict__ hl,
                                        int16_t* __restrict__ hh, float inv_lh, float inv_hl, float inv_hh) {
  constexpr int WR = 2 * (NR + F::L + F::R), WC = 2 * (NC + F::L + F::R);  // sample windows
  constexpr float QMAX = 32767.0f;
  const int64_t j0 = (blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x) * NC;
  if (j0 >= wb) return;
  const int64_t tj0 = j0 / tw * tw, nc0 = j0 - tj0;
  int64_t col[WC];
#pragma unroll
  for (int b = 0; b < WC; ++b) col[b] = min64(2 * (tj0 + clamp64(nc0 - F::L + b / 2, 0, tw - 1)) + (b & 1), w - 1);
  for (int64_t p = blockIdx.z; p < planes; p += gridDim.z) {
    for (int64_t i0 = (blockIdx.y * static_cast<int64_t>(blockDim.y) + threadIdx.y) * NR; i0 < hb;
         i0 += static_cast<int64_t>(gridDim.y) * blockDim.y * NR) {
      const int64_t ti0 = i0 / th * th, nr0 = i0 - ti0;
      F2 v[WR][NC];  // per window row: the horizontal (low, high) pairs of the strip
#pragma unroll
      for (int a = 0; a < WR; ++a) {
        const int64_t r = min64(2 * (ti0 + clamp64(nr0 - F::L + a / 2, 0, th - 1)) + (a & 1), h - 1);
        const In* src = x + (p * h + r) * w;
        float win[WC], s[NC], d[NC];
#pragma unroll
        for (int b = 0; b < WC; ++b) win[b] = widen(src[col[b]]);
        F::template fwd<NC>(win, nc0 - F::L, tw, s, d);
#pragma unroll
        for (int c = 0; c < NC; ++c) v[a][c] = {s[c], d[c]};
      }
      float o_ll[NR][NC];
      int16_t o_lh[NR][NC], o_hl[NR][NC], o_hh[NR][NC];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        F2 win[WR], s[NR], d[NR];  // s = (ll, lh), d = (hl, hh)
#pragma unroll
        for (int a = 0; a < WR; ++a) win[a] = v[a][c];
        F::template fwd<NR>(win, nr0 - F::L, th, s, d);
#pragma unroll
        for (int r = 0; r < NR; ++r) {
          o_ll[r][c] = s[r].a;
          o_lh[r][c] = static_cast<int16_t>(quantize(s[r].b, inv_lh, QMAX));
          o_hl[r][c] = static_cast<int16_t>(quantize(d[r].a, inv_hl, QMAX));
          o_hh[r][c] = static_cast<int16_t>(quantize(d[r].b, inv_hh, QMAX));
        }
      }
#pragma unroll
      for (int r = 0; r < NR; ++r) {
        const int64_t o = (p * hb + i0 + r) * wb + j0;
        store_row<float, NC>(ll + o, o_ll[r]);
        store_row<int16_t, NC>(lh + o, o_lh[r]);
        store_row<int16_t, NC>(hl + o, o_hl[r]);
        store_row<int16_t, NC>(hh + o, o_hh[r]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// K9: one inverse level. The band grid is hb x wb (tile th x tw); the LL
// (planes, llh, llw) and the codes (planes, bh, bw) are read as if
// edge-padded (or cropped) to it. out is (planes, 2 hb, 2 wb), float32 or
// uint8. A thread expands an NR x NC strip of coefficient positions into its
// 2NR x 2NC output block.
// ---------------------------------------------------------------------------

template <class F, bool EMIT_U8, int NR, int NC>
__global__ void lift97_inv_level_kernel(const float* __restrict__ ll, int64_t llh, int64_t llw,
                                        const int16_t* __restrict__ lh, const int16_t* __restrict__ hl,
                                        const int16_t* __restrict__ hh, int64_t bh, int64_t bw, int64_t planes,
                                        int64_t hb, int64_t wb, int64_t th, int64_t tw, float s_lh, float s_hl,
                                        float s_hh, float offset, void* __restrict__ out) {
  constexpr int WR = NR + F::L + F::R, WC = NC + F::L + F::R;  // coefficient windows
  const int64_t j0 = (blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x) * NC;
  if (j0 >= wb) return;
  const int64_t tj0 = j0 / tw * tw, nc0 = j0 - tj0;
  int64_t col[WC];
#pragma unroll
  for (int b = 0; b < WC; ++b) col[b] = tj0 + clamp64(nc0 - F::L + b, 0, tw - 1);
  for (int64_t p = blockIdx.z; p < planes; p += gridDim.z) {
    for (int64_t i0 = (blockIdx.y * static_cast<int64_t>(blockDim.y) + threadIdx.y) * NR; i0 < hb;
         i0 += static_cast<int64_t>(gridDim.y) * blockDim.y * NR) {
      const int64_t ti0 = i0 / th * th, nr0 = i0 - ti0;
      int64_t row[WR];
#pragma unroll
      for (int a = 0; a < WR; ++a) row[a] = ti0 + clamp64(nr0 - F::L + a, 0, th - 1);
      F2 v[2 * NR][WC];  // per output row: (lo, hi) at each window column
#pragma unroll
      for (int b = 0; b < WC; ++b) {
        const int64_t cl = min64(col[b], llw - 1), cb = min64(col[b], bw - 1);
        F2 s[WR], d[WR], x[2 * NR];  // s = (ll, lh), d = (hl, hh)
#pragma unroll
        for (int a = 0; a < WR; ++a) {
          const int64_t ol = (p * llh + min64(row[a], llh - 1)) * llw + cl;
          const int64_t ob = (p * bh + min64(row[a], bh - 1)) * bw + cb;
          s[a] = {ll[ol], dequantize(lh[ob], offset, s_lh)};
          d[a] = {dequantize(hl[ob], offset, s_hl), dequantize(hh[ob], offset, s_hh)};
        }
        F::template inv<NR>(s, d, nr0 - F::L, th, x);
#pragma unroll
        for (int r = 0; r < 2 * NR; ++r) v[r][b] = x[r];
      }
#pragma unroll
      for (int r = 0; r < 2 * NR; ++r) {
        float lo[WC], hi[WC], px[2 * NC];
#pragma unroll
        for (int b = 0; b < WC; ++b) lo[b] = v[r][b].a, hi[b] = v[r][b].b;
        F::template inv<NC>(lo, hi, nc0 - F::L, tw, px);
        const int64_t o = (p * 2 * hb + 2 * i0 + r) * (2 * wb) + 2 * j0;
        if constexpr (EMIT_U8) {
          uint8_t q[2 * NC];
#pragma unroll
          for (int e = 0; e < 2 * NC; ++e) q[e] = to_u8(px[e]);
          store_row<uint8_t, 2 * NC>(static_cast<uint8_t*>(out) + o, q);
        } else {
          store_row<float, 2 * NC>(static_cast<float*>(out) + o, px);
        }
      }
    }
  }
}

template <class F, typename In>
struct FwdLaunch {
  template <int NR, int NC>
  struct At {
    static void run(const In* x, int64_t planes, int64_t h, int64_t w, int64_t hb, int64_t wb, int64_t th,
                    int64_t tw, float* ll, int16_t* lh, int16_t* hl, int16_t* hh, float inv_lh, float inv_hl,
                    float inv_hh, cudaStream_t st) {
      auto* kernel = lift97_fwd_level_kernel<F, In, NR, NC>;
      WICCA_LAUNCH(kernel, grid_for(planes, hb / NR, wb / NC), dim3(kBlockX, kBlockY), st, x, planes, h, w, hb, wb,
                   th, tw, ll, lh, hl, hh, inv_lh, inv_hl, inv_hh);
    }
  };
};

template <class F, bool EMIT_U8>
struct InvLaunch {
  template <int NR, int NC>
  struct At {
    static void run(const float* ll, int64_t llh, int64_t llw, const int16_t* lh, const int16_t* hl,
                    const int16_t* hh, int64_t bh, int64_t bw, int64_t planes, int64_t hb, int64_t wb, int64_t th,
                    int64_t tw, float s_lh, float s_hl, float s_hh, float offset, void* out, cudaStream_t st) {
      auto* kernel = lift97_inv_level_kernel<F, EMIT_U8, NR, NC>;
      WICCA_LAUNCH(kernel, grid_for(planes, hb / NR, wb / NC), dim3(kBlockX, kBlockY), st, ll, llh, llw, lh, hl, hh,
                   bh, bw, planes, hb, wb, th, tw, s_lh, s_hl, s_hh, offset, out);
    }
  };
};

template <class F>
void launch_fwd(const void* x, int from_u8, int64_t planes, int64_t h, int64_t w, int64_t hb, int64_t wb, int64_t th,
                int64_t tw, float* ll, int16_t* lh, int16_t* hl, int16_t* hh, float inv_lh, float inv_hl,
                float inv_hh, cudaStream_t st) {
  if (from_u8)
    with_strip<FwdLaunch<F, uint8_t>::template At>(th, tw, static_cast<const uint8_t*>(x), planes, h, w, hb, wb, th,
                                                   tw, ll, lh, hl, hh, inv_lh, inv_hl, inv_hh, st);
  else
    with_strip<FwdLaunch<F, float>::template At>(th, tw, static_cast<const float*>(x), planes, h, w, hb, wb, th, tw,
                                                 ll, lh, hl, hh, inv_lh, inv_hl, inv_hh, st);
}

template <class F>
void launch_inv(const float* ll, int64_t llh, int64_t llw, const int16_t* lh, const int16_t* hl, const int16_t* hh,
                int64_t bh, int64_t bw, int64_t planes, int64_t hb, int64_t wb, int64_t th, int64_t tw, float s_lh,
                float s_hl, float s_hh, float offset, void* out, int emit_u8, cudaStream_t st) {
  if (emit_u8)
    with_strip<InvLaunch<F, true>::template At>(th, tw, ll, llh, llw, lh, hl, hh, bh, bw, planes, hb, wb, th, tw, s_lh,
                                                s_hl, s_hh, offset, out, st);
  else
    with_strip<InvLaunch<F, false>::template At>(th, tw, ll, llh, llw, lh, hl, hh, bh, bw, planes, hb, wb, th, tw,
                                                 s_lh, s_hl, s_hh, offset, out, st);
}

}  // namespace
}  // namespace wicca

using namespace wicca;

extern "C" {

// K8, one level: x (planes, h, w) uint8 (from_u8) or float32, read as if
// edge-padded to (2 hb, 2 wb) -> ll (planes, hb, wb) float32 and lh, hl, hh
// (planes, hb, wb) int16 codes, each band multiplied by its f32(1/step).
// (th, tw): the level's tile in band coordinates. filt: 0 CDF 9/7, 1 db2.
int wicca_lift97_fwd_level(const void* x, int from_u8, int filt, int64_t planes, int64_t h, int64_t w, int64_t hb,
                           int64_t wb, int64_t th, int64_t tw, void* ll, void* lh, void* hl, void* hh, float inv_lh,
                           float inv_hl, float inv_hh, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* l = static_cast<float*>(ll);
  int16_t *a = static_cast<int16_t*>(lh), *b = static_cast<int16_t*>(hl), *c = static_cast<int16_t*>(hh);
  switch (filt) {
    case 0: launch_fwd<Cdf97>(x, from_u8, planes, h, w, hb, wb, th, tw, l, a, b, c, inv_lh, inv_hl, inv_hh, st); break;
    case 1: launch_fwd<Db2>(x, from_u8, planes, h, w, hb, wb, th, tw, l, a, b, c, inv_lh, inv_hl, inv_hh, st); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// K9, one level: ll (planes, llh, llw) float32 and lh, hl, hh (planes, bh,
// bw) int16 codes, read as if edge-padded or cropped to the band grid
// (hb, wb) with tile (th, tw); each code dequantized with its f32 step and
// the reconstruction offset -> out (planes, 2 hb, 2 wb), float32 or uint8
// (emit_u8). filt as for K8.
int wicca_lift97_inv_level(const void* ll, int64_t llh, int64_t llw, const void* lh, const void* hl, const void* hh,
                           int64_t bh, int64_t bw, int filt, int64_t planes, int64_t hb, int64_t wb, int64_t th,
                           int64_t tw, float s_lh, float s_hl, float s_hh, float offset, void* out, int emit_u8,
                           void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* l = static_cast<const float*>(ll);
  const int16_t *a = static_cast<const int16_t*>(lh), *b = static_cast<const int16_t*>(hl),
                *c = static_cast<const int16_t*>(hh);
  switch (filt) {
    case 0:
      launch_inv<Cdf97>(l, llh, llw, a, b, c, bh, bw, planes, hb, wb, th, tw, s_lh, s_hl, s_hh, offset, out, emit_u8,
                        st);
      break;
    case 1:
      launch_inv<Db2>(l, llh, llw, a, b, c, bh, bw, planes, hb, wb, th, tw, s_lh, s_hl, s_hh, offset, out, emit_u8,
                      st);
      break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
