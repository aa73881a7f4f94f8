// Hand-written Hopper kernels for the lossless (reversible) codec: tile-local
// integer lifting levels, forward (K6) and inverse (K7), for the filters of
// lifting_kernels.cuh (LeGall 5/3 and integer Haar).
//
// Replaces (wicca_tpu/ops/dwt53_pallas.py):
//   K6  dwt53_multilevel_pallas  -> _dwt53_kernel
//   K7  idwt53_multilevel_pallas -> _idwt53_kernel
//
// Semantics: JPEG2000-style independent tiles. A pass's input is cut into
// (512, 1024) tiles (or one tile per dimension that fits); level l of the
// pass works on the tile halved l-1 times and clamps every lifting step at
// that tile's edges. A level lifts horizontally first, then vertically;
// details are stored int16 (cast from int32), the LL stays int32. The
// inverse runs on the same grid; a partial pass of a progressive decode
// passes the coarse tile of the full pass (orig_k) so its clamps land where
// the encoder's did.
//
// What bounds them on an H100: device-memory bytes. A 5/3 level does about
// 20 integer operations per coefficient; the lossless depth-5 roundtrip of a
// 3x8704x6144 uint8 frame moves about 1 GB (about 0.3 ms at 3.35 TB/s) and
// its operations take a few microseconds.
//
// What the design does about it: the TPU keeps a whole (512, 1024) tile in
// VMEM, 2 MB in int32, far above the 227 KB a block may hold here. So
// nothing is carried over: one launch per level, and each thread owns a
// strip of 2 x 4 coefficient positions (1 x 1 where a tile's extents are not
// multiples of 2 and 4) that never crosses a tile seam. It loads from device memory the
// window its lifting steps need at clamped tile-local indices (7 x 11
// samples for a 5/3 forward strip, 4 x 6 per band for an inverse one; the
// neighbouring strips' overlap hits L1) and writes its outputs as 8- and
// 16-byte rows. A thread per single position, the first version, issued 25
// (forward) and about 30 (inverse) loads per position and ran at 10-26% of
// the byte bound; the strips share their windows (PERF.md). Between the
// levels of a pass the LL goes through int32 scratch that the wrapper
// allocates. No shared memory and no barrier, so the host build
// (host_emulation.h) runs the same code. A fused pass with shared-memory
// halos, as K2/K3 fuse their levels, is later work.
//
// Interface: plain C, bound with ctypes; the wrapper is
// wicca_tpu_torch/ops/dwt53_cuda.py. Each entry point launches one level on
// the stream it is given and returns cudaGetLastError().

#include <type_traits>

#include "launch.cuh"
#include "lifting_kernels.cuh"

namespace wicca {
namespace {

// ---------------------------------------------------------------------------
// K6: one forward level. x (planes, h, w) is read as if edge-padded to the
// band grid (2 hb, 2 wb); th x tw is the tile in band coordinates (pairs).
// A thread computes an NR x NC strip of coefficient positions, which never
// crosses a tile seam (NR divides th, NC divides tw).
// ---------------------------------------------------------------------------

template <class F, typename In, int NR, int NC>
__global__ void lift_fwd_level_kernel(const In* __restrict__ x, int64_t planes, int64_t h, int64_t w, int64_t hb,
                                      int64_t wb, int64_t th, int64_t tw, int32_t* __restrict__ ll,
                                      int16_t* __restrict__ lh, int16_t* __restrict__ hl,
                                      int16_t* __restrict__ hh) {
  constexpr int WR = 2 * NR + 3, WC = 2 * NC + 3;  // sample windows
  const int64_t j0 = (blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x) * NC;
  if (j0 >= wb) return;
  const int64_t tj0 = j0 / tw * tw, nc0 = j0 - tj0;
  int64_t col[WC];
  F::template fwd_taps<NC>(nc0, tw, col);
#pragma unroll
  for (int b = 0; b < WC; ++b) col[b] = min64(2 * tj0 + col[b], w - 1);
  for (int64_t p = blockIdx.z; p < planes; p += gridDim.z) {
    for (int64_t i0 = (blockIdx.y * static_cast<int64_t>(blockDim.y) + threadIdx.y) * NR; i0 < hb;
         i0 += static_cast<int64_t>(gridDim.y) * blockDim.y * NR) {
      const int64_t ti0 = i0 / th * th, nr0 = i0 - ti0;
      int64_t row[WR];
      F::template fwd_taps<NR>(nr0, th, row);
      I2 v[WR][NC];  // per window row: the horizontal (low, high) pairs of the strip
#pragma unroll
      for (int a = 0; a < WR; ++a) {
        const In* src = x + (p * h + min64(2 * ti0 + row[a], h - 1)) * w;
        int32_t win[WC], s[NC], d[NC];
#pragma unroll
        for (int b = 0; b < WC; ++b) win[b] = static_cast<int32_t>(src[col[b]]);
        F::template fwd<NC>(win, nc0 == 0, s, d);
#pragma unroll
        for (int c = 0; c < NC; ++c) v[a][c] = {s[c], d[c]};
      }
      int32_t o_ll[NR][NC];
      int16_t o_lh[NR][NC], o_hl[NR][NC], o_hh[NR][NC];
#pragma unroll
      for (int c = 0; c < NC; ++c) {
        I2 win[WR], s[NR], d[NR];  // s = (ll, lh), d = (hl, hh)
#pragma unroll
        for (int a = 0; a < WR; ++a) win[a] = v[a][c];
        F::template fwd<NR>(win, nr0 == 0, s, d);
#pragma unroll
        for (int r = 0; r < NR; ++r) {
          o_ll[r][c] = s[r].a;
          o_lh[r][c] = static_cast<int16_t>(s[r].b);
          o_hl[r][c] = static_cast<int16_t>(d[r].a);
          o_hh[r][c] = static_cast<int16_t>(d[r].b);
        }
      }
#pragma unroll
      for (int r = 0; r < NR; ++r) {
        const int64_t o = (p * hb + i0 + r) * wb + j0;
        store_row<int32_t, NC>(ll + o, o_ll[r]);
        store_row<int16_t, NC>(lh + o, o_lh[r]);
        store_row<int16_t, NC>(hl + o, o_hl[r]);
        store_row<int16_t, NC>(hh + o, o_hh[r]);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// K7: one inverse level. The band grid is hb x wb (tile th x tw); the LL
// (planes, llh, llw) and the bands (planes, bh, bw) are read as if
// edge-padded (or cropped) to it. out is (planes, 2 hb, 2 wb), int32 or uint8
// (clip, cast). A thread expands an NR x NC strip of coefficient positions
// into its 2NR x 2NC output block.
// ---------------------------------------------------------------------------

template <class F, bool EMIT_U8, int NR, int NC>
__global__ void lift_inv_level_kernel(const int32_t* __restrict__ ll, int64_t llh, int64_t llw,
                                      const int16_t* __restrict__ lh, const int16_t* __restrict__ hl,
                                      const int16_t* __restrict__ hh,
                                      int64_t bh, int64_t bw, int64_t planes, int64_t hb, int64_t wb, int64_t th,
                                      int64_t tw, void* __restrict__ out) {
  constexpr int WR = NR + 2, WC = NC + 2;  // coefficient windows
  const int64_t j0 = (blockIdx.x * static_cast<int64_t>(blockDim.x) + threadIdx.x) * NC;
  if (j0 >= wb) return;
  const int64_t tj0 = j0 / tw * tw, nc0 = j0 - tj0;
  int64_t col[WC];
  F::template inv_taps<NC>(nc0, tw, col);
  for (int64_t p = blockIdx.z; p < planes; p += gridDim.z) {
    for (int64_t i0 = (blockIdx.y * static_cast<int64_t>(blockDim.y) + threadIdx.y) * NR; i0 < hb;
         i0 += static_cast<int64_t>(gridDim.y) * blockDim.y * NR) {
      const int64_t ti0 = i0 / th * th, nr0 = i0 - ti0;
      int64_t row[WR];
      F::template inv_taps<NR>(nr0, th, row);
      I2 v[2 * NR][WC];  // per output row: (lo, hi) at each window column
#pragma unroll
      for (int b = 0; b < WC; ++b) {
        const int64_t cl = min64(tj0 + col[b], llw - 1), cb = min64(tj0 + col[b], bw - 1);
        I2 s[WR], d[WR], x[2 * NR];  // s = (ll, lh), d = (hl, hh)
#pragma unroll
        for (int a = 0; a < WR; ++a) {
          const int64_t r = ti0 + row[a];
          const int64_t ol = (p * llh + min64(r, llh - 1)) * llw + cl;
          const int64_t ob = (p * bh + min64(r, bh - 1)) * bw + cb;
          s[a] = {ll[ol], static_cast<int32_t>(lh[ob])};
          d[a] = {static_cast<int32_t>(hl[ob]), static_cast<int32_t>(hh[ob])};
        }
        F::template inv<NR>(s, d, nr0 + NR == th, x);
#pragma unroll
        for (int r = 0; r < 2 * NR; ++r) v[r][b] = x[r];
      }
#pragma unroll
      for (int r = 0; r < 2 * NR; ++r) {
        int32_t lo[WC], hi[WC], px[2 * NC];
#pragma unroll
        for (int b = 0; b < WC; ++b) lo[b] = v[r][b].a, hi[b] = v[r][b].b;
        F::template inv<NC>(lo, hi, nc0 + NC == tw, px);
        const int64_t o = (p * 2 * hb + 2 * i0 + r) * (2 * wb) + 2 * j0;
        if constexpr (EMIT_U8) {
          uint8_t q[2 * NC];
#pragma unroll
          for (int e = 0; e < 2 * NC; ++e) q[e] = static_cast<uint8_t>(px[e] < 0 ? 0 : (px[e] > 255 ? 255 : px[e]));
          store_row<uint8_t, 2 * NC>(static_cast<uint8_t*>(out) + o, q);
        } else {
          store_row<int32_t, 2 * NC>(static_cast<int32_t*>(out) + o, px);
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
                    int64_t tw, int32_t* ll, int16_t* lh, int16_t* hl, int16_t* hh, cudaStream_t st) {
      auto* kernel = lift_fwd_level_kernel<F, In, NR, NC>;
      WICCA_LAUNCH(kernel, grid_for(planes, hb / NR, wb / NC), dim3(kBlockX, kBlockY), st, x, planes, h, w, hb, wb,
                   th, tw, ll, lh, hl, hh);
    }
  };
};

template <class F, bool EMIT_U8>
struct InvLaunch {
  template <int NR, int NC>
  struct At {
    static void run(const int32_t* ll, int64_t llh, int64_t llw, const int16_t* lh, const int16_t* hl,
                    const int16_t* hh, int64_t bh,
                    int64_t bw, int64_t planes, int64_t hb, int64_t wb, int64_t th, int64_t tw, void* out,
                    cudaStream_t st) {
      auto* kernel = lift_inv_level_kernel<F, EMIT_U8, NR, NC>;
      WICCA_LAUNCH(kernel, grid_for(planes, hb / NR, wb / NC), dim3(kBlockX, kBlockY), st, ll, llh, llw, lh, hl, hh,
                   bh, bw, planes, hb, wb, th, tw, out);
    }
  };
};

template <class F>
void launch_fwd(const void* x, int from_u8, int64_t planes, int64_t h, int64_t w, int64_t hb, int64_t wb,
                int64_t th, int64_t tw, int32_t* ll, int16_t* lh, int16_t* hl, int16_t* hh, cudaStream_t st) {
  if (from_u8)
    with_strip<FwdLaunch<F, uint8_t>::template At>(th, tw, static_cast<const uint8_t*>(x), planes, h, w, hb, wb, th,
                                                   tw, ll, lh, hl, hh, st);
  else
    with_strip<FwdLaunch<F, int32_t>::template At>(th, tw, static_cast<const int32_t*>(x), planes, h, w, hb, wb, th,
                                                   tw, ll, lh, hl, hh, st);
}

template <class F>
void launch_inv(const int32_t* ll, int64_t llh, int64_t llw, const int16_t* lh, const int16_t* hl, const int16_t* hh,
                int64_t bh, int64_t bw, int64_t planes, int64_t hb, int64_t wb, int64_t th, int64_t tw, void* out,
                int emit_u8, cudaStream_t st) {
  if (emit_u8)
    with_strip<InvLaunch<F, true>::template At>(th, tw, ll, llh, llw, lh, hl, hh, bh, bw, planes, hb, wb, th, tw, out,
                                                st);
  else
    with_strip<InvLaunch<F, false>::template At>(th, tw, ll, llh, llw, lh, hl, hh, bh, bw, planes, hb, wb, th, tw,
                                                 out, st);
}

}  // namespace
}  // namespace wicca

using namespace wicca;

extern "C" {

// K6, one level: x (planes, h, w) uint8 (from_u8) or int32, read as if
// edge-padded to (2 hb, 2 wb) -> ll (planes, hb, wb) int32 and lh, hl, hh
// (planes, hb, wb) int16. (th, tw): the level's tile in band coordinates.
// filt: 0 LeGall 5/3, 1 integer Haar.
int wicca_lift_fwd_level(const void* x, int from_u8, int filt, int64_t planes, int64_t h, int64_t w, int64_t hb,
                         int64_t wb, int64_t th, int64_t tw, void* ll, void* lh, void* hl, void* hh, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int32_t* l = static_cast<int32_t*>(ll);
  int16_t *a = static_cast<int16_t*>(lh), *b = static_cast<int16_t*>(hl), *c = static_cast<int16_t*>(hh);
  switch (filt) {
    case 0: launch_fwd<Legall53>(x, from_u8, planes, h, w, hb, wb, th, tw, l, a, b, c, st); break;
    case 1: launch_fwd<HaarInt>(x, from_u8, planes, h, w, hb, wb, th, tw, l, a, b, c, st); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// K7, one level: ll (planes, llh, llw) int32 and lh, hl, hh (planes, bh, bw)
// int16, read as if edge-padded or cropped to the band grid (hb, wb) with
// tile (th, tw) -> out (planes, 2 hb, 2 wb), int32 or uint8 (emit_u8). filt
// as for K6.
int wicca_lift_inv_level(const void* ll, int64_t llh, int64_t llw, const void* lh, const void* hl, const void* hh,
                         int64_t bh, int64_t bw, int filt, int64_t planes, int64_t hb, int64_t wb, int64_t th,
                         int64_t tw, void* out, int emit_u8, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int32_t* l = static_cast<const int32_t*>(ll);
  const int16_t *a = static_cast<const int16_t*>(lh), *b = static_cast<const int16_t*>(hl),
                *c = static_cast<const int16_t*>(hh);
  switch (filt) {
    case 0: launch_inv<Legall53>(l, llh, llw, a, b, c, bh, bw, planes, hb, wb, th, tw, out, emit_u8, st); break;
    case 1: launch_inv<HaarInt>(l, llh, llw, a, b, c, bh, bw, planes, hb, wb, th, tw, out, emit_u8, st); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
