// Hand-written Hopper kernels for the lossless (reversible) codec: tile-local
// integer lifting levels, forward (K6) and inverse (K7), for the filters of
// lifting_kernels.cuh (LeGall 5/3 and integer Haar), with the reversible
// color transform folded into K6's first and K7's last launch.
//
// Replaces (wicca_tpu/ops/dwt53_pallas.py):
//   K6  dwt53_multilevel_pallas  -> _dwt53_kernel
//   K7  idwt53_multilevel_pallas -> _idwt53_kernel
// and, with color 1, the jnp RCT around them (wicca_tpu/codec/pipeline.py:
// 176-179 and 461-464, i.e. wicca_tpu/core/color.py:23-41).
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
// 20 integer operations per coefficient. Levels 1-3 of a 3x8704x6144 uint8
// frame read the frame and write the bands and the level-3 LL: 486.3 MB,
// 0.145 ms at 3.35 TB/s; with the int32 LL that this design still writes
// and reads back between the levels, 886 MB. The inverse moves the same.
//
// The first design (PR 2) gave each thread a 2 x 4 strip of positions and
// loaded the strip's whole window, 7 x 11 samples for a forward strip and
// 4 x 6 per band for an inverse one, with scalar loads and 64-bit clamped
// index arithmetic per tap: 77 and 96 loads per 8 positions. It ran at
// 23-56% of the byte bound, bound by instruction issue (levels 1-3 from
// uint8 0.6209 ms, to uint8 0.4138 ms; H100 80GB HBM3 at 700 W, PERF.md).
//
// This design (line lifting): a warp owns 32 neighbouring strips of NC = 4
// pair columns of one tile row and walks down a chunk of R pair rows of one
// tile, keeping the whole lifting state in registers. Forward: each sample
// row is read once, lifted horizontally in registers, and the vertical
// step is the filter's own recurrence, with e[n] and d[n-1] carried from
// one pair row to the next; each pair row stores 16 bytes of LL and 8 of
// each band per thread, neighbouring lanes on neighbouring addresses.
// Inverse: the same in reverse, each coefficient row read once (the strip
// and its two tile-clamped neighbour columns, which the thread inverts
// vertically itself), two output rows stored per step. A unit reads its
// rows at 32-bit offsets from a 64-bit base, the start of its first row, so
// a plane may hold 2**31 samples or more at the cost of one 64-bit product
// per unit; plan() keeps a chunk of rows under 2**31 samples.
//
// The loads: a row-walking thread that loads each row when it needs it
// keeps too few bytes in flight at the occupancy its registers allow (80-
// 200 of them), so uint8 rows (K6) and all of K7's rows go through a ring
// in shared memory that each thread fills, 4-8 rows ahead, with its own
// cp.async copies (the strip, and the 4- or 8-byte words that hold its halo
// samples) and reads back itself: no barrier. K6's int32 rows are loaded
// directly as two 16-byte vectors per thread, which measured faster than
// through the ring. Tiles whose width is not a
// multiple of 4 take NC = 1 with scalar loads, as do rows whose stride is
// not a multiple of 16 bytes. R is chosen per level so the grid fills the
// card (plan()). The host build (host_emulation.h) runs the same code; its
// cp.async copies land only at the wait that covers them, so a read before
// the right wait fails a test.
//
// The RCT (color 1): a unit carries an image's three planes. K6's first
// launch reads planar RGB(A), uint8 or int32, each of R, G, B once, forms
// Y = (R + 2G + B) >> 2, U = B - G, V = R - G and lifts the three (a unit
// that gave each output plane its own thread read seven source strips per
// position instead of three, and measured slower). K7's last launch
// reconstructs Y, U and V and applies G = Y - ((U + V) >> 2), R = V + G,
// B = U + G and, with emit_u8, the clip. An alpha plane is a unit of its
// own, lifted as it is.
//
// Interface: plain C, bound with ctypes; the wrapper is
// wicca_tpu_torch/ops/dwt53_cuda.py. Each entry point launches one level on
// the stream it is given and returns cudaGetLastError().

#include "launch.cuh"
#include "lifting_kernels.cuh"

namespace wicca {
namespace {

constexpr int kLanes = 32;
constexpr int kWarps = 4;           // warps per block; each warp walks one unit
constexpr int kMaxRows = 32;        // pair rows per unit, at most
constexpr int kMinRows = 4;         // ... and at least, unless the tile is shorter
constexpr int kWarpsPerSm = 64;     // the grid aims at this many units per SM
constexpr int kNc = 4;              // pair columns per strip, where the tile's width allows (else 1)

WICCA_HD int mini(int a, int b) { return a < b ? a : b; }

// A unit: kLanes neighbouring strips of NC pair columns of one tile row, R
// pair rows of one tile of one plane (or, with the RCT, of one group of
// planes). Units are numbered planes fastest, then strip groups, then
// chunks of rows, so the planes of one image at one place run side by side.
struct Unit {
  int p;   // plane or group
  int i0;  // first pair row of the chunk
  int j0;  // first pair column of this lane's strip
};

WICCA_D bool unit_of(int64_t units, int nplanes, int sgroups, int rows, int nc, Unit& u) {
  const int64_t v = int64_t(blockIdx.x) * kWarps + threadIdx.y;
  if (v >= units) return false;
  u.p = static_cast<int>(v % nplanes);
  const int64_t rest = v / nplanes;
  u.i0 = static_cast<int>(rest / sgroups) * rows;
  u.j0 = (static_cast<int>(rest % sgroups) * kLanes + static_cast<int>(threadIdx.x)) * nc;
  return true;
}

// The planes of group p: with the RCT an image's three color planes or its
// alpha plane (groups_of counts them), else plane p alone.
template <bool RCT>
WICCA_D void group_planes(int p, int cin, int& first, int& np) {
  first = p, np = 1;
  if constexpr (RCT) {
    const int per = cin == 4 ? 2 : 1;  // groups per image
    const bool alpha = p % per == 1;
    first = p / per * cin + (alpha ? 3 : 0);
    np = alpha ? 1 : 3;
  }
}

// The launch shape of a level: R pair rows per unit, the largest power of
// two up to kMaxRows that divides the tile and still gives kWarpsPerSm
// units per SM (not below kMinRows), and whose chunk of rows, span(R) rows
// of row_len samples, stays under 2**31 samples (the units' 32-bit row
// offsets; R = 0 when not even one pair row fits).
struct Plan {
  int rows, sgroups;
  int64_t units;
};

template <typename Span>
Plan plan(int64_t nplanes, int hb, int wb, int th, int nc, int64_t row_len, Span span) {
  int dev = 0, sms = 0;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  const int sgroups = (wb + kLanes * nc - 1) / (kLanes * nc);
  auto units = [&](int r) { return nplanes * (hb / r) * sgroups; };
  auto fits = [&](int r) { return span(r) * row_len < (int64_t(1) << 31); };
  int r = kMaxRows;
  while (r > 1 && (th % r != 0 || !fits(r) || (r > kMinRows && units(r) < int64_t(kWarpsPerSm) * sms))) r /= 2;
  if (!fits(r)) return {0, sgroups, 0};
  return {r, sgroups, units(r)};
}

int64_t blocks_for(int64_t units) { return (units + kWarps - 1) / kWarps; }

// ---------------------------------------------------------------------------
// The ring of rows. A thread with a strip inside the input copies the rows
// it will read, DEPTH rows ahead, with cp.async into slots of its own in
// dynamic shared memory and reads them back itself, so loads stay in flight
// without holding registers and no barrier is needed. A slot holds pieces of
// 16 bytes, piece-major with the block's threads side by side (a warp reads
// 32 neighbouring pieces: no bank conflicts).
// ---------------------------------------------------------------------------

struct alignas(16) Piece {
  uint32_t w[4];
};

constexpr int kThreads = kLanes * kWarps;

// rows in flight per thread for a row of `pieces` pieces
constexpr int ring_depth(int pieces) { return pieces <= 4 ? 8 : (pieces <= 8 ? 4 : 2); }

// ---------------------------------------------------------------------------
// K6: one forward level. x (planes, h, w) is read as if edge-padded to the
// band grid (2 hb, 2 wb); th x tw is the tile in band coordinates (pairs).
// ---------------------------------------------------------------------------

// The window of one sample row for a strip starting at sample column cs,
// loaded directly (the path without a ring): x[0], x[1] the two samples
// before it and x[2NC+2] the one after it, at the tile-clamped columns c0,
// c1, c2 (loaded only if HALO), and the strip in x[2 .. 2NC+1], clamped to
// the input's last column w-1 unless vec (vector loads, in bounds and
// aligned).
template <typename In, int NC, bool HALO>
WICCA_D void load_window(const In* __restrict__ row, int cs, int c0, int c1, int c2, int w, bool vec, int32_t* x) {
  if (vec) {
    In t[2 * NC];
    load_row<In, 2 * NC>(row + cs, t);
#pragma unroll
    for (int e = 0; e < 2 * NC; ++e) x[2 + e] = t[e];
  } else {
#pragma unroll
    for (int e = 0; e < 2 * NC; ++e) x[2 + e] = row[mini(cs + e, w - 1)];
  }
  if constexpr (HALO) {
    x[0] = row[c0];
    x[1] = row[c1];
    x[2 * NC + 2] = row[c2];
  } else {  // never read by a pair-local filter
    x[0] = x[1] = x[2 * NC + 2] = x[2];
  }
}

// uint8 rows only: int32 rows (32 bytes per strip) measured faster loaded
// directly. A thread's ring slot holds, per source plane (with the RCT R, G
// and B), a piece with the strip and a halo piece: the 4 bytes before the
// strip (its left neighbours, where it does not start its tile) and the 4
// just after it (the right one, where the tile and the input go on).
template <typename In, int NC, bool RCT>
struct FwdRing {
  static constexpr bool ON = sizeof(In) == 1 && NC == kNc;
  static constexpr int SRC = RCT ? 3 : 1;  // source planes per row
  static constexpr int DEPTH = ring_depth(SRC * 2);
  static constexpr size_t BYTES = ON ? size_t(DEPTH) * SRC * 2 * kThreads * sizeof(Piece) : 0;
};

// With the RCT a unit is a group, as in K7: an image's R, G, B planes, from
// which it lifts Y, U and V, or its alpha plane.
template <class F, typename In, int NC, bool RCT>
__global__ void __launch_bounds__(kThreads)
    lift_fwd_lines_kernel(const In* __restrict__ x, int groups, int cin, int h, int w, int hb, int wb, int th,
                          int tw, int rows, int sgroups, int64_t units, bool vec_ok, int32_t* __restrict__ ll,
                          int16_t* __restrict__ lh, int16_t* __restrict__ hl, int16_t* __restrict__ hh) {
  using Ring = FwdRing<In, NC, RCT>;
  constexpr int P = RCT ? 3 : 1;  // planes a unit carries
  constexpr int W = 2 * NC + 3, DEPTH = Ring::DEPTH;
  constexpr int LO = 4;  // where column cs lies in a halo piece
  Unit u;
  if (!unit_of(units, groups, sgroups, rows, NC, u) || u.j0 >= wb) return;
  int first, np;  // the unit's first plane and its count
  group_planes<RCT>(u.p, cin, first, np);
  const int ti0 = u.i0 / th * th, n0 = u.i0 - ti0;
  const int tj0 = u.j0 / tw * tw, nc0 = u.j0 - tj0;
  const int cs = 2 * u.j0;
  const int c0 = mini(2 * tj0 + (nc0 > 0 ? 2 * nc0 - 2 : 0), w - 1);
  const int c1 = mini(2 * tj0 + (nc0 > 0 ? 2 * nc0 - 1 : 1), w - 1);
  const int c2 = mini(2 * tj0 + (nc0 + NC < tw ? 2 * (nc0 + NC) : 2 * tw - 2), w - 1);
  const bool vec = vec_ok && cs + 2 * NC <= w;
  const bool ring = Ring::ON && vec;
  const int64_t hw = int64_t(h) * w;
  // the unit's sample rows, tile-local: a_first .. a_last, in this order
  const int a_first = F::kHalo && n0 > 0 ? 2 * n0 - 2 : 2 * n0;
  const int a_last = n0 + rows < th ? 2 * (n0 + rows) : 2 * th - 1;
  // row a of source k: 32-bit offset from the unit's first row (the base)
  const int rb = mini(2 * ti0 + a_first, h - 1);
  const In* src = x + int64_t(first) * hw + int64_t(rb) * w;
  auto row_of = [&](int k, int a) { return src + k * hw + (mini(2 * ti0 + a, h - 1) - rb) * w; };
  const bool need_left = F::kHalo && nc0 > 0, need_right = F::kHalo && c2 == cs + 2 * NC;
  WICCA_SMEM(smem);
  // this thread's slot of row a and source k
  auto slot = [&](int a, int k) {
    const int s = (a - a_first) & (DEPTH - 1);
    const int t = static_cast<int>(threadIdx.y) * kLanes + static_cast<int>(threadIdx.x);
    return reinterpret_cast<Piece*>(smem) + (s * Ring::SRC + k) * 2 * kThreads + t;
  };
  // copy row a of every source into its slot, as one group (empty past the last row)
  auto fetch = [&](int a) {
    if constexpr (Ring::ON) {
      if (a <= a_last) {
#pragma unroll
        for (int k = 0; k < P; ++k) {
          if (k < np) {
            const In* row = row_of(k, a);
            Piece* p = slot(a, k);
            copy_async<2 * NC>(p, row + cs);
            unsigned char* halo = reinterpret_cast<unsigned char*>(p + kThreads);
            if (need_left) copy_async<4>(halo, row + cs - 4);
            if (need_right) copy_async<4>(halo + 4, row + cs + 2 * NC);
          }
        }
      }
      async_commit();
    }
  };
  if constexpr (Ring::ON) {
    if (ring) {
#pragma unroll
      for (int i = 0; i < DEPTH - 1; ++i) fetch(a_first + i);
    }
  }

  // the window of row a of source k (x[0..1] the two samples before the
  // strip, x[2NC+2] the one after it, all tile-clamped)
  auto window = [&](int a, int k, int32_t* xw) {
    if constexpr (Ring::ON) {
      if (ring) {
        const Piece* p = slot(a, k);
        In t[2 * NC];
        load_row<In, 2 * NC>(reinterpret_cast<const In*>(p), t);
#pragma unroll
        for (int e = 0; e < 2 * NC; ++e) xw[2 + e] = t[e];
        const In* halo = reinterpret_cast<const In*>(p + kThreads);
        xw[0] = need_left ? halo[LO - 2] : t[0];
        xw[1] = need_left ? halo[LO - 1] : t[1];
        xw[2 * NC + 2] = need_right ? halo[LO] : (c2 == cs + 2 * NC - 1 ? t[2 * NC - 1] : t[2 * NC - 2]);
        return;
      }
    }
    load_window<In, NC, F::kHalo>(row_of(k, a), cs, c0, c1, c2, w, vec, xw);
  };
  // the horizontal level of row a for every plane: (low, high) per pair
  // column. Row a is in its slots once this thread's oldest group has
  // landed; the slots of row a-1, read by now, take row a + DEPTH - 1.
  auto hrow = [&](int a, I2 (*v)[NC]) {
    if constexpr (Ring::ON) {
      if (ring) {
        async_wait<DEPTH - 2>();
        fetch(a + DEPTH - 1);
      }
    }
    int32_t win[P][W];
#pragma unroll
    for (int k = 0; k < P; ++k)
      if (k < np) window(a, k, win[k]);
    if constexpr (RCT) {
      if (np == 3) {  // Y = (R + 2G + B) >> 2, U = B - G, V = R - G
#pragma unroll
        for (int e = 0; e < W; ++e) {
          const int32_t r = win[0][e], g = win[1][e], b = win[2][e];
          win[0][e] = (r + 2 * g + b) >> 2, win[1][e] = b - g, win[2][e] = r - g;
        }
      }
    }
#pragma unroll
    for (int q = 0; q < P; ++q) {
      if (q < np) {
        int32_t s[NC], d[NC];
        lift_run<F, NC>(win[q], nc0 == 0, s, d);
#pragma unroll
        for (int c = 0; c < NC; ++c) v[q][c] = {s[c], d[c]};
      }
    }
  };

  // the vertical level: e = row 2n, dp = d[n-1], carried down the chunk
  I2 e[P][NC], dp[P][NC] = {}, o[P][NC], e1[P][NC];
  if (F::kHalo && n0 > 0) {
    I2 ep[P][NC], op[P][NC];
    hrow(2 * n0 - 2, ep);
    hrow(2 * n0 - 1, op);
    hrow(2 * n0, e);
#pragma unroll
    for (int q = 0; q < P; ++q)
#pragma unroll
      for (int c = 0; c < NC; ++c) dp[q][c] = F::predict(ep[q][c], op[q][c], e[q][c]);
  } else {
    hrow(2 * n0, e);
  }
  const int64_t plane = int64_t(hb) * wb;
  int64_t ob = (int64_t(first) * hb + u.i0) * wb + u.j0;
  for (int n = n0; n < n0 + rows; ++n, ob += wb) {
    hrow(2 * n + 1, o);
    if (n + 1 < th) {
      hrow(2 * n + 2, e1);
    } else {  // e[m] -> e[m-1]
#pragma unroll
      for (int q = 0; q < P; ++q)
#pragma unroll
        for (int c = 0; c < NC; ++c) e1[q][c] = e[q][c];
    }
#pragma unroll
    for (int q = 0; q < P; ++q) {
      if (q < np) {
        int32_t o_ll[NC];
        int16_t o_lh[NC], o_hl[NC], o_hh[NC];
#pragma unroll
        for (int c = 0; c < NC; ++c) {
          const I2 d = F::predict(e[q][c], o[q][c], e1[q][c]);
          if (n == 0) dp[q][c] = d;  // d[-1] -> d[0]
          const I2 s = F::update(e[q][c], dp[q][c], d);
          o_ll[c] = s.a;
          o_lh[c] = static_cast<int16_t>(s.b);
          o_hl[c] = static_cast<int16_t>(d.a);
          o_hh[c] = static_cast<int16_t>(d.b);
          e[q][c] = e1[q][c];
          dp[q][c] = d;
        }
        const int64_t oq = ob + q * plane;
        store_row<int32_t, NC>(ll + oq, o_ll);
        store_row<int16_t, NC>(lh + oq, o_lh);
        store_row<int16_t, NC>(hl + oq, o_hl);
        store_row<int16_t, NC>(hh + oq, o_hh);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// K7: one inverse level. The band grid is hb x wb (tile th x tw); the LL
// (planes, llh, llw) and the bands (planes, bh, bw) are read as if
// edge-padded (or cropped) to it. out is (planes, 2 hb, 2 wb), int32 or uint8
// (clip, cast). With the RCT a unit is a group: an image's Y, U, V planes,
// or its alpha plane.
// ---------------------------------------------------------------------------

template <int NC, bool RCT>
struct InvRing {
  // per plane: the LL strip, the three band strips, two halo pieces
  static constexpr int PLANE = 1 + 3 + 2;
  static constexpr bool ON = NC == kNc;
  static constexpr int P = RCT ? 3 : 1;
  static constexpr int DEPTH = ring_depth(P * PLANE);
  static constexpr size_t BYTES = ON ? size_t(DEPTH) * P * PLANE * kThreads * sizeof(Piece) : 0;
};

template <class F, bool EMIT_U8, int NC, bool RCT>
__global__ void __launch_bounds__(kThreads)
    lift_inv_lines_kernel(const int32_t* __restrict__ ll, int llh, int llw, const int16_t* __restrict__ lh,
                          const int16_t* __restrict__ hl, const int16_t* __restrict__ hh, int bh, int bw,
                          int groups, int cin, int hb, int wb, int th, int tw, int rows, int sgroups, int64_t units,
                          bool vec_ok, void* __restrict__ out) {
  using Ring = InvRing<NC, RCT>;
  constexpr int P = Ring::P;      // planes a unit carries
  constexpr int K = NC + 2;       // columns: n0-1 (tile-clamped), the strip, n0+NC (tile-clamped)
  constexpr int DEPTH = Ring::DEPTH;
  Unit u;
  if (!unit_of(units, groups, sgroups, rows, NC, u) || u.j0 >= wb) return;
  int first, np;  // the unit's first plane and its count
  group_planes<RCT>(u.p, cin, first, np);
  const int ti0 = u.i0 / th * th, n0 = u.i0 - ti0;
  const int tj0 = u.j0 / tw * tw, nc0 = u.j0 - tj0;
  const int cl = tj0 + (nc0 > 0 ? nc0 - 1 : 0), cr = tj0 + (nc0 + NC < tw ? nc0 + NC : tw - 1);
  const int lcr = mini(cr, llw - 1), bcl = mini(cl, bw - 1), bcr = mini(cr, bw - 1);
  const bool last = nc0 + NC == tw;
  const bool vec = vec_ok && u.j0 + NC <= llw && u.j0 + NC <= bw;
  const bool need_left = F::kHalo && nc0 > 0, need_right = F::kHalo && !last;
  // the ring also takes the right halo as 4-byte words: columns cr, cr + 1
  const bool ring = Ring::ON && vec && (!need_right || (cr + 1 <= llw && cr + 2 <= bw));
  // the unit's coefficient rows, tile-local: b_first .. b_last, in this order
  const int b_first = F::kHalo && n0 > 0 ? n0 - 1 : n0;
  const int b_last = n0 + rows < th ? n0 + rows : th - 1;
  // rows at 32-bit offsets from the unit's first LL and band rows (the bases)
  const int rl = mini(ti0 + b_first, llh - 1), rbb = mini(ti0 + b_first, bh - 1);
  auto ll_row = [&](int q, int r) {
    return ll + (int64_t(first + q) * llh + rl) * llw + (mini(ti0 + r, llh - 1) - rl) * llw;
  };
  auto band_off = [&](int q, int r) {
    return (int64_t(first + q) * bh + rbb) * bw + (mini(ti0 + r, bh - 1) - rbb) * bw;
  };
  WICCA_SMEM(smem);
  const int tid = static_cast<int>(threadIdx.y) * kLanes + static_cast<int>(threadIdx.x);
  auto slot = [&](int r, int q) {
    const int s = (r - b_first) & (DEPTH - 1);
    return reinterpret_cast<Piece*>(smem) + (s * P + q) * Ring::PLANE * kThreads + tid;
  };
  // copy row r of every plane into its slot, as one group (empty past the last row)
  auto fetch = [&](int r) {
    if constexpr (Ring::ON) {
      if (r <= b_last) {
#pragma unroll
        for (int q = 0; q < P; ++q) {
          if (q < np) {
            const int32_t* L = ll_row(q, r);
            const int64_t ob = band_off(q, r);
            const int16_t* bands[3] = {lh + ob, hl + ob, hh + ob};
            Piece* p = slot(r, q);
            copy_async<4 * NC>(p, L + u.j0);
#pragma unroll
            for (int b = 0; b < 3; ++b) copy_async<2 * NC>(p + (1 + b) * kThreads, bands[b] + u.j0);
            // halo words: lh, hh at columns j0-2, j0-1; ll at cr; lh, hl, hh at cr, cr+1
            unsigned char* halo = reinterpret_cast<unsigned char*>(p + 4 * kThreads);
            if (need_left) {
              copy_async<4>(halo, bands[0] + u.j0 - 2);
              copy_async<4>(halo + 4, bands[2] + u.j0 - 2);
            }
            if (need_right) {
              copy_async<4>(halo + 8, L + cr);
              copy_async<4>(halo + 12, bands[0] + cr);
              copy_async<4>(halo + 16 * kThreads, bands[1] + cr);
              copy_async<4>(halo + 16 * kThreads + 4, bands[2] + cr);
            }
          }
        }
      }
      async_commit();
    }
  };
  if constexpr (Ring::ON) {
    if (ring) {
#pragma unroll
      for (int i = 0; i < DEPTH; ++i) fetch(b_first + i);
    }
  }
  auto acquire = [&]() {
    if constexpr (Ring::ON) {
      if (ring) async_wait<DEPTH - 1>();
    }
  };
  auto release = [&](int r) {
    if constexpr (Ring::ON) {
      if (ring) fetch(r + DEPTH);
    }
  };

  // coefficient row r (tile-local) of plane first + q: s = (ll, lh) and
  // d = (hl, hh) at the K columns (the left column's low band is not needed)
  auto crow = [&](int q, int r, I2* s, I2* d) {
    int32_t l[NC];
    int16_t a[NC], b[NC], c[NC];
    bool left = false, right = false;
    if constexpr (Ring::ON) {
      if (ring) {
        const Piece* p = slot(r, q);
        load_row<int32_t, NC>(reinterpret_cast<const int32_t*>(p), l);
        load_row<int16_t, NC>(reinterpret_cast<const int16_t*>(p + kThreads), a);
        load_row<int16_t, NC>(reinterpret_cast<const int16_t*>(p + 2 * kThreads), b);
        load_row<int16_t, NC>(reinterpret_cast<const int16_t*>(p + 3 * kThreads), c);
        const unsigned char* halo = reinterpret_cast<const unsigned char*>(p + 4 * kThreads);
        const int16_t* h0 = reinterpret_cast<const int16_t*>(halo);
        const int16_t* h1 = reinterpret_cast<const int16_t*>(halo + 16 * kThreads);
        if (need_left) s[0] = {0, h0[1]}, d[0] = {0, h0[3]}, left = true;
        if (need_right) {
          s[K - 1] = {reinterpret_cast<const int32_t*>(halo)[2], h0[6]}, d[K - 1] = {h1[0], h1[2]};
          right = true;
        }
      }
    }
    if (!(Ring::ON && ring)) {
      const int32_t* L = ll_row(q, r);
      const int64_t ob = band_off(q, r);
      const int16_t *A = lh + ob, *B = hl + ob, *C = hh + ob;
      if (vec) {
        load_row<int32_t, NC>(L + u.j0, l);
        load_row<int16_t, NC>(A + u.j0, a);
        load_row<int16_t, NC>(B + u.j0, b);
        load_row<int16_t, NC>(C + u.j0, c);
      } else {
#pragma unroll
        for (int e = 0; e < NC; ++e) {
          const int jl = mini(u.j0 + e, llw - 1), jb = mini(u.j0 + e, bw - 1);
          l[e] = L[jl], a[e] = A[jb], b[e] = B[jb], c[e] = C[jb];
        }
      }
      if constexpr (F::kHalo) {
        s[0] = {0, A[bcl]}, d[0] = {0, C[bcl]};
        s[K - 1] = {L[lcr], A[bcr]}, d[K - 1] = {B[bcr], C[bcr]};
        left = right = true;
      }
    }
#pragma unroll
    for (int e = 0; e < NC; ++e) s[1 + e] = {l[e], a[e]}, d[1 + e] = {b[e], c[e]};
    if (!left) s[0] = s[1], d[0] = d[1];  // column n0-1 clamps to n0 (or is never read)
    if (!right) s[K - 1] = s[K - 2], d[K - 1] = d[K - 2];  // n0+NC clamps to n0+NC-1 (never read)
  };

  // the vertical state per plane and column: e[n] and d[n]
  I2 E[P][K], D[P][K], dm[P][K];
  if (F::kHalo && n0 > 0) {
    acquire();
#pragma unroll
    for (int q = 0; q < P; ++q) {
      if (q < np) {
        I2 unused[K];
        crow(q, n0 - 1, unused, dm[q]);
      }
    }
    release(n0 - 1);
  }
  acquire();
#pragma unroll
  for (int q = 0; q < P; ++q) {
    if (q < np) {
      I2 s0[K];
      crow(q, n0, s0, D[q]);
      if (!(F::kHalo && n0 > 0)) {  // d[-1] -> d[0]
#pragma unroll
        for (int k = 0; k < K; ++k) dm[q][k] = D[q][k];
      }
#pragma unroll
      for (int k = 0; k < K; ++k) E[q][k] = F::unupdate(s0[k], dm[q][k], D[q][k]);
    }
  }
  release(n0);

  // store output row 2 (ti0 + n) + odd of every plane the unit carries
  const int64_t ow = 2 * int64_t(wb);
  auto store = [&](int n, int odd, int32_t (*px)[2 * NC]) {
    if constexpr (RCT) {
      if (np == 3) {
#pragma unroll
        for (int e = 0; e < 2 * NC; ++e) rct_inv_px(px[0][e], px[1][e], px[2][e], px[0][e], px[1][e], px[2][e]);
      }
    }
#pragma unroll
    for (int q = 0; q < P; ++q) {
      if (q < np) {
        const int64_t o = ((first + q) * 2 * int64_t(hb) + 2 * (ti0 + n) + odd) * ow + 2 * u.j0;
        if constexpr (EMIT_U8) {
          uint8_t b[2 * NC];
#pragma unroll
          for (int e = 0; e < 2 * NC; ++e)
            b[e] = static_cast<uint8_t>(px[q][e] < 0 ? 0 : (px[q][e] > 255 ? 255 : px[q][e]));
          store_row<uint8_t, 2 * NC>(static_cast<uint8_t*>(out) + o, b);
        } else {
          store_row<int32_t, 2 * NC>(static_cast<int32_t*>(out) + o, px[q]);
        }
      }
    }
  };

  for (int n = n0; n < n0 + rows; ++n) {
    int32_t px[P][2 * NC];
    // even row 2n: e[n], horizontally inverted
#pragma unroll
    for (int q = 0; q < P; ++q) {
      if (q < np) {
        int32_t lo[K], hi[K];
#pragma unroll
        for (int k = 0; k < K; ++k) lo[k] = E[q][k].a, hi[k] = E[q][k].b;
        unlift_run<F, NC>(lo, hi, last, px[q]);
      }
    }
    store(n, 0, px);
    // odd row 2n+1 from e[n], d[n] and e[n+1] (the next row's, or e[m-1])
    const bool more = n + 1 < th;
    if (more) acquire();
#pragma unroll
    for (int q = 0; q < P; ++q) {
      if (q < np) {
        I2 e1[K], d1[K];
        if (more) {
          I2 s1[K];
          crow(q, n + 1, s1, d1);
#pragma unroll
          for (int k = 0; k < K; ++k) e1[k] = F::unupdate(s1[k], D[q][k], d1[k]);
        } else {
#pragma unroll
          for (int k = 0; k < K; ++k) e1[k] = E[q][k], d1[k] = D[q][k];
        }
        int32_t lo[K], hi[K];
#pragma unroll
        for (int k = 0; k < K; ++k) {
          const I2 xo = F::unpredict(E[q][k], D[q][k], e1[k]);
          lo[k] = xo.a, hi[k] = xo.b;
          E[q][k] = e1[k], D[q][k] = d1[k];
        }
        unlift_run<F, NC>(lo, hi, last, px[q]);
      }
    }
    if (more) release(n + 1);
    store(n, 1, px);
  }
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

// A kernel with a ring takes its shared memory dynamically, above 48 KB
// once allowed (the caller's `allowed`, one per kernel, is returned if it
// failed); one without it launches without.
template <typename K, typename... A>
cudaError_t launch_lines(K kernel, size_t smem, cudaError_t allowed, int64_t blocks, dim3 block, cudaStream_t st,
                         A... args) {
  if (allowed != cudaSuccess) return allowed;
  if (smem)
    WICCA_LAUNCH_SMEM(kernel, dim3(static_cast<unsigned>(blocks)), block, smem, st, args...);
  else
    WICCA_LAUNCH(kernel, dim3(static_cast<unsigned>(blocks)), block, st, args...);
  return cudaGetLastError();
}

template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes) {
  if (!bytes) return cudaSuccess;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(bytes));
}

template <class F, typename In, int NC, bool RCT>
cudaError_t launch_fwd(const In* x, int groups, int cin, int h, int w, int hb, int wb, int th, int tw, int32_t* ll,
                       int16_t* lh, int16_t* hl, int16_t* hh, cudaStream_t st) {
  // a chunk reads up to 2 R + 3 sample rows
  const Plan pl = plan(groups, hb, wb, th, NC, w, [](int r) { return int64_t(2) * r + 3; });
  if (!pl.rows) return cudaErrorInvalidValue;
  const bool vec_ok = int64_t(w) * int64_t(sizeof(In)) % 16 == 0;
  auto* kernel = lift_fwd_lines_kernel<F, In, NC, RCT>;
  constexpr size_t smem = FwdRing<In, NC, RCT>::BYTES;
  static const cudaError_t allowed = allow_smem(kernel, smem);
  return launch_lines(kernel, smem, allowed, blocks_for(pl.units), dim3(kLanes, kWarps), st, x, groups, cin, h, w,
                      hb, wb, th, tw, pl.rows, pl.sgroups, pl.units, vec_ok, ll, lh, hl, hh);
}

template <class F, typename In>
cudaError_t launch_fwd_any(const In* x, int rct, int groups, int cin, int h, int w, int hb, int wb, int th, int tw,
                           int32_t* ll, int16_t* lh, int16_t* hl, int16_t* hh, cudaStream_t st) {
  if (rct)
    return tw % kNc == 0 ? launch_fwd<F, In, kNc, true>(x, groups, cin, h, w, hb, wb, th, tw, ll, lh, hl, hh, st)
                         : launch_fwd<F, In, 1, true>(x, groups, cin, h, w, hb, wb, th, tw, ll, lh, hl, hh, st);
  return tw % kNc == 0 ? launch_fwd<F, In, kNc, false>(x, groups, cin, h, w, hb, wb, th, tw, ll, lh, hl, hh, st)
                       : launch_fwd<F, In, 1, false>(x, groups, cin, h, w, hb, wb, th, tw, ll, lh, hl, hh, st);
}

template <class F>
cudaError_t launch_fwd_in(const void* x, int from_u8, int rct, int groups, int cin, int h, int w, int hb, int wb,
                          int th, int tw, int32_t* ll, int16_t* lh, int16_t* hl, int16_t* hh, cudaStream_t st) {
  if (from_u8)
    return launch_fwd_any<F>(static_cast<const uint8_t*>(x), rct, groups, cin, h, w, hb, wb, th, tw, ll, lh, hl, hh,
                             st);
  return launch_fwd_any<F>(static_cast<const int32_t*>(x), rct, groups, cin, h, w, hb, wb, th, tw, ll, lh, hl, hh,
                           st);
}

struct InvArgs {
  const int32_t* ll;
  int llh, llw;
  const int16_t *lh, *hl, *hh;
  int bh, bw, groups, cin, hb, wb, th, tw;
  void* out;
};

template <class F, bool EMIT_U8, int NC, bool RCT>
cudaError_t launch_inv(const InvArgs& a, cudaStream_t st) {
  // a chunk reads up to R + 2 coefficient rows
  const Plan pl = plan(a.groups, a.hb, a.wb, a.th, NC, a.llw > a.bw ? a.llw : a.bw,
                       [](int r) { return int64_t(r) + 2; });
  if (!pl.rows) return cudaErrorInvalidValue;
  const bool vec_ok = int64_t(a.llw) * 4 % 16 == 0 && int64_t(a.bw) * 2 % 16 == 0;
  auto* kernel = lift_inv_lines_kernel<F, EMIT_U8, NC, RCT>;
  constexpr size_t smem = InvRing<NC, RCT>::BYTES;
  static const cudaError_t allowed = allow_smem(kernel, smem);
  return launch_lines(kernel, smem, allowed, blocks_for(pl.units), dim3(kLanes, kWarps), st, a.ll, a.llh, a.llw,
                      a.lh, a.hl, a.hh, a.bh, a.bw, a.groups, a.cin, a.hb, a.wb, a.th, a.tw, pl.rows, pl.sgroups,
                      pl.units, vec_ok, a.out);
}

template <class F, bool EMIT_U8>
cudaError_t launch_inv_nc(const InvArgs& a, int rct, cudaStream_t st) {
  if (rct) return a.tw % kNc == 0 ? launch_inv<F, EMIT_U8, kNc, true>(a, st) : launch_inv<F, EMIT_U8, 1, true>(a, st);
  return a.tw % kNc == 0 ? launch_inv<F, EMIT_U8, kNc, false>(a, st) : launch_inv<F, EMIT_U8, 1, false>(a, st);
}

template <class F>
cudaError_t launch_inv_any(const InvArgs& a, int emit_u8, int rct, cudaStream_t st) {
  return emit_u8 ? launch_inv_nc<F, true>(a, rct, st) : launch_inv_nc<F, false>(a, rct, st);
}

// The units' planes: with the RCT, an image's three color planes or its
// alpha plane form one group.
int64_t groups_of(int64_t planes, int color, int cin) { return color ? planes / cin * (cin == 4 ? 2 : 1) : planes; }

}  // namespace
}  // namespace wicca

using namespace wicca;

extern "C" {

// K6, one level: x (planes, h, w) uint8 (from_u8) or int32, read as if
// edge-padded to (2 hb, 2 wb) -> ll (planes, hb, wb) int32 and lh, hl, hh
// (planes, hb, wb) int16. (th, tw): the level's tile in band coordinates.
// filt: 0 LeGall 5/3, 1 integer Haar. color 1: the planes are images of cin
// (3 or 4) planes R, G, B (, A), and the level lifts Y, U, V (, A) of the
// RCT.
int wicca_lift_fwd_level(const void* x, int from_u8, int filt, int64_t planes, int64_t h, int64_t w, int64_t hb,
                         int64_t wb, int64_t th, int64_t tw, void* ll, void* lh, void* hl, void* hh, int color,
                         int cin, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int32_t* l = static_cast<int32_t*>(ll);
  int16_t *a = static_cast<int16_t*>(lh), *b = static_cast<int16_t*>(hl), *c = static_cast<int16_t*>(hh);
  const int args[] = {static_cast<int>(groups_of(planes, color, cin)), cin, static_cast<int>(h), static_cast<int>(w),
                      static_cast<int>(hb), static_cast<int>(wb), static_cast<int>(th), static_cast<int>(tw)};
  switch (filt) {
    case 0:
      return static_cast<int>(launch_fwd_in<Legall53>(x, from_u8, color, args[0], args[1], args[2], args[3], args[4],
                                                       args[5], args[6], args[7], l, a, b, c, st));
    case 1:
      return static_cast<int>(launch_fwd_in<HaarInt>(x, from_u8, color, args[0], args[1], args[2], args[3], args[4],
                                                      args[5], args[6], args[7], l, a, b, c, st));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// K7, one level: ll (planes, llh, llw) int32 and lh, hl, hh (planes, bh, bw)
// int16, read as if edge-padded or cropped to the band grid (hb, wb) with
// tile (th, tw) -> out (planes, 2 hb, 2 wb), int32 or uint8 (emit_u8). filt
// as for K6. color 1: the planes are images of cin planes Y, U, V (, A), and
// the level emits R, G, B (, A) of the inverse RCT.
int wicca_lift_inv_level(const void* ll, int64_t llh, int64_t llw, const void* lh, const void* hl, const void* hh,
                         int64_t bh, int64_t bw, int filt, int64_t planes, int64_t hb, int64_t wb, int64_t th,
                         int64_t tw, void* out, int emit_u8, int color, int cin, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int64_t groups = groups_of(planes, color, cin);
  const InvArgs a{static_cast<const int32_t*>(ll), static_cast<int>(llh), static_cast<int>(llw),
                  static_cast<const int16_t*>(lh), static_cast<const int16_t*>(hl), static_cast<const int16_t*>(hh),
                  static_cast<int>(bh), static_cast<int>(bw), static_cast<int>(groups), cin, static_cast<int>(hb),
                  static_cast<int>(wb), static_cast<int>(th), static_cast<int>(tw), out};
  switch (filt) {
    case 0: return static_cast<int>(launch_inv_any<Legall53>(a, emit_u8, color, st));
    case 1: return static_cast<int>(launch_inv_any<HaarInt>(a, emit_u8, color, st));
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // extern "C"
