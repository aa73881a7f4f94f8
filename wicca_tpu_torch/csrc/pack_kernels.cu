// Hand-written Hopper kernels of the port's packed stream transfer (PACK1,
// wicca_tpu_torch/codec/transfer.py): the escape-tail statistics (P1), the
// k-bit pack with per-segment escape compaction (P2) and the upload's unpack
// with corrections (P3).
//
// Counterparts in the JAX package (wicca_tpu/codec/transfer.py), jnp under
// jax.jit there, not Pallas:
//   P1  pack1_stats   _stats_fn          (:335)
//   P2  pack1_pack    _pack_fn           (:411)
//   P3  pack1_unpack  _unpack_plane_fn   (:580)
//
// What bounds them on an H100: device-memory bytes. P1 reads every detail
// code once; P2 reads the codes and the LL and writes the packed buffer
// (about 0.65x the codes); P3 reads the fields and corrections and writes
// the planes. Each does a few integer operations per byte.
//
// What the design does about it: one 256-thread block per segment of 4096
// samples (SEG), one launch for all the planes of a stream (a table of up to
// kMaxPlanes planes passed by value as a __grid_constant__, so that blocks
// read it where it lies; a block finds its plane in the table).
// A thread owns 16 consecutive samples, two groups of 8, read as 16-byte
// accesses, so its fields are exactly 2k consecutive bytes and no two
// threads touch one byte: no atomics and no bit overlap between threads.
// P2's escape compaction is a prefix count of the escape flags over the
// block's threads in shared memory (no sort): the first C escapes of the
// segment in position order, then, as the JAX package's lax.top_k pads its
// rows, its first non-escape samples in position order. P1 sums each
// thread's counts per k in shared memory and takes the max over segments
// with one atomicMax per k and block. P3 unpacks a segment's fields into
// shared memory, applies the corrections that fall in it (positions sorted,
// found by binary search), and writes the plane.
//
// Interface: plain C, bound with ctypes. The kernels allocate nothing and
// never synchronise; each entry point launches on the stream it is given and
// returns cudaGetLastError(). Code planes must be 16-byte aligned.
//
// A host C++ compiler builds this same file against host_emulation.h (the
// tests hold that build against the plain PyTorch twins).

#include "launch.cuh"
#include "pack_kernels.cuh"

namespace wicca {
namespace pack1 {
namespace {

// One plane of a launch. P1/P2: src = the int8/int16 codes (or, for P2's
// kind 1, the LL's bytes); P3: dst = the plane written.
struct Plane {
  const void* src;
  void* dst;
  int64_t n;        // samples (kind 1: bytes)
  int64_t seg0;     // the plane's first block in the launch
  int64_t off;      // P1: first stats entry; P2: the plane's byte offset in the buffer; P3: its fields' offset
  int64_t pos_off;  // P3: byte offset of the int32 positions (4-aligned)
  int64_t val_off;  // P3: byte offset of the values
  int32_t ncorr;    // P3: corrections (0: none)
  int32_t width;    // 8 or 16
  int32_t k;        // field bits; k == width: raw zigzag codes
  int32_t cap;      // P2: escape row length
  int32_t kind;     // P2: 0 codes, 1 a byte copy (the LL)
  int32_t pad;
};

struct Table {
  Plane p[kMaxPlanes];
  int32_t count;
};

// The plane that block b belongs to (planes in block order).
WICCA_D const Plane& find_plane(const Table& t, int64_t b) {
  int i = 0;
  while (i + 1 < t.count && t.p[i + 1].seg0 <= b) ++i;
  return t.p[i];
}

// ---------------------------------------------------------------------------
// P1: per plane and k = 1..W-1, the max over segments of #{z >= 2^k - 1}
// ---------------------------------------------------------------------------

template <int W>
WICCA_D void stats_segment(const Plane& pl, int64_t seg, int32_t* __restrict__ out, int (*red)[kThreads]) {
  const int t = threadIdx.x;
  uint32_t z[kPer];
  load_codes<W>(pl.src, pl.n, seg * kSeg + t * kPer, z);
  int cnt[W - 1];
#pragma unroll
  for (int k = 1; k < W; ++k) {
    int c = 0;
#pragma unroll
    for (int j = 0; j < kPer; ++j) c += z[j] >= (1u << k) - 1u;
    cnt[k - 1] = c;
  }
#pragma unroll
  for (int k = 0; k < W - 1; ++k) red[k][t] = cnt[k];
  __syncthreads();
  for (int s = kThreads / 2; s > 0; s >>= 1) {
    if (t < s) {
#pragma unroll
      for (int k = 0; k < W - 1; ++k) red[k][t] += red[k][t + s];
    }
    __syncthreads();
  }
  if (t < W - 1) atomicMax(out + pl.off + t, red[t][0]);
}

__global__ void __launch_bounds__(kThreads)
    pack1_stats_kernel(const __grid_constant__ Table table, int32_t* __restrict__ out) {
  __shared__ int red[15][kThreads];
  const int64_t b = blockIdx.x;
  const Plane& pl = find_plane(table, b);
  if (pl.width == 8)
    stats_segment<8>(pl, b - pl.seg0, out, red);
  else
    stats_segment<16>(pl, b - pl.seg0, out, red);
}

// ---------------------------------------------------------------------------
// P2: the packed buffer. A plane's part: k == W: its npad zigzag codes as
// W-bit little-endian values; else npad*k/8 bytes of fields saturated at the
// marker 2^k - 1, then per segment a row of cap W-bit values: the segment's
// first cap escapes (z >= marker) in position order, padded with its first
// non-escapes in position order. Then the LL's bytes (kind 1).
// ---------------------------------------------------------------------------

template <int W>
WICCA_D void pack_segment(const Plane& pl, int64_t seg, uint8_t* __restrict__ buf, int (*scan)[kThreads]) {
  const int t = threadIdx.x;
  const int k = pl.k;
  const int64_t s0 = seg * kSeg;
  uint32_t z[kPer];
  load_codes<W>(pl.src, pl.n, s0 + t * kPer, z);
  uint8_t* part = buf + pl.off;
  if (k == W) {
    for (int j = 0; j < kPer; ++j) store_value<W>(part, s0 + t * kPer + j, z[j]);
    return;
  }
  const uint32_t marker = (1u << k) - 1u;
  int e = 0;
  for (int g = 0; g < kPer / 8; ++g) {
    uint32_t f[8];
    for (int j = 0; j < 8; ++j) {
      const uint32_t v = z[8 * g + j];
      f[j] = v < marker ? v : marker;
      e += v >= marker;
    }
    pack_group(f, k, part + ((s0 + t * kPer) / 8 + g) * k);
  }
  // inclusive prefix count of the escapes over the block's threads
  int cur = 0;
  scan[0][t] = e;
  __syncthreads();
  for (int d = 1; d < kThreads; d <<= 1) {
    int v = scan[cur][t];
    if (t >= d) v += scan[cur][t - d];
    scan[cur ^ 1][t] = v;
    cur ^= 1;
    __syncthreads();
  }
  const int total = scan[cur][kThreads - 1];
  int esc = scan[cur][t] - e;          // escapes before this thread's samples
  int plain = t * kPer - esc;          // non-escapes before them
  const int64_t npad = (pl.n + kSeg - 1) / kSeg * kSeg;
  uint8_t* row = part + npad * k / 8 + seg * pl.cap * (W / 8);
  for (int j = 0; j < kPer; ++j) {
    const int r = z[j] >= marker ? esc++ : total + plain++;
    if (r < pl.cap) store_value<W>(row, r, z[j]);
  }
}

__global__ void __launch_bounds__(kThreads)
    pack1_pack_kernel(const __grid_constant__ Table table, uint8_t* __restrict__ buf) {
  __shared__ int scan[2][kThreads];
  const int64_t b = blockIdx.x;
  const Plane& pl = find_plane(table, b);
  const int64_t seg = b - pl.seg0;
  if (pl.kind == 1) {
    const uint8_t* src = static_cast<const uint8_t*>(pl.src);
    for (int64_t i = seg * kSeg + threadIdx.x * kPer, e = i + kPer; i < e && i < pl.n; ++i) buf[pl.off + i] = src[i];
  } else if (pl.width == 8) {
    pack_segment<8>(pl, seg, buf, scan);
  } else {
    pack_segment<16>(pl, seg, buf, scan);
  }
}

// ---------------------------------------------------------------------------
// P3: fields (+ sorted corrections) -> the int8/int16 plane
// ---------------------------------------------------------------------------

// The first index of pos[0, n) whose value is >= v (pos non-decreasing).
WICCA_D int lower_bound(const int32_t* pos, int n, int64_t v) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) / 2;
    if (pos[mid] < v)
      lo = mid + 1;
    else
      hi = mid;
  }
  return lo;
}

template <int W>
WICCA_D void unpack_segment(const Plane& pl, int64_t seg, const uint8_t* __restrict__ buf, uint16_t* zs,
                            int* range) {
  using C = typename std::conditional<W == 8, int8_t, int16_t>::type;
  const int t = threadIdx.x;
  const int k = pl.k;
  const int64_t s0 = seg * kSeg;
  const uint8_t* fields = buf + pl.off;
  for (int g = 0; g < kPer / 8; ++g) {
    uint32_t z[8];
    const int64_t i0 = s0 + t * kPer + 8 * g;
    if (k == W) {
      for (int j = 0; j < 8; ++j) z[j] = load_value<W>(fields, i0 + j);
    } else {
      unpack_group(fields + i0 / 8 * k, k, z);
    }
    for (int j = 0; j < 8; ++j) zs[t * kPer + 8 * g + j] = static_cast<uint16_t>(z[j]);
  }
  if (t < 2) {
    const int32_t* pos = reinterpret_cast<const int32_t*>(buf + pl.pos_off);
    range[t] = pl.ncorr ? lower_bound(pos, pl.ncorr, s0 + t * kSeg) : 0;
  }
  __syncthreads();
  const int32_t* pos = reinterpret_cast<const int32_t*>(buf + pl.pos_off);
  for (int c = range[0] + t; c < range[1]; c += kThreads)  // repeats carry equal values
    zs[pos[c] - s0] = static_cast<uint16_t>(load_value<W>(buf + pl.val_off, c));
  __syncthreads();
  C* dst = static_cast<C*>(pl.dst);
  for (int j = 0; j < kPer; ++j) {
    const int64_t i = s0 + t * kPer + j;
    if (i < pl.n) dst[i] = static_cast<C>(unzigzag(zs[t * kPer + j]));
  }
}

__global__ void __launch_bounds__(kThreads)
    pack1_unpack_kernel(const __grid_constant__ Table table, const uint8_t* __restrict__ buf) {
  __shared__ uint16_t zs[kSeg];
  __shared__ int range[2];
  const int64_t b = blockIdx.x;
  const Plane& pl = find_plane(table, b);
  if (pl.width == 8)
    unpack_segment<8>(pl, b - pl.seg0, buf, zs, range);
  else
    unpack_segment<16>(pl, b - pl.seg0, buf, zs, range);
}

// ---------------------------------------------------------------------------
// launches
// ---------------------------------------------------------------------------

// The table of one launch from the wrappers' flat arrays; returns the blocks.
int64_t make_table(Table* t, int count, const void* const* src, void* const* dst, const int64_t* n,
                   const int64_t* off, const int64_t* pos_off, const int64_t* val_off, const int32_t* ncorr,
                   const int32_t* width, const int32_t* k, const int32_t* cap, const int32_t* kind) {
  memset(t, 0, sizeof(Table));
  t->count = count;
  int64_t blocks = 0;
  for (int i = 0; i < count; ++i) {
    Plane& p = t->p[i];
    p.src = src ? src[i] : nullptr;
    p.dst = dst ? dst[i] : nullptr;
    p.n = n[i];
    p.seg0 = blocks;
    p.off = off[i];
    p.pos_off = pos_off ? pos_off[i] : 0;
    p.val_off = val_off ? val_off[i] : 0;
    p.ncorr = ncorr ? ncorr[i] : 0;
    p.width = width[i];
    p.k = k ? k[i] : width[i];
    p.cap = cap ? cap[i] : 0;
    p.kind = kind ? kind[i] : 0;
    blocks += (n[i] + kSeg - 1) / kSeg;
  }
  return blocks;
}

}  // namespace
}  // namespace pack1
}  // namespace wicca

using namespace wicca::pack1;

extern "C" {

// P1: count planes (int8 or int16 codes, width[i] bits, n[i] samples) ->
// out[off[i] + k - 1] = max over segments of #{zigzag >= 2^k - 1},
// k = 1..width-1. out must hold zeros (the launch takes maxima into it).
int wicca_pack1_stats(int count, const void* const* src, const int64_t* n, const int64_t* off,
                      const int32_t* width, int32_t* out, void* stream) {
  if (count < 1 || count > kMaxPlanes) return static_cast<int>(cudaErrorInvalidValue);
  Table t;
  const int64_t blocks = make_table(&t, count, src, nullptr, n, off, nullptr, nullptr, nullptr, width, nullptr,
                                    nullptr, nullptr);
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  if (blocks == 0) return 0;
  WICCA_LAUNCH_SMEM(pack1_stats_kernel, dim3(static_cast<unsigned>(blocks)), dim3(kThreads), 0,
                    static_cast<cudaStream_t>(stream), t, out);
  return static_cast<int>(cudaGetLastError());
}

// P2: count parts into buf: for each, its part at byte off[i]; kind 0: a
// code plane (width, n samples, k, cap); kind 1: n bytes copied (the LL).
int wicca_pack1_pack(int count, const void* const* src, const int64_t* n, const int64_t* off,
                     const int32_t* width, const int32_t* k, const int32_t* cap, const int32_t* kind, void* buf,
                     void* stream) {
  if (count < 1 || count > kMaxPlanes) return static_cast<int>(cudaErrorInvalidValue);
  Table t;
  const int64_t blocks = make_table(&t, count, src, nullptr, n, off, nullptr, nullptr, nullptr, width, k, cap, kind);
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  if (blocks == 0) return 0;
  WICCA_LAUNCH_SMEM(pack1_pack_kernel, dim3(static_cast<unsigned>(blocks)), dim3(kThreads), 0,
                    static_cast<cudaStream_t>(stream), t, static_cast<uint8_t*>(buf));
  return static_cast<int>(cudaGetLastError());
}

// P3: count planes out of buf: plane i (width, n samples) from its fields at
// byte off[i] (k bits; k == width: raw zigzag codes) and ncorr[i] sorted
// int32 positions at pos_off[i] with their values at val_off[i].
int wicca_pack1_unpack(int count, void* const* dst, const int64_t* n, const int64_t* off, const int64_t* pos_off,
                       const int64_t* val_off, const int32_t* ncorr, const int32_t* width, const int32_t* k,
                       const void* buf, void* stream) {
  if (count < 1 || count > kMaxPlanes) return static_cast<int>(cudaErrorInvalidValue);
  Table t;
  const int64_t blocks = make_table(&t, count, nullptr, dst, n, off, pos_off, val_off, ncorr, width, k, nullptr,
                                    nullptr);
  if (blocks > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  if (blocks == 0) return 0;
  WICCA_LAUNCH_SMEM(pack1_unpack_kernel, dim3(static_cast<unsigned>(blocks)), dim3(kThreads), 0,
                    static_cast<cudaStream_t>(stream), t, static_cast<const uint8_t*>(buf));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
