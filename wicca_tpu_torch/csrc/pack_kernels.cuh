// Per-sample and per-group arithmetic of the PACK1 kernels (pack_kernels.cu).
//
// Plain C++ marked __host__ __device__ under nvcc, so a host compiler takes
// the same header (tests/test_torch_kernels_host.py). The layout is the JAX
// package's (wicca_tpu/codec/transfer.py, _pack_fields_jnp and
// _unpack_fields_jnp): 8 samples of k bits make exactly k bytes, sample s of
// a group at bits [s*k, (s+1)*k) of the group's flat little-endian bit
// string (bit 0 = the LSB of its first byte). k <= 15, so a group's bits fit
// in 128.
#pragma once

#include <stdint.h>
#include <string.h>

#include <type_traits>

#if !defined(WICCA_HD)
#if defined(__CUDACC__)
#define WICCA_HD __host__ __device__ __forceinline__
#else
#define WICCA_HD inline
#endif
#endif

namespace wicca {
namespace pack1 {

constexpr int kSeg = 4096;                   // escape-compaction segment (samples); SEG in Python
constexpr int kThreads = 256;                // one block per segment
constexpr int kPer = kSeg / kThreads;        // samples per thread: two groups of 8
constexpr int kMaxPlanes = 40;               // planes per launch (the wrappers split longer lists)

// Zigzag of a W-bit code: small |c| -> small z; -2^(W-1) -> 2^W - 1.
template <int W>
WICCA_HD uint32_t zigzag(int32_t c) {
  const uint32_t z = (static_cast<uint32_t>(c) << 1) ^ static_cast<uint32_t>(c >> 31);
  return z & ((1u << W) - 1u);
}

WICCA_HD int32_t unzigzag(uint32_t z) {
  return static_cast<int32_t>(z >> 1) ^ -static_cast<int32_t>(z & 1u);
}

// Eight fields of k bits (each < 2^k) -> k bytes.
WICCA_HD void pack_group(const uint32_t* z, int k, uint8_t* out) {
  uint64_t lo = 0, hi = 0;
  for (int s = 0; s < 8; ++s) {
    const int off = s * k;
    const uint64_t v = z[s];
    if (off < 64) {
      lo |= v << off;
      if (off + k > 64) hi |= v >> (64 - off);
    } else {
      hi |= v << (off - 64);
    }
  }
  for (int i = 0; i < k; ++i) out[i] = static_cast<uint8_t>(i < 8 ? lo >> (8 * i) : hi >> (8 * (i - 8)));
}

// k bytes -> eight fields of k bits.
WICCA_HD void unpack_group(const uint8_t* in, int k, uint32_t* z) {
  uint64_t lo = 0, hi = 0;
  for (int i = 0; i < k; ++i) {
    if (i < 8)
      lo |= static_cast<uint64_t>(in[i]) << (8 * i);
    else
      hi |= static_cast<uint64_t>(in[i]) << (8 * (i - 8));
  }
  const uint32_t mask = (1u << k) - 1u;
  for (int s = 0; s < 8; ++s) {
    const int off = s * k;
    uint64_t v;
    if (off < 64) {
      v = lo >> off;
      if (off + k > 64) v |= hi << (64 - off);
    } else {
      v = hi >> (off - 64);
    }
    z[s] = static_cast<uint32_t>(v) & mask;
  }
}

// The 16 zigzag codes of one thread: samples [i0, i0 + 16) of a W-bit plane
// of n samples, zeros past n (the segment padding). One 16-byte access per 16
// bytes where the whole span lies inside the plane (i0 is a multiple of 16
// and the plane's base 16-byte aligned).
template <int W>
WICCA_HD void load_codes(const void* src, int64_t n, int64_t i0, uint32_t* z) {
  using C = typename std::conditional<W == 8, int8_t, int16_t>::type;
  const C* p = static_cast<const C*>(src) + i0;
  C c[kPer];
  if (i0 + kPer <= n) {
#if defined(__CUDA_ARCH__)
    for (int b = 0; b < kPer * W / 8; b += 16) {
      const uint4 v = *reinterpret_cast<const uint4*>(reinterpret_cast<const uint8_t*>(p) + b);
      memcpy(reinterpret_cast<uint8_t*>(c) + b, &v, 16);
    }
#else
    memcpy(c, p, sizeof(c));
#endif
  } else {
    for (int j = 0; j < kPer; ++j) c[j] = i0 + j < n ? p[j] : C(0);
  }
  for (int j = 0; j < kPer; ++j) z[j] = zigzag<W>(c[j]);
}

// A W-bit value as W/8 little-endian bytes at byte offset 'at' of dst.
template <int W>
WICCA_HD void store_value(uint8_t* dst, int64_t at, uint32_t v) {
  dst[at * (W / 8)] = static_cast<uint8_t>(v);
  if (W == 16) dst[at * 2 + 1] = static_cast<uint8_t>(v >> 8);
}

template <int W>
WICCA_HD uint32_t load_value(const uint8_t* src, int64_t at) {
  uint32_t v = src[at * (W / 8)];
  if (W == 16) v |= static_cast<uint32_t>(src[at * 2 + 1]) << 8;
  return v;
}

}  // namespace pack1
}  // namespace wicca
