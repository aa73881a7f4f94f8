// PACK1 host side of the port's packed stream transfer
// (wicca_tpu_torch/codec/transfer.py; the port's own copy of the JAX
// package's wicca_tpu/native/pack.cpp, the same body). Reconstructing
// ~160M samples a frame in one linear pass here costs ~0.3 s on one core;
// the transfer module runs one plane per thread.
//
//   reconstruct  device->host: k-bit fields + the per-segment escape rows
//                the device packed (csrc/pack_kernels.cu, pack1_pack) ->
//                the int8/int16 plane
//   pack         host->device: plane -> saturated k-bit fields + explicit
//                (position, value) corrections, unpacked on the card by
//                pack1_unpack
//   stats        global escape-tail counts that choose the upload's k
//
// Bit layout contract: fields pack groups of 8 samples into exactly k bytes,
// assembled as ceil(8k/32) little-endian uint32 words. On a little-endian
// host that is equivalent to a flat LE bit stream: sample s of a group
// occupies bits [s*k, (s+1)*k) counted from the group's first byte, bit 0 =
// LSB of byte 0. The readers/writers below use that flat addressing; a
// reader or writer touches the 4 bytes from a field's first byte, so a
// field buffer needs 3 bytes of slack after its end (+4 in the writer's
// caller, the rest of the packed buffer in the reader's).
//
// ABI: plain C + size_t returns, bound with ctypes (native/pack.py).

#include <cstdint>
#include <cstring>
#include <cstddef>

namespace {

inline uint32_t read_bits(const uint8_t* base, size_t bit_off, int k) {
  // k <= 25 so an unaligned 32-bit window always covers the field
  uint32_t w;
  std::memcpy(&w, base + (bit_off >> 3), 4);
  return (w >> (bit_off & 7)) & ((1u << k) - 1u);
}

inline void write_bits(uint8_t* base, size_t bit_off, int k, uint32_t v) {
  (void)k;  // v is already < 2**k (saturated by the caller)
  uint32_t w;
  uint8_t* p = base + (bit_off >> 3);
  std::memcpy(&w, p, 4);
  w |= v << (bit_off & 7);
  std::memcpy(p, &w, 4);
}

template <typename Z>
inline Z zigzag(int32_t c) {
  return static_cast<Z>((c << 1) ^ (c >> 31));
}

template <typename C>
inline C unzigzag(uint32_t z) {
  return static_cast<C>(static_cast<int32_t>(z >> 1) ^ -static_cast<int32_t>(z & 1));
}

// ---- device->host reconstruction: fields (+ segmented escape rows) -> plane
template <typename C, typename Z>
size_t reconstruct(const uint8_t* fields, const Z* exc, int k, size_t n,
                   size_t npad, size_t cap, size_t seg, C* out) {
  const uint32_t marker = (1u << k) - 1u;
  size_t used = 0;
  for (size_t s0 = 0; s0 < n; s0 += seg) {
    const Z* row = exc + (s0 / seg) * cap;
    size_t take = 0;
    size_t hi = s0 + seg < n ? s0 + seg : n;
    for (size_t i = s0; i < hi; ++i) {
      uint32_t z = read_bits(fields, i * static_cast<size_t>(k), k);
      if (z == marker) z = static_cast<uint32_t>(row[take++]);
      out[i] = unzigzag<C>(z);
    }
    used += take;
  }
  (void)npad;
  return used;
}

// ---- host->device pack: plane -> saturated fields + explicit corrections
template <typename C, typename Z>
size_t pack(const C* plane, size_t n, size_t npad, int k, uint8_t* fields,
            int32_t* pos, Z* val, size_t max_corr) {
  const uint32_t marker = (1u << k) - 1u;
  std::memset(fields, 0, npad * static_cast<size_t>(k) / 8);
  size_t ncorr = 0;
  for (size_t i = 0; i < n; ++i) {
    uint32_t z = static_cast<uint32_t>(zigzag<Z>(static_cast<int32_t>(plane[i])));
    uint32_t f = z;
    if (z >= marker) {
      f = marker;
      if (ncorr < max_corr) {
        pos[ncorr] = static_cast<int32_t>(i);
        val[ncorr] = static_cast<Z>(z);
      }
      ++ncorr;
    }
    write_bits(fields, i * static_cast<size_t>(k), k, f);
  }
  return ncorr;  // caller verifies ncorr <= max_corr (stats-derived)
}

// ---- escape-tail stats: counts[j] = #{ z >= 2^(j+1) - 1 }, j = 0..width-2
template <typename C>
void stats(const C* plane, size_t n, int width, int64_t* counts) {
  size_t hist[33] = {0};  // by bit-length class of z+1
  for (size_t i = 0; i < n; ++i) {
    int32_t c = static_cast<int32_t>(plane[i]);
    uint32_t z = static_cast<uint32_t>((c << 1) ^ (c >> 31));
    // classify: smallest k with z < 2^k - 1  <=>  z+1 < 2^k
    uint32_t zp = z + 1;
    int bl = 32 - __builtin_clz(zp);  // bits needed for z+1, >= 1
    ++hist[bl];
  }
  // z >= 2^k - 1  <=>  z+1 >= 2^k  <=>  bl(z+1) >= k+1
  for (int k = 1; k < width; ++k) {
    int64_t c = 0;
    for (int b = k + 1; b <= 32; ++b) c += static_cast<int64_t>(hist[b]);
    counts[k - 1] = c;
  }
}

}  // namespace

extern "C" {

size_t wicca_pack1_reconstruct_i8(const uint8_t* fields, const uint8_t* exc,
                                  int k, size_t n, size_t npad, size_t cap,
                                  size_t seg, int8_t* out) {
  return reconstruct<int8_t, uint8_t>(fields, exc, k, n, npad, cap, seg, out);
}

size_t wicca_pack1_reconstruct_i16(const uint8_t* fields, const uint16_t* exc,
                                   int k, size_t n, size_t npad, size_t cap,
                                   size_t seg, int16_t* out) {
  return reconstruct<int16_t, uint16_t>(fields, exc, k, n, npad, cap, seg, out);
}

size_t wicca_pack1_pack_i8(const int8_t* plane, size_t n, size_t npad, int k,
                           uint8_t* fields, int32_t* pos, uint8_t* val,
                           size_t max_corr) {
  return pack<int8_t, uint8_t>(plane, n, npad, k, fields, pos, val, max_corr);
}

size_t wicca_pack1_pack_i16(const int16_t* plane, size_t n, size_t npad, int k,
                            uint8_t* fields, int32_t* pos, uint16_t* val,
                            size_t max_corr) {
  return pack<int16_t, uint16_t>(plane, n, npad, k, fields, pos, val, max_corr);
}

void wicca_pack1_stats_i8(const int8_t* plane, size_t n, int64_t* counts) {
  stats<int8_t>(plane, n, 8, counts);
}

void wicca_pack1_stats_i16(const int16_t* plane, size_t n, int64_t* counts) {
  stats<int16_t>(plane, n, 16, counts);
}

}  // extern "C"
