// Adaptive Rice/Golomb entropy codec and context-modeled range coder for
// quantized wavelet detail planes: the host-side entropy stage of the
// ``.wct`` container (wicca_tpu_torch/codec/container.py). The card produces
// deadzone int8/int16 codes (and int32 at high bit depth); this library turns
// them into a compact bitstream and back, bit-exactly.
//
// This is the port's own copy of wicca_tpu/native/entropy.cpp, built by
// wicca_tpu_torch/native/rice.py. Both bitstream formats are frozen: the
// port's container bytes must equal the reference's, and each package reads
// the other's files, so any change here that alters an encoded byte needs a
// new codec id in both packages.
//
// Scheme: zigzag map to unsigned, then per-block (B=512) coding in one of
// two modes (1 header bit + 5-bit Rice parameter):
//   mode 0 — plain Rice: unary quotient (capped at ESCAPE -> raw value)
//            plus k low bits, k chosen from the block's mean magnitude.
//   mode 1 — zero-run: Elias-gamma zero-run lengths alternating with
//            Rice-coded (value-1) for the nonzeros; chosen when >=3/4 of
//            the block is zero. Deadzone detail planes are overwhelmingly
//            zero, and runs push the rate well below 1 bit/value, close to
//            the order-0 Shannon bound measured by
//            codec/pipeline.estimated_entropy_bytes.
//
// C ABI (ctypes): all functions return the number of bytes written/read,
// or 0 on error (insufficient capacity / malformed stream).

#include <cstdint>
#include <cstring>
#include <algorithm>

namespace {

constexpr int BLOCK = 512;
constexpr uint32_t ESCAPE_Q = 20;  // unary quotient cap before raw escape

// 64-bit accumulators: the writer flushes 4 bytes per spill (unaligned
// store), the reader refills 8 bytes at a time and decodes unary runs with
// one ctz instead of bit-by-bit loops. The emitted BITSTREAM is identical
// to the original byte-at-a-time implementation (LSB-first packing).
struct BitWriter {
    uint8_t* out;
    size_t cap;
    size_t byte = 0;
    uint64_t acc = 0;
    int nbits = 0;
    bool overflow = false;

    inline void put(uint32_t bits, int n) {  // n <= 32
        acc |= static_cast<uint64_t>(bits) << nbits;
        nbits += n;
        if (nbits >= 32) {
            if (byte + 4 > cap) { overflow = true; nbits &= 31; return; }
            uint32_t w = static_cast<uint32_t>(acc);
            std::memcpy(out + byte, &w, 4);
            byte += 4;
            acc >>= 32;
            nbits -= 32;
        }
    }
    size_t finish() {
        while (nbits > 0) {
            if (byte >= cap) { overflow = true; return 0; }
            out[byte++] = static_cast<uint8_t>(acc & 0xff);
            acc >>= 8;
            nbits -= 8;
        }
        return overflow ? 0 : byte;
    }
};

struct BitReader {
    const uint8_t* in;
    size_t len;
    size_t byte = 0;
    uint64_t acc = 0;
    int nbits = 0;
    bool error = false;

    inline void refill() {
        if (byte + 8 <= len) {
            // whole-word refill: OR 8 bytes at the current offset, advance
            // only by the bytes that fit. Bits shifted past 64 are lost but
            // re-ORed identically on the next refill (acc only ever shifts
            // right, so its stale top bits always match the stream).
            uint64_t w;
            std::memcpy(&w, in + byte, 8);
            acc |= w << nbits;
            int take = (63 - nbits) >> 3;
            byte += take;
            nbits += take * 8;
            return;
        }
        while (nbits <= 56 && byte < len) {
            acc |= static_cast<uint64_t>(in[byte++]) << nbits;
            nbits += 8;
        }
    }
    inline uint32_t get(int n) {
        if (nbits < n) {
            refill();
            if (nbits < n) { error = true; return 0; }
        }
        uint32_t v = static_cast<uint32_t>(acc & ((n == 32) ? 0xffffffffu : ((1u << n) - 1u)));
        acc >>= n;
        nbits -= n;
        return v;
    }
    inline uint32_t get_unary(uint32_t cap_q) {
        uint32_t q = 0;
        for (;;) {
            if (nbits == 0) {
                refill();
                if (nbits == 0) { error = true; return 0; }
            }
            uint64_t mask = (nbits >= 64) ? ~0ull : ((1ull << nbits) - 1ull);
            uint64_t inv = (~acc) & mask;  // zero-bit positions
            int run = inv ? __builtin_ctzll(inv) : nbits;  // leading ones
            if (q + static_cast<uint32_t>(run) >= cap_q) {
                int used = static_cast<int>(cap_q - q);  // escape: cap ones, no terminator
                acc >>= used;
                nbits -= used;
                return cap_q;
            }
            if (inv) {
                acc >>= run;  // two shifts: run + 1 may be 64 (shift-width UB)
                acc >>= 1;
                nbits -= (run + 1);
                return q + static_cast<uint32_t>(run);
            }
            q += static_cast<uint32_t>(run);  // buffer was all ones
            acc = 0;
            nbits = 0;
        }
    }
};

inline uint32_t zigzag32(int32_t v) {
    return (static_cast<uint32_t>(v) << 1) ^ static_cast<uint32_t>(v >> 31);
}
inline int32_t unzigzag32(uint32_t u) {
    return static_cast<int32_t>(u >> 1) ^ -static_cast<int32_t>(u & 1);
}

// pick k from the block's mean unsigned magnitude
inline int pick_k(const uint32_t* u, int n) {
    uint64_t sum = 0;
    for (int i = 0; i < n; i++) sum += u[i];
    if (sum == 0) return 0;
    double mean = static_cast<double>(sum) / n;
    int k = 0;
    while ((1u << (k + 1)) < mean + 1 && k < 30) k++;
    return k;
}

inline void put_gamma(BitWriter& bw, uint32_t v) {
    // Elias gamma for v >= 1: (len-1) ones, a zero, then the low len-1 bits
    // (v <= BLOCK+1 here, so 2*len-1 <= 21 bits -> single put)
    int len = 1;
    while ((v >> len) != 0) len++;
    uint32_t low = v & ((1u << (len - 1)) - 1u);
    bw.put((low << len) | ((1u << (len - 1)) - 1u), 2 * len - 1);
}

inline uint32_t get_gamma(BitReader& br) {
    // ctz-based ones count (get_unary) instead of bit-by-bit gets; gamma
    // lengths here are <= 10 bits (runs <= BLOCK), so 32 ones = corruption
    uint32_t ext = br.get_unary(32);
    if (br.error || ext >= 32) { br.error = true; return 0; }
    uint32_t low = ext ? br.get(static_cast<int>(ext)) : 0;
    return (1u << ext) | low;
}

template <int RAWBITS>
inline void put_rice(BitWriter& bw, uint32_t u, int k) {
    // escape raw width: zigzag of a RAWBITS-wide signed value needs
    // RAWBITS+1 bits, except int32 whose zigzag wraps into exactly 32
    // (also the BitWriter/BitReader single-put ceiling)
    constexpr int RB = RAWBITS < 32 ? RAWBITS + 1 : 32;
    uint32_t q = u >> k;
    if (q >= ESCAPE_Q) {
        bw.put((1u << ESCAPE_Q) - 1u, ESCAPE_Q);  // cap_q ones
        bw.put(u, RB);                            // raw zigzag value
    } else {
        int n = static_cast<int>(q) + 1 + k;
        uint32_t low = k ? (u & ((1u << k) - 1u)) : 0u;
        if (n <= 32) {  // fuse ones + terminator + remainder into one put
            bw.put(((low << q) << 1) | ((1u << q) - 1u), n);
        } else {
            if (q) bw.put((1u << q) - 1u, static_cast<int>(q));
            bw.put(low << 1, k + 1);
        }
    }
}

template <int RAWBITS>
uint32_t get_rice(BitReader& br, int k) {
    constexpr int RB = RAWBITS < 32 ? RAWBITS + 1 : 32;
    uint32_t q = br.get_unary(ESCAPE_Q);
    if (q >= ESCAPE_Q) return br.get(RB);
    uint32_t low = k ? br.get(k) : 0;
    return (q << k) | low;
}

template <typename T, int RAWBITS>
size_t encode_impl(const T* codes, size_t n, uint8_t* out, size_t cap) {
    BitWriter bw{out, cap};
    uint32_t u[BLOCK];
    uint32_t nz[BLOCK];
    int16_t pos[BLOCK];
    for (size_t start = 0; start < n; start += BLOCK) {
        const T* p = codes + start;
        int blk = static_cast<int>(std::min<size_t>(BLOCK, n - start));
        // branchless nonzero extraction (VERDICT r2 #7: the old per-element
        // branchy scan dominated sparse deadzone planes): one pass records
        // each nonzero's zigzag-1 and position; runs fall out of position
        // deltas, so emission never rescans the block
        int m = 0;
        for (int i = 0; i < blk; i++) {
            uint32_t z = zigzag32(static_cast<int32_t>(p[i]));
            nz[m] = z - 1;
            pos[m] = static_cast<int16_t>(i);
            m += (z != 0);
        }
        bool zero_run = (blk - m) * 4 >= blk * 3;
        if (zero_run) {
            int k = m ? pick_k(nz, m) : 0;
            bw.put(1, 1);
            bw.put(static_cast<uint32_t>(k), 5);
            int prev = -1;
            for (int j = 0; j < m; j++) {
                put_gamma(bw, static_cast<uint32_t>(pos[j] - prev));  // run+1
                put_rice<RAWBITS>(bw, nz[j], k);
                prev = pos[j];
                if (bw.overflow) return 0;
            }
            if (prev + 1 < blk) {  // trailing zero run
                put_gamma(bw, static_cast<uint32_t>(blk - prev - 1 + 1));
                if (bw.overflow) return 0;
            }
        } else {
            for (int i = 0; i < blk; i++)  // branch-free, auto-vectorized
                u[i] = zigzag32(static_cast<int32_t>(p[i]));
            int k = pick_k(u, blk);
            bw.put(0, 1);
            bw.put(static_cast<uint32_t>(k), 5);
            for (int i = 0; i < blk; i++) {
                put_rice<RAWBITS>(bw, u[i], k);
                if (bw.overflow) return 0;
            }
        }
    }
    return bw.finish();
}

template <typename T, int RAWBITS>
size_t decode_impl(const uint8_t* in, size_t len, T* codes, size_t n) {
    BitReader br{in, len};
    for (size_t start = 0; start < n; start += BLOCK) {
        int blk = static_cast<int>(std::min<size_t>(BLOCK, n - start));
        bool zero_run = br.get(1) != 0;
        int k = static_cast<int>(br.get(5));
        if (br.error || k > 30) return 0;
        if (zero_run) {
            int i = 0;
            while (i < blk) {
                uint32_t run = get_gamma(br) - 1;
                if (br.error || run > static_cast<uint32_t>(blk - i)) return 0;
                for (uint32_t r = 0; r < run; r++) codes[start + i + r] = 0;
                i += static_cast<int>(run);
                if (i < blk) {
                    uint32_t u = get_rice<RAWBITS>(br, k) + 1;
                    if (br.error) return 0;
                    codes[start + i] = static_cast<T>(unzigzag32(u));
                    i++;
                }
            }
        } else {
            for (int i = 0; i < blk; i++) {
                uint32_t u = get_rice<RAWBITS>(br, k);
                if (br.error) return 0;
                codes[start + i] = static_cast<T>(unzigzag32(u));
            }
        }
    }
    return br.byte;
}

// ---------------------------------------------------------------------------
// Context-adaptive binary range coder ("rc", container codec id 1).
//
// The Rice coder above is order-0 per block; quantized wavelet details are
// spatially CLUSTERED (significance of a coefficient is strongly predicted by
// its causal neighbors — the observation behind JPEG2000's EBCOT context
// modeling). This coder exploits that with a carry-propagating binary range
// coder (the classic 32-bit-range / 64-bit-low construction used by LZMA;
// public-domain arithmetic) driving adaptive 11-bit probabilities indexed by
// neighbor state:
//   zero flag — ctx = clamp(|left|,2)*3 + clamp(|up|,2)        (9 contexts)
//   sign      — ctx = sgnstate(left)*3 + sgnstate(up)          (9 contexts)
//   magnitude-1 — 4 adaptive unary bits (ctx = clamp(l+u,4)), then an
//   Elias-gamma tail: adaptive unary length prefix + raw ("direct") bits.
// Contexts reset per 2-D plane. Measured 10-20% smaller than the Rice
// streams on deadzone detail planes at a lower (but multi-thread-scalable)
// MB/s; the container picks per plane (codec="auto").
//
// THE RC BITSTREAM FORMAT IS FROZEN once shipped, same rule as Rice: any
// change needs a new codec id (golden fixture in tests/test_native.py).

namespace rc {

constexpr int PBITS = 11;                      // probability precision
constexpr uint16_t PINIT = 1u << (PBITS - 1);  // p = 1/2
constexpr int PADAPT = 5;                      // adaptation shift
constexpr uint32_t TOP = 1u << 24;
constexpr int UNARY = 4;  // adaptive unary magnitude bits before gamma tail

struct Encoder {
    uint8_t* out;
    size_t cap;
    size_t pos = 0;
    uint64_t low = 0;
    uint32_t range = 0xffffffffu;
    uint8_t cache = 0;
    uint64_t cache_size = 1;  // pending bytes awaiting carry resolution
    bool overflow = false;

    inline void shift_low() {
        if (static_cast<uint32_t>(low >> 32) != 0 || static_cast<uint32_t>(low) < 0xff000000u) {
            uint8_t carry = static_cast<uint8_t>(low >> 32);
            uint8_t b = cache;
            do {
                if (pos >= cap) { overflow = true; return; }
                out[pos++] = static_cast<uint8_t>(b + carry);
                b = 0xff;
            } while (--cache_size != 0);
            cache = static_cast<uint8_t>(low >> 24);
        }
        cache_size++;
        low = static_cast<uint32_t>(low) << 8;  // drop bits 24..31 (now in cache)
    }
    // bit coded against p = P(bit == 0), adapted toward the seen bit
    inline void bit(uint16_t& p, int b) {
        uint32_t bound = (range >> PBITS) * p;
        if (!b) {
            range = bound;
            p += ((1u << PBITS) - p) >> PADAPT;
        } else {
            low += bound;
            range -= bound;
            p -= p >> PADAPT;
        }
        if (range < TOP) { range <<= 8; shift_low(); }
    }
    inline void direct(uint32_t v, int n) {  // equiprobable raw bits
        for (int i = n - 1; i >= 0; i--) {
            range >>= 1;
            if ((v >> i) & 1u) low += range;
            if (range < TOP) { range <<= 8; shift_low(); }
        }
    }
    size_t finish() {
        for (int i = 0; i < 5; i++) shift_low();
        return overflow ? 0 : pos;
    }
};

struct Decoder {
    const uint8_t* in;
    size_t len;
    size_t pos = 0;
    uint32_t range = 0xffffffffu;
    uint32_t code = 0;
    bool error = false;

    inline uint8_t next() {
        if (pos >= len) { error = true; return 0; }
        return in[pos++];
    }
    void init() {
        for (int i = 0; i < 5; i++) code = (code << 8) | next();
    }
    inline int bit(uint16_t& p) {
        uint32_t bound = (range >> PBITS) * p;
        int b;
        if (code < bound) {
            range = bound;
            p += ((1u << PBITS) - p) >> PADAPT;
            b = 0;
        } else {
            code -= bound;
            range -= bound;
            p -= p >> PADAPT;
            b = 1;
        }
        if (range < TOP) { range <<= 8; code = (code << 8) | next(); }
        return b;
    }
    inline uint32_t direct(int n) {
        uint32_t v = 0;
        for (int i = 0; i < n; i++) {
            range >>= 1;
            uint32_t b = code >= range;
            if (b) code -= range;
            v = (v << 1) | b;
            if (range < TOP) { range <<= 8; code = (code << 8) | next(); }
        }
        return v;
    }
};

struct Model {
    uint16_t zero[9];        // significance flag
    uint16_t sign[9];        // sign of nonzeros
    uint16_t mag[5][UNARY];  // unary magnitude prefix
    uint16_t gam[5][16];     // gamma-length unary prefix of the tail
    void reset() {
        for (auto& p : zero) p = PINIT;
        for (auto& p : sign) p = PINIT;
        for (auto& row : mag)
            for (auto& p : row) p = PINIT;
        for (auto& row : gam)
            for (auto& p : row) p = PINIT;
    }
};

// causal-neighbor state kept per column: magnitude clamped to 2,
// sign state 0/1/2 = neg/zero-or-edge/pos
template <typename T>
size_t encode_impl(const T* codes, size_t planes, size_t h, size_t w, uint8_t* out, size_t cap) {
    Encoder enc{out, cap};
    Model mdl;
    uint8_t* up_mag = new uint8_t[2 * w];
    uint8_t* up_sgn = up_mag + w;
    for (size_t pl = 0; pl < planes; pl++) {
        mdl.reset();
        std::memset(up_mag, 0, w);
        std::memset(up_sgn, 1, w);
        const T* p = codes + pl * h * w;
        for (size_t y = 0; y < h; y++) {
            uint8_t left_mag = 0, left_sgn = 1;
            for (size_t x = 0; x < w; x++) {
                int32_t v = p[y * w + x];
                uint32_t m = v < 0 ? 0u - static_cast<uint32_t>(v) : static_cast<uint32_t>(v);
                int l = left_mag, u = up_mag[x];
                enc.bit(mdl.zero[l * 3 + u], v != 0);
                if (v != 0) {
                    enc.bit(mdl.sign[left_sgn * 3 + up_sgn[x]], v < 0);
                    uint32_t m1 = m - 1;
                    int mctx = std::min(l + u, 4);
                    int i = 0;
                    while (i < UNARY) {
                        int more = m1 > static_cast<uint32_t>(i);
                        enc.bit(mdl.mag[mctx][i], more);
                        if (!more) break;
                        i++;
                    }
                    if (i == UNARY) {
                        uint32_t tail = m1 - UNARY + 1;  // >= 1
                        int len = 0;
                        while ((tail >> (len + 1)) != 0) len++;
                        for (int j = 0; j < len; j++) enc.bit(mdl.gam[mctx][std::min(j, 15)], 1);
                        enc.bit(mdl.gam[mctx][std::min(len, 15)], 0);
                        if (len) enc.direct(tail & ((1u << len) - 1u), len);
                    }
                }
                left_mag = m > 2 ? 2 : static_cast<uint8_t>(m);
                left_sgn = v == 0 ? 1 : (v < 0 ? 0 : 2);
                up_mag[x] = left_mag;
                up_sgn[x] = left_sgn;
            }
            if (enc.overflow) { delete[] up_mag; return 0; }
        }
    }
    delete[] up_mag;
    return enc.finish();
}

template <typename T>
size_t decode_impl(const uint8_t* in, size_t len, T* codes, size_t planes, size_t h, size_t w) {
    Decoder dec{in, len};
    dec.init();
    Model mdl;
    uint8_t* up_mag = new uint8_t[2 * w];
    uint8_t* up_sgn = up_mag + w;
    for (size_t pl = 0; pl < planes; pl++) {
        mdl.reset();
        std::memset(up_mag, 0, w);
        std::memset(up_sgn, 1, w);
        T* p = codes + pl * h * w;
        for (size_t y = 0; y < h; y++) {
            uint8_t left_mag = 0, left_sgn = 1;
            for (size_t x = 0; x < w; x++) {
                int l = left_mag, u = up_mag[x];
                int32_t v = 0;
                if (dec.bit(mdl.zero[l * 3 + u])) {
                    int neg = dec.bit(mdl.sign[left_sgn * 3 + up_sgn[x]]);
                    int mctx = std::min(l + u, 4);
                    uint32_t m1 = 0;
                    int i = 0;
                    while (i < UNARY && dec.bit(mdl.mag[mctx][i])) {
                        i++;
                        m1 = i;
                    }
                    if (i == UNARY) {
                        int len_ = 0;
                        while (dec.bit(mdl.gam[mctx][std::min(len_, 15)])) {
                            len_++;
                            if (len_ > 31) { dec.error = true; break; }
                        }
                        uint32_t tail = len_ ? ((1u << len_) | dec.direct(len_)) : 1u;
                        m1 = UNARY - 1 + tail;
                    }
                    uint32_t m = m1 + 1;
                    v = neg ? -static_cast<int32_t>(m) : static_cast<int32_t>(m);
                }
                if (dec.error) { delete[] up_mag; return 0; }
                p[y * w + x] = static_cast<T>(v);
                uint32_t m = v < 0 ? 0u - static_cast<uint32_t>(v) : static_cast<uint32_t>(v);
                left_mag = m > 2 ? 2 : static_cast<uint8_t>(m);
                left_sgn = v == 0 ? 1 : (v < 0 ? 0 : 2);
                up_mag[x] = left_mag;
                up_sgn[x] = left_sgn;
            }
        }
    }
    delete[] up_mag;
    return dec.pos;
}

}  // namespace rc

}  // namespace

extern "C" {

size_t wicca_rice_encode_i8(const int8_t* codes, size_t n, uint8_t* out, size_t cap) {
    return encode_impl<int8_t, 8>(codes, n, out, cap);
}
size_t wicca_rice_decode_i8(const uint8_t* in, size_t len, int8_t* codes, size_t n) {
    return decode_impl<int8_t, 8>(in, len, codes, n);
}
size_t wicca_rice_encode_i16(const int16_t* codes, size_t n, uint8_t* out, size_t cap) {
    return encode_impl<int16_t, 16>(codes, n, out, cap);
}
size_t wicca_rice_decode_i16(const uint8_t* in, size_t len, int16_t* codes, size_t n) {
    return decode_impl<int16_t, 16>(in, len, codes, n);
}

size_t wicca_rc_encode_i8(const int8_t* codes, size_t planes, size_t h, size_t w,
                          uint8_t* out, size_t cap) {
    return rc::encode_impl<int8_t>(codes, planes, h, w, out, cap);
}
size_t wicca_rc_decode_i8(const uint8_t* in, size_t len, int8_t* codes, size_t planes,
                          size_t h, size_t w) {
    return rc::decode_impl<int8_t>(in, len, codes, planes, h, w);
}
size_t wicca_rc_encode_i16(const int16_t* codes, size_t planes, size_t h, size_t w,
                           uint8_t* out, size_t cap) {
    return rc::encode_impl<int16_t>(codes, planes, h, w, out, cap);
}
size_t wicca_rc_decode_i16(const uint8_t* in, size_t len, int16_t* codes, size_t planes,
                           size_t h, size_t w) {
    return rc::decode_impl<int16_t>(in, len, codes, planes, h, w);
}

// int32 planes: the high-bit-depth (> 8 bpp) codec path. New symbols + a new
// escape width — the i8/i16 bitstreams above are untouched (frozen).
size_t wicca_rice_encode_i32(const int32_t* codes, size_t n, uint8_t* out, size_t cap) {
    return encode_impl<int32_t, 32>(codes, n, out, cap);
}
size_t wicca_rice_decode_i32(const uint8_t* in, size_t len, int32_t* codes, size_t n) {
    return decode_impl<int32_t, 32>(in, len, codes, n);
}
size_t wicca_rc_encode_i32(const int32_t* codes, size_t planes, size_t h, size_t w,
                           uint8_t* out, size_t cap) {
    return rc::encode_impl<int32_t>(codes, planes, h, w, out, cap);
}
size_t wicca_rc_decode_i32(const uint8_t* in, size_t len, int32_t* codes, size_t planes,
                           size_t h, size_t w) {
    return rc::decode_impl<int32_t>(in, len, codes, planes, h, w);
}

}  // extern "C"
