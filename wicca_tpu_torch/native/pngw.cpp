// Strip-parallel PNG writer for the folder-decode output stage
// (wicca_tpu_torch/data/pngw.py).
//
// This is the port's own copy of wicca_tpu/native/pngw.cpp, built by
// wicca_tpu_torch/native/pngw.py into a shared object of its own linked with
// -lz, so that a host without zlib still has the entropy coders and the
// host IDWT. Its output bytes equal the reference writer's for the same
// input and options (tests/test_torch_io.py).
//
// Why: the folder decode writes a lossless PNG per decoded .wct, and
// cv2.imwrite deflates on one thread after an RGB->BGR conversion pass.
// This writer:
//
//   * takes PLANAR (C, H, W) uint8 input directly — no HWC interleave copy,
//     no channel-order conversion (PNG is natively RGB);
//   * filters rows with the PNG "Sub" predictor (fast, good on photographic
//     content) and deflates row strips in PARALLEL, one zlib stream per
//     strip ended with Z_FULL_FLUSH (byte-aligned empty stored block), the
//     pigz construction: concatenated flushed streams + a final 2-byte
//     BFINAL fixed block (0x03 0x00) + the adler32_combine()d checksum form
//     one valid zlib stream any PNG reader inflates;
//   * emits one IDAT chunk per strip (any number of IDATs is legal PNG).
//
// The output is a standard, fully lossless PNG (8-bit gray / RGB / RGBA);
// only the byte-level encoding differs from cv2's. Decoders (cv2, PIL,
// browsers) read it back pixel-identical.
//
// C ABI (ctypes): returns bytes written, or 0 on error (capacity/args).

#include <zlib.h>

#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

inline void put_be32(uint8_t* p, uint32_t v) {
  p[0] = static_cast<uint8_t>(v >> 24);
  p[1] = static_cast<uint8_t>(v >> 16);
  p[2] = static_cast<uint8_t>(v >> 8);
  p[3] = static_cast<uint8_t>(v);
}

// One PNG chunk: length + type + payload + CRC over type||payload.
size_t write_chunk(uint8_t* out, const char type[4], const uint8_t* data, size_t n) {
  put_be32(out, static_cast<uint32_t>(n));
  std::memcpy(out + 4, type, 4);
  if (n) std::memcpy(out + 8, data, n);
  uLong crc = crc32(0L, Z_NULL, 0);
  crc = crc32(crc, out + 4, static_cast<uInt>(4 + n));
  put_be32(out + 8 + n, static_cast<uint32_t>(crc));
  return 12 + n;
}

struct StripResult {
  std::vector<uint8_t> deflated;
  uLong adler = 0;       // adler32 of this strip's FILTERED bytes
  size_t raw_len = 0;    // filtered byte count (for adler32_combine)
  bool ok = false;
};

// Filter rows [r0, r1) with the Sub predictor into interleaved scanlines
// (1 filter byte + w*ch bytes per row), then deflate them as one stream
// ended with Z_FULL_FLUSH. `zlib_header` selects windowBits 15 (strip 0,
// emits the 2-byte zlib header) vs -15 (raw deflate continuation strips).
void encode_strip(const uint8_t* img, size_t c_stride, size_t r_stride,
                  size_t w, size_t ch, size_t r0, size_t r1, int level,
                  int strategy, bool zlib_header, StripResult* res) {
  const size_t row_bytes = 1 + w * ch;
  const size_t nrows = r1 - r0;
  std::vector<uint8_t> filt(nrows * row_bytes);
  const uint8_t* src[4] = {nullptr, nullptr, nullptr, nullptr};
  for (size_t r = r0; r < r1; ++r) {
    uint8_t* fr = filt.data() + (r - r0) * row_bytes;
    fr[0] = 1;  // Sub filter
    uint8_t* frow = fr + 1;
    for (size_t c = 0; c < ch; ++c) {
      src[c] = img + c * c_stride + r * r_stride;
      frow[c] = src[c][0];
    }
    // j outer / c inner: sequential writes, ch sequential read streams
    // (the c-outer form writes at stride ch — measurably slower)
    if (ch == 3) {
      for (size_t j = 1; j < w; ++j) {
        frow[3 * j] = static_cast<uint8_t>(src[0][j] - src[0][j - 1]);
        frow[3 * j + 1] = static_cast<uint8_t>(src[1][j] - src[1][j - 1]);
        frow[3 * j + 2] = static_cast<uint8_t>(src[2][j] - src[2][j - 1]);
      }
    } else {
      for (size_t j = 1; j < w; ++j)
        for (size_t c = 0; c < ch; ++c)
          frow[j * ch + c] = static_cast<uint8_t>(src[c][j] - src[c][j - 1]);
    }
  }
  res->raw_len = filt.size();

  z_stream zs;
  std::memset(&zs, 0, sizeof(zs));
  if (deflateInit2(&zs, level, Z_DEFLATED, zlib_header ? 15 : -15, 8,
                   strategy) != Z_OK)
    return;
  res->deflated.resize(deflateBound(&zs, static_cast<uLong>(filt.size())) + 16);
  // zlib's avail_in/avail_out (and adler32's len) are uInt: feed input AND
  // drain output in sub-4GB chunks so >4 GiB strips (gigapixel
  // single-strip encodes) neither truncate the checksum nor the output
  // window. Z_FULL_FLUSH on exhausted input ends the strip on a byte
  // boundary (empty stored block, BFINAL=0) so strips concatenate into one
  // stream; the flush is complete when deflate leaves avail_out nonzero.
  const size_t max_io = 1u << 30;
  res->adler = adler32(0L, Z_NULL, 0);
  size_t fed = 0;
  bool ok = true, done = false;
  int stalls = 0;
  while (!done && ok) {
    if (zs.avail_in == 0 && fed < filt.size()) {
      size_t n = filt.size() - fed < max_io ? filt.size() - fed : max_io;
      zs.next_in = filt.data() + fed;
      zs.avail_in = static_cast<uInt>(n);
      res->adler = adler32(res->adler, filt.data() + fed, static_cast<uInt>(n));
      fed += n;
    }
    size_t out_off = static_cast<size_t>(zs.total_out);
    size_t avail = res->deflated.size() - out_off;
    zs.next_out = res->deflated.data() + out_off;
    zs.avail_out = static_cast<uInt>(avail < max_io ? avail : max_io);
    if (zs.avail_out == 0) { ok = false; break; }  // bound exceeded (never)
    int flush = fed == filt.size() ? Z_FULL_FLUSH : Z_NO_FLUSH;
    int rc = deflate(&zs, flush);
    if (rc != Z_OK && rc != Z_BUF_ERROR) { ok = false; break; }
    stalls = rc == Z_BUF_ERROR ? stalls + 1 : 0;
    if (stalls > 2) { ok = false; break; }  // no progress — malformed state
    done = flush == Z_FULL_FLUSH && zs.avail_in == 0 && zs.avail_out != 0;
  }
  res->deflated.resize(static_cast<size_t>(zs.total_out));
  deflateEnd(&zs);
  res->ok = ok;
}

}  // namespace

extern "C" {

// Upper bound on the encoded size for a caller-allocated buffer.
size_t wicca_png_bound(uint32_t h, uint32_t w, uint32_t channels, int nthreads) {
  size_t raw = static_cast<size_t>(h) * (1 + static_cast<size_t>(w) * channels);
  size_t strips = nthreads < 1 ? 1 : static_cast<size_t>(nthreads);
  // deflate worst case ~ raw + raw/1000 + 13 per strip, + chunk framing
  return raw + raw / 512 + strips * 64 + 1024;
}

// Encode planar uint8 (channels, h, w) -> PNG bytes in `out`.
// c_stride/r_stride are ELEMENT strides between channels / rows. channels:
// 1 (gray), 3 (RGB), 4 (RGBA). level: zlib 0-9. Returns bytes written, 0 on
// error or insufficient capacity.
// strategy: 0 = Z_DEFAULT_STRATEGY, 1 = Z_RLE (run-length only: much
// faster matching, near-identical size on filtered photographic rows —
// libpng's own recommendation for filtered data), 2 = Z_FILTERED.
size_t wicca_png_encode_planar(const uint8_t* img, size_t c_stride, size_t r_stride,
                               uint32_t h, uint32_t w, uint32_t channels,
                               int level, int strategy, int nthreads,
                               uint8_t* out, size_t cap) {
  if (!img || !out || h == 0 || w == 0) return 0;
  if (channels != 1 && channels != 3 && channels != 4) return 0;
  if (level < 0 || level > 9) return 0;
  int zstrat = strategy == 1 ? Z_RLE : (strategy == 2 ? Z_FILTERED : Z_DEFAULT_STRATEGY);

  size_t nstrips = nthreads < 1 ? 1 : static_cast<size_t>(nthreads);
  // keep strips at a size where deflate efficiency is unaffected
  const size_t min_rows = 64;
  if (nstrips > 1 && h / nstrips < min_rows) nstrips = h >= min_rows ? h / min_rows : 1;
  if (nstrips == 0) nstrips = 1;

  std::vector<StripResult> strips(nstrips);
  size_t chunk_rows = (h + nstrips - 1) / nstrips;
  {
    std::vector<std::thread> ts;
    ts.reserve(nstrips);
    for (size_t s = 0; s < nstrips; ++s) {
      size_t r0 = s * chunk_rows;
      size_t r1 = r0 + chunk_rows < h ? r0 + chunk_rows : h;
      if (r0 >= r1) { strips[s].ok = true; continue; }
      if (nstrips == 1) {
        encode_strip(img, c_stride, r_stride, w, channels, r0, r1, level,
                     zstrat, s == 0, &strips[s]);
      } else {
        ts.emplace_back(encode_strip, img, c_stride, r_stride, w, channels,
                        r0, r1, level, zstrat, s == 0, &strips[s]);
      }
    }
    for (auto& t : ts) t.join();
  }
  uLong adler = adler32(0L, Z_NULL, 0);
  for (auto& s : strips) {
    if (!s.ok) return 0;
    if (s.raw_len == 0) continue;  // skipped strip: its default 0 is not the
                                   // empty-input adler (1); just omit it
    adler = adler32_combine(adler, s.adler, static_cast<z_off_t>(s.raw_len));
  }

  // --- assemble ---
  static const uint8_t sig[8] = {0x89, 'P', 'N', 'G', '\r', '\n', 0x1a, '\n'};
  size_t pos = 0;
  if (cap < 8 + 25) return 0;
  std::memcpy(out, sig, 8);
  pos += 8;
  uint8_t ihdr[13];
  put_be32(ihdr, w);
  put_be32(ihdr + 4, h);
  ihdr[8] = 8;  // bit depth
  ihdr[9] = channels == 1 ? 0 : (channels == 3 ? 2 : 6);  // color type
  ihdr[10] = 0;  // deflate
  ihdr[11] = 0;  // filter method 0
  ihdr[12] = 0;  // no interlace
  pos += write_chunk(out + pos, "IHDR", ihdr, 13);
  const size_t max_chunk = 1u << 30;  // PNG chunk length caps at 2^31-1
  for (auto& s : strips) {
    if (s.raw_len == 0) continue;
    for (size_t off = 0; off < s.deflated.size(); off += max_chunk) {
      size_t n = s.deflated.size() - off;
      if (n > max_chunk) n = max_chunk;
      if (pos + 12 + n > cap) return 0;
      pos += write_chunk(out + pos, "IDAT", s.deflated.data() + off, n);
    }
  }
  // final IDAT: BFINAL empty fixed-huffman block + the combined adler32
  uint8_t tail[6] = {0x03, 0x00, 0, 0, 0, 0};
  put_be32(tail + 2, static_cast<uint32_t>(adler));
  if (pos + 12 + 6 + 12 > cap) return 0;
  pos += write_chunk(out + pos, "IDAT", tail, 6);
  pos += write_chunk(out + pos, "IEND", nullptr, 0);
  return pos;
}

}  // extern "C"
