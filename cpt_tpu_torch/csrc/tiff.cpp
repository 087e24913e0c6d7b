// TIFF codecs of the port's image codec (no library beyond the C++ standard
// one; built by kernels/build.py with the host C++ compiler and bound with
// ctypes by utils/image_codec.py, which reads the container).
//
// They give libtiff 4.7.1's output bit for bit, as Pillow 12.1 drives it for
// a compressed TIFF (one TIFFReadEncodedStrip / TIFFReadEncodedTile call a
// strip or tile, into a buffer of the strip's or tile's decoded size):
//
// - LZW (compression 5) as LZWDecode reads it: codes MSB-first, the code
//   width grown one code early (at 511, 1023 and 2047 entries, not GIF's
//   512), a table that opens at the first clear code and stops taking
//   entries 1024 codes past 4095; a code not yet in the table (any code
//   before the first clear), or data that ends before the buffer is full and
//   before an EOI code, fail, the rest of the buffer zeroed; an EOI code
//   before the buffer is full fails the same way. Old-style (bit-reversed,
//   "compat") LZW strips are refused.
// - PackBits (32773) as PackBitsDecode reads it, runs cut at the buffer's
//   end, the rest zeroed and the strip failed when the data runs out.
// - The horizontal predictor (317 = 2) at 8 and 16 bits, a row at a time,
//   16-bit samples in the file's byte order swapped first.
// - FillOrder 2: the bits of each byte reversed.
// - YCbCr -> RGB as TIFFRGBAImage does it for a file that is not JPEG
//   (TIFFYCbCrToRGBInit's fixed-point tables from YCbCrCoefficients and
//   ReferenceBlackWhite; the put routines' replicated chroma: each pixel of
//   a subsampling block takes the block's Cb and Cr).
//
// Deflate is Python's zlib and JPEG (compression 7) the JPEG decoder of
// csrc/image_codec.cpp (cpt_jpeg_decode_tiff).
//
// Every entry point returns a non-negative count on success and a negative
// status with a message in ``err`` on failure; ``fault`` selects the named
// faults that the checks use to show their digests can fail (0 in use).

#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <stdexcept>
#include <string>
#include <vector>

namespace {

enum Fault {
  kLzwLateGrowth = 131072,  // LZW code width grown one code late (GIF's rule)
};

struct TiffError : std::runtime_error {
  using std::runtime_error::runtime_error;
};

[[noreturn]] void fail(const std::string& msg) { throw TiffError(msg); }

int report(const std::exception& e, char* err, int errlen) {
  if (err && errlen > 0) std::snprintf(err, (size_t)errlen, "%s", e.what());
  return -1;
}

// ------------------------------------------------------------------- LZW

constexpr int kClear = 256, kEoi = 257, kFirst = 258;
constexpr int kBitsMin = 9, kBitsMax = 12;
constexpr int kTableSize = (1 << kBitsMax) - 1 + 1024;  // libtiff's CSIZE

struct Code {
  int next;        // the code of the string without its last byte; -1 none
  int length;      // bytes of the string
  uint8_t first;   // its first byte
  uint8_t value;   // its last byte
};

// LZWDecode over one strip or tile: fills ``out`` (``occ`` bytes); false
// with ``why`` set where libtiff fails (the rest of ``out`` zeroed).
bool lzw_decode(const uint8_t* in, long n, uint8_t* out, long occ, int fault,
                std::string* why) {
  std::vector<Code> tab(kTableSize);
  for (int c = 0; c < 256; c++) tab[c] = {-1, 1, (uint8_t)c, (uint8_t)c};
  tab[kClear] = tab[kEoi] = {-1, 0, 0, 0};
  const int late = (fault & kLzwLateGrowth) ? 1 : 0;
  int nbits = kBitsMin;
  long mask = (1L << nbits) - 1;
  long maxcode = mask - 1 + late;
  long free_ = -1;  // closed (every code but a clear or EOI fails) until a clear
  long old = 0;
  const uint64_t total = (uint64_t)n * 8;
  uint64_t bitpos = 0;
  long o = 0;
  auto code_of = [&](long* code) {  // the next nbits, MSB first
    if (bitpos + (uint64_t)nbits > total) return false;
    const uint64_t at = bitpos >> 3;
    uint32_t w = (uint32_t)in[at] << 16;
    if (at + 1 < (uint64_t)n) w |= (uint32_t)in[at + 1] << 8;
    if (at + 2 < (uint64_t)n) w |= in[at + 2];
    *code = (long)((w >> (24 - (int)(bitpos & 7) - nbits)) & ((1u << nbits) - 1));
    bitpos += (uint64_t)nbits;
    return true;
  };
  auto grow = [&]() {
    if (++free_ > maxcode) {
      if (++nbits > kBitsMax) nbits = kBitsMax;
      mask = (1L << nbits) - 1;
      maxcode = mask - 1 + late;
      if (free_ >= kTableSize) free_ = -1;
    }
  };
  auto emit = [&](long code) {  // the string of ``code``, cut at the end
    long len = tab[code].length;
    long take = len < occ - o ? len : occ - o;
    long c = code;
    for (long k = len; k > take; k--) c = tab[c].next;
    for (long k = take - 1; k >= 0; k--) {
      out[o + k] = tab[c].value;
      c = tab[c].next;
    }
    o += take;
  };
  auto failed = [&](const char* msg) {
    std::memset(out + o, 0, (size_t)(occ - o));
    *why = msg;
    return false;
  };
  while (o < occ) {
    long code;
    if (!code_of(&code)) return failed("LZW strip not terminated with an EOI code");
    if (code == kEoi) break;
    if (code == kClear) {
      free_ = kFirst;
      nbits = kBitsMin;
      mask = (1L << nbits) - 1;
      maxcode = mask - 1 + late;
      do {
        if (!code_of(&code)) return failed("LZW strip not terminated with an EOI code");
      } while (code == kClear);
      if (code == kEoi) break;
      if (code > kEoi) return failed("LZW code not yet in the table");
      out[o++] = (uint8_t)code;
      old = code;
      continue;
    }
    if (code > free_) return failed("LZW code not yet in the table");
    if (free_ >= 0) {
      Code& e = tab[free_];
      uint8_t value = code < 256 ? (uint8_t)code
                      : code == free_ ? tab[old].first : tab[code].first;
      e = {(int)old, tab[old].length + 1, tab[old].first, value};
    }
    grow();
    old = code;
    emit(code);
  }
  if (o < occ) {
    std::memset(out + o, 0, (size_t)(occ - o));
    *why = "not enough LZW data for the strip";
    return false;
  }
  return true;
}

// -------------------------------------------------------------- PackBits

bool packbits_decode(const uint8_t* in, long n, uint8_t* out, long occ, std::string* why) {
  const int8_t* bp = (const int8_t*)in;
  long cc = n, o = 0;
  while (cc > 0 && occ - o > 0) {
    long k = *bp++;
    cc--;
    if (k < 0) {
      if (k == -128) continue;
      k = -k + 1;
      if (occ - o < k) k = occ - o;
      if (cc == 0) break;
      uint8_t b = (uint8_t)*bp++;
      cc--;
      std::memset(out + o, b, (size_t)k);
      o += k;
    } else {
      if (occ - o < k + 1) k = occ - o - 1;
      if (cc < k + 1) break;
      std::memcpy(out + o, bp, (size_t)(k + 1));
      o += k + 1;
      bp += k + 1;
      cc -= k + 1;
    }
  }
  if (o < occ) {
    std::memset(out + o, 0, (size_t)(occ - o));
    *why = "not enough PackBits data for the strip";
    return false;
  }
  return true;
}

// ------------------------------------------------------------- YCbCr

struct YCbCrToRGB {
  int cr_r[256], cb_b[256];
  int32_t cr_g[256], cb_g[256], y_tab[256];
};

constexpr int kShift = 16;
inline int32_t fix(float x) { return (int32_t)(x * (1L << kShift) + 0.5); }
inline float clampf(float f, float lo, float hi) { return !(f >= lo) ? lo : f > hi ? hi : f; }
inline float code2v(int c, float rb, float rw, float cr) {
  return (((c) - (int32_t)(rb)) * (float)(cr)) / (float)(((rw) - (rb) != 0) ? ((rw) - (rb)) : 1);
}

// TIFFYCbCrToRGBInit.
void ycbcr_init(YCbCrToRGB* t, const float* luma, const float* rbw) {
  float f1 = 2 - 2 * luma[0];
  int32_t d1 = fix(clampf(f1, 0.0F, 2.0F));
  float f2 = luma[0] * f1 / luma[1];
  int32_t d2 = -fix(clampf(f2, 0.0F, 2.0F));
  float f3 = 2 - 2 * luma[2];
  int32_t d3 = fix(clampf(f3, 0.0F, 2.0F));
  float f4 = luma[2] * f3 / luma[1];
  int32_t d4 = -fix(clampf(f4, 0.0F, 2.0F));
  const int32_t half = 1 << (kShift - 1);
  for (int i = 0, x = -128; i < 256; i++, x++) {
    int32_t cr = (int32_t)clampf(code2v(x, rbw[4] - 128.0F, rbw[5] - 128.0F, 127),
                                 -128.0F * 32, 128.0F * 32);
    int32_t cb = (int32_t)clampf(code2v(x, rbw[2] - 128.0F, rbw[3] - 128.0F, 127),
                                 -128.0F * 32, 128.0F * 32);
    t->cr_r[i] = (int32_t)((d1 * cr + half) >> kShift);
    t->cb_b[i] = (int32_t)((d3 * cb + half) >> kShift);
    t->cr_g[i] = d2 * cr;
    t->cb_g[i] = d4 * cb + half;
    t->y_tab[i] = (int32_t)clampf(code2v(x + 128, rbw[0], rbw[1], 255),
                                  -128.0F * 32, 128.0F * 32);
  }
}

inline uint8_t clamp8(int32_t v) { return (uint8_t)(v < 0 ? 0 : v > 255 ? 255 : v); }

// TIFFYCbCrtoRGB.
inline void ycbcr_pixel(const YCbCrToRGB& t, int y, int cb, int cr, uint8_t* rgb) {
  rgb[0] = clamp8(t.y_tab[y] + t.cr_r[cr]);
  rgb[1] = clamp8(t.y_tab[y] + (int)((t.cb_g[cb] + t.cr_g[cr]) >> kShift));
  rgb[2] = clamp8(t.y_tab[y] + t.cb_b[cb]);
}

}  // namespace

extern "C" {

// Decode one LZW strip or tile into ``occ`` bytes of ``out``: ``occ``, or
// -1 (``out`` then holds what libtiff leaves: the bytes decoded, then 0s).
long cpt_tiff_lzw(const uint8_t* data, long n, uint8_t* out, long occ, int fault, char* err,
                  int errlen) {
  try {
    if (n >= 2 && data[0] == 0 && (data[1] & 1))
      fail("TIFF of old-style LZW codes is not supported");
    std::string why;
    if (!lzw_decode(data, n, out, occ, fault, &why)) fail(why);
    return occ;
  } catch (const std::exception& e) {
    return report(e, err, errlen);
  }
}

// Decode one PackBits strip or tile, as cpt_tiff_lzw.
long cpt_tiff_packbits(const uint8_t* data, long n, uint8_t* out, long occ, char* err,
                       int errlen) {
  try {
    std::string why;
    if (!packbits_decode(data, n, out, occ, &why)) fail(why);
    return occ;
  } catch (const std::exception& e) {
    return report(e, err, errlen);
  }
}

// Undo the horizontal predictor in place over ``rows`` rows of
// ``rowbytes`` bytes: ``stride`` samples a pixel of ``bytes`` (1 or 2)
// bytes each; 16-bit samples swapped to host order first when ``swap``.
long cpt_tiff_unpredict(uint8_t* buf, long rows, long rowbytes, int stride, int bytes, int swap,
                        char* err, int errlen) {
  try {
    if (bytes == 1) {
      for (long r = 0; r < rows; r++) {
        uint8_t* p = buf + r * rowbytes;
        for (long i = stride; i < rowbytes; i++) p[i] = (uint8_t)(p[i] + p[i - stride]);
      }
      return 0;
    }
    if (bytes != 2) fail("TIFF predictor on samples of an unsupported size");
    for (long r = 0; r < rows; r++) {
      uint8_t* p = buf + r * rowbytes;
      long count = rowbytes / 2;
      std::vector<uint16_t> v((size_t)count);
      std::memcpy(v.data(), p, (size_t)count * 2);
      if (swap)
        for (auto& s : v) s = (uint16_t)((s >> 8) | (s << 8));
      for (long i = stride; i < count; i++) v[i] = (uint16_t)(v[i] + v[i - stride]);
      std::memcpy(p, v.data(), (size_t)count * 2);
    }
    return 0;
  } catch (const std::exception& e) {
    return report(e, err, errlen);
  }
}

// Reverse the bits of each of ``n`` bytes in place (FillOrder 2).
long cpt_tiff_reverse_bits(uint8_t* buf, long n) {
  for (long i = 0; i < n; i++) {
    uint8_t b = buf[i];
    b = (uint8_t)((b & 0xF0) >> 4 | (b & 0x0F) << 4);
    b = (uint8_t)((b & 0xCC) >> 2 | (b & 0x33) << 2);
    buf[i] = (uint8_t)((b & 0xAA) >> 1 | (b & 0x55) << 1);
  }
  return n;
}

// Packed YCbCr (blocks of hs x vs Y samples in raster order, then Cb, Cr;
// ``blocks_per_row`` blocks a block row) -> ``rows`` x ``width`` x 3 RGB,
// TIFFRGBAImage's conversion; ``coeffs`` YCbCrCoefficients, ``rbw``
// ReferenceBlackWhite.
long cpt_tiff_ycbcr(const uint8_t* packed, long blocks_per_row, int hs, int vs, long width,
                    long rows, const float* coeffs, const float* rbw, uint8_t* out, char* err,
                    int errlen) {
  try {
    YCbCrToRGB t;
    ycbcr_init(&t, coeffs, rbw);
    const long block = (long)hs * vs + 2;
    for (long r = 0; r < rows; r++) {
      const uint8_t* brow = packed + (r / vs) * blocks_per_row * block;
      int dy = (int)(r % vs);
      uint8_t* o = out + r * width * 3;
      for (long x = 0; x < width; x++) {
        const uint8_t* b = brow + (x / hs) * block;
        ycbcr_pixel(t, b[dy * hs + (int)(x % hs)], b[block - 2], b[block - 1], o + 3 * x);
      }
    }
    return 0;
  } catch (const std::exception& e) {
    return report(e, err, errlen);
  }
}

}  // extern "C"
