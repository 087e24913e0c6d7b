// Run-length and text decoders of Pillow's other raster formats (no library
// beyond the C++ standard one; built by kernels/build.py with the host C++
// compiler and bound with ctypes by utils/raster_formats.py, which reads the
// headers).
//
// Each gives Pillow 12.1's output bit for bit, damaged data included, as
// ImageFile.load drives the decoder: all the data from the tile's offset to
// the end of the file, the decoder done when its last row is stored, the
// file "truncated" when the data ends first.
//
// - Targa RLE (TgaRleDecode.c): packets of ``depth`` bytes a pixel; a run
//   past the end of its row fails (overrun), a literal packet carries on
//   into the following rows.
// - PackBits as PSD's composite image uses it (PackDecode.c): rows after one
//   another, a packet's bytes past the end of its row dropped. (libtiff's
//   PackBitsDecode, csrc/tiff.cpp, reads a TIFF strip otherwise: it fills
//   the strip's buffer across its rows.)
// - PCX RLE (PcxDecode.c): runs cut at the end of the row buffer and the
//   decode then failed when it ends; the planes of a padded row moved
//   together as Pillow moves them (the 1-bit planes of a 2- or 4-plane row
//   by its stride, the others by the width).
// - Sun raster RLE (SunRleDecode.c): ``0x80 n v`` runs of n + 1 carried
//   across rows, rows of (width * depth + 7) / 8 bytes (the file's 16-bit
//   row padding not counted).
// - SGI RLE (SgiRleDecode.c): the offset and length tables, each row's
//   packets with its bounds checks, a row buffer kept from the row before,
//   a row whose last packet is not a terminator ending the decode early
//   with the rows so far.
// - QOI (QoiImagePlugin.QoiDecoder), XBM's hex bytes (XbmDecode.c), the
//   MSP version 2 rows (MspImagePlugin.MspDecoder) and the plain (ASCII)
//   netpbm samples (PpmImagePlugin.PpmPlainDecoder: its 1 MiB blocks,
//   comments, tokens and round-half-even scaling).
//
// Every entry point returns a non-negative count on success and -1 with a
// message in ``err`` on failure; ``fault`` selects the named faults that the
// checks use to show their digests can fail (0 in use).

#include <algorithm>
#include <cmath>
#include <cstdint>
#include <cstdio>
#include <cstring>
#include <stdexcept>
#include <string>
#include <vector>

namespace {

enum Fault {
  kPsdShortRun = 1,      // PackBits runs one byte short
  kSgiTableSwapped = 2,  // the RLE offset table read channel by channel
  kQoiHashPrime = 4,     // the index hash's green prime 6 rather than 5
  kSunRunExact = 8,      // a run of n, not n + 1
  kPlainTruncated = 32,  // plain netpbm scaling truncated, not rounded
  kMspBlankBlack = 64,   // an empty MSP row black, not white
};

struct RasterError : std::runtime_error {
  using std::runtime_error::runtime_error;
};

[[noreturn]] void fail(const std::string& msg) { throw RasterError(msg); }

int report(const std::exception& e, char* err, int errlen) {
  if (err && errlen > 0) std::snprintf(err, (size_t)errlen, "%s", e.what());
  return -1;
}

// Rows handed out in decode order: ``out`` holds ``rows`` rows of
// ``linebytes``; the decoder returns the number of rows it completed.
struct Rows {
  uint8_t* out;
  long linebytes, rows, done = 0;
  std::vector<uint8_t> buffer;
  long x = 0;
  Rows(uint8_t* o, long lb, long r) : out(o), linebytes(lb), rows(r), buffer((size_t)lb) {}
  // store the row buffer; true when the last row is stored
  bool flush() {
    std::memcpy(out + done * linebytes, buffer.data(), (size_t)linebytes);
    x = 0;
    return ++done >= rows;
  }
};

bool is_space(uint8_t c) { return c == ' ' || (c >= 9 && c <= 13); }

}  // namespace

extern "C" {

// Targa RLE: ``depth`` bytes a pixel (Pillow's depth / 8, 0 for 1-bit
// files), rows of ``linebytes``. Rows completed (``rows`` when done), -1
// on an overrun.
long cpt_tga_rle(const uint8_t* in, long n, int depth, long linebytes, long rows,
                 uint8_t* out, char* err, int errlen) {
  try {
    Rows r(out, linebytes, rows);
    const uint8_t* ptr = in;
    long bytes = n, extra = 0;
    uint8_t* buf = r.buffer.data();
    for (;;) {
      if (bytes < 1) return r.done;
      long k = (long)depth * ((ptr[0] & 0x7f) + 1);
      if (ptr[0] & 0x80) {
        if (bytes < 1 + depth) return r.done;
        if (r.x + k > linebytes) fail("buffer overrun when reading image file");
        for (long i = 0; i < k; i += depth) std::memcpy(buf + r.x + i, ptr + 1, (size_t)depth);
        ptr += 1 + depth;
        bytes -= 1 + depth;
      } else {
        if (bytes < 1 + k) return r.done;
        if (r.x + k > linebytes) {
          extra = k;
          k = linebytes - r.x;
          extra -= k;
        }
        std::memcpy(buf + r.x, ptr + 1, (size_t)k);
        ptr += 1 + k;
        bytes -= 1 + k;
      }
      for (;;) {
        r.x += k;
        if (r.x >= linebytes && r.flush()) return r.done;
        if (extra == 0) break;
        if (r.x > 0) break;
        k = extra >= linebytes ? linebytes : extra;
        std::memcpy(buf + r.x, ptr, (size_t)k);
        ptr += k;
        bytes -= k;
        extra -= k;
      }
    }
  } catch (const std::exception& e) {
    return report(e, err, errlen);
  }
}

// PackBits as PackDecode.c reads it: rows completed.
long cpt_packbits_rows(const uint8_t* in, long n, long linebytes, long rows, int fault,
                       uint8_t* out) {
  Rows r(out, linebytes, rows);
  const uint8_t* ptr = in;
  long bytes = n;
  uint8_t* buf = r.buffer.data();
  for (;;) {
    if (bytes < 1) break;
    if (ptr[0] & 0x80) {
      if (ptr[0] == 0x80) {
        ptr++;
        bytes--;
        continue;
      }
      if (bytes < 2) break;
      int k = 257 - ptr[0] - ((fault & kPsdShortRun) ? 1 : 0);
      for (; k > 0 && r.x < linebytes; k--) buf[r.x++] = ptr[1];
      ptr += 2;
      bytes -= 2;
    } else {
      int k = ptr[0] + 2;
      if (bytes < k) break;
      for (int i = 1; i < k && r.x < linebytes; i++) buf[r.x++] = ptr[i];
      ptr += k;
      bytes -= k;
    }
    if (r.x >= linebytes && r.flush()) break;
  }
  return r.done;
}

// PCX RLE: rows of ``linebytes`` (planes * stride) holding ``xsize``
// pixels of ``bits`` (the raw mode's); rows completed, ``*overrun`` set when a run passed the end of a
// row (Pillow then fails the decode when it ends).
long cpt_pcx_rle(const uint8_t* in, long n, long linebytes, long xsize, int bits, long rows,
                 uint8_t* out, int* overrun) {
  Rows r(out, linebytes, rows);
  const uint8_t* ptr = in;
  long bytes = n;
  uint8_t* buf = r.buffer.data();
  *overrun = 0;
  for (;;) {
    if (bytes < 1) return r.done;
    if ((ptr[0] & 0xC0) == 0xC0) {
      if (bytes < 2) return r.done;
      for (int k = ptr[0] & 0x3F; k > 0; k--) {
        if (r.x >= linebytes) {
          *overrun = 1;
          break;
        }
        buf[r.x++] = ptr[1];
      }
      ptr += 2;
      bytes -= 2;
    } else {
      buf[r.x++] = ptr[0];
      ptr++;
      bytes--;
    }
    if (r.x >= linebytes) {
      // the planes of a padded row moved together: 2- and 4-plane bit rows
      // to (width + 7) / 8 bytes apart, the others to ``xsize``
      long width, bands, stride = 0;
      if (bits == 2 || bits == 4) {
        width = (xsize + 7) / 8;
        bands = bits;
        stride = linebytes / bits;
      } else {
        width = xsize;
        bands = linebytes / xsize;
        if (bands) stride = linebytes / bands;
      }
      if (stride > width)
        for (long i = 1; i < bands; i++)
          std::memmove(buf + i * width, buf + i * stride, (size_t)width);
      if (r.flush()) return r.done;
    }
  }
}

// Sun raster RLE: rows completed.
long cpt_sun_rle(const uint8_t* in, long n, long linebytes, long rows, int fault, uint8_t* out) {
  Rows r(out, linebytes, rows);
  const uint8_t* ptr = in;
  long bytes = n;
  uint8_t* buf = r.buffer.data();
  for (;;) {
    if (bytes < 1) return r.done;
    long k;
    uint8_t extra_value = 0;
    long extra = 0;
    if (ptr[0] == 0x80) {
      if (bytes < 2) return r.done;
      k = ptr[1];
      if (k == 0) {
        k = 1;
        buf[r.x] = 0x80;
        ptr += 2;
        bytes -= 2;
      } else {
        if (bytes < 3) return r.done;
        if (!(fault & kSunRunExact)) k += 1;
        if (r.x + k > linebytes) {
          extra = k;
          k = linebytes - r.x;
          extra -= k;
          extra_value = ptr[2];
        }
        std::memset(buf + r.x, ptr[2], (size_t)k);
        ptr += 3;
        bytes -= 3;
      }
    } else {
      k = 1;
      buf[r.x] = ptr[0];
      ptr++;
      bytes--;
    }
    for (;;) {
      r.x += k;
      if (r.x >= linebytes && r.flush()) return r.done;
      if (extra == 0) break;
      if (r.x > 0) break;
      k = extra >= linebytes ? linebytes : extra;
      std::memset(buf + r.x, extra_value, (size_t)k);
      extra -= k;
    }
  }
}

// SGI RLE over the whole file (``n`` bytes, the 512-byte header first):
// ``out`` holds ``ysize`` rows of xsize * zsize samples of ``bpc`` bytes,
// interleaved, row 0 first in the file's order (bottom-up when ``ystep``
// is -1). 0, or -1 on an overrun; rows the decode did not reach stay 0.
long cpt_sgi_rle(const uint8_t* file, long n, long xsize, long ysize, int zsize, int bpc,
                 int ystep, int fault, uint8_t* out, char* err, int errlen) {
  try {
    const long header = 512;
    long bufsize = n - header;
    long tablen = (long)zsize * ysize;
    if (bufsize < 8 * tablen) fail("buffer overrun when reading image file");
    const uint8_t* ptr = file + header;
    const uint8_t* end = ptr + bufsize - 1;
    auto be32 = [&](long at) {
      const uint8_t* p = ptr + at;
      return (uint32_t)p[0] << 24 | (uint32_t)p[1] << 16 | (uint32_t)p[2] << 8 | p[3];
    };
    long linebytes = xsize * zsize * bpc;
    std::vector<uint8_t> buffer((size_t)linebytes * 1, 0);
    long y = ystep < 0 ? ysize - 1 : 0;
    ystep = ystep < 0 ? -1 : 1;
    for (long row = 0; row < ysize; row++, y += ystep) {
      for (int ch = 0; ch < zsize; ch++) {
        long idx = (fault & kSgiTableSwapped) ? row * zsize + ch : row + ch * ysize;
        uint32_t offset = be32(4 * idx), length = be32(4 * tablen + 4 * idx);
        if (offset < header) fail("buffer overrun when reading image file");
        offset -= header;
        const uint8_t* src = ptr + offset;
        uint8_t* dest = buffer.data() + (long)ch * bpc;
        long step = (long)zsize * bpc, x = 0;
        int status = 0;
        // the length is SgiRleDecode's int count of packets: past 2^31 it is
        // negative, and the row takes no packet
        for (int k = (int)length; k > 0; k--) {
          uint8_t pixel;
          if (bpc == 1) {
            if (src > end) { status = -1; break; }
            pixel = *src++;
          } else {
            if (src + 1 > end) { status = -1; break; }
            pixel = src[1];
            src += 2;
          }
          if (k == 1 && pixel != 0) { status = 1; break; }
          int count = pixel & 0x7f;
          if (!count) break;
          if (x + count > xsize) { status = -1; break; }
          x += count;
          if (pixel & 0x80) {
            if (src + (long)bpc * count > end) { status = -1; break; }
            for (; count; count--, dest += step, src += bpc) std::memcpy(dest, src, (size_t)bpc);
          } else {
            if (src + (bpc == 1 ? 0 : 2) > end) { status = -1; break; }
            for (; count; count--, dest += step) std::memcpy(dest, src, (size_t)bpc);
            src += bpc;
          }
        }
        if (status == -1) fail("buffer overrun when reading image file");
        if (status == 1) return 0;
      }
      std::memcpy(out + y * linebytes, buffer.data(), (size_t)linebytes);
    }
    return 0;
  } catch (const std::exception& e) {
    return report(e, err, errlen);
  }
}

// QOI: ``npix`` pixels as RGBA into ``out`` (runs may write past ``npix``
// up to 62 pixels: ``out`` holds npix + 62). Bytes read, or -1 when the
// data ends first.
long cpt_qoi(const uint8_t* in, long n, long npix, int fault, uint8_t* out, char* err,
             int errlen) {
  try {
    uint8_t index[64][4];
    std::memset(index, 0, sizeof index);
    uint8_t prev[4] = {0, 0, 0, 255};
    const int pg = (fault & kQoiHashPrime) ? 6 : 5;
    long pos = 0, have = 0;
    auto need = [&](long k) {
      if (pos + k > n) fail("truncated QOI data");
    };
    while (have < npix) {
      need(1);
      uint8_t b = in[pos++];
      uint8_t v[4];
      if (b == 0xFE) {
        need(3);
        v[0] = in[pos]; v[1] = in[pos + 1]; v[2] = in[pos + 2]; v[3] = prev[3];
        pos += 3;
      } else if (b == 0xFF) {
        need(4);
        std::memcpy(v, in + pos, 4);
        pos += 4;
      } else if ((b >> 6) == 0) {
        std::memcpy(v, index[b & 63], 4);
      } else if ((b >> 6) == 1) {
        v[0] = (uint8_t)(prev[0] + ((b >> 4) & 3) - 2);
        v[1] = (uint8_t)(prev[1] + ((b >> 2) & 3) - 2);
        v[2] = (uint8_t)(prev[2] + (b & 3) - 2);
        v[3] = prev[3];
      } else if ((b >> 6) == 2) {
        need(1);
        uint8_t b2 = in[pos++];
        int dg = (b & 63) - 32;
        v[0] = (uint8_t)(prev[0] + dg + ((b2 >> 4) & 15) - 8);
        v[1] = (uint8_t)(prev[1] + dg);
        v[2] = (uint8_t)(prev[2] + dg + (b2 & 15) - 8);
        v[3] = prev[3];
      } else {
        for (int k = (b & 63) + 1; k > 0; k--, have++) std::memcpy(out + 4 * have, prev, 4);
        continue;
      }
      std::memcpy(prev, v, 4);
      std::memcpy(index[(v[0] * 3 + v[1] * pg + v[2] * 7 + v[3] * 11) % 64], v, 4);
      std::memcpy(out + 4 * have++, v, 4);
    }
    return pos;
  } catch (const std::exception& e) {
    return report(e, err, errlen);
  }
}

// XBM's hex bytes: rows of ``linebytes`` in file order; rows completed.
long cpt_xbm(const uint8_t* in, long n, long linebytes, long rows, uint8_t* out) {
  auto hex = [](uint8_t v) -> int {
    return v >= '0' && v <= '9' ? v - '0' : v >= 'a' && v <= 'f' ? v - 'a' + 10
         : v >= 'A' && v <= 'F' ? v - 'A' + 10 : 0;
  };
  Rows r(out, linebytes, rows);
  const uint8_t* ptr = in;
  long bytes = n;
  for (;;) {
    while (bytes > 0 && *ptr != 'x') {
      ptr++;
      bytes--;
    }
    if (bytes < 3) return r.done;
    r.buffer[(size_t)r.x++] = (uint8_t)((hex(ptr[1]) << 4) + hex(ptr[2]));
    if (r.x >= linebytes && r.flush()) return r.done;
    ptr += 3;
    bytes -= 3;
  }
}

// MSP version 2 rows: ``rows`` row lengths at ``in`` (little-endian u16),
// then the rows; the bytes MspDecoder writes (a zero-length row is
// ``blank`` bytes of 0xFF), or -1 when a row is truncated or corrupt.
long cpt_msp_rle(const uint8_t* in, long n, long rows, long blank, int fault, uint8_t* out,
                 long cap, char* err, int errlen) {
  try {
    if (n < 2 * rows) fail("Truncated MSP file in row map");
    long pos = 2 * rows, o = 0;
    auto put = [&](const uint8_t* src, long k) {
      if (o + k > cap) fail("MSP output past its bound");
      std::memcpy(out + o, src, (size_t)k);
      o += k;
    };
    for (long y = 0; y < rows; y++) {
      long len = in[2 * y] | (long)in[2 * y + 1] << 8;
      if (len == 0) {
        if (o + blank > cap) fail("MSP output past its bound");
        std::memset(out + o, (fault & kMspBlankBlack) ? 0 : 0xFF, (size_t)blank);
        o += blank;
        continue;
      }
      if (pos + len > n)
        fail("Truncated MSP file, expected " + std::to_string(len) + " bytes on row " +
             std::to_string(y));
      const uint8_t* row = in + pos;
      pos += len;
      long idx = 0;
      while (idx < len) {
        uint8_t kind = row[idx++];
        if (kind == 0) {
          if (idx + 2 > len) fail("Corrupted MSP file in row " + std::to_string(y));
          long count = row[idx];
          if (o + count > cap) fail("MSP output past its bound");
          std::memset(out + o, row[idx + 1], (size_t)count);
          o += count;
          idx += 2;
        } else {
          long k = std::min<long>(kind, len - idx);
          put(row + idx, k);
          idx += kind;
        }
      }
    }
    return o;
  } catch (const std::exception& e) {
    return report(e, err, errlen);
  }
}

// Plain netpbm samples after the header: ``total`` values into ``out``
// (uint8 0xFF / 0 for P1's bits when ``bitonal``, else int32 samples
// scaled to ``out_max``, rounding half to even). The number of values
// (fewer than ``total``: not enough data), or -1 with Pillow's ValueError.
long cpt_ppm_plain(const uint8_t* in, long n, int bitonal, long total, long maxval,
                   long out_max, int fault, void* out, char* err, int errlen) {
  try {
    const long block_size = 1024 * 1024;  // ImageFile.SAFEBLOCK
    long pos = 0;
    bool spans = false;
    auto read_block = [&]() {
      long k = std::min(block_size, n - pos);
      std::string b((const char*)in + pos, (size_t)std::max(0L, k));
      pos += std::max(0L, k);
      return b;
    };
    // PpmPlainDecoder._find_comment_end: the lowest of the two indices, but
    // -1 * x > 0 only for two -1s, and an index of 0 loses to the other
    auto comment_end = [](const std::string& b, size_t start) -> long {
      long a = b.find('\n', start) == std::string::npos ? -1 : (long)b.find('\n', start);
      long c = b.find('\r', start) == std::string::npos ? -1 : (long)b.find('\r', start);
      return a * c > 0 ? std::min(a, c) : std::max(a, c);
    };
    auto ignore_comments = [&](std::string b) {
      if (spans) {
        while (!b.empty()) {
          long e = comment_end(b, 0);
          if (e != -1) {
            b = b.substr((size_t)e + 1);
            break;
          }
          b = read_block();
        }
      }
      spans = false;
      for (;;) {
        size_t s = b.find('#');
        if (s == std::string::npos) break;
        long e = comment_end(b, s);
        if (e != -1) {
          b = b.substr(0, s) + b.substr((size_t)e + 1);
        } else {
          b = b.substr(0, s);
          spans = true;
          break;
        }
      }
      return b;
    };
    long have = 0;
    if (bitonal) {
      uint8_t* o = (uint8_t*)out;
      while (have != total) {
        std::string b = read_block();
        if (b.empty()) break;
        b = ignore_comments(b);
        for (unsigned char c : b) {
          if (is_space(c)) continue;
          if (c != '0' && c != '1')
            fail(std::string("Invalid token for this mode: ") + (char)c);
        }
        for (unsigned char c : b) {
          if (is_space(c)) continue;
          if (have >= total) break;
          o[have++] = c == '0' ? 0xFF : 0x00;
        }
      }
      return have;
    }
    int32_t* o = (int32_t*)out;
    std::string half;
    while (have != total) {
      std::string b = read_block();
      if (b.empty()) {
        if (half.empty()) break;
        b = " ";
      }
      b = ignore_comments(b);
      if (!half.empty()) {
        b = half + b;
        half.clear();
      }
      std::vector<std::string> tokens;
      for (size_t i = 0; i < b.size();) {
        while (i < b.size() && is_space((uint8_t)b[i])) i++;
        size_t j = i;
        while (j < b.size() && !is_space((uint8_t)b[j])) j++;
        if (j > i) tokens.push_back(b.substr(i, j - i));
        i = j;
      }
      if (!b.empty() && !is_space((uint8_t)b.back())) {
        half = tokens.back();
        tokens.pop_back();
        if (half.size() > 10)
          fail("Token too long found in data: " + half.substr(0, 11));
      }
      for (const std::string& t : tokens) {
        if (t.size() > 10) fail("Token too long found in data: " + t.substr(0, 11));
        // Python's int(): a sign, then digits with single underscores
        // between them
        size_t i = 0;
        bool neg = false;
        if (t[0] == '+' || t[0] == '-') {
          neg = t[0] == '-';
          i = 1;
        }
        long long v = 0;
        bool ok = i < t.size();
        bool last_digit = false;
        for (; ok && i < t.size(); i++) {
          char c = t[i];
          if (c >= '0' && c <= '9') {
            v = v * 10 + (c - '0');
            last_digit = true;
          } else if (c == '_' && last_digit && i + 1 < t.size()) {
            last_digit = false;
          } else {
            ok = false;
          }
        }
        if (!ok || !last_digit)
          fail("invalid literal for int() with base 10: " + t);
        if (neg) v = -v;
        if (v < 0) fail("Channel value is negative: " + std::to_string(v));
        if (v > maxval) fail("Channel value too large for this mode: " + std::to_string(v));
        double scaled = (double)v / (double)maxval * (double)out_max;
        o[have++] = (int32_t)((fault & kPlainTruncated) ? std::floor(scaled)
                                                          : std::nearbyint(scaled));
        if (have == total) break;
      }
    }
    return have;
  } catch (const std::exception& e) {
    return report(e, err, errlen);
  }
}

// Pillow's PCX encoder (PcxEncode.c) over ``h`` rows of ``planes`` planes
// of ``w`` bytes (planar lines): runs of up to 63, a lone byte below 0xC0
// as itself, each plane's line padded to an even length. Bytes written.
long cpt_pcx_encode(const uint8_t* px, long w, long h, int planes, uint8_t* out, long cap) {
  const long bpl = w, padding = w % 2;
  long o = 0;
  auto put = [&](uint8_t v) {
    if (o < cap) out[o] = v;
    o++;
  };
  for (long y = 0; y < h; y++) {
    const uint8_t* buf = px + y * planes * w;
    long x = 1, count = 1;
    uint8_t last = buf[0];
    do {
      while (x % bpl) {
        if (count == 63) {
          put(0xFF);
          put(last);
          count = 0;
        }
        uint8_t v = buf[x];
        if (v == last) {
          x++;
          count++;
        } else {
          if (count == 1 && last < 0xC0) {
            put(last);
          } else if (count > 0) {
            put((uint8_t)(0xC0 | count));
            put(last);
          }
          last = v;
          count = 1;
          x++;
        }
      }
      if (count == 1 && last < 0xC0) {
        put(last);
      } else if (count > 0) {
        put((uint8_t)(0xC0 | count));
        put(last);
      }
      for (long i = 0; i < padding; i++) put(0);
      if (x < planes * bpl) {
        count = 1;
        last = buf[x];
        x++;
      }
    } while (x < planes * bpl);
  }
  return o;
}

// Pillow's QOI encoder (QoiImagePlugin.QoiEncoder) over ``npix`` pixels of
// ``channels`` bytes (alpha 255 for RGB): the ops without the header and
// the end marker. Bytes written.
long cpt_qoi_encode(const uint8_t* px, long npix, int channels, uint8_t* out, long cap) {
  uint8_t seen[64][4];
  bool have[64] = {false};
  std::memset(seen, 0, sizeof seen);
  have[0] = true;  // {0: (0, 0, 0, 0)}
  uint8_t prev[4] = {0, 0, 0, 255};
  long o = 0, run = 0;
  auto put = [&](uint8_t v) {
    if (o < cap) out[o] = v;
    o++;
  };
  auto delta = [](int a, int b) {
    int r = (a - b) & 255;
    return r >= 128 ? r - 256 : r;
  };
  for (long i = 0; i < npix; i++) {
    uint8_t p[4] = {px[i * channels], px[i * channels + 1], px[i * channels + 2],
                    (uint8_t)(channels == 4 ? px[i * channels + 3] : 255)};
    if (std::memcmp(p, prev, 4) == 0) {
      if (++run == 62) {
        put((uint8_t)(0xC0 | (run - 1)));
        run = 0;
      }
    } else {
      if (run) {
        put((uint8_t)(0xC0 | (run - 1)));
        run = 0;
      }
      int hash = (p[0] * 3 + p[1] * 5 + p[2] * 7 + p[3] * 11) % 64;
      if (have[hash] && std::memcmp(seen[hash], p, 4) == 0) {
        put((uint8_t)hash);
      } else {
        std::memcpy(seen[hash], p, 4);
        have[hash] = true;
        if (prev[3] == p[3]) {
          int dr = delta(p[0], prev[0]), dg = delta(p[1], prev[1]), db = delta(p[2], prev[2]);
          if (-2 <= dr && dr < 2 && -2 <= dg && dg < 2 && -2 <= db && db < 2) {
            put((uint8_t)(0x40 | (dr + 2) << 4 | (dg + 2) << 2 | (db + 2)));
          } else {
            int dgr = delta(dr, dg), dgb = delta(db, dg);
            if (-8 <= dgr && dgr < 8 && -32 <= dg && dg < 32 && -8 <= dgb && dgb < 8) {
              put((uint8_t)(0x80 | (dg + 32)));
              put((uint8_t)((dgr + 8) << 4 | (dgb + 8)));
            } else {
              put(0xFE);
              put(p[0]);
              put(p[1]);
              put(p[2]);
            }
          }
        } else {
          put(0xFF);
          for (int k = 0; k < 4; k++) put(p[k]);
        }
      }
    }
    std::memcpy(prev, p, 4);
  }
  if (run) put((uint8_t)(0xC0 | (run - 1)));
  return o;
}

}  // extern "C"
