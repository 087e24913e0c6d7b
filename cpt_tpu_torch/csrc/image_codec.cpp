// Host JPEG codec and PNG row filters of the port (no library beyond the
// C++ standard one; built by kernels/build.py with the host C++ compiler and
// bound with ctypes by utils/image_codec.py, which reads a JPEG's markers as
// Pillow's JpegImagePlugin does before this decoder runs).
//
// JPEG decode reproduces libjpeg-turbo 3.1.3's default decompression as
// Pillow 12.1 drives it for Image.open(f).convert("RGB") (mode "L" for one
// component) on x86-64: baseline, extended and progressive Huffman;
// arithmetic coding (jdarith.c: sequential and progressive, DAC
// conditioning); lossless at 8 bits (SOF3: predictors 1-7, the point
// transform, box upsampling, no colour conversion but RGB); restart
// markers; the islow IDCT in its SSE2 / AVX2 arithmetic (16-bit
// dequantisation and sums, saturating packs); block smoothing of
// progressive files left unrefined (decompress_smooth_data, 5x5 DC
// neighbourhoods); fancy upsampling (h2v1, h1v2, h2v2; replication for
// other factors and for components no wider than 2 samples);
// ycc_rgb_convert with libjpeg's fixed point tables; colour space by
// libjpeg's default rule (JFIF, Adobe transform, component ids; a lossless
// file RGB without a marker). A 4-component file is CMYK, or YCCK under
// Adobe transform 2 (ycck_cmyk_convert on the same tables); its samples are
// then inverted, as Pillow unpacks every CMYK JPEG ("CMYK;I", Adobe's
// polarity), and turned into RGB by Pillow's cmyk2rgb. Damaged data
// decodes, or fails, as it does there: the bit buffer's fill schedule
// (decode_mcu_fast's too), corrupt tables and codes, the markers that
// jpeg_finish_decompress reads after a single scan, and the 65536-byte
// reads Pillow feeds libjpeg, past which an arithmetic scan fails (its
// decoder cannot suspend). Refused, as libjpeg-turbo refuses them:
// hierarchical frames, precisions other than 8, arithmetic lossless, MCUs
// of more than 10 blocks, data that ends before its image is read. A
// Huffman table 0 or 1 that a sequential scan uses undefined is the
// standard one (std_huff_tables).
// A TIFF's JPEG strip or tile (cpt_jpeg_decode_tiff) decodes as libtiff 4.7.1
// asks libjpeg to: its JPEGTables read first, the end of the data read as an
// EOI (libtiff's source manager), YCbCr -> RGB for a contiguous YCbCr TIFF
// and no colour transform otherwise, up to 10 components; the markers after
// a single scan are not read (libtiff ignores their errors).
//
// JPEG encode reproduces jpeg_set_defaults + jpeg_set_quality(q, TRUE) as
// Pillow's save(format="JPEG", quality=q) drives it: JFIF header, 4:2:0
// with the alternating 1/2 bias, edge replication, rgb_ycc_convert, the
// islow forward DCT, reciprocal quantisation, the standard Huffman tables.
//
// PNG: the per-row filters only (zlib is Python's).
//
// GIF: the LZW expansion of one frame's image data (the container is
// Python's). BMP: the RLE8 / RLE4 expansion, as Pillow's BmpRleDecoder
// reads it.
//
// Every entry point returns 0 on success and a negative status with a
// message in ``err`` on failure; the ``fault`` arguments select the named
// faults that the checks use to show their digests can fail (0 in use).

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
  kReplicateUpsample = 1,   // box replication instead of fancy upsampling
  kFloatIdct = 2,           // a float IDCT instead of islow
  kRefineNoCorrection = 4,  // AC refinement ignores correction bits
  kFloatYcc = 8,            // YCbCr -> RGB in float arithmetic
  kQualityOffByOne = 16,    // quality scaling of q + 1
  kPaethTies = 32,          // Paeth ties resolved to the later predictor
  kCmykNotInverted = 64,    // Adobe CMYK samples taken as stored
  kYcckAsCmyk = 128,        // YCCK samples taken as CMYK
  kGifLateGrowth = 256,     // LZW code size grown one code late
  kCIdct = 1 << 22,         // islow in jidctint.c's C arithmetic, not the SIMD's
  kArithDefaultConditioning = 1 << 23,  // arithmetic decoding ignores DAC
  kLosslessLeftPredictor = 1 << 24,     // lossless samples all predicted from the left
  kNoBlockSmoothing = 1 << 25,          // unrefined progressive blocks left unsmoothed
};

// Pillow refuses a file declaring more than twice Image.MAX_IMAGE_PIXELS
// (DecompressionBombError); utils/image_codec.py's MAX_IMAGE_PIXELS
constexpr long long kMaxPixels = 2LL * 89478485;

struct CodecError : std::runtime_error {
  using std::runtime_error::runtime_error;
};

[[noreturn]] void fail(const std::string& msg) { throw CodecError(msg); }

// Zigzag index -> natural index, with 16 extra entries so that a corrupt
// run past 63 stays in the block (as libjpeg's table does).
const int kNatural[80] = {
    0,  1,  8,  16, 9,  2,  3,  10, 17, 24, 32, 25, 18, 11, 4,  5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6,  7,  14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63,
    63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63, 63};

// The standard Huffman tables (JPEG Annex K.3): the encoder's, and the
// decoder's for a table a scan uses undefined.
const uint8_t kBitsDcLum[17] = {0, 0, 1, 5, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0, 0, 0};
const uint8_t kValDc[12] = {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11};
const uint8_t kBitsDcChrom[17] = {0, 0, 3, 1, 1, 1, 1, 1, 1, 1, 1, 1, 0, 0, 0, 0, 0};
const uint8_t kBitsAcLum[17] = {0, 0, 2, 1, 3, 3, 2, 4, 3, 5, 5, 4, 4, 0, 0, 1, 0x7d};
const uint8_t kValAcLum[162] = {
    0x01, 0x02, 0x03, 0x00, 0x04, 0x11, 0x05, 0x12, 0x21, 0x31, 0x41, 0x06, 0x13, 0x51, 0x61,
    0x07, 0x22, 0x71, 0x14, 0x32, 0x81, 0x91, 0xa1, 0x08, 0x23, 0x42, 0xb1, 0xc1, 0x15, 0x52,
    0xd1, 0xf0, 0x24, 0x33, 0x62, 0x72, 0x82, 0x09, 0x0a, 0x16, 0x17, 0x18, 0x19, 0x1a, 0x25,
    0x26, 0x27, 0x28, 0x29, 0x2a, 0x34, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44, 0x45,
    0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59, 0x5a, 0x63, 0x64,
    0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78, 0x79, 0x7a, 0x83,
    0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97, 0x98, 0x99,
    0x9a, 0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4, 0xb5, 0xb6,
    0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9, 0xca, 0xd2, 0xd3,
    0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe1, 0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7, 0xe8,
    0xe9, 0xea, 0xf1, 0xf2, 0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};
const uint8_t kBitsAcChrom[17] = {0, 0, 2, 1, 2, 4, 4, 3, 4, 7, 5, 4, 4, 0, 1, 2, 0x77};
const uint8_t kValAcChrom[162] = {
    0x00, 0x01, 0x02, 0x03, 0x11, 0x04, 0x05, 0x21, 0x31, 0x06, 0x12, 0x41, 0x51, 0x07, 0x61,
    0x71, 0x13, 0x22, 0x32, 0x81, 0x08, 0x14, 0x42, 0x91, 0xa1, 0xb1, 0xc1, 0x09, 0x23, 0x33,
    0x52, 0xf0, 0x15, 0x62, 0x72, 0xd1, 0x0a, 0x16, 0x24, 0x34, 0xe1, 0x25, 0xf1, 0x17, 0x18,
    0x19, 0x1a, 0x26, 0x27, 0x28, 0x29, 0x2a, 0x35, 0x36, 0x37, 0x38, 0x39, 0x3a, 0x43, 0x44,
    0x45, 0x46, 0x47, 0x48, 0x49, 0x4a, 0x53, 0x54, 0x55, 0x56, 0x57, 0x58, 0x59, 0x5a, 0x63,
    0x64, 0x65, 0x66, 0x67, 0x68, 0x69, 0x6a, 0x73, 0x74, 0x75, 0x76, 0x77, 0x78, 0x79, 0x7a,
    0x82, 0x83, 0x84, 0x85, 0x86, 0x87, 0x88, 0x89, 0x8a, 0x92, 0x93, 0x94, 0x95, 0x96, 0x97,
    0x98, 0x99, 0x9a, 0xa2, 0xa3, 0xa4, 0xa5, 0xa6, 0xa7, 0xa8, 0xa9, 0xaa, 0xb2, 0xb3, 0xb4,
    0xb5, 0xb6, 0xb7, 0xb8, 0xb9, 0xba, 0xc2, 0xc3, 0xc4, 0xc5, 0xc6, 0xc7, 0xc8, 0xc9, 0xca,
    0xd2, 0xd3, 0xd4, 0xd5, 0xd6, 0xd7, 0xd8, 0xd9, 0xda, 0xe2, 0xe3, 0xe4, 0xe5, 0xe6, 0xe7,
    0xe8, 0xe9, 0xea, 0xf2, 0xf3, 0xf4, 0xf5, 0xf6, 0xf7, 0xf8, 0xf9, 0xfa};

// ---------------------------------------------------------------- decoder

struct HuffSpec {
  bool defined = false;
  uint8_t bits[17] = {0};
  uint8_t vals[256] = {0};
};

struct HuffDerived {
  int32_t maxcode[18];
  int32_t valoffset[18];
  uint8_t vals[256];
  uint16_t look[256];  // (length << 8) | symbol for codes of <= 8 bits
};

// jpeg_make_d_derived_tbl: a DC table's symbols at most ``max_dc`` (15; 16
// in a lossless file).
void derive(const HuffSpec& s, bool dc, int max_dc, HuffDerived* d) {
  if (!s.defined) fail("JPEG scan uses an undefined Huffman table");
  int huffsize[257], huffcode[257], p = 0;
  for (int l = 1; l <= 16; l++) {
    int i = s.bits[l];
    if (p + i > 256) fail("bogus Huffman table definition");
    while (i--) huffsize[p++] = l;
  }
  huffsize[p] = 0;
  int numsymbols = p, code = 0, si = huffsize[0];
  p = 0;
  while (huffsize[p]) {
    while (huffsize[p] == si) huffcode[p++] = code++;
    if (code >= (1 << si)) fail("bogus Huffman table definition");
    code <<= 1;
    si++;
  }
  p = 0;
  for (int l = 1; l <= 16; l++) {
    if (s.bits[l]) {
      d->valoffset[l] = p - huffcode[p];
      p += s.bits[l];
      d->maxcode[l] = huffcode[p - 1];
    } else {
      d->maxcode[l] = -1;
    }
  }
  d->valoffset[17] = 0;
  d->maxcode[17] = 0xFFFFF;
  std::memcpy(d->vals, s.vals, 256);
  std::memset(d->look, 0, sizeof(d->look));
  p = 0;
  for (int l = 1; l <= 8; l++) {
    for (int i = 1; i <= s.bits[l]; i++, p++) {
      int look = huffcode[p] << (8 - l);
      for (int c = 1 << (8 - l); c > 0; c--) d->look[look++] = (l << 8) | s.vals[p];
    }
  }
  if (dc)
    for (int i = 0; i < numsymbols; i++)
      if (s.vals[i] > max_dc) fail("bogus Huffman table definition");
}

// Pillow feeds libjpeg the file 65536 bytes a call (ImageFile.load's
// decodermaxblock); libjpeg's arithmetic decoder cannot suspend for more.
constexpr size_t kFeed = 65536;

// A Huffman decoder's read that crossed what Pillow has fed libjpeg: libjpeg
// suspends, Pillow feeds the next 65536 bytes, and the MCU is decoded again
// from its start (perhaps now on the fast path).
struct Refill {};

// Entropy-coded data reader with libjpeg's conventions and its bit buffer's
// schedule (jdhuff.c), which decides where a file that ends without a
// marker runs out: FF00 is a data FF; any other marker stops the data and
// reads as zero bits (the decoder then leaves the rest of the restart
// interval at zero); a fill loads bytes to 57 bits or a marker, and the end
// of the input before a marker is a truncated file. ``fast``:
// decode_mcu_fast's reads (six bytes when 16 bits or fewer are left; an
// FF not followed by 00 is noted in ``fast_marker`` and the MCU is decoded
// again the slow way).
struct BitReader {
  const uint8_t* d;
  size_t n;
  size_t pos;
  uint64_t acc = 0;
  int nbits = 0;
  int marker = 0;
  bool insufficient = false;
  bool eof_eoi = false;  // the end of the data reads as an EOI marker (TIFF)
  size_t* feed = nullptr;   // what Pillow has fed libjpeg (Pillow's files)
  bool refill = false;      // a read past ``feed`` restarts the MCU
  bool fast = false;
  int fast_marker = 0;

  bool at_end() {
    if (pos < n) {
      if (feed && pos >= *feed) {
        *feed = (pos / kFeed + 1) * kFeed;
        if (refill) throw Refill();
      }
      return false;
    }
    if (!eof_eoi) fail("truncated JPEG file (data ends inside a scan)");
    marker = 0xD9;
    return true;
  }

  void fill() {
    while (nbits < 57) {
      if (marker) {
        return;
      }
      if (at_end()) return;
      int c = d[pos++];
      if (c == 0xFF) {
        int c2;
        do {
          if (at_end()) return;
          c2 = d[pos++];
        } while (c2 == 0xFF);
        if (c2 != 0) {
          marker = c2;
          return;
        }
      }
      acc = (acc << 8) | (uint64_t)c;
      nbits += 8;
    }
  }
  // FILL_BIT_BUFFER_FAST (decode_mcu_fast runs only with 512 bytes a block
  // of the MCU in the buffer, so these reads stay inside the data).
  void fill_fast() {
    if (nbits > 16) return;
    for (int i = 0; i < 6; i++) {
      int c = d[pos++];
      int c1 = pos < n ? d[pos] : 0;
      acc = (acc << 8) | (uint64_t)c;
      nbits += 8;
      if (c == 0xFF) {
        pos++;
        if (c1 != 0) {  // a marker: back up to it, a zero byte read
          fast_marker = c1;
          pos -= 2;
          acc &= ~uint64_t(0xFF);
        }
      }
    }
  }
  inline void need(int k) {
    if (nbits < k) fill();
  }
  // The next k bits (k <= 17), zero bits past a marker.
  inline uint32_t peek(int k) const {
    if (nbits >= k) return (uint32_t)(acc >> (nbits - k)) & ((1u << k) - 1);
    return (uint32_t)(acc << (k - nbits)) & ((1u << k) - 1);
  }
  inline void drop(int k) {
    if (k > nbits) {
      insufficient = true;
      nbits = 0;
    } else {
      nbits -= k;
    }
    acc &= nbits ? ((uint64_t(1) << nbits) - 1) : 0;
  }
  inline int get(int k) {
    if (k == 0) return 0;
    if (fast) fill_fast();
    else need(k);
    uint32_t v = peek(k);
    drop(k);
    return (int)v;
  }
  // jpeg_huff_decode's bits (CHECK_BIT_BUFFER then GET_BITS), or
  // HUFF_DECODE_FAST's, which it reads with no fill.
  inline int take(int k) {
    if (!fast) need(k);
    uint32_t v = peek(k);
    drop(k);
    return (int)v;
  }
  // HUFF_DECODE: a fill when fewer than 8 bits are left, the 8-bit lookup,
  // else jpeg_huff_decode.
  inline int decode(const HuffDerived& t) {
    if (fast) fill_fast();
    else if (nbits < 8) {
      fill();
      if (nbits < 8) return decode_slow(t, 1);
    }
    int v = t.look[peek(8)];
    if (v) {
      drop(v >> 8);
      return v & 0xFF;
    }
    return decode_slow(t, 9);
  }
  // jpeg_huff_decode: ``l`` bits taken at once, then one at a time (each
  // taken before the next is asked for) while the code is too long; a code
  // past 16 bits is libjpeg's zero.
  int decode_slow(const HuffDerived& t, int l) {
    int32_t code = take(l);
    while (code > t.maxcode[l]) {
      code = (code << 1) | take(1);
      l++;
    }
    if (l > 16) return 0;
    return t.vals[(code + t.valoffset[l]) & 0xFF];
  }
};

inline int extend(int r, int s) {
  return r < (1 << (s - 1)) ? r + (int)((unsigned)-1 << s) + 1 : r;
}

// T.81 Table D.2 in libjpeg's packed form (jaricom.c): Qe << 16 |
// Next_Index_MPS << 8 | Switch_MPS << 7 | Next_Index_LPS; the last entry
// the fixed probability 0.5.
const uint32_t kAritab[114] = {
    0x5a1d0181, 0x2586020e, 0x11140310, 0x080b0412, 0x03d80514, 0x01da0617, 0x00e50719,
    0x006f081c, 0x0036091e, 0x001a0a21, 0x000d0b23, 0x00060c09, 0x00030d0a, 0x00010d0c,
    0x5a7f0f8f, 0x3f251024, 0x2cf21126, 0x207c1227, 0x17b91328, 0x1182142a, 0x0cef152b,
    0x09a1162d, 0x072f172e, 0x055c1830, 0x04061931, 0x03031a33, 0x02401b34, 0x01b11c36,
    0x01441d38, 0x00f51e39, 0x00b71f3b, 0x008a203c, 0x0068213e, 0x004e223f, 0x003b2320,
    0x002c0921, 0x5ae125a5, 0x484c2640, 0x3a0d2741, 0x2ef12843, 0x261f2944, 0x1f332a45,
    0x19a82b46, 0x15182c48, 0x11772d49, 0x0e742e4a, 0x0bfb2f4b, 0x09f8304d, 0x0861314e,
    0x0706324f, 0x05cd3330, 0x04de3432, 0x040f3532, 0x03633633, 0x02d43734, 0x025c3835,
    0x01f83936, 0x01a43a37, 0x01603b38, 0x01253c39, 0x00f63d3a, 0x00cb3e3b, 0x00ab3f3d,
    0x008f203d, 0x5b1241c1, 0x4d044250, 0x412c4351, 0x37d84452, 0x2fe84553, 0x293c4654,
    0x23794756, 0x1edf4857, 0x1aa94957, 0x174e4a48, 0x14244b48, 0x119c4c4a, 0x0f6b4d4a,
    0x0d514e4b, 0x0bb64f4d, 0x0a40304d, 0x583251d0, 0x4d1c5258, 0x438e5359, 0x3bdd545a,
    0x34ee555b, 0x2eae565c, 0x299a575d, 0x25164756, 0x557059d8, 0x4ca95a5f, 0x44d95b60,
    0x3e225c61, 0x38245d63, 0x32b45e63, 0x2e17565d, 0x56a860df, 0x4f466165, 0x47e56266,
    0x41cf6367, 0x3c3d6468, 0x375e5d63, 0x52316669, 0x4c0f676a, 0x4639686b, 0x415e6367,
    0x56276ae9, 0x50e76b6c, 0x4b85676d, 0x55976d6e, 0x504f6b6f, 0x5a106fee, 0x55226d70,
    0x59eb6ff0, 0x5a1d7171};

struct Decoder;

// The arithmetic decoder of jdarith.c (T.81 Annex D): its C and A
// registers, the bit shift counter (-16 until the first two bytes are in,
// -1 after a bad code: the rest of the restart interval is left as it is)
// and the marker that ended the data (zero bytes follow it).
struct ArithReader {
  Decoder* dec;
  size_t pos;
  int marker = 0;
  int64_t c = 0, a = 0;
  int ct = -16;
  int get_byte();
  int decode(uint8_t* st) {
    while (a < 0x8000) {
      if (--ct < 0) {
        int data = 0;
        if (!marker) {
          data = get_byte();
          if (data == 0xFF) {
            do data = get_byte();
            while (data == 0xFF);
            if (data == 0) {
              data = 0xFF;
            } else {
              marker = data;
              data = 0;
            }
          }
        }
        c = (c << 8) | data;
        if ((ct += 8) < 0)
          if (++ct == 0) a = 0x8000;
      }
      a <<= 1;
    }
    int sv = *st;
    uint32_t qe = kAritab[sv & 0x7F];
    int nl = qe & 0xFF;
    qe >>= 8;
    int nm = qe & 0xFF;
    qe >>= 8;
    int64_t temp = a - qe;
    a = temp;
    temp <<= ct;
    if (c >= temp) {
      c -= temp;
      if (a < (int64_t)qe) {
        a = qe;
        *st = (uint8_t)((sv & 0x80) ^ nm);
      } else {
        a = qe;
        *st = (uint8_t)((sv & 0x80) ^ nl);
        sv ^= 0x80;
      }
    } else if (a < 0x8000) {
      if (a < (int64_t)qe) {
        *st = (uint8_t)((sv & 0x80) ^ nl);
        sv ^= 0x80;
      } else {
        *st = (uint8_t)((sv & 0x80) ^ nm);
      }
    }
    return sv >> 7;
  }
};

struct Component {
  int id = 0, index = 0, h = 1, v = 1, tq = 0;
  int dc_tbl = 0, ac_tbl = 0;
  int dw = 0, dh = 0;    // downsampled size (real samples)
  int wib = 0, hib = 0;  // width / height in blocks (real; samples when lossless)
  int bw = 0, bh = 0;    // blocks allocated (rounded up to the MCU)
  bool latched = false;
  int16_t q[64];         // latched quantisation table (natural order)
  uint16_t qraw[64];     // the same as stored (block smoothing's divisors)
  std::vector<int16_t> coef;
  std::vector<uint8_t> samples;  // lossless: the component's wib x hib plane
  int coef_bits[64];
  int prev_coef_bits[10];  // coef_bits 0-9 as the component's last scan found them
  int pred = 0;            // the DC predictor (last_dc_val)
  int dc_context = 0;      // arithmetic DC conditioning
  // lossless undifferencing: the next row starts a scan or interval
  bool first_row = true;
  std::vector<int32_t> diff;  // one iMCU row of differences (MCU-padded)
  std::vector<int32_t> undiff;  // its undifferenced samples, v rows of wib
  int16_t* block(int by, int bx) { return &coef[((size_t)by * bw + bx) * 64]; }
};

// The end of the data where libjpeg would suspend while it reads the markers
// that follow a complete image: Pillow's load then returns the image.
struct Suspend {};

struct Decoder {
  Decoder(const uint8_t* data, size_t size) : d(data), n(size) {}
  const uint8_t* d;
  size_t n;
  size_t pos = 0;
  int fault = 0;
  size_t feed = kFeed;      // the bytes Pillow has fed libjpeg so far
  bool finishing = false;   // reading what follows a complete image

  uint16_t qt[4][64];
  bool qt_defined[4] = {false, false, false, false};
  HuffSpec dc_spec[4], ac_spec[4];
  int restart_interval = 0;
  bool jfif = false, adobe = false;
  int adobe_transform = 0;
  uint8_t arith_L[16], arith_U[16], arith_K[16];  // DAC conditioning

  bool frame = false, progressive = false, arith = false, lossless = false;
  int precision = 8, width = 0, height = 0, ncomp = 0;
  int max_h = 1, max_v = 1, mcux = 0, mcuy = 0;  // mcuy: the iMCU rows
  std::vector<Component> comps;
  int scans = 0;
  bool multi_scan = false;     // libjpeg's has_multiple_scans
  int last_good_imcu_row = 0;  // of the last scan: block smoothing's latch
  int unread_marker = 0;  // the marker that ended a scan's data
  // A strip or tile of a TIFF file, as libtiff hands it to libjpeg: the
  // end of the data reads as an EOI marker.
  bool tiff = false;

  void reached(size_t p) {  // libjpeg suspends at the end of what it has
    if (p >= feed) feed = (p / kFeed + 1) * kFeed;
  }
  int u8() {
    if (pos >= n) {
      if (finishing) throw Suspend();
      fail("truncated JPEG file (data ends inside a marker)");
    }
    reached(pos);
    return d[pos++];
  }
  int u16() {
    int a = u8();
    return (a << 8) | u8();
  }
  void skip(long len) {  // skip_input_data
    if (len <= 0) return;
    if (pos + (size_t)len > n) {
      if (finishing) throw Suspend();
      fail("truncated JPEG file (data ends inside a marker)");
    }
    pos += len;
    reached(pos - 1);
  }

  // libjpeg's next_marker: skip garbage, then any FF fill bytes.
  int next_marker() {
    if (unread_marker) {
      int m = unread_marker;
      unread_marker = 0;
      return m;
    }
    for (;;) {
      if (tiff && pos >= n) return 0xD9;
      int c = u8();
      while (c != 0xFF) {
        if (tiff && pos >= n) return 0xD9;
        c = u8();
      }
      do {
        if (tiff && pos >= n) return 0xD9;
        c = u8();
      } while (c == 0xFF);
      if (c != 0) return c;
    }
  }

  // get_soi: what an SOI resets.
  void reset_at_soi() {
    restart_interval = 0;
    jfif = adobe = false;
    adobe_transform = 0;
    for (int i = 0; i < 16; i++) {
      arith_L[i] = 0;
      arith_U[i] = 1;
      arith_K[i] = 5;
    }
  }

  // Tables-only data (TIFF's JPEGTables) read before the stream, as
  // jpeg_read_header(FALSE) reads it: SOI, then table and other marker
  // segments up to EOI or the end.
  void load_tables(const uint8_t* tables, size_t tn) {
    const uint8_t* sd = d;
    size_t sn = n;
    d = tables;
    n = tn;
    pos = 0;
    if (n < 2 || d[0] != 0xFF || d[1] != 0xD8) fail("not a JPEG file (JPEGTables)");
    pos = 2;
    reset_at_soi();
    for (;;) {
      int m = next_marker();
      if ((m >= 0xC0 && m <= 0xCF && m != 0xC4 && m != 0xCC) || m == 0xDA)
        fail("bogus JPEGTables field");
      if (read_marker(m) == kEOI) break;
    }
    d = sd;
    n = sn;
    pos = 0;
  }

  // The next marker from ``p`` in the entropy-coded data (libjpeg's
  // next_marker); the end of the data is a truncated file, or EOI in TIFF.
  // ``strict``: past what Pillow has fed, the arithmetic decoder's
  // read_restart_marker cannot suspend.
  int scan_marker(size_t& p, bool strict) {
    auto byte = [&]() -> int {
      if (p >= n) {
        if (tiff) return -1;
        fail(strict ? "broken arithmetic-coded JPEG data (data ends inside a scan)"
                    : "truncated JPEG file (data ends inside a scan)");
      }
      if (strict && !tiff && p >= feed) fail_feed();
      if (!strict) reached(p);
      return d[p++];
    };
    for (;;) {
      int c = byte();
      if (c < 0) return 0xD9;
      if (c != 0xFF) continue;
      do {
        c = byte();
        if (c < 0) return 0xD9;
      } while (c == 0xFF);
      if (c != 0) return c;
    }
  }

  [[noreturn]] void fail_feed() {
    fail("arithmetic-coded JPEG data past the 65536-byte reads Pillow feeds libjpeg "
         "(its arithmetic decoder cannot suspend)");
  }

  void read_header_only(bool* has_frame) {
    if (n < 2 || d[0] != 0xFF || d[1] != 0xD8) fail("not a JPEG file");
    pos = 2;
    reset_at_soi();
    for (;;) {
      int m = next_marker();
      if (m >= 0xC0 && m <= 0xCF && m != 0xC4 && m != 0xCC && m != 0xC8) {
        read_marker(m);
        break;
      }
      if (m == 0xDA) fail("JPEG scan before a frame header");
      if (read_marker(m) == kEOI) break;
    }
    *has_frame = frame;
  }

  static constexpr int kSOS = 1, kEOI = 2;

  // One marker as libjpeg's read_markers takes it: 0, or kSOS after a scan
  // header, or kEOI.
  int read_marker(int m) {
    switch (m) {
      case 0xC0: case 0xC1: case 0xC2: case 0xC3: case 0xC9: case 0xCA: case 0xCB:
        read_sof(m);
        return 0;
      case 0xC5: case 0xC6: case 0xC7: case 0xCD: case 0xCE: case 0xCF:
        fail("hierarchical JPEG is not supported");
      case 0xC8: fail("unsupported JPEG marker 0xC8 (JPG)");
      case 0xC4: read_dht(); return 0;
      case 0xCC: read_dac(); return 0;
      case 0xDB: read_dqt(); return 0;
      case 0xDD: read_dri(); return 0;
      case 0xDA: read_sos(); return kSOS;
      case 0xD9: return kEOI;
      case 0xD8: fail("JPEG file has a second SOI marker");
      case 0xDC: case 0xFE: skip(u16() - 2); return 0;  // DNL, COM
      default:
        if (m >= 0xE0 && m <= 0xEF) {
          read_app(m);
          return 0;
        }
        if ((m >= 0xD0 && m <= 0xD7) || m == 0x01) return 0;  // RSTn, TEM
        {
          char buf[64];
          std::snprintf(buf, sizeof buf, "unsupported JPEG marker 0x%02X", m);
          fail(buf);
        }
    }
  }

  // get_interesting_appn for APP0 / APP14 (JFIF, Adobe), skip_variable
  // for the others; a length under 2 skips nothing.
  void read_app(int m) {
    long len = u16() - 2;
    if (m != 0xE0 && m != 0xEE) {
      skip(len);
      return;
    }
    uint8_t b[14];
    long take = std::max(0L, std::min(len, 14L));
    for (long i = 0; i < take; i++) b[i] = (uint8_t)u8();
    if (m == 0xE0 && take >= 14 && b[0] == 'J' && b[1] == 'F' && b[2] == 'I' && b[3] == 'F' &&
        b[4] == 0)
      jfif = true;
    if (m == 0xEE && take >= 12 && b[0] == 'A' && b[1] == 'd' && b[2] == 'o' && b[3] == 'b' &&
        b[4] == 'e') {
      adobe = true;
      adobe_transform = b[11];
    }
    skip(len - take);
  }

  // get_dqt: 64 entries a table, whatever the length says (a short
  // segment reads on into what follows and fails its length check).
  void read_dqt() {
    long len = u16() - 2;
    while (len > 0) {
      int pq = u8();
      int tq = pq & 15, prec = pq >> 4;
      if (tq > 3) fail("bogus JPEG quantisation table index");
      for (int i = 0; i < 64; i++) qt[tq][kNatural[i]] = (uint16_t)(prec ? u16() : u8());
      qt_defined[tq] = true;
      len -= 65 + (prec ? 64 : 0);
    }
    if (len != 0) fail("bogus JPEG DQT length");
  }

  void read_dht() {
    long len = u16() - 2;
    while (len > 16) {
      int index = u8();
      uint8_t bits[17];
      bits[0] = 0;
      int count = 0;
      for (int i = 1; i <= 16; i++) {
        bits[i] = (uint8_t)u8();
        count += bits[i];
      }
      len -= 1 + 16;
      if (count > 256 || count > len) fail("bogus Huffman table definition");
      uint8_t vals[256] = {0};
      for (int i = 0; i < count; i++) vals[i] = (uint8_t)u8();
      len -= count;
      HuffSpec* spec;
      if (index & 0x10) {
        index -= 0x10;
        if (index < 0 || index > 3) fail("bogus DHT index");
        spec = &ac_spec[index];
      } else {
        if (index < 0 || index > 3) fail("bogus DHT index");
        spec = &dc_spec[index];
      }
      std::memcpy(spec->bits, bits, 17);
      std::memcpy(spec->vals, vals, 256);
      spec->defined = true;
    }
    if (len != 0) fail("bogus JPEG DHT length");
  }

  // get_dac: arithmetic coding conditioning (DC L and U, AC K).
  void read_dac() {
    long len = u16() - 2;
    while (len > 0) {
      int index = u8(), val = u8();
      len -= 2;
      if (index >= 32) fail("bogus DAC index");
      if (index >= 16) {
        arith_K[index - 16] = (uint8_t)val;
      } else {
        arith_L[index] = (uint8_t)(val & 15);
        arith_U[index] = (uint8_t)(val >> 4);
        if (arith_L[index] > arith_U[index]) fail("bogus DAC value");
      }
    }
    if (len != 0) fail("bogus JPEG DAC length");
  }

  void read_dri() {
    if (u16() != 4) fail("bogus JPEG DRI length");
    restart_interval = u16();
  }

  void read_sof(int m) {
    if (frame) fail("JPEG file has two frame headers");
    progressive = m == 0xC2 || m == 0xCA;
    lossless = m == 0xC3 || m == 0xCB;
    arith = m >= 0xC9;
    int len = u16();
    precision = u8();
    height = u16();
    width = u16();
    ncomp = u8();
    if (width <= 0 || height <= 0 || ncomp <= 0) fail("JPEG frame has an empty image");
    if (len - 8 != 3 * ncomp) fail("bogus JPEG SOF length");
    comps.assign(ncomp, Component());
    for (int ci = 0; ci < ncomp; ci++) {
      Component& c = comps[ci];
      c.index = ci;
      c.id = u8();
      int hv = u8();
      c.h = hv >> 4;
      c.v = hv & 15;
      c.tq = u8();
    }
    frame = true;
  }

  // -- scans
  Component* scan_comp[4];
  int scan_n = 0, Ss = 0, Se = 63, Ah = 0, Al = 0;
  HuffDerived dc_d[4], ac_d[4];
  int eobrun = 0;

  // get_sos: a component is found only among the first four, and only
  // once (libjpeg-turbo's cur_comp_info test).
  void read_sos() {
    if (!frame) fail("JPEG scan before a frame header");
    int len = u16();
    int ns = u8();
    if (len != 6 + 2 * ns || ns < 1 || ns > 4) fail("bogus JPEG SOS length");
    scan_n = ns;
    Component* slot[4] = {nullptr, nullptr, nullptr, nullptr};
    for (int i = 0; i < ns; i++) {
      int cid = u8(), tbl = u8();
      Component* found = nullptr;
      for (int ci = 0; ci < ncomp && ci < 4; ci++)
        if (comps[ci].id == cid && !slot[ci]) {
          found = &comps[ci];
          break;
        }
      if (!found) fail("JPEG scan names an unknown component");
      slot[i] = found;
      for (int j = 0; j < i; j++)
        if (slot[j] == found) fail("JPEG scan names a component twice");
      found->dc_tbl = tbl >> 4;
      found->ac_tbl = tbl & 15;
    }
    for (int i = 0; i < ns; i++) scan_comp[i] = slot[i];
    Ss = u8();
    Se = u8();
    int a = u8();
    Ah = a >> 4;
    Al = a & 15;
  }

  // libjpeg's initial_setup and master_selection at the first scan.
  void initial_setup() {
    if (width > 65500 || height > 65500) fail("JPEG image wider or taller than 65500 pixels");
    if (precision != 8) {
      char buf[80];
      std::snprintf(buf, sizeof buf, "%d-bit JPEG is not supported", precision);
      fail(buf);
    }
    if ((long long)width * height > kMaxPixels) {
      char buf[120];
      std::snprintf(buf, sizeof buf, "image size (%lld pixels) exceeds limit of "
                    "%lld pixels, could be decompression bomb DOS attack",
                    (long long)width * height, kMaxPixels);
      fail(buf);
    }
    // a TIFF strip holds as many components as its samples (libjpeg takes
    // up to 10); a JPEG file one, three or four (Pillow's modes)
    if (tiff ? ncomp > 10 : (ncomp != 1 && ncomp != 3 && ncomp != 4)) {
      char buf[80];
      std::snprintf(buf, sizeof buf, "%d-component JPEG is not supported", ncomp);
      fail(buf);
    }
    max_h = max_v = 1;
    for (auto& c : comps) {
      if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4) fail("bogus JPEG sampling factors");
      max_h = std::max(max_h, c.h);
      max_v = std::max(max_v, c.v);
    }
    if (lossless && arith) fail("arithmetic-coded lossless JPEG is not supported (nor by libjpeg-turbo)");
    const int du = lossless ? 1 : 8;
    mcux = (width + du * max_h - 1) / (du * max_h);
    mcuy = (height + du * max_v - 1) / (du * max_v);
    for (auto& c : comps) {
      if (max_h % c.h || max_v % c.v) fail("fractional JPEG sampling ratios are not supported");
      c.dw = (int)(((long)width * c.h + max_h - 1) / max_h);
      c.dh = (int)(((long)height * c.v + max_v - 1) / max_v);
      c.wib = (int)(((long)width * c.h + (long)du * max_h - 1) / ((long)du * max_h));
      c.hib = (int)(((long)height * c.v + (long)du * max_v - 1) / ((long)du * max_v));
      c.bw = mcux * c.h;
      c.bh = mcuy * c.v;
      if (lossless) {
        c.samples.assign((size_t)c.wib * c.hib, 0);
        c.diff.assign((size_t)c.bw * c.v, 0);
        c.undiff.assign((size_t)c.wib * c.v, 0);
      } else {
        c.coef.assign((size_t)c.bw * c.bh * 64, 0);
      }
      for (int k = 0; k < 64; k++) c.coef_bits[k] = -1;
    }
    multi_scan = scan_n < ncomp || progressive;
  }

  // libjpeg-turbo's std_huff_tables (jinit_huff_decoder, sequential files
  // only): a table 0 or 1 that a scan uses undefined is the standard one
  // (motion-JPEG frames rely on it).
  const HuffSpec& huff(HuffSpec* specs, int index, bool dc) {
    if (index > 3) fail("JPEG scan uses an undefined Huffman table");
    HuffSpec& s = specs[index];
    if (!s.defined && index < 2 && !progressive && !lossless) {
      const uint8_t* bits = dc ? (index ? kBitsDcChrom : kBitsDcLum)
                               : (index ? kBitsAcChrom : kBitsAcLum);
      const uint8_t* vals = dc ? kValDc : (index ? kValAcChrom : kValAcLum);
      std::memcpy(s.bits, bits, 17);
      int count = 0;
      for (int l = 1; l <= 16; l++) count += bits[l];
      std::memset(s.vals, 0, sizeof s.vals);
      std::memcpy(s.vals, vals, (size_t)count);
      s.defined = true;
    }
    return s;
  }

  // start_input_pass: per_scan_setup, the quantisation latch and the
  // entropy decoder's start_pass checks.
  void start_scan() {
    if (scan_n > 1) {  // libjpeg's D_MAX_BLOCKS_IN_MCU
      int blocks = 0;
      for (int i = 0; i < scan_n; i++) blocks += scan_comp[i]->h * scan_comp[i]->v;
      if (blocks > 10) fail("JPEG sampling factors too large for an interleaved scan");
    }
    if (!lossless) {
      for (int i = 0; i < scan_n; i++) {  // latch each table at its first scan
        Component* c = scan_comp[i];
        if (c->latched) continue;
        if (c->tq > 3 || !qt_defined[c->tq])
          fail("JPEG component uses an undefined quantisation table");
        for (int k = 0; k < 64; k++) {
          c->q[k] = (int16_t)qt[c->tq][k];
          c->qraw[k] = qt[c->tq][k];
        }
        c->latched = true;
      }
    }
    if (lossless) {
      // start_pass_lossless (Ss the predictor, Al the point transform)
      if (Ss < 1 || Ss > 7 || Se != 0 || Ah != 0 || Al >= precision)
        fail("invalid lossless JPEG scan parameters");
      int mcus_per_row = scan_n == 1 ? scan_comp[0]->wib : mcux;
      if (restart_interval % mcus_per_row)
        fail("lossless JPEG restart interval not a multiple of the MCUs in a row");
      for (int i = 0; i < scan_n; i++) {
        if (scan_comp[i]->dc_tbl > 3) fail("JPEG scan uses an undefined Huffman table");
        derive(huff(dc_spec, scan_comp[i]->dc_tbl, true), true, 16, &dc_d[i]);
      }
      for (auto& c : comps) c.first_row = true;
    } else if (progressive) {
      bool bad = false;
      if (Ss == 0) {
        if (Se != 0) bad = true;
      } else {
        if (Se < Ss || Se > 63 || scan_n != 1) bad = true;
      }
      if (Ah != 0 && Ah - 1 != Al) bad = true;
      if (Al > 13) bad = true;
      if (bad) fail("invalid progressive JPEG scan parameters");
      // Each coefficient's known precision, and coefficients 0-9 as they
      // were before this scan (libjpeg only warns on out-of-order
      // refinements, so neither does this).
      for (int i = 0; i < scan_n; i++) {
        Component* c = scan_comp[i];
        for (int k = std::min(Ss, 1); k <= std::max(Se, 9); k++)
          if (k < 10) c->prev_coef_bits[k] = scans > 0 ? c->coef_bits[k] : 0;
        for (int k = Ss; k <= Se; k++) c->coef_bits[k] = Al;
      }
      if (!arith)
        for (int i = 0; i < scan_n; i++) {
          Component* c = scan_comp[i];
          if (Ss == 0 && Ah == 0) derive(huff(dc_spec, c->dc_tbl, true), true, 15, &dc_d[i]);
          if (Ss != 0) derive(huff(ac_spec, c->ac_tbl, false), false, 15, &ac_d[i]);
        }
    } else if (!arith) {  // a sequential scan's Ss, Se, Ah and Al are ignored
      for (int i = 0; i < scan_n; i++) {
        Component* c = scan_comp[i];
        derive(huff(dc_spec, c->dc_tbl, true), true, 15, &dc_d[i]);
        derive(huff(ac_spec, c->ac_tbl, false), false, 15, &ac_d[i]);
      }
    }
    scans++;
  }

  // ---- arithmetic decoding (jdarith.c)
  uint8_t dc_stats[16][64], ac_stats[16][256];
  uint8_t fixed_bin[4] = {113, 0, 0, 0};

  void arith_reset_stats() {
    for (int i = 0; i < scan_n; i++) {
      Component* c = scan_comp[i];
      if (!progressive || (Ss == 0 && Ah == 0)) {
        std::memset(dc_stats[c->dc_tbl], 0, 64);
        c->pred = 0;
        c->dc_context = 0;
      }
      if (!progressive || Ss) std::memset(ac_stats[c->ac_tbl], 0, 256);
    }
  }

  // DC difference (F.19, F.21-F.24) into the component's predictor; false
  // on a bad code (the decoder stops for the rest of the interval).
  bool arith_dc(ArithReader& ar, Component* c) {
    int tbl = c->dc_tbl;
    uint8_t* base = dc_stats[tbl];
    const bool conditioned = !(fault & kArithDefaultConditioning);
    int L = conditioned ? arith_L[tbl] : 0, U = conditioned ? arith_U[tbl] : 1;
    uint8_t* st = base + c->dc_context;
    if (ar.decode(st) == 0) {
      c->dc_context = 0;
      return true;
    }
    int sign = ar.decode(st + 1);
    st += 2 + sign;
    int m = ar.decode(st);
    if (m) {
      st = base + 20;
      while (ar.decode(st)) {
        if ((m <<= 1) == 0x8000) return false;
        st += 1;
      }
    }
    if (m < (int)((1L << L) >> 1))
      c->dc_context = 0;
    else if (m > (int)((1L << U) >> 1))
      c->dc_context = 12 + sign * 4;
    else
      c->dc_context = 4 + sign * 4;
    int v = m;
    st += 14;
    while (m >>= 1)
      if (ar.decode(st)) v |= m;
    v += 1;
    if (sign) v = -v;
    c->pred = (c->pred + v) & 0xFFFF;
    return true;
  }

  // The AC value at k's bins (sign, F.23, F.24); false on a bad code.
  bool arith_ac_value(ArithReader& ar, int tbl, int k, uint8_t* st, int* out) {
    const int K = (fault & kArithDefaultConditioning) ? 5 : arith_K[tbl];
    int sign = ar.decode(fixed_bin);
    st += 2;
    int m = ar.decode(st);
    if (m) {
      if (ar.decode(st)) {
        m <<= 1;
        st = ac_stats[tbl] + (k <= K ? 189 : 217);
        while (ar.decode(st)) {
          if ((m <<= 1) == 0x8000) return false;
          st += 1;
        }
      }
    }
    int v = m;
    st += 14;
    while (m >>= 1)
      if (ar.decode(st)) v |= m;
    v += 1;
    *out = sign ? -v : v;
    return true;
  }

  // One block of an arithmetic-coded scan (decode_mcu and the four
  // progressive decoders, block by block).
  void arith_block(ArithReader& ar, int i, int16_t* blk) {
    Component* c = scan_comp[i];
    if (!progressive || (Ss == 0 && Ah == 0)) {
      if (!arith_dc(ar, c)) {
        ar.ct = -1;
        return;
      }
      blk[0] = progressive ? (int16_t)((unsigned)c->pred << Al) : (int16_t)c->pred;
      if (progressive) return;
    }
    if (progressive && Ss == 0) {  // DC refine: the next bit
      if (ar.decode(fixed_bin)) blk[0] = (int16_t)(blk[0] | (1 << Al));
      return;
    }
    const int tbl = c->ac_tbl;
    const int first = progressive ? Ss : 1, last = progressive ? Se : 63;
    if (progressive && Ah != 0) {  // AC refine
      const int p1 = 1 << Al, m1 = (int)((unsigned)-1 << Al);
      int kex = last;
      for (; kex > 0; kex--)
        if (blk[kNatural[kex]]) break;
      for (int k = first; k <= last; k++) {
        uint8_t* st = ac_stats[tbl] + 3 * (k - 1);
        if (k > kex && ar.decode(st)) break;
        for (;;) {
          int16_t* coef = blk + kNatural[k];
          if (*coef) {
            if (ar.decode(st + 2)) *coef = (int16_t)(*coef + (*coef < 0 ? m1 : p1));
            break;
          }
          if (ar.decode(st + 1)) {
            *coef = (int16_t)(ar.decode(fixed_bin) ? m1 : p1);
            break;
          }
          st += 3;
          if (++k > last) {
            ar.ct = -1;
            return;
          }
        }
      }
      return;
    }
    for (int k = first; k <= last; k++) {  // sequential AC, or AC first
      uint8_t* st = ac_stats[tbl] + 3 * (k - 1);
      if (ar.decode(st)) break;  // EOB
      while (ar.decode(st + 1) == 0) {
        st += 3;
        if (++k > last) {
          ar.ct = -1;
          return;
        }
      }
      int v;
      if (!arith_ac_value(ar, tbl, k, st, &v)) {
        ar.ct = -1;
        return;
      }
      blk[kNatural[k]] = progressive ? (int16_t)((unsigned)v << Al) : (int16_t)v;
    }
  }

  // ---- scans of DCT blocks (Huffman or arithmetic)

  void decode_scan() {
    if (lossless) {
      decode_lossless_scan();
      return;
    }
    BitReader br{d, n, pos};
    br.eof_eoi = tiff;
    if (!tiff) br.feed = &feed;
    br.refill = !tiff && !progressive;
    ArithReader ar{this, pos};
    if (arith) arith_reset_stats();
    for (int i = 0; i < scan_n; i++) scan_comp[i]->pred = 0;
    eobrun = 0;
    int restarts_to_go = restart_interval;
    int next_restart = 0;
    long mcus_x, mcus_y;
    if (scan_n == 1) {
      mcus_x = scan_comp[0]->wib;
      mcus_y = scan_comp[0]->hib;
    } else {
      mcus_x = mcux;
      mcus_y = mcuy;
    }
    const int v0 = scan_comp[0]->v;
    for (long my = 0; my < mcus_y; my++) {
      // consume_data's iMCU row (a single-component scan's holds v rows)
      const int imcu_row = (int)(scan_n == 1 ? my / v0 : my);
      for (long mx = 0; mx < mcus_x; mx++) {
        // consume_data notes the row before decode_mcu takes a restart
        if (arith || !br.insufficient) last_good_imcu_row = imcu_row;
        if (restart_interval) {
          if (restarts_to_go == 0) {
            if (arith)
              arith_restart(ar, next_restart);
            else
              process_restart(br, next_restart);
            next_restart = (next_restart + 1) & 7;
            restarts_to_go = restart_interval;
          }
        }
        if (arith) {
          if (ar.ct != -1) {
            if (scan_n == 1) {
              arith_block(ar, 0, scan_comp[0]->block((int)my, (int)mx));
            } else {
              for (int i = 0; i < scan_n && ar.ct != -1; i++) {
                Component* c = scan_comp[i];
                for (int yy = 0; yy < c->v; yy++)
                  for (int xx = 0; xx < c->h; xx++)
                    if (ar.ct != -1)
                      arith_block(ar, i, c->block((int)my * c->v + yy, (int)mx * c->h + xx));
              }
            }
          }
        } else if (!br.insufficient) {
          huffman_mcu(br, (int)my, (int)mx);
        }
        if (restart_interval) restarts_to_go--;
      }
    }
    // Hand the marker that ended the data (if any) to the marker reader.
    if (arith) {
      pos = ar.pos;
      unread_marker = ar.marker;
    } else {
      pos = br.pos;
      unread_marker = br.marker;
    }
  }

  void mcu_blocks(BitReader& br, int my, int mx) {
    if (scan_n == 1) {
      decode_block(br, 0, scan_comp[0]->block(my, mx));
      return;
    }
    for (int i = 0; i < scan_n; i++) {
      Component* c = scan_comp[i];
      for (int yy = 0; yy < c->v; yy++)
        for (int xx = 0; xx < c->h; xx++)
          decode_block(br, i, c->block(my * c->v + yy, mx * c->h + xx));
    }
  }

  // One MCU of a Huffman scan as decode_mcu reads it: a sequential scan
  // takes decode_mcu_fast while libjpeg's buffer holds 512 bytes a block of
  // the MCU past the reader (no restart interval, no marker met; a marker
  // met on the way sends the MCU to the slow path from its start), and a
  // sequential MCU whose read crosses what Pillow has fed starts again once
  // Pillow feeds more. (A progressive one goes on: it reads the same bits.)
  void huffman_mcu(BitReader& br, int my, int mx) {
    if (progressive) {
      mcu_blocks(br, my, mx);
      return;
    }
    const BitReader start = br;
    int preds[4];
    for (int i = 0; i < scan_n; i++) preds[i] = scan_comp[i]->pred;
    size_t blocks = 0;
    for (int i = 0; i < scan_n; i++)
      blocks += scan_n == 1 ? 1 : (size_t)scan_comp[i]->h * scan_comp[i]->v;
    for (;;) {
      try {
        if (!tiff && !restart_interval && !br.marker &&
            std::min(n, feed) >= br.pos + 512 * blocks) {
          br.fast = true;
          br.fast_marker = 0;
          mcu_blocks(br, my, mx);
          br.fast = false;
          if (!br.fast_marker) return;
          br = start;
          for (int i = 0; i < scan_n; i++) scan_comp[i]->pred = preds[i];
        }
        mcu_blocks(br, my, mx);
        return;
      } catch (const Refill&) {
        br = start;
        for (int i = 0; i < scan_n; i++) scan_comp[i]->pred = preds[i];
      }
    }
  }

  // read_restart_marker, with jpeg_resync_to_restart; returns the marker it
  // leaves unread (a segment to be read as empty), or 0. ``strict``: the
  // arithmetic decoder's, which cannot suspend.
  int read_restart_marker(size_t& p, int marker, int expected, bool strict) {
    int m = marker ? marker : scan_marker(p, strict);
    if (m == 0xD0 + expected) return 0;
    for (;;) {
      int action;
      if (m < 0xC0) action = 2;
      else if (m < 0xD0 || m > 0xD7) action = 3;
      else if (m == 0xD0 + ((expected + 1) & 7) || m == 0xD0 + ((expected + 2) & 7)) action = 3;
      else if (m == 0xD0 + ((expected - 1) & 7) || m == 0xD0 + ((expected - 2) & 7)) action = 2;
      else action = 1;
      if (action == 1) return 0;
      if (action == 3) return m;
      m = scan_marker(p, strict);
    }
  }

  void process_restart(BitReader& br, int expected) {
    br.acc = 0;
    br.nbits = 0;
    int left = read_restart_marker(br.pos, br.marker, expected, false);
    br.marker = left;
    for (int i = 0; i < scan_n; i++) scan_comp[i]->pred = 0;
    eobrun = 0;
    if (!left) br.insufficient = false;
  }

  void arith_restart(ArithReader& ar, int expected) {
    ar.marker = read_restart_marker(ar.pos, ar.marker, expected, true);
    arith_reset_stats();
    ar.c = 0;
    ar.a = 0;
    ar.ct = -16;
  }

  void decode_block(BitReader& br, int i, int16_t* blk) {
    Component* c = scan_comp[i];
    if (!progressive) {
      int s = br.decode(dc_d[i]);
      if (s) s = extend(br.get(s), s);
      s += c->pred;
      c->pred = s;
      blk[0] = (int16_t)s;
      const HuffDerived& ac = ac_d[i];
      for (int k = 1; k < 64; k++) {
        int rs = br.decode(ac);
        int r = rs >> 4;
        s = rs & 15;
        if (s) {
          k += r;
          s = extend(br.get(s), s);
          blk[kNatural[k]] = (int16_t)s;
        } else {
          if (r != 15) break;
          k += 15;
        }
      }
      return;
    }
    if (Ss == 0) {
      if (Ah == 0) {  // DC first
        int s = br.decode(dc_d[i]);
        if (s) s = extend(br.get(s), s);
        s += c->pred;
        c->pred = s;
        blk[0] = (int16_t)((unsigned)s << Al);
      } else {  // DC refine
        if (br.get(1)) blk[0] = (int16_t)(blk[0] | (1 << Al));
      }
      return;
    }
    const HuffDerived& ac = ac_d[i];
    if (Ah == 0) {  // AC first
      if (eobrun > 0) {
        eobrun--;
        return;
      }
      for (int k = Ss; k <= Se; k++) {
        int rs = br.decode(ac);
        int r = rs >> 4, s = rs & 15;
        if (s) {
          k += r;
          s = extend(br.get(s), s);
          blk[kNatural[k]] = (int16_t)((unsigned)s << Al);
        } else {
          if (r == 15) {
            k += 15;
          } else {
            eobrun = 1 << r;
            if (r) eobrun += br.get(r);
            eobrun--;
            break;
          }
        }
      }
      return;
    }
    // AC refine
    int p1 = 1 << Al, m1 = (int)((unsigned)-1 << Al);
    bool apply = !(fault & kRefineNoCorrection);
    int k = Ss;
    if (eobrun == 0) {
      for (; k <= Se; k++) {
        int rs = br.decode(ac);
        int r = rs >> 4, s = rs & 15;
        if (s) {
          s = br.get(1) ? p1 : m1;
        } else {
          if (r != 15) {
            eobrun = 1 << r;
            if (r) eobrun += br.get(r);
            break;
          }
        }
        do {
          int16_t* coef = blk + kNatural[k];
          if (*coef != 0) {
            if (br.get(1) && apply) {
              if ((*coef & p1) == 0) {
                if (*coef >= 0) *coef = (int16_t)(*coef + p1);
                else *coef = (int16_t)(*coef + m1);
              }
            }
          } else {
            if (--r < 0) break;
          }
          k++;
        } while (k <= Se);
        if (s) blk[kNatural[k]] = (int16_t)s;
      }
    }
    if (eobrun > 0) {
      for (; k <= Se; k++) {
        int16_t* coef = blk + kNatural[k];
        if (*coef != 0) {
          if (br.get(1) && apply) {
            if ((*coef & p1) == 0) {
              if (*coef >= 0) *coef = (int16_t)(*coef + p1);
              else *coef = (int16_t)(*coef + m1);
            }
          }
        }
      }
      eobrun--;
    }
  }

  // ---- lossless scans (jddiffct.c, jdlhuff.c, jdlossls.c)

  // One row of a component: undifference ``w`` samples (the first-row rule
  // after a scan or restart start, else the scan's predictor with the
  // sample above first), then the point transform into 8 bits.
  void undifference(Component& c, const int32_t* diff, const int32_t* prev, int32_t* out,
                    uint8_t* samples) {
    const int w = c.wib;
    int psv = (fault & kLosslessLeftPredictor) ? 1 : Ss;
    if (c.first_row) {
      int ra = (diff[0] + (1 << (precision - Al - 1))) & 0xFFFF;
      out[0] = ra;
      for (int x = 1; x < w; x++) out[x] = ra = (diff[x] + ra) & 0xFFFF;
      c.first_row = false;
    } else {
      int rb = prev[0], ra = (diff[0] + rb) & 0xFFFF;
      out[0] = ra;
      for (int x = 1; x < w; x++) {
        int rc = rb;
        rb = prev[x];
        int p;
        switch (psv) {
          case 1: p = ra; break;
          case 2: p = rb; break;
          case 3: p = rc; break;
          case 4: p = ra + rb - rc; break;
          case 5: p = ra + ((rb - rc) >> 1); break;
          case 6: p = rb + ((ra - rc) >> 1); break;
          default: p = (ra + rb) >> 1; break;
        }
        out[x] = ra = (diff[x] + p) & 0xFFFF;
      }
    }
    for (int x = 0; x < w; x++) samples[x] = (uint8_t)(out[x] << Al);
  }

  void decode_lossless_scan() {
    BitReader br{d, n, pos};
    br.eof_eoi = tiff;
    const bool interleaved = scan_n > 1;
    const int mcus_per_row = interleaved ? mcux : scan_comp[0]->wib;
    int restart_rows_to_go = restart_interval / mcus_per_row;
    int next_restart = 0;
    for (int row = 0; row < mcuy; row++) {
      const bool last = row == mcuy - 1;
      Component* c0 = scan_comp[0];
      int last_rows = c0->hib % c0->v ? c0->hib % c0->v : c0->v;
      int mcu_rows = interleaved ? 1 : (last ? last_rows : c0->v);
      for (int yoff = 0; yoff < mcu_rows; yoff++) {
        if (restart_interval) {
          if (restart_rows_to_go == 0) {
            br.acc = 0;
            br.nbits = 0;
            int left = read_restart_marker(br.pos, br.marker, next_restart, false);
            br.marker = left;
            if (!left) br.insufficient = false;
            next_restart = (next_restart + 1) & 7;
            for (auto& c : comps) c.first_row = true;
            restart_rows_to_go = restart_interval / mcus_per_row;
          }
        }
        if (br.insufficient) {  // out of data: zero differences, first-row rule
          for (int i = 0; i < scan_n; i++) {
            Component* c = scan_comp[i];
            int rows = interleaved ? c->v : 1;
            for (int y = 0; y < rows; y++)
              std::fill_n(&c->diff[(size_t)(yoff + y) * c->bw], (size_t)mcus_per_row *
                          (interleaved ? c->h : 1), 0);
          }
          for (auto& c : comps) c.first_row = true;
        } else {
          for (int mx = 0; mx < mcus_per_row; mx++)
            for (int i = 0; i < scan_n; i++) {
              Component* c = scan_comp[i];
              int mh = interleaved ? c->v : 1, mw = interleaved ? c->h : 1;
              for (int y = 0; y < mh; y++)
                for (int x = 0; x < mw; x++) {
                  int s = br.decode(dc_d[i]);
                  if (s) {
                    if (s == 16)
                      s = 32768;
                    else
                      s = extend(br.get(s), s);
                  }
                  c->diff[(size_t)(yoff + y) * c->bw + mx * mw + x] = s;
                }
            }
        }
        if (restart_interval) restart_rows_to_go--;
      }
      for (int i = 0; i < scan_n; i++) {
        Component& c = *scan_comp[i];
        int rows = last ? (c.hib % c.v ? c.hib % c.v : c.v) : c.v;
        for (int r = 0; r < rows; r++) {
          int prev = r ? r - 1 : c.v - 1;
          int y = row * c.v + r;
          undifference(c, &c.diff[(size_t)r * c.bw], &c.undiff[(size_t)prev * c.wib],
                       &c.undiff[(size_t)r * c.wib], &c.samples[(size_t)y * c.wib]);
        }
      }
    }
    pos = br.pos;
    unread_marker = br.marker;
  }

  // ---- the whole file

  void run() {
    if (n < 2 || d[0] != 0xFF || d[1] != 0xD8) fail("not a JPEG file");
    pos = 2;
    reset_at_soi();
    for (;;) {  // jpeg_read_header: to the first scan
      int m = next_marker();
      int r = read_marker(m);
      if (r == kSOS) break;
      if (r == kEOI) {
        if (frame || tiff) fail("JPEG file has no scan");
        // tables only: Pillow reads the header again, which must start
        // with an SOI at once
        if (pos + 2 > n) fail("truncated JPEG file (data ends inside a marker)");
        if (d[pos] != 0xFF || d[pos + 1] != 0xD8) fail("not a JPEG file (no SOI after its tables)");
        pos += 2;
        reset_at_soi();
      }
    }
    initial_setup();
    start_scan();
    decode_scan();
    if (!multi_scan) {
      // a single scan holds the whole image: Pillow's jpeg_finish_decompress
      // reads the markers that follow to EOI (the end of the data ends it
      // well); libtiff's JPEGDecode ignores them
      if (!tiff) finish();
      return;
    }
    for (;;) {  // absorb every scan to EOI (TIFF: or the end of the data)
      int m = next_marker();
      int r = read_marker(m);
      if (r == kEOI) break;
      if (r == kSOS) {
        start_scan();
        decode_scan();
      }
    }
  }

  void finish() {
    finishing = true;
    try {
      for (;;) {
        int m = next_marker();
        int r = read_marker(m);
        if (r == kEOI) return;
        if (r == kSOS) fail("JPEG file has a second scan after its one sequential scan");
      }
    } catch (const Suspend&) {
    }
  }
};

int ArithReader::get_byte() {
  if (pos >= dec->n) {
    if (dec->tiff) {  // libtiff's source manager: the end reads as EOI
      return pos++ == dec->n ? 0xFF : 0xD9;
    }
    fail("broken arithmetic-coded JPEG data (data ends inside a scan)");
  }
  if (!dec->tiff && pos >= dec->feed) dec->fail_feed();
  return dec->d[pos++];
}

// The islow IDCT's output table (libjpeg's range_limit + CENTERJSAMPLE,
// indexed by value & RANGE_MASK).
struct RangeLimit {
  uint8_t idct[1024];
  uint8_t simple[256 * 3];  // index + 256: clamp to 0..255
  RangeLimit() {
    for (int x = 0; x < 1024; x++) {
      int v = x < 512 ? x : x - 1024;
      idct[x] = (uint8_t)std::min(255, std::max(0, v + 128));
    }
    for (int i = 0; i < 768; i++) simple[i] = (uint8_t)std::min(255, std::max(0, i - 256));
  }
};
const RangeLimit kRange;

constexpr int CONST_BITS = 13;
constexpr int PASS1_BITS = 2;
constexpr int32_t FIX_0_298631336 = 2446, FIX_0_390180644 = 3196, FIX_0_541196100 = 4433,
                  FIX_0_765366865 = 6270, FIX_0_899976223 = 7373, FIX_1_175875602 = 9633,
                  FIX_1_501321110 = 12299, FIX_1_847759065 = 15137, FIX_1_961570560 = 16069,
                  FIX_2_053119869 = 16819, FIX_2_562915447 = 20995, FIX_3_072711026 = 25172;

inline int32_t descale(int32_t x, int n) { return (x + (1 << (n - 1))) >> n; }

// One 1-D islow pass (jidctint.c's butterfly) over x[0..7], undescaled:
// arithmetic modulo 2^32, as x86-64 computes it. With ``lanes`` the sums
// that libjpeg-turbo's SSE2 / AVX2 code forms in 16-bit lanes (x0 +- x4,
// x7 + x3, x5 + x1) wrap to 16 bits; its products (pmaddwd) are exact.
inline void islow_1d(const int32_t* x, int32_t* o, bool lanes) {
  auto lane = [lanes](uint32_t v) -> uint32_t { return lanes ? (uint32_t)(int32_t)(int16_t)v : v; };
  const uint32_t x0 = (uint32_t)x[0], x1 = (uint32_t)x[1], x2 = (uint32_t)x[2],
                 x3 = (uint32_t)x[3], x4 = (uint32_t)x[4], x5 = (uint32_t)x[5],
                 x6 = (uint32_t)x[6], x7 = (uint32_t)x[7];
  // even part
  uint32_t tmp3 = x2 * (uint32_t)(FIX_0_541196100 + FIX_0_765366865) + x6 * (uint32_t)FIX_0_541196100;
  uint32_t tmp2 = x2 * (uint32_t)FIX_0_541196100 + x6 * (uint32_t)(FIX_0_541196100 - FIX_1_847759065);
  uint32_t tmp0 = lane(x0 + x4) << CONST_BITS, tmp1 = lane(x0 - x4) << CONST_BITS;
  uint32_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3, tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
  // odd part
  uint32_t z3 = lane(x7 + x3), z4 = lane(x5 + x1);
  uint32_t z3r = z3 * (uint32_t)(FIX_1_175875602 - FIX_1_961570560) + z4 * (uint32_t)FIX_1_175875602;
  uint32_t z4r = z3 * (uint32_t)FIX_1_175875602 + z4 * (uint32_t)(FIX_1_175875602 - FIX_0_390180644);
  uint32_t t0 = x7 * (uint32_t)(FIX_0_298631336 - FIX_0_899976223) - x1 * (uint32_t)FIX_0_899976223 + z3r;
  uint32_t t3 = x1 * (uint32_t)(FIX_1_501321110 - FIX_0_899976223) - x7 * (uint32_t)FIX_0_899976223 + z4r;
  uint32_t t1 = x5 * (uint32_t)(FIX_2_053119869 - FIX_2_562915447) - x3 * (uint32_t)FIX_2_562915447 + z4r;
  uint32_t t2 = x3 * (uint32_t)(FIX_3_072711026 - FIX_2_562915447) - x5 * (uint32_t)FIX_2_562915447 + z3r;
  o[0] = (int32_t)(tmp10 + t3);
  o[7] = (int32_t)(tmp10 - t3);
  o[1] = (int32_t)(tmp11 + t2);
  o[6] = (int32_t)(tmp11 - t2);
  o[2] = (int32_t)(tmp12 + t1);
  o[5] = (int32_t)(tmp12 - t1);
  o[3] = (int32_t)(tmp13 + t0);
  o[4] = (int32_t)(tmp13 - t0);
}

inline int32_t sat16(int32_t v) { return std::min(32767, std::max(-32768, v)); }
inline int32_t descale32(int32_t x, int n) {  // (x + round) >> n, the add modulo 2^32
  return (int32_t)((uint32_t)x + (1u << (n - 1))) >> n;
}

// The islow IDCT as libjpeg-turbo's SSE2 / AVX2 code (jidctint-sse2 /
// -avx2, which agree) computes it for Pillow on x86-64: coefficients
// dequantised in 16 bits (pmullw, wrapping); when rows 1-7 of the whole
// block are zero, each column's DC << PASS1_BITS in 16 bits (wrapping),
// else the butterfly with its 16-bit sums; pass-1 outputs saturated to 16
// bits (packssdw); samples saturated to -128..127 (packssdw, packsswb) and
// centred. With ``c_arith`` (the named fault c_idct) jidctint.c's C as the
// port first had it: 32-bit products, a per-column DC shortcut, 32-bit
// pass-1 outputs and the range-limit table, which wraps. The two agree on
// every block of valid data; damaged data tells them apart.
void idct_islow(const int16_t* in, const int16_t* q, uint8_t* out, int stride, bool c_arith) {
  const bool lanes = !c_arith;
  int32_t ws[64], x[8], o[8];
  bool ac_zero = true;  // SIMD: rows 1-7 of the whole block
  for (int k = 8; k < 64 && ac_zero; k++) ac_zero = in[k] == 0;
  for (int c = 0; c < 8; c++) {
    const int16_t* ip = in + c;
    const int16_t* qp = q + c;
    if (c_arith ? (!ip[8] && !ip[16] && !ip[24] && !ip[32] && !ip[40] && !ip[48] && !ip[56])
                : ac_zero) {
      int32_t dc = c_arith ? (int32_t)((uint32_t)(ip[0] * qp[0]) << PASS1_BITS)
                           : (int16_t)((uint32_t)(int16_t)(ip[0] * qp[0]) << PASS1_BITS);
      for (int r = 0; r < 8; r++) ws[8 * r + c] = dc;
      continue;
    }
    for (int r = 0; r < 8; r++) {
      int32_t v = ip[8 * r] * qp[8 * r];
      x[r] = c_arith ? v : (int16_t)v;
    }
    islow_1d(x, o, lanes);
    for (int r = 0; r < 8; r++) {
      int32_t v = descale32(o[r], CONST_BITS - PASS1_BITS);
      ws[8 * r + c] = c_arith ? v : sat16(v);
    }
  }
  const int n = CONST_BITS + PASS1_BITS + 3;
  for (int r = 0; r < 8; r++) {
    const int32_t* wp = ws + 8 * r;
    uint8_t* op = out + (size_t)r * stride;
    if (c_arith && !wp[1] && !wp[2] && !wp[3] && !wp[4] && !wp[5] && !wp[6] && !wp[7]) {
      uint8_t v = kRange.idct[descale32(wp[0], PASS1_BITS + 3) & 1023];
      for (int c = 0; c < 8; c++) op[c] = v;
      continue;
    }
    islow_1d(wp, o, lanes);
    for (int c = 0; c < 8; c++) {
      int32_t v = descale32(o[c], n);
      op[c] = c_arith ? kRange.idct[v & 1023] : (uint8_t)(std::min(127, std::max(-128, v)) + 128);
    }
  }
}

// The named fault: a float IDCT (the separable cosine sum in double,
// rounded to nearest) in place of islow.
struct Cosines {
  double c[8][8];
  Cosines() {
    const double kPi = 3.14159265358979323846;
    for (int x = 0; x < 8; x++)
      for (int u = 0; u < 8; u++)
        c[x][u] = (u ? 1.0 : std::sqrt(0.5)) * std::cos((2 * x + 1) * u * kPi / 16) / 2;
  }
};
const Cosines kCosines;

void idct_float(const int16_t* in, const int16_t* q, uint8_t* out, int stride) {
  const auto& cosines = kCosines.c;
  double tmp[64];
  for (int u = 0; u < 8; u++)
    for (int y = 0; y < 8; y++) {
      double s = 0;
      for (int v = 0; v < 8; v++) s += cosines[y][v] * in[v * 8 + u] * q[v * 8 + u];
      tmp[y * 8 + u] = s;
    }
  for (int y = 0; y < 8; y++)
    for (int x = 0; x < 8; x++) {
      double s = 0;
      for (int u = 0; u < 8; u++) s += cosines[x][u] * tmp[y * 8 + u];
      long v = std::lround(s) + 128;
      out[(size_t)y * stride + x] = (uint8_t)std::min(255L, std::max(0L, v));
    }
}

// libjpeg-turbo's smoothing_ok, once every scan is in (Pillow drives
// libjpeg in non-buffered mode): a progressive file whose components all
// have a latched table, nonzero quantisers at the ten positions block
// smoothing divides by, and some DC bits, and whose coefficients 1-9 are
// not all exact.
bool smoothing_ok(const Decoder& dec) {
  if (!dec.progressive || (dec.fault & kNoBlockSmoothing)) return false;
  static const int kPos[10] = {0, 1, 8, 16, 9, 2, 3, 10, 17, 24};
  bool useful = false;
  for (auto& c : dec.comps) {
    if (!c.latched) return false;
    for (int p : kPos)
      if (c.qraw[p] == 0) return false;
    if (c.coef_bits[0] < 0) return false;
    for (int k = 1; k < 10; k++)
      if (c.coef_bits[k] != 0) useful = true;
  }
  return useful;
}

// One coefficient's estimate (jdcoefct.c): ``num`` = Q00 x the weighted DC
// sum, over 256 x ``q``, rounded; at most 2^Al - 1 in magnitude while Al
// bits of it are unknown.
inline int16_t smooth_pred(int64_t num, int64_t q, int al, bool clamp) {
  int64_t m = num >= 0 ? num : -num;
  int pred = (int)(((q << 7) + m) / (q << 8));
  if (clamp && al > 0 && pred >= (1 << al)) pred = (1 << al) - 1;
  return (int16_t)(num >= 0 ? pred : -pred);
}

// One component's plane of samples after the IDCT: bw*8 x bh*8. With
// ``smooth`` libjpeg-turbo 3.1's decompress_smooth_data: each block's
// unknown low-frequency coefficients estimated from the DC values of the
// 5x5 blocks around it (DC interpolated too while no AC bits are known),
// with the coefficient bits latched at the end of the file, or the state
// before the last scan for iMCU rows past the last one it decoded whole.
std::vector<uint8_t> reconstruct(const Decoder& dec, Component& c, int fault, bool smooth) {
  int stride = c.bw * 8;
  std::vector<uint8_t> plane((size_t)stride * c.bh * 8);
  const bool c_arith = fault & kCIdct;
  auto idct = [&](const int16_t* blk, int by, int bx) {
    uint8_t* o = &plane[(size_t)by * 8 * stride + bx * 8];
    if (fault & kFloatIdct) idct_float(blk, c.q, o, stride);
    else idct_islow(blk, c.q, o, stride, c_arith);
  };
  if (!smooth) {
    for (int by = 0; by < c.hib; by++)
      for (int bx = 0; bx < c.wib; bx++) idct(c.block(by, bx), by, bx);
    return plane;
  }
  int latch[10], prev_latch[10];
  for (int k = 0; k < 10; k++) {
    latch[k] = c.coef_bits[k];
    prev_latch[k] = dec.scans > 1 ? c.prev_coef_bits[k] : -1;
  }
  const int64_t Q00 = c.qraw[0], Q01 = c.qraw[1], Q10 = c.qraw[8], Q20 = c.qraw[16],
                Q11 = c.qraw[9], Q02 = c.qraw[2], Q03 = c.qraw[3], Q12 = c.qraw[10],
                Q21 = c.qraw[17], Q30 = c.qraw[24];
  const int T = dec.mcuy, last_col = c.wib - 1;
  auto dc = [&](int row, int col) { return (int)c.coef[((size_t)row * c.bw + col) * 64]; };
  int16_t ws[64];
  for (int r = 0; r < T; r++) {
    const int* bits = r > dec.last_good_imcu_row ? prev_latch : latch;
    bool change_dc = true;
    for (int k = 1; k < 10; k++) change_dc = change_dc && bits[k] == -1;
    const int block_rows = r < T - 1 ? c.v : (c.hib % c.v ? c.hib % c.v : c.v);
    // libjpeg counts image rows in this iMCU row's height (a short last
    // iMCU row shifts where the edge rows repeat)
    const long image_rows = (long)block_rows * T;
    for (int b = 0; b < block_rows; b++) {
      const long ibr = (long)r * block_rows + b;
      const int R = r * c.v + b;
      const int pR = ibr > 0 ? R - 1 : R, ppR = ibr > 1 ? R - 2 : pR;
      const int nR = ibr < image_rows - 1 ? R + 1 : R, nnR = ibr < image_rows - 2 ? R + 2 : nR;
      const int rows[5] = {ppR, pR, R, nR, nnR};
      int D[5][5];  // D[row][col]: libjpeg's DC01..DC25, the block at D[2][2]
      for (int i = 0; i < 5; i++)
        for (int j = 0; j < 5; j++) D[i][j] = dc(rows[i], 0);
      for (int bn = 0; bn <= last_col; bn++) {
        std::memcpy(ws, c.block(R, bn), sizeof ws);
        if (bn == 0 && bn < last_col)
          for (int i = 0; i < 5; i++) D[i][3] = D[i][4] = dc(rows[i], 1);
        if (bn + 1 < last_col)
          for (int i = 0; i < 5; i++) D[i][4] = dc(rows[i], bn + 2);
#define DCV(n) D[((n) - 1) / 5][((n) - 1) % 5]
        const int DC01 = DCV(1), DC02 = DCV(2), DC03 = DCV(3), DC04 = DCV(4), DC05 = DCV(5),
                  DC06 = DCV(6), DC07 = DCV(7), DC08 = DCV(8), DC09 = DCV(9), DC10 = DCV(10),
                  DC11 = DCV(11), DC12 = DCV(12), DC13 = DCV(13), DC14 = DCV(14),
                  DC15 = DCV(15), DC16 = DCV(16), DC17 = DCV(17), DC18 = DCV(18),
                  DC19 = DCV(19), DC20 = DCV(20), DC21 = DCV(21), DC22 = DCV(22),
                  DC23 = DCV(23), DC24 = DCV(24), DC25 = DCV(25);
#undef DCV
        int al;
        if ((al = bits[1]) != 0 && ws[1] == 0)  // AC01
          ws[1] = smooth_pred(Q00 * (change_dc ?
              (-DC01 - DC02 + DC04 + DC05 - 3 * DC06 + 13 * DC07 - 13 * DC09 + 3 * DC10 -
               3 * DC11 + 38 * DC12 - 38 * DC14 + 3 * DC15 - 3 * DC16 + 13 * DC17 -
               13 * DC19 + 3 * DC20 - DC21 - DC22 + DC24 + DC25) :
              (-7 * DC11 + 50 * DC12 - 50 * DC14 + 7 * DC15)), Q01, al, true);
        if ((al = bits[2]) != 0 && ws[8] == 0)  // AC10
          ws[8] = smooth_pred(Q00 * (change_dc ?
              (-DC01 - 3 * DC02 - 3 * DC03 - 3 * DC04 - DC05 - DC06 + 13 * DC07 +
               38 * DC08 + 13 * DC09 - DC10 + DC16 - 13 * DC17 - 38 * DC18 - 13 * DC19 +
               DC20 + DC21 + 3 * DC22 + 3 * DC23 + 3 * DC24 + DC25) :
              (-7 * DC03 + 50 * DC08 - 50 * DC18 + 7 * DC23)), Q10, al, true);
        if ((al = bits[3]) != 0 && ws[16] == 0)  // AC20
          ws[16] = smooth_pred(Q00 * (change_dc ?
              (DC03 + 2 * DC07 + 7 * DC08 + 2 * DC09 - 5 * DC12 - 14 * DC13 - 5 * DC14 +
               2 * DC17 + 7 * DC18 + 2 * DC19 + DC23) :
              (-DC03 + 13 * DC08 - 24 * DC13 + 13 * DC18 - DC23)), Q20, al, true);
        if ((al = bits[4]) != 0 && ws[9] == 0)  // AC11
          ws[9] = smooth_pred(Q00 * (change_dc ?
              (-DC01 + DC05 + 9 * DC07 - 9 * DC09 - 9 * DC17 + 9 * DC19 + DC21 - DC25) :
              (DC10 + DC16 - 10 * DC17 + 10 * DC19 - DC02 - DC20 + DC22 - DC24 + DC04 -
               DC06 + 10 * DC07 - 10 * DC09)), Q11, al, true);
        if ((al = bits[5]) != 0 && ws[2] == 0)  // AC02
          ws[2] = smooth_pred(Q00 * (change_dc ?
              (2 * DC07 - 5 * DC08 + 2 * DC09 + DC11 + 7 * DC12 - 14 * DC13 + 7 * DC14 +
               DC15 + 2 * DC17 - 5 * DC18 + 2 * DC19) :
              (-DC11 + 13 * DC12 - 24 * DC13 + 13 * DC14 - DC15)), Q02, al, true);
        if (change_dc) {
          if ((al = bits[6]) != 0 && ws[3] == 0)  // AC03
            ws[3] = smooth_pred(Q00 * (DC07 - DC09 + 2 * DC12 - 2 * DC14 + DC17 - DC19),
                                Q03, al, true);
          if ((al = bits[7]) != 0 && ws[10] == 0)  // AC12
            ws[10] = smooth_pred(Q00 * (DC07 - 3 * DC08 + DC09 - DC17 + 3 * DC18 - DC19),
                                 Q12, al, true);
          if ((al = bits[8]) != 0 && ws[17] == 0)  // AC21
            ws[17] = smooth_pred(Q00 * (DC07 - DC09 - 3 * DC12 + 3 * DC14 + DC17 - DC19),
                                 Q21, al, true);
          if ((al = bits[9]) != 0 && ws[24] == 0)  // AC30
            ws[24] = smooth_pred(Q00 * (DC07 + 2 * DC08 + DC09 - DC17 - 2 * DC18 - DC19),
                                 Q30, al, true);
          ws[0] = smooth_pred(Q00 * (-2 * DC01 - 6 * DC02 - 8 * DC03 - 6 * DC04 - 2 * DC05 -
                                     6 * DC06 + 6 * DC07 + 42 * DC08 + 6 * DC09 - 6 * DC10 -
                                     8 * DC11 + 42 * DC12 + 152 * DC13 + 42 * DC14 -
                                     8 * DC15 - 6 * DC16 + 6 * DC17 + 42 * DC18 + 6 * DC19 -
                                     6 * DC20 - 2 * DC21 - 6 * DC22 - 8 * DC23 - 6 * DC24 -
                                     2 * DC25), Q00, 0, false);
        }
        idct(ws, R, bn);
        for (int i = 0; i < 5; i++)
          for (int j = 0; j < 4; j++) D[i][j] = D[i][j + 1];
      }
    }
  }
  return plane;
}

// Upsample a component's ``plane`` (rows ``stride`` apart) to full
// resolution (width x height), as libjpeg's jdsample.c does: fancy when
// ``fancy`` (never for a lossless file, whose scaled block is one sample).
std::vector<uint8_t> upsample(const Decoder& dec, const Component& c, const uint8_t* plane,
                              int stride, bool fancy) {
  const int W = dec.width, H = dec.height;
  int hx = dec.max_h / c.h, vx = dec.max_v / c.v;
  std::vector<uint8_t> out((size_t)W * H);
  if (hx == 1 && vx == 1) {
    for (int y = 0; y < H; y++) std::memcpy(&out[(size_t)y * W], &plane[(size_t)y * stride], W);
    return out;
  }
  auto row = [&](int i) {  // a real row, the edge rows replicated
    i = std::max(0, std::min(c.dh - 1, i));
    return &plane[(size_t)i * stride];
  };
  std::vector<uint8_t> line((size_t)2 * c.dw + 16);

  if (hx == 2 && vx == 1 && fancy && c.dw > 2) {
    for (int y = 0; y < H; y++) {
      const uint8_t* in = &plane[(size_t)y * stride];
      uint8_t* o = line.data();
      int inv = in[0];
      *o++ = (uint8_t)inv;
      *o++ = (uint8_t)((inv * 3 + in[1] + 2) >> 2);
      for (int x = 1; x < c.dw - 1; x++) {
        inv = in[x] * 3;
        *o++ = (uint8_t)((inv + in[x - 1] + 1) >> 2);
        *o++ = (uint8_t)((inv + in[x + 1] + 2) >> 2);
      }
      inv = in[c.dw - 1];
      *o++ = (uint8_t)((inv * 3 + in[c.dw - 2] + 1) >> 2);
      *o++ = (uint8_t)inv;
      std::memcpy(&out[(size_t)y * W], line.data(), W);
    }
    return out;
  }
  if (hx == 1 && vx == 2 && fancy) {
    for (int y = 0; y < H; y++) {
      int i = y >> 1, v = y & 1;
      const uint8_t* in0 = row(i);
      const uint8_t* in1 = v ? row(i + 1) : row(i - 1);
      int bias = v ? 2 : 1;
      uint8_t* o = &out[(size_t)y * W];
      for (int x = 0; x < W; x++) o[x] = (uint8_t)((in0[x] * 3 + in1[x] + bias) >> 2);
    }
    return out;
  }
  if (hx == 2 && vx == 2 && fancy && c.dw > 2) {
    for (int y = 0; y < H; y++) {
      int i = y >> 1, v = y & 1;
      const uint8_t* in0 = row(i);
      const uint8_t* in1 = v ? row(i + 1) : row(i - 1);
      uint8_t* o = line.data();
      int thiscolsum = in0[0] * 3 + in1[0];
      int nextcolsum = in0[1] * 3 + in1[1];
      *o++ = (uint8_t)((thiscolsum * 4 + 8) >> 4);
      *o++ = (uint8_t)((thiscolsum * 3 + nextcolsum + 7) >> 4);
      int lastcolsum = thiscolsum;
      thiscolsum = nextcolsum;
      for (int x = 2; x < c.dw; x++) {
        nextcolsum = in0[x] * 3 + in1[x];
        *o++ = (uint8_t)((thiscolsum * 3 + lastcolsum + 8) >> 4);
        *o++ = (uint8_t)((thiscolsum * 3 + nextcolsum + 7) >> 4);
        lastcolsum = thiscolsum;
        thiscolsum = nextcolsum;
      }
      *o++ = (uint8_t)((thiscolsum * 3 + lastcolsum + 8) >> 4);
      *o++ = (uint8_t)((thiscolsum * 4 + 7) >> 4);
      std::memcpy(&out[(size_t)y * W], line.data(), W);
    }
    return out;
  }
  // Replication (libjpeg's h2v1 / h2v2 box and int_upsample).
  for (int y = 0; y < H; y++) {
    const uint8_t* in = &plane[(size_t)(y / vx) * stride];
    uint8_t* o = &out[(size_t)y * W];
    for (int x = 0; x < W; x++) o[x] = in[x / hx];
  }
  return out;
}

struct YccTables {
  int cr_r[256], cb_b[256];
  int32_t cr_g[256], cb_g[256];
  YccTables() {
    const int SCALEBITS = 16;
    const int32_t ONE_HALF = 1 << (SCALEBITS - 1);
    auto FIX = [](double x) { return (int32_t)(x * (1L << 16) + 0.5); };
    for (int i = 0, x = -128; i < 256; i++, x++) {
      cr_r[i] = (int)((FIX(1.40200) * x + ONE_HALF) >> SCALEBITS);
      cb_b[i] = (int)((FIX(1.77200) * x + ONE_HALF) >> SCALEBITS);
      cr_g[i] = -FIX(0.71414) * x;
      cb_g[i] = -FIX(0.34414) * x + ONE_HALF;
    }
  }
};
const YccTables kYcc;

enum ColorSpace { kGray, kYCbCr, kRGB, kCMYK, kYCCK };

// libjpeg's default_decompress_parms: JFIF, Adobe's transform, then the
// component ids; without either marker a lossless file is RGB unless its
// ids say otherwise ("assuming ... RGB (lossless)").
ColorSpace color_space(const Decoder& dec) {
  if (dec.ncomp == 1) return kGray;
  if (dec.ncomp == 4) return dec.adobe && dec.adobe_transform != 0 ? kYCCK : kCMYK;
  if (dec.jfif) return kYCbCr;
  if (dec.adobe) return dec.adobe_transform == 0 ? kRGB : kYCbCr;
  int a = dec.comps[0].id, b = dec.comps[1].id, c = dec.comps[2].id;
  if (a == 82 && b == 71 && c == 66) return kRGB;
  return dec.lossless ? kRGB : kYCbCr;
}

// Pillow's cmyk2rgb.
inline void cmyk2rgb(const int* cmyk, uint8_t* rgb) {
  const uint8_t* rl = kRange.simple + 256;
  int nk = 255 - cmyk[3];
  for (int c = 0; c < 3; c++) {
    int t = cmyk[c] * nk + 128;
    rgb[c] = rl[nk - (((t >> 8) + t) >> 8)];
  }
}

// Every component at full resolution: the lossless samples, or the IDCT
// of the coefficients (smoothed where libjpeg smooths them), upsampled.
std::vector<std::vector<uint8_t>> full_planes(const Decoder& dec, int fault) {
  const bool smooth = !dec.lossless && smoothing_ok(dec);
  const bool fancy = !dec.lossless && !(fault & kReplicateUpsample);
  std::vector<std::vector<uint8_t>> full(dec.ncomp);
  for (int ci = 0; ci < dec.ncomp; ci++) {
    Component& c = const_cast<Component&>(dec.comps[ci]);
    if (dec.lossless) {
      full[ci] = upsample(dec, c, c.samples.data(), c.wib, fancy);
    } else {
      auto plane = reconstruct(dec, c, fault, smooth);
      full[ci] = upsample(dec, c, plane.data(), c.bw * 8, fancy);
    }
  }
  return full;
}

// Decode a JPEG file whose frame Pillow's header reader found ``W`` x ``H``
// with ``nc`` components.
void decode_jpeg(const uint8_t* data, size_t n, int W, int H, int nc, uint8_t* out, int fault) {
  Decoder dec(data, n);
  dec.fault = fault;
  dec.run();
  if (dec.width != W || dec.height != H || dec.ncomp != nc)
    fail("JPEG frame header differs from the one Pillow's reader keeps");
  ColorSpace cs = color_space(dec);
  // jinit_color_deconverter allows no lossy colour conversion of a
  // lossless file
  if (dec.lossless && (cs == kYCbCr || cs == kYCCK))
    fail("lossless JPEG in YCbCr or YCCK (libjpeg converts no colours of a lossless file)");
  std::vector<std::vector<uint8_t>> full = full_planes(dec, fault);
  size_t npix = (size_t)W * H;
  if (cs == kGray) {
    std::memcpy(out, full[0].data(), npix);
    return;
  }
  const uint8_t* y = full[0].data();
  const uint8_t* cb = full[1].data();
  const uint8_t* cr = full[2].data();
  const uint8_t* rl = kRange.simple + 256;
  if (cs == kCMYK || cs == kYCCK) {
    const uint8_t* k = full[3].data();
    bool ycck = cs == kYCCK && !(fault & kYcckAsCmyk);
    uint8_t flip = (fault & kCmykNotInverted) ? 0 : 255;
    for (size_t i = 0; i < npix; i++) {
      int cmyk[4] = {y[i], cb[i], cr[i], k[i]};
      if (ycck) {  // ycck_cmyk_convert
        int Y = y[i], B = cb[i], R = cr[i];
        cmyk[0] = rl[255 - (Y + kYcc.cr_r[R])];
        cmyk[1] = rl[255 - (Y + (int)((kYcc.cb_g[B] + kYcc.cr_g[R]) >> 16))];
        cmyk[2] = rl[255 - (Y + kYcc.cb_b[B])];
      }
      for (int& v : cmyk) v ^= flip;  // Pillow's "CMYK;I" unpacker
      cmyk2rgb(cmyk, out + 3 * i);
    }
    return;
  }
  if (cs == kRGB) {
    for (size_t i = 0; i < npix; i++) {
      out[3 * i] = y[i];
      out[3 * i + 1] = cb[i];
      out[3 * i + 2] = cr[i];
    }
    return;
  }
  if (fault & kFloatYcc) {
    for (size_t i = 0; i < npix; i++) {
      double Y = y[i], B = cb[i] - 128.0, R = cr[i] - 128.0;
      double rgb[3] = {Y + 1.402 * R, Y - 0.344136 * B - 0.714136 * R, Y + 1.772 * B};
      for (int k = 0; k < 3; k++)
        out[3 * i + k] = (uint8_t)std::min(255L, std::max(0L, std::lround(rgb[k])));
    }
    return;
  }
  for (size_t i = 0; i < npix; i++) {
    int Y = y[i], B = cb[i], R = cr[i];
    out[3 * i] = rl[Y + kYcc.cr_r[R]];
    out[3 * i + 1] = rl[Y + (int)((kYcc.cb_g[B] + kYcc.cr_g[R]) >> 16)];
    out[3 * i + 2] = rl[Y + kYcc.cb_b[B]];
  }
}

// A strip or tile of a TIFF file's JPEG data (compression 7) after its
// JPEGTables (``tn`` 0: none), decoded as libtiff asks libjpeg to: YCbCr
// converted to RGB when ``to_rgb`` (JPEGCOLORMODE_RGB), else the components
// as stored (JCS_UNKNOWN), interleaved: height x width x ncomp bytes.
void decode_jpeg_tiff(const uint8_t* tables, size_t tn, const uint8_t* data, size_t n,
                      bool to_rgb, uint8_t* out, int fault) {
  Decoder dec(data, n);
  dec.fault = fault;
  dec.tiff = true;
  if (tn) dec.load_tables(tables, tn);
  dec.run();
  const int nc = dec.ncomp;
  const size_t npix = (size_t)dec.width * dec.height;
  std::vector<std::vector<uint8_t>> full = full_planes(dec, fault);
  if (to_rgb) {
    if (nc != 3) fail("JPEG YCbCr data without three components");
    if (dec.lossless) fail("lossless JPEG in YCbCr (libjpeg converts no colours of a lossless file)");
    const uint8_t* rl = kRange.simple + 256;
    for (size_t i = 0; i < npix; i++) {
      int Y = full[0][i], B = full[1][i], R = full[2][i];
      out[3 * i] = rl[Y + kYcc.cr_r[R]];
      out[3 * i + 1] = rl[Y + (int)((kYcc.cb_g[B] + kYcc.cr_g[R]) >> 16)];
      out[3 * i + 2] = rl[Y + kYcc.cb_b[B]];
    }
    return;
  }
  for (size_t i = 0; i < npix; i++)
    for (int ci = 0; ci < nc; ci++) out[i * nc + ci] = full[ci][i];
}

// ---------------------------------------------------------------- encoder

const uint8_t kStdLumQ[64] = {16, 11, 10, 16, 24,  40,  51,  61,  12, 12, 14, 19, 26,
                              58, 60, 55, 14, 13,  16,  24,  40,  57, 69, 56, 14, 17,
                              22, 29, 51, 87, 80,  62,  18,  22,  37, 56, 68, 109, 103,
                              77, 24, 35, 55, 64,  81,  104, 113, 92, 49, 64, 78,  87,
                              103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99};
const uint8_t kStdChromQ[64] = {17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99,
                                99, 99, 99, 24, 26, 56, 99, 99, 99, 99, 99, 47, 66,
                                99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99,
                                99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99,
                                99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99, 99};

struct HuffEnc {
  uint32_t code[256];
  uint8_t size[256];
};

void fill_enc(HuffEnc* e, const uint8_t* bits, const uint8_t* vals) {
  int huffsize[257], huffcode[257], p = 0;
  for (int l = 1; l <= 16; l++)
    for (int i = 0; i < bits[l]; i++) huffsize[p++] = l;
  huffsize[p] = 0;
  int last = p, code = 0, si = huffsize[0];
  p = 0;
  while (huffsize[p]) {
    while (huffsize[p] == si) huffcode[p++] = code++;
    code <<= 1;
    si++;
  }
  std::memset(e->size, 0, sizeof e->size);
  for (p = 0; p < last; p++) {
    e->code[vals[p]] = (uint32_t)huffcode[p];
    e->size[vals[p]] = (uint8_t)huffsize[p];
  }
}

struct BitWriter {
  std::vector<uint8_t>& out;
  uint64_t acc = 0;
  int nbits = 0;
  explicit BitWriter(std::vector<uint8_t>& o) : out(o) {}
  inline void put(uint32_t bits, int n) {
    if (n == 0) return;
    acc = (acc << n) | (bits & ((1u << n) - 1));
    nbits += n;
    while (nbits >= 8) {
      uint8_t b = (uint8_t)(acc >> (nbits - 8));
      out.push_back(b);
      if (b == 0xFF) out.push_back(0);
      nbits -= 8;
    }
    acc &= nbits ? ((uint64_t(1) << nbits) - 1) : 0;
  }
  void flush() {
    if (nbits) put(0x7F, 7);
    nbits = 0;
    acc = 0;
  }
};

// jcdctmgr.c's compute_reciprocal for a 16-bit DCTELEM.
struct Divisor {
  uint32_t recip, corr;
  int shift;
};

Divisor reciprocal(uint32_t divisor) {  // divisor = 8 * quantval >= 8
  Divisor dv;
  int b = 0;
  while ((1u << (b + 1)) <= divisor) b++;  // flss(divisor) - 1
  int r = 16 + b;
  uint32_t fq = (uint32_t)((1ull << r) / divisor);
  uint32_t fr = (uint32_t)((1ull << r) % divisor);
  uint32_t c = divisor / 2;
  if (fr == 0) {
    fq >>= 1;
    r--;
  } else if (fr <= divisor / 2u) {
    c++;
  } else {
    fq++;
  }
  dv.recip = fq & 0xFFFF;
  dv.corr = c & 0xFFFF;
  dv.shift = r;  // the product is shifted right by r in all
  return dv;
}

void fdct_islow(int32_t* data) {
  int32_t* p = data;
  for (int r = 0; r < 8; r++, p += 8) {
    int32_t tmp0 = p[0] + p[7], tmp7 = p[0] - p[7];
    int32_t tmp1 = p[1] + p[6], tmp6 = p[1] - p[6];
    int32_t tmp2 = p[2] + p[5], tmp5 = p[2] - p[5];
    int32_t tmp3 = p[3] + p[4], tmp4 = p[3] - p[4];
    int32_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3, tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    p[0] = (int16_t)((tmp10 + tmp11) * (1 << PASS1_BITS));
    p[4] = (int16_t)((tmp10 - tmp11) * (1 << PASS1_BITS));
    int32_t z1 = (tmp12 + tmp13) * FIX_0_541196100;
    p[2] = (int16_t)descale(z1 + tmp13 * FIX_0_765366865, CONST_BITS - PASS1_BITS);
    p[6] = (int16_t)descale(z1 + tmp12 * -FIX_1_847759065, CONST_BITS - PASS1_BITS);
    z1 = tmp4 + tmp7;
    int32_t z2 = tmp5 + tmp6, z3 = tmp4 + tmp6, z4 = tmp5 + tmp7;
    int32_t z5 = (z3 + z4) * FIX_1_175875602;
    tmp4 *= FIX_0_298631336;
    tmp5 *= FIX_2_053119869;
    tmp6 *= FIX_3_072711026;
    tmp7 *= FIX_1_501321110;
    z1 *= -FIX_0_899976223;
    z2 *= -FIX_2_562915447;
    z3 *= -FIX_1_961570560;
    z4 *= -FIX_0_390180644;
    z3 += z5;
    z4 += z5;
    p[7] = (int16_t)descale(tmp4 + z1 + z3, CONST_BITS - PASS1_BITS);
    p[5] = (int16_t)descale(tmp5 + z2 + z4, CONST_BITS - PASS1_BITS);
    p[3] = (int16_t)descale(tmp6 + z2 + z3, CONST_BITS - PASS1_BITS);
    p[1] = (int16_t)descale(tmp7 + z1 + z4, CONST_BITS - PASS1_BITS);
  }
  p = data;
  for (int c = 0; c < 8; c++, p++) {
    int32_t tmp0 = p[0] + p[56], tmp7 = p[0] - p[56];
    int32_t tmp1 = p[8] + p[48], tmp6 = p[8] - p[48];
    int32_t tmp2 = p[16] + p[40], tmp5 = p[16] - p[40];
    int32_t tmp3 = p[24] + p[32], tmp4 = p[24] - p[32];
    int32_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3, tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    p[0] = (int16_t)descale(tmp10 + tmp11, PASS1_BITS);
    p[32] = (int16_t)descale(tmp10 - tmp11, PASS1_BITS);
    int32_t z1 = (tmp12 + tmp13) * FIX_0_541196100;
    p[16] = (int16_t)descale(z1 + tmp13 * FIX_0_765366865, CONST_BITS + PASS1_BITS);
    p[48] = (int16_t)descale(z1 + tmp12 * -FIX_1_847759065, CONST_BITS + PASS1_BITS);
    z1 = tmp4 + tmp7;
    int32_t z2 = tmp5 + tmp6, z3 = tmp4 + tmp6, z4 = tmp5 + tmp7;
    int32_t z5 = (z3 + z4) * FIX_1_175875602;
    tmp4 *= FIX_0_298631336;
    tmp5 *= FIX_2_053119869;
    tmp6 *= FIX_3_072711026;
    tmp7 *= FIX_1_501321110;
    z1 *= -FIX_0_899976223;
    z2 *= -FIX_2_562915447;
    z3 *= -FIX_1_961570560;
    z4 *= -FIX_0_390180644;
    z3 += z5;
    z4 += z5;
    p[56] = (int16_t)descale(tmp4 + z1 + z3, CONST_BITS + PASS1_BITS);
    p[40] = (int16_t)descale(tmp5 + z2 + z4, CONST_BITS + PASS1_BITS);
    p[24] = (int16_t)descale(tmp6 + z2 + z3, CONST_BITS + PASS1_BITS);
    p[8] = (int16_t)descale(tmp7 + z1 + z4, CONST_BITS + PASS1_BITS);
  }
}

// rgb_ycc_convert's tables (jccolor.c): R->Y, G->Y, B->Y, R->Cb, G->Cb,
// B->Cb (= R->Cr), G->Cr, B->Cr.
struct RgbYccTables {
  int32_t tab[8][256];
  RgbYccTables() {
    const int32_t ONE_HALF = 1 << 15, CBCR_OFFSET = 128 << 16;
    auto FIX = [](double x) { return (int32_t)(x * 65536 + 0.5); };
    for (int i = 0; i < 256; i++) {
      tab[0][i] = FIX(0.29900) * i;
      tab[1][i] = FIX(0.58700) * i;
      tab[2][i] = FIX(0.11400) * i + ONE_HALF;
      tab[3][i] = -FIX(0.16874) * i;
      tab[4][i] = -FIX(0.33126) * i;
      tab[5][i] = FIX(0.50000) * i + CBCR_OFFSET + ONE_HALF - 1;
      tab[6][i] = -FIX(0.41869) * i;
      tab[7][i] = -FIX(0.08131) * i;
    }
  }
};
const RgbYccTables kRgbYcc;

struct EncComponent {
  int id, h, v, tq, tbl;
  int wib, hib;                 // real blocks
  int pw, ph;                   // plane size (samples, padded)
  std::vector<uint8_t> plane;
  Divisor div[64];
  int last_dc = 0;
};

void quantize_block(const EncComponent& c, const uint8_t* src, int stride, int16_t* out) {
  int32_t ws[64];
  for (int y = 0; y < 8; y++)
    for (int x = 0; x < 8; x++) ws[y * 8 + x] = (int32_t)src[(size_t)y * stride + x] - 128;
  fdct_islow(ws);
  for (int i = 0; i < 64; i++) {
    int32_t t = (int16_t)ws[i];
    const Divisor& dv = c.div[i];
    bool neg = t < 0;
    // |t| + corr < 2^16 and recip <= 2^16: the product fits 32 bits, as
    // in libjpeg's UDCTELEM2 arithmetic
    uint32_t a = (uint32_t)(neg ? -t : t);
    int32_t v = (int16_t)(((a + dv.corr) * dv.recip) >> dv.shift);
    out[i] = (int16_t)(neg ? -v : v);
  }
}

void encode_block(BitWriter& bw, const int16_t* blk, int* last_dc, const HuffEnc& dc,
                  const HuffEnc& ac) {
  int temp = blk[0] - *last_dc, temp2 = temp;
  *last_dc = blk[0];
  if (temp < 0) {
    temp = -temp;
    temp2--;
  }
  int nbits = 0;
  while (temp) {
    nbits++;
    temp >>= 1;
  }
  if (nbits > 11) fail("JPEG encoder: DC coefficient out of range");
  bw.put(dc.code[nbits], dc.size[nbits]);
  if (nbits) bw.put((uint32_t)temp2, nbits);
  int r = 0;
  for (int k = 1; k < 64; k++) {
    temp = blk[kNatural[k]];
    if (temp == 0) {
      r++;
      continue;
    }
    while (r > 15) {
      bw.put(ac.code[0xF0], ac.size[0xF0]);
      r -= 16;
    }
    temp2 = temp;
    if (temp < 0) {
      temp = -temp;
      temp2--;
    }
    nbits = 1;
    while ((temp >>= 1)) nbits++;
    if (nbits > 10) fail("JPEG encoder: AC coefficient out of range");
    int i = (r << 4) + nbits;
    bw.put(ac.code[i], ac.size[i]);
    bw.put((uint32_t)temp2, nbits);
    r = 0;
  }
  if (r > 0) bw.put(ac.code[0], ac.size[0]);
}

void put16(std::vector<uint8_t>& o, int v) {
  o.push_back((uint8_t)(v >> 8));
  o.push_back((uint8_t)(v & 0xFF));
}

void emit_dht(std::vector<uint8_t>& o, int index, const uint8_t* bits, const uint8_t* vals) {
  int count = 0;
  for (int i = 1; i <= 16; i++) count += bits[i];
  o.push_back(0xFF);
  o.push_back(0xC4);
  put16(o, count + 2 + 1 + 16);
  o.push_back((uint8_t)index);
  for (int i = 1; i <= 16; i++) o.push_back(bits[i]);
  for (int i = 0; i < count; i++) o.push_back(vals[i]);
}

std::vector<uint8_t> encode_jpeg(const uint8_t* px, int W, int H, int ncomp, int quality,
                                 int fault) {
  if (W <= 0 || H <= 0 || W > 65500 || H > 65500) fail("JPEG encoder: bad image size");
  if (ncomp != 1 && ncomp != 3) fail("JPEG encoder takes 1 or 3 channels");
  // jpeg_set_quality(quality, force_baseline=TRUE)
  int q = quality + ((fault & kQualityOffByOne) ? 1 : 0);
  if (q <= 0) q = 1;
  if (q > 100) q = 100;
  int scale = q < 50 ? 5000 / q : 200 - q * 2;
  uint16_t qtab[2][64];
  for (int t = 0; t < 2; t++)
    for (int i = 0; i < 64; i++) {
      long temp = ((long)(t ? kStdChromQ : kStdLumQ)[i] * scale + 50L) / 100L;
      if (temp <= 0L) temp = 1L;
      if (temp > 32767L) temp = 32767L;
      if (temp > 255L) temp = 255L;
      qtab[t][i] = (uint16_t)temp;
    }
  int max_h = ncomp == 3 ? 2 : 1, max_v = max_h;
  std::vector<EncComponent> comps(ncomp);
  for (int ci = 0; ci < ncomp; ci++) {
    auto& c = comps[ci];
    c.id = ci + 1;
    c.h = c.v = ci == 0 ? max_h : 1;
    c.tq = c.tbl = ci == 0 ? 0 : 1;
    for (int i = 0; i < 64; i++) c.div[i] = reciprocal((uint32_t)qtab[c.tq][i] << 3);
  }
  int mcux = (W + 8 * max_h - 1) / (8 * max_h), mcuy = (H + 8 * max_v - 1) / (8 * max_v);
  // Colour conversion (rgb_ycc_convert), full resolution.
  size_t npix = (size_t)W * H;
  std::vector<uint8_t> full[3];
  if (ncomp == 1) {
    full[0].assign(px, px + npix);
  } else {
    const auto& tab = kRgbYcc.tab;
    for (int k = 0; k < 3; k++) full[k].resize(npix);
    for (size_t i = 0; i < npix; i++) {
      int r = px[3 * i], g = px[3 * i + 1], b = px[3 * i + 2];
      full[0][i] = (uint8_t)((tab[0][r] + tab[1][g] + tab[2][b]) >> 16);
      full[1][i] = (uint8_t)((tab[3][r] + tab[4][g] + tab[5][b]) >> 16);
      full[2][i] = (uint8_t)((tab[5][r] + tab[6][g] + tab[7][b]) >> 16);
    }
  }
  // Planes: each component padded to its blocks' width by right-edge
  // replication and to whole MCU rows by replicating its last row.
  for (int ci = 0; ci < ncomp; ci++) {
    auto& c = comps[ci];
    int cw = (int)(((long)W * c.h + max_h - 1) / max_h);
    int ch = (int)(((long)H * c.v + max_v - 1) / max_v);
    c.wib = (cw + 7) / 8;
    c.hib = (ch + 7) / 8;
    c.pw = c.wib * 8;
    c.ph = mcuy * c.v * 8;
    c.plane.assign((size_t)c.pw * c.ph, 0);
    const uint8_t* src = full[ci].data();
    if (c.h == max_h && c.v == max_v) {
      for (int y = 0; y < c.ph; y++) {
        const uint8_t* s = src + (size_t)std::min(y, H - 1) * W;
        uint8_t* d = &c.plane[(size_t)y * c.pw];
        std::memcpy(d, s, W);
        for (int x = W; x < c.pw; x++) d[x] = s[W - 1];
      }
    } else {
      // h2v2_downsample on rows padded to an even count by replication,
      // columns replicated to twice the output width.
      int outw = c.pw;
      std::vector<uint8_t> r0(2 * outw), r1(2 * outw);
      for (int oy = 0; oy < ch; oy++) {
        const uint8_t* s0 = src + (size_t)std::min(2 * oy, H - 1) * W;
        const uint8_t* s1 = src + (size_t)std::min(2 * oy + 1, H - 1) * W;
        std::memcpy(r0.data(), s0, W);
        std::memcpy(r1.data(), s1, W);
        for (int x = W; x < 2 * outw; x++) {
          r0[x] = s0[W - 1];
          r1[x] = s1[W - 1];
        }
        uint8_t* d = &c.plane[(size_t)oy * c.pw];
        int bias = 1;
        for (int x = 0; x < outw; x++) {
          d[x] = (uint8_t)((r0[2 * x] + r0[2 * x + 1] + r1[2 * x] + r1[2 * x + 1] + bias) >> 2);
          bias ^= 3;
        }
      }
      for (int y = ch; y < c.ph; y++)
        std::memcpy(&c.plane[(size_t)y * c.pw], &c.plane[(size_t)(ch - 1) * c.pw], c.pw);
    }
  }
  HuffEnc dc[2], ac[2];
  fill_enc(&dc[0], kBitsDcLum, kValDc);
  fill_enc(&ac[0], kBitsAcLum, kValAcLum);
  fill_enc(&dc[1], kBitsDcChrom, kValDc);
  fill_enc(&ac[1], kBitsAcChrom, kValAcChrom);

  std::vector<uint8_t> o;
  o.reserve(npix / 2 + 1024);
  const uint8_t head[] = {0xFF, 0xD8, 0xFF, 0xE0, 0x00, 0x10, 'J', 'F', 'I', 'F', 0x00,
                          0x01, 0x01, 0x00, 0x00, 0x01, 0x00, 0x01, 0x00, 0x00};
  o.insert(o.end(), head, head + sizeof head);
  for (int t = 0; t < (ncomp == 3 ? 2 : 1); t++) {
    o.push_back(0xFF);
    o.push_back(0xDB);
    put16(o, 67);
    o.push_back((uint8_t)t);
    for (int i = 0; i < 64; i++) o.push_back((uint8_t)qtab[t][kNatural[i]]);
  }
  o.push_back(0xFF);
  o.push_back(0xC0);
  put16(o, 8 + 3 * ncomp);
  o.push_back(8);
  put16(o, H);
  put16(o, W);
  o.push_back((uint8_t)ncomp);
  for (auto& c : comps) {
    o.push_back((uint8_t)c.id);
    o.push_back((uint8_t)((c.h << 4) | c.v));
    o.push_back((uint8_t)c.tq);
  }
  emit_dht(o, 0x00, kBitsDcLum, kValDc);
  emit_dht(o, 0x10, kBitsAcLum, kValAcLum);
  if (ncomp == 3) {
    emit_dht(o, 0x01, kBitsDcChrom, kValDc);
    emit_dht(o, 0x11, kBitsAcChrom, kValAcChrom);
  }
  o.push_back(0xFF);
  o.push_back(0xDA);
  put16(o, 6 + 2 * ncomp);
  o.push_back((uint8_t)ncomp);
  for (auto& c : comps) {
    o.push_back((uint8_t)c.id);
    o.push_back((uint8_t)((c.tbl << 4) | c.tbl));
  }
  o.push_back(0);
  o.push_back(63);
  o.push_back(0);

  BitWriter bw(o);
  int16_t blocks[4][64];
  if (ncomp == 1) {
    auto& c = comps[0];
    for (int by = 0; by < c.hib; by++)
      for (int bx = 0; bx < c.wib; bx++) {
        quantize_block(c, &c.plane[(size_t)by * 8 * c.pw + bx * 8], c.pw, blocks[0]);
        encode_block(bw, blocks[0], &c.last_dc, dc[0], ac[0]);
      }
  } else {
    for (int my = 0; my < mcuy; my++)
      for (int mx = 0; mx < mcux; mx++)
        for (auto& c : comps) {
          int n = 0;
          for (int yy = 0; yy < c.v; yy++) {
            int by = my * c.v + yy;
            for (int xx = 0; xx < c.h; xx++, n++) {
              int bx = mx * c.h + xx;
              if (by < c.hib && bx < c.wib) {
                quantize_block(c, &c.plane[(size_t)by * 8 * c.pw + bx * 8], c.pw, blocks[n]);
              } else {
                // A dummy block: AC zero, DC that of the previous block
                // (the left one, or at the bottom the last of the row above).
                std::memset(blocks[n], 0, sizeof blocks[n]);
                blocks[n][0] = by < c.hib ? blocks[n - 1][0] : blocks[yy * c.h - 1][0];
              }
            }
          }
          for (int k = 0; k < n; k++) encode_block(bw, blocks[k], &c.last_dc, dc[c.tbl], ac[c.tbl]);
        }
  }
  bw.flush();
  o.push_back(0xFF);
  o.push_back(0xD9);
  return o;
}

// ---------------------------------------------------------------- PNG rows

inline int paeth(int a, int b, int c, bool wrong) {
  int p = a + b - c;
  int pa = std::abs(p - a), pb = std::abs(p - b), pc = std::abs(p - c);
  if (wrong) {  // ties to the later predictor: c before b before a
    if (pa < pb && pa < pc) return a;
    return pb < pc ? b : c;
  }
  if (pa <= pb && pa <= pc) return a;
  return pb <= pc ? b : c;
}

void png_unfilter(const uint8_t* in, long rows, long rowbytes, int bpp, int fault, uint8_t* out) {
  bool wrong = fault & kPaethTies;
  std::vector<uint8_t> zero(rowbytes, 0);
  for (long y = 0; y < rows; y++) {
    const uint8_t* src = in + y * (rowbytes + 1);
    int type = src[0];
    src++;
    uint8_t* cur = out + y * rowbytes;
    const uint8_t* prev = y ? out + (y - 1) * rowbytes : zero.data();
    switch (type) {
      case 0: std::memcpy(cur, src, rowbytes); break;
      case 1:
        for (long i = 0; i < rowbytes; i++) cur[i] = (uint8_t)(src[i] + (i >= bpp ? cur[i - bpp] : 0));
        break;
      case 2:
        for (long i = 0; i < rowbytes; i++) cur[i] = (uint8_t)(src[i] + prev[i]);
        break;
      case 3:
        for (long i = 0; i < rowbytes; i++)
          cur[i] = (uint8_t)(src[i] + (((i >= bpp ? cur[i - bpp] : 0) + prev[i]) >> 1));
        break;
      case 4:
        for (long i = 0; i < rowbytes; i++) {
          int a = i >= bpp ? cur[i - bpp] : 0, b = prev[i], c = i >= bpp ? prev[i - bpp] : 0;
          cur[i] = (uint8_t)(src[i] + paeth(a, b, c, wrong));
        }
        break;
      default: {
        char buf[64];
        std::snprintf(buf, sizeof buf, "PNG row has unknown filter type %d", type);
        fail(buf);
      }
    }
  }
}

// Adaptive filtering: each row takes the filter whose output has the
// smallest sum of absolute values (as signed bytes).
void png_filter(const uint8_t* px, long rows, long rowbytes, int bpp, uint8_t* out) {
  std::vector<uint8_t> zero(rowbytes, 0), cand(5 * rowbytes);
  for (long y = 0; y < rows; y++) {
    const uint8_t* cur = px + y * rowbytes;
    const uint8_t* prev = y ? px + (y - 1) * rowbytes : zero.data();
    long best = -1, best_sum = 0;
    for (int f = 0; f < 5; f++) {
      uint8_t* c = &cand[f * rowbytes];
      long sum = 0;
      for (long i = 0; i < rowbytes; i++) {
        int a = i >= bpp ? cur[i - bpp] : 0, b = prev[i], cc = i >= bpp ? prev[i - bpp] : 0;
        int pred = f == 0 ? 0 : f == 1 ? a : f == 2 ? b : f == 3 ? (a + b) >> 1 : paeth(a, b, cc, false);
        uint8_t v = (uint8_t)(cur[i] - pred);
        c[i] = v;
        sum += v < 128 ? v : 256 - v;
      }
      if (best < 0 || sum < best_sum) {
        best = f;
        best_sum = sum;
      }
    }
    uint8_t* o = out + y * (rowbytes + 1);
    o[0] = (uint8_t)best;
    std::memcpy(o + 1, &cand[best * rowbytes], rowbytes);
  }
}

// ---------------------------------------------------------------- GIF LZW

// Expand one frame's LZW codes (the data sub-blocks joined) into at most
// ``npix`` palette indices; returns the count written. Codes are read LSB
// first; a clear code resets the table, the end code or the end of the data
// stops, the code size grows when the next free code reaches 1 << size (up
// to 12 bits, after which the table stays full until a clear).
long gif_lzw(const uint8_t* in, long n, int min_bits, uint8_t* out, long npix, int fault) {
  if (min_bits < 1 || min_bits > 11) fail("GIF image data with a bad LZW code size");
  const int clear = 1 << min_bits, end = clear + 1;
  const int late = (fault & kGifLateGrowth) ? 1 : 0;
  std::vector<uint16_t> prefix(4096);
  std::vector<uint8_t> suffix(4096), first(4096), stack(4097);
  for (int c = 0; c < clear; c++) {
    suffix[c] = first[c] = (uint8_t)c;
  }
  int bits = min_bits + 1, next = clear + 2, prev = -1;
  long pos = 0, written = 0;
  uint32_t acc = 0;
  int nacc = 0;
  while (written < npix) {
    while (nacc < bits && pos < n) {
      acc |= (uint32_t)in[pos++] << nacc;
      nacc += 8;
    }
    if (nacc < bits) break;  // the data ends without an end code
    int code = (int)(acc & ((1u << bits) - 1));
    acc >>= bits;
    nacc -= bits;
    if (code == clear) {
      bits = min_bits + 1;
      next = clear + 2;
      prev = -1;
      continue;
    }
    if (code == end) break;
    int top = 0, c = code;
    if (prev < 0) {
      if (code >= clear) fail("broken GIF image data (bad first LZW code)");
    } else if (code > next || (code == next && next >= 4096)) {
      fail("broken GIF image data (LZW code past the table)");
    } else if (code == next) {  // KwKwK: the previous string and its first
      stack[top++] = first[prev];
      c = prev;
    }
    for (; c >= clear; c = prefix[c]) stack[top++] = suffix[c];
    stack[top++] = (uint8_t)c;
    if (prev >= 0 && next < 4096) {
      prefix[next] = (uint16_t)prev;
      suffix[next] = (uint8_t)c;
      first[next] = first[prev];
      next++;
      if (next == (1 << bits) + late && bits < 12) bits++;
    }
    while (top && written < npix) out[written++] = stack[--top];
    prev = code;
  }
  return written;
}

// ---------------------------------------------------------------- BMP RLE

// Pillow's BmpRleDecoder (BmpImagePlugin.py) over ``in`` from ``start``:
// the row-major indices it gathers (``xsize`` a row, zeros for end-of-line
// and delta skips), stopping once ``xsize * ysize`` are there or the data
// ends; returns the count (up to ``cap``, which holds one step past the
// image). Its quirks are kept: a delta reads two bytes and then its two
// offsets; an RLE4 absolute run reads count / 2 bytes; runs align to an
// even offset of the file.
long bmp_rle(const uint8_t* in, long n, long start, int rle4, long xsize, long ysize, uint8_t* out,
             long cap) {
  const long dest = xsize * ysize;
  long pos = start, len = 0, x = 0;
  auto put = [&](uint8_t v, long count) {
    if (len + count > cap) fail("BMP RLE data past the image");
    std::memset(out + len, v, (size_t)count);
    len += count;
  };
  while (len < dest) {
    if (pos + 2 > n) break;
    int count = in[pos], byte = in[pos + 1];
    pos += 2;
    if (count) {  // encoded run
      if (x + count > xsize) count = (int)std::max(0L, xsize - x);
      if (rle4) {
        for (int i = 0; i < count; i++) put((uint8_t)(i % 2 ? byte & 15 : byte >> 4), 1);
      } else {
        put((uint8_t)byte, count);
      }
      x += count;
    } else if (byte == 0) {  // end of line
      if (len % xsize) put(0, xsize - len % xsize);
      x = 0;
    } else if (byte == 1) {  // end of bitmap
      break;
    } else if (byte == 2) {  // delta
      if (pos + 2 > n) break;
      pos += 2;
      if (pos + 2 > n) fail("truncated BMP file (data ends inside an RLE delta)");
      int right = in[pos], up = in[pos + 1];
      pos += 2;
      put(0, right + (long)up * xsize);
      x = len % xsize;
    } else {  // absolute run
      long want = rle4 ? byte / 2 : byte, got = std::min(want, n - pos);
      for (long i = 0; i < got; i++) {
        if (rle4) {
          put((uint8_t)(in[pos + i] >> 4), 1);
          put((uint8_t)(in[pos + i] & 15), 1);
        } else {
          put(in[pos + i], 1);
        }
      }
      pos += got;
      if (got < want) break;
      x += byte;
      if (pos % 2) pos++;
    }
  }
  return len;
}

int report(const std::exception& e, char* err, int errlen) {
  if (err && errlen > 0) {
    std::snprintf(err, (size_t)errlen, "%s", e.what());
  }
  return -1;
}

}  // namespace

extern "C" {

// Decode into ``out``: height x width bytes (one component, gray) or
// height x width x 3 (RGB; a CMYK or YCCK file converted as Pillow does).
int cpt_jpeg_decode(const uint8_t* data, long n, int width, int height, int ncomp, uint8_t* out,
                    int fault, char* err, int errlen) {
  try {
    decode_jpeg(data, (size_t)n, width, height, ncomp, out, fault);
    return 0;
  } catch (const std::exception& e) {
    return report(e, err, errlen);
  }
}

// Pillow's cmyk2rgb over ``n`` CMYK pixels (a TIFF's) into RGB.
long cpt_cmyk_to_rgb(const uint8_t* cmyk, long n, uint8_t* out) {
  for (long i = 0; i < n; i++) {
    int px[4] = {cmyk[4 * i], cmyk[4 * i + 1], cmyk[4 * i + 2], cmyk[4 * i + 3]};
    cmyk2rgb(px, out + 3 * i);
  }
  return n;
}

// Frame of a TIFF strip's or tile's JPEG data after its JPEGTables:
// ``info`` = width, height, component count, then each component's
// horizontal and vertical sampling factors.
int cpt_jpeg_frame_tiff(const uint8_t* tables, long tn, const uint8_t* data, long n, int* info,
                        char* err, int errlen) {
  try {
    Decoder dec(data, (size_t)n);
    dec.tiff = true;
    if (tn) dec.load_tables(tables, (size_t)tn);
    bool has_frame;
    dec.read_header_only(&has_frame);
    if (!has_frame) fail("JPEG data has no frame header");
    info[0] = dec.width;
    info[1] = dec.height;
    info[2] = dec.ncomp;
    for (int ci = 0; ci < dec.ncomp; ci++) {
      info[3 + 2 * ci] = dec.comps[ci].h;
      info[4 + 2 * ci] = dec.comps[ci].v;
    }
    return 0;
  } catch (const std::exception& e) {
    return report(e, err, errlen);
  }
}

// Decode a TIFF strip's or tile's JPEG data (decode_jpeg_tiff) into
// ``out``.
int cpt_jpeg_decode_tiff(const uint8_t* tables, long tn, const uint8_t* data, long n,
                         int to_rgb, uint8_t* out, int fault, char* err, int errlen) {
  try {
    decode_jpeg_tiff(tables, (size_t)tn, data, (size_t)n, to_rgb != 0, out, fault);
    return 0;
  } catch (const std::exception& e) {
    return report(e, err, errlen);
  }
}

// Encode height x width x ncomp bytes (1: gray, 3: RGB). Returns the byte
// count, written to ``out`` when it is at most ``cap`` (call again with a
// larger buffer otherwise), or -1.
long cpt_jpeg_encode(const uint8_t* px, int width, int height, int ncomp, int quality,
                     int fault, uint8_t* out, long cap, char* err, int errlen) {
  try {
    std::vector<uint8_t> o = encode_jpeg(px, width, height, ncomp, quality, fault);
    if ((long)o.size() <= cap) std::memcpy(out, o.data(), o.size());
    return (long)o.size();
  } catch (const std::exception& e) {
    return report(e, err, errlen);
  }
}

// Undo PNG row filters: ``in`` holds rows x (1 + rowbytes) bytes.
int cpt_png_unfilter(const uint8_t* in, long rows, long rowbytes, int bpp, int fault,
                     uint8_t* out, char* err, int errlen) {
  try {
    png_unfilter(in, rows, rowbytes, bpp, fault, out);
    return 0;
  } catch (const std::exception& e) {
    return report(e, err, errlen);
  }
}

// Filter rows x rowbytes pixel bytes into rows x (1 + rowbytes).
int cpt_png_filter(const uint8_t* px, long rows, long rowbytes, int bpp, uint8_t* out,
                   char* err, int errlen) {
  try {
    png_filter(px, rows, rowbytes, bpp, out);
    return 0;
  } catch (const std::exception& e) {
    return report(e, err, errlen);
  }
}

// Expand a GIF frame's LZW data into at most ``npix`` indices: the count
// written, or -1.
long cpt_gif_lzw(const uint8_t* data, long n, int min_bits, uint8_t* out, long npix, int fault,
                 char* err, int errlen) {
  try {
    return gif_lzw(data, n, min_bits, out, npix, fault);
  } catch (const std::exception& e) {
    return report(e, err, errlen);
  }
}

// Expand a BMP's RLE8 / RLE4 data from ``start`` of the file: the count of
// indices written to ``out`` (at most ``cap``), or -1.
long cpt_bmp_rle(const uint8_t* data, long n, long start, int rle4, long xsize, long ysize,
                 uint8_t* out, long cap, char* err, int errlen) {
  try {
    return bmp_rle(data, n, start, rle4, xsize, ysize, out, cap);
  } catch (const std::exception& e) {
    return report(e, err, errlen);
  }
}

}  // extern "C"
