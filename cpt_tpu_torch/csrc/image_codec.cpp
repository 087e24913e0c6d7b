// Host JPEG codec and PNG row filters of the port (no library beyond the
// C++ standard one; built by kernels/build.py with the host C++ compiler and
// bound with ctypes by utils/image_codec.py).
//
// JPEG decode reproduces libjpeg-turbo's default decompression as Pillow
// drives it for Image.open(f).convert("RGB") (mode "L" for one component):
// baseline, extended and progressive Huffman, restart markers, the islow
// IDCT (CONST_BITS 13, PASS1_BITS 2, the range-limit table), fancy
// upsampling (h2v1, h1v2, h2v2; replication for other factors and for
// components no wider than 2 samples), ycc_rgb_convert with libjpeg's fixed
// point tables, colour space by libjpeg's default rule (JFIF, Adobe
// transform, component ids). A 4-component file is CMYK, or YCCK under
// Adobe transform 2 (ycck_cmyk_convert on the same tables); its samples are
// then inverted, as Pillow unpacks every CMYK JPEG ("CMYK;I", Adobe's
// polarity), and turned into RGB by Pillow's cmyk2rgb. Arithmetic coding,
// lossless and 12-bit frames, and progressive files whose scans leave
// coefficients unrefined (libjpeg smooths those blocks) raise; so does data
// that ends before its terminating marker.
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

void derive(const HuffSpec& s, bool dc, HuffDerived* d) {
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
      if (s.vals[i] > 15) fail("bogus Huffman table definition");
}

// Entropy-coded data reader with libjpeg's conventions: FF00 is a data FF;
// any other marker stops the data and reads as zero bits (the decoder then
// leaves the rest of the restart interval at zero); the end of the input
// before a marker is a truncated file.
struct BitReader {
  const uint8_t* d;
  size_t n;
  size_t pos;
  uint64_t acc = 0;
  int nbits = 0;
  int marker = 0;
  bool insufficient = false;

  void fill() {
    while (nbits < 57) {
      if (marker) {
        return;
      }
      if (pos >= n) fail("truncated JPEG file (data ends inside a scan)");
      int c = d[pos++];
      if (c == 0xFF) {
        int c2;
        do {
          if (pos >= n) fail("truncated JPEG file (data ends inside a scan)");
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
    need(k);
    uint32_t v = peek(k);
    drop(k);
    return (int)v;
  }
  inline int decode(const HuffDerived& t) {
    if (nbits < 8) {
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
  int decode_slow(const HuffDerived& t, int l) {
    for (; l <= 16; l++) {
      need(l);
      int32_t code = (int32_t)peek(l);
      if (code <= t.maxcode[l]) {
        drop(l);
        return t.vals[(code + t.valoffset[l]) & 0xFF];
      }
    }
    need(17);
    drop(17);
    return 0;  // libjpeg's answer to a code it cannot find
  }
};

inline int extend(int r, int s) {
  return r < (1 << (s - 1)) ? r + (int)((unsigned)-1 << s) + 1 : r;
}

struct Component {
  int id = 0, h = 1, v = 1, tq = 0;
  int dc_tbl = 0, ac_tbl = 0;
  int dw = 0, dh = 0;    // downsampled size (real samples)
  int wib = 0, hib = 0;  // width / height in blocks (real)
  int bw = 0, bh = 0;    // blocks allocated (rounded up to the MCU)
  bool latched = false;
  int16_t q[64];         // latched quantisation table (natural order)
  std::vector<int16_t> coef;
  int coef_bits[64];
  int pred = 0;
  int16_t* block(int by, int bx) { return &coef[((size_t)by * bw + bx) * 64]; }
};

struct Decoder {
  Decoder(const uint8_t* data, size_t size) : d(data), n(size) {}
  const uint8_t* d;
  size_t n;
  size_t pos = 0;
  int fault = 0;

  uint16_t qt[4][64];
  bool qt_defined[4] = {false, false, false, false};
  HuffSpec dc_spec[4], ac_spec[4];
  int restart_interval = 0;
  bool jfif = false, adobe = false;
  int adobe_transform = 0;

  bool frame = false, progressive = false;
  int width = 0, height = 0, ncomp = 0;
  int max_h = 1, max_v = 1, mcux = 0, mcuy = 0;
  std::vector<Component> comps;
  int scans = 0;
  int unread_marker = 0;  // the marker that ended a scan's data

  int u8() {
    if (pos >= n) fail("truncated JPEG file (data ends inside a marker)");
    return d[pos++];
  }
  int u16() {
    int a = u8();
    return (a << 8) | u8();
  }

  // libjpeg's next_marker: skip garbage, then any FF fill bytes.
  int next_marker() {
    if (unread_marker) {
      int m = unread_marker;
      unread_marker = 0;
      return m;
    }
    for (;;) {
      int c = u8();
      while (c != 0xFF) c = u8();
      do {
        c = u8();
      } while (c == 0xFF);
      if (c != 0) return c;
    }
  }

  void read_header_only(bool* has_frame) {
    if (n < 2 || d[0] != 0xFF || d[1] != 0xD8) fail("not a JPEG file");
    pos = 2;
    for (;;) {
      int m = next_marker();
      if (handle_marker(m, /*stop_at_sof=*/true)) break;
    }
    *has_frame = frame;
  }

  // Returns true to stop (SOF in header-only mode, or EOI).
  bool handle_marker(int m, bool stop_at_sof) {
    switch (m) {
      case 0xC0: case 0xC1: case 0xC2:
        read_sof(m);
        return stop_at_sof;
      case 0xC3: fail("lossless JPEG (SOF3) is not supported");
      case 0xC5: case 0xC6: case 0xC7:
        fail("hierarchical JPEG is not supported");
      case 0xC9: case 0xCA: case 0xCB: case 0xCD: case 0xCE: case 0xCF:
        fail("arithmetic-coded JPEG is not supported");
      case 0xC4: read_dht(); return false;
      case 0xCC: skip_segment(); return false;  // DAC
      case 0xDB: read_dqt(); return false;
      case 0xDD: read_dri(); return false;
      case 0xDA:
        if (stop_at_sof) fail("JPEG scan before a frame header");
        read_sos_and_scan();
        return false;
      case 0xD9:
        return true;
      case 0xD8: fail("JPEG file has a second SOI marker");
      case 0xDC: skip_segment(); return false;  // DNL
      case 0xFE: skip_segment(); return false;  // COM
      default:
        if (m >= 0xE0 && m <= 0xEF) {
          read_app(m);
          return false;
        }
        if ((m >= 0xD0 && m <= 0xD7) || m == 0x01) return false;  // RSTn, TEM
        {
          char buf[64];
          std::snprintf(buf, sizeof buf, "unsupported JPEG marker 0x%02X", m);
          fail(buf);
        }
    }
  }

  void skip_segment() {
    int len = u16();
    if (len < 2) fail("bogus JPEG marker length");
    if (pos + (size_t)(len - 2) > n) fail("truncated JPEG file (data ends inside a marker)");
    pos += len - 2;
  }

  void read_app(int m) {
    int len = u16();
    if (len < 2) fail("bogus JPEG marker length");
    size_t start = pos, datalen = (size_t)(len - 2);
    if (start + datalen > n) fail("truncated JPEG file (data ends inside a marker)");
    const uint8_t* p = d + start;
    if (m == 0xE0 && datalen >= 14 && p[0] == 'J' && p[1] == 'F' && p[2] == 'I' &&
        p[3] == 'F' && p[4] == 0)
      jfif = true;
    if (m == 0xEE && datalen >= 12 && p[0] == 'A' && p[1] == 'd' && p[2] == 'o' &&
        p[3] == 'b' && p[4] == 'e') {
      adobe = true;
      adobe_transform = p[11];
    }
    pos = start + datalen;
  }

  void read_dqt() {
    long len = u16() - 2;
    while (len > 0) {
      int pq = u8();
      int tq = pq & 15, prec = pq >> 4;
      if (tq > 3) fail("bogus JPEG quantisation table index");
      if (prec > 1) fail("bogus JPEG quantisation table precision");
      int cnt = 64;
      if (len < 1 + 64 * (prec + 1)) cnt = (int)((len - 1) / (prec + 1));
      uint16_t tmp[64];
      for (int i = 0; i < 64; i++) tmp[i] = 1;
      for (int i = 0; i < cnt; i++) tmp[kNatural[i]] = (uint16_t)(prec ? u16() : u8());
      std::memcpy(qt[tq], tmp, sizeof tmp);
      qt_defined[tq] = true;
      len -= 1 + (long)cnt * (prec + 1);
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
      HuffSpec* spec;
      if (index & 0x10) {
        index -= 0x10;
        if (index < 0 || index > 3) fail("bogus Huffman table index");
        spec = &ac_spec[index];
      } else {
        if (index < 0 || index > 3) fail("bogus Huffman table index");
        spec = &dc_spec[index];
      }
      std::memcpy(spec->bits, bits, 17);
      std::memset(spec->vals, 0, 256);
      for (int i = 0; i < count; i++) spec->vals[i] = (uint8_t)u8();
      spec->defined = true;
      len -= count;
    }
    if (len != 0) fail("bogus JPEG DHT length");
  }

  void read_dri() {
    if (u16() != 4) fail("bogus JPEG DRI length");
    restart_interval = u16();
  }

  void read_sof(int m) {
    if (frame) fail("JPEG file has two frame headers");
    int len = u16();
    int prec = u8();
    height = u16();
    width = u16();
    ncomp = u8();
    if (prec != 8) {
      char buf[80];
      std::snprintf(buf, sizeof buf, "%d-bit JPEG is not supported", prec);
      fail(buf);
    }
    if (len != 8 + 3 * ncomp) fail("bogus JPEG SOF length");
    if (width <= 0 || height <= 0) fail("JPEG frame has an empty image");
    if ((long long)width * height > kMaxPixels) {
      char buf[120];
      std::snprintf(buf, sizeof buf, "image size (%lld pixels) exceeds limit of "
                    "%lld pixels, could be decompression bomb DOS attack",
                    (long long)width * height, kMaxPixels);
      fail(buf);
    }
    if (ncomp != 1 && ncomp != 3 && ncomp != 4) {
      char buf[80];
      std::snprintf(buf, sizeof buf, "%d-component JPEG is not supported", ncomp);
      fail(buf);
    }
    comps.resize(ncomp);
    max_h = max_v = 1;
    for (auto& c : comps) {
      c.id = u8();
      int hv = u8();
      c.h = hv >> 4;
      c.v = hv & 15;
      c.tq = u8();
      if (c.h < 1 || c.h > 4 || c.v < 1 || c.v > 4) fail("bogus JPEG sampling factors");
      if (c.tq > 3) fail("bogus JPEG quantisation table index");
      max_h = std::max(max_h, c.h);
      max_v = std::max(max_v, c.v);
    }
    progressive = (m == 0xC2);
    frame = true;
  }

  void allocate() {
    mcux = (width + 8 * max_h - 1) / (8 * max_h);
    mcuy = (height + 8 * max_v - 1) / (8 * max_v);
    for (auto& c : comps) {
      c.dw = (int)(((long)width * c.h + max_h - 1) / max_h);
      c.dh = (int)(((long)height * c.v + max_v - 1) / max_v);
      c.wib = (int)(((long)width * c.h + 8L * max_h - 1) / (8L * max_h));
      c.hib = (int)(((long)height * c.v + 8L * max_v - 1) / (8L * max_v));
      c.bw = mcux * c.h;
      c.bh = mcuy * c.v;
      c.coef.assign((size_t)c.bw * c.bh * 64, 0);
      for (int k = 0; k < 64; k++) c.coef_bits[k] = -1;
    }
  }

  // -- scans
  Component* scan_comp[4];
  int scan_n = 0, Ss = 0, Se = 63, Ah = 0, Al = 0;
  HuffDerived dc_d[4], ac_d[4];
  int eobrun = 0;

  void read_sos_and_scan() {
    if (!frame) fail("JPEG scan before a frame header");
    if (scans == 0) allocate();
    int len = u16();
    int ns = u8();
    if (len != 6 + 2 * ns || ns < 1 || ns > 4) fail("bogus JPEG SOS length");
    scan_n = ns;
    for (int i = 0; i < ns; i++) {
      int cid = u8(), tbl = u8();
      Component* found = nullptr;
      for (auto& c : comps)
        if (c.id == cid) found = &c;
      if (!found) fail("JPEG scan names an unknown component");
      for (int j = 0; j < i; j++)
        if (scan_comp[j] == found) fail("JPEG scan names a component twice");
      found->dc_tbl = tbl >> 4;
      found->ac_tbl = tbl & 15;
      if (found->dc_tbl > 3 || found->ac_tbl > 3) fail("bogus Huffman table index");
      scan_comp[i] = found;
    }
    if (ns > 1) {  // libjpeg's D_MAX_BLOCKS_IN_MCU
      int blocks = 0;
      for (int i = 0; i < ns; i++) blocks += scan_comp[i]->h * scan_comp[i]->v;
      if (blocks > 10) fail("JPEG sampling factors too large for an interleaved scan");
    }
    Ss = u8();
    Se = u8();
    int a = u8();
    Ah = a >> 4;
    Al = a & 15;
    if (progressive) {
      bool bad = false;
      if (Ss == 0) {
        if (Se != 0) bad = true;
      } else {
        if (Se < Ss || Se > 63 || ns != 1) bad = true;
      }
      if (Ah != 0 && Ah - 1 != Al) bad = true;
      if (Al > 13) bad = true;
      if (bad) fail("invalid progressive JPEG scan parameters");
      // Each coefficient's known precision (libjpeg only warns on
      // out-of-order refinements, so neither does this).
      for (int i = 0; i < ns; i++)
        for (int k = Ss; k <= Se; k++) scan_comp[i]->coef_bits[k] = Al;
    }  // a sequential scan's Ss, Se, Ah and Al are ignored, as libjpeg does
    // Latch each component's quantisation table at its first scan.
    for (int i = 0; i < ns; i++) {
      Component* c = scan_comp[i];
      if (!c->latched) {
        if (!qt_defined[c->tq]) fail("JPEG component uses an undefined quantisation table");
        for (int k = 0; k < 64; k++) c->q[k] = (int16_t)qt[c->tq][k];
        c->latched = true;
      }
    }
    for (int i = 0; i < ns; i++) {
      Component* c = scan_comp[i];
      bool need_dc = !progressive || (Ss == 0 && Ah == 0);
      bool need_ac = !progressive || Ss != 0;
      if (need_dc) derive(dc_spec[c->dc_tbl], true, &dc_d[i]);
      if (need_ac) derive(ac_spec[c->ac_tbl], false, &ac_d[i]);
    }
    scans++;
    decode_scan();
  }

  void decode_scan() {
    BitReader br{d, n, pos};
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
    for (long my = 0; my < mcus_y; my++) {
      for (long mx = 0; mx < mcus_x; mx++) {
        if (restart_interval) {
          if (restarts_to_go == 0) {
            process_restart(br, next_restart);
            next_restart = (next_restart + 1) & 7;
            restarts_to_go = restart_interval;
          }
        }
        if (!br.insufficient) {
          if (scan_n == 1) {
            decode_block(br, 0, scan_comp[0]->block((int)my, (int)mx));
          } else {
            for (int i = 0; i < scan_n; i++) {
              Component* c = scan_comp[i];
              for (int yy = 0; yy < c->v; yy++)
                for (int xx = 0; xx < c->h; xx++)
                  decode_block(br, i, c->block((int)my * c->v + yy, (int)mx * c->h + xx));
            }
          }
        }
        if (restart_interval) restarts_to_go--;
      }
    }
    // Hand the marker that ended the data (if any) to the marker reader.
    pos = br.pos;
    unread_marker = br.marker;
  }

  void process_restart(BitReader& br, int expected) {
    br.acc = 0;
    br.nbits = 0;
    int m = br.marker;
    if (!m) {
      // next_marker from the reader's position
      size_t p = br.pos;
      for (;;) {
        if (p >= n) fail("truncated JPEG file (data ends inside a scan)");
        int c = d[p++];
        if (c != 0xFF) continue;
        do {
          if (p >= n) fail("truncated JPEG file (data ends inside a scan)");
          c = d[p++];
        } while (c == 0xFF);
        if (c != 0) {
          m = c;
          break;
        }
      }
      br.pos = p;
    }
    br.marker = 0;
    bool left_marker = false;  // resync left the marker for the next segment
    if (m != 0xD0 + expected) {
      // jpeg_resync_to_restart
      for (;;) {
        int action;
        if (m < 0xC0) action = 2;
        else if (m < 0xD0 || m > 0xD7) action = 3;
        else if (m == 0xD0 + ((expected + 1) & 7) || m == 0xD0 + ((expected + 2) & 7)) action = 3;
        else if (m == 0xD0 + ((expected - 1) & 7) || m == 0xD0 + ((expected - 2) & 7)) action = 2;
        else action = 1;
        if (action == 1) break;
        if (action == 3) {
          br.marker = m;
          left_marker = true;
          break;
        }
        // scan to the next marker
        size_t p = br.pos;
        int c;
        for (;;) {
          if (p >= n) fail("truncated JPEG file (data ends inside a scan)");
          c = d[p++];
          if (c != 0xFF) continue;
          do {
            if (p >= n) fail("truncated JPEG file (data ends inside a scan)");
            c = d[p++];
          } while (c == 0xFF);
          if (c != 0) break;
        }
        br.pos = p;
        m = c;
      }
    }
    for (int i = 0; i < scan_n; i++) scan_comp[i]->pred = 0;
    eobrun = 0;
    if (!left_marker) br.insufficient = false;
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

  void run() {
    bool has_frame;
    read_header_only(&has_frame);
    if (!has_frame) fail("JPEG file has no frame header");
    // Continue with the tables and scans.
    for (;;) {
      int m = next_marker();
      if (m == 0xDA) {
        read_sos_and_scan();
        if (!progressive && scans == 1 && scan_n == ncomp) return;  // single-scan file
        continue;
      }
      if (handle_marker(m, false)) break;
    }
    if (scans == 0) fail("JPEG file has no scan");
  }

  // libjpeg smooths the blocks of a progressive file whose scans leave some
  // of the first ten coefficients unrefined; that path is not reproduced.
  void check_no_smoothing() {
    if (!progressive) return;
    static const int pos[10] = {0, 1, 8, 16, 9, 2, 3, 10, 17, 24};
    bool useful = false;
    for (auto& c : comps) {
      if (!c.latched) return;
      for (int i = 0; i < 10; i++)
        if (c.q[pos[i]] == 0) return;
      if (c.coef_bits[0] < 0) return;
      for (int k = 1; k < 10; k++)
        if (c.coef_bits[k] != 0) useful = true;
    }
    if (useful)
      fail("progressive JPEG whose scans leave coefficients unrefined "
           "(block smoothing) is not supported");
  }
};

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

void idct_islow(const int16_t* in, const int16_t* q, uint8_t* out, int stride) {
  int ws[64];
  for (int c = 0; c < 8; c++) {
    const int16_t* ip = in + c;
    const int16_t* qp = q + c;
    int* wp = ws + c;
    if (!ip[8] && !ip[16] && !ip[24] && !ip[32] && !ip[40] && !ip[48] && !ip[56]) {
      int dc = (ip[0] * qp[0]) * (1 << PASS1_BITS);
      for (int r = 0; r < 8; r++) wp[8 * r] = dc;
      continue;
    }
    int32_t z2 = ip[16] * qp[16], z3 = ip[48] * qp[48];
    int32_t z1 = (z2 + z3) * FIX_0_541196100;
    int32_t tmp2 = z1 + z3 * -FIX_1_847759065;
    int32_t tmp3 = z1 + z2 * FIX_0_765366865;
    z2 = ip[0] * qp[0];
    z3 = ip[32] * qp[32];
    int32_t tmp0 = (z2 + z3) * (1 << CONST_BITS);
    int32_t tmp1 = (z2 - z3) * (1 << CONST_BITS);
    int32_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3, tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = ip[56] * qp[56];
    tmp1 = ip[40] * qp[40];
    tmp2 = ip[24] * qp[24];
    tmp3 = ip[8] * qp[8];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int32_t z4 = tmp1 + tmp3;
    int32_t z5 = (z3 + z4) * FIX_1_175875602;
    tmp0 = tmp0 * FIX_0_298631336;
    tmp1 = tmp1 * FIX_2_053119869;
    tmp2 = tmp2 * FIX_3_072711026;
    tmp3 = tmp3 * FIX_1_501321110;
    z1 = z1 * -FIX_0_899976223;
    z2 = z2 * -FIX_2_562915447;
    z3 = z3 * -FIX_1_961570560;
    z4 = z4 * -FIX_0_390180644;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    const int n = CONST_BITS - PASS1_BITS;
    wp[0] = descale(tmp10 + tmp3, n);
    wp[56] = descale(tmp10 - tmp3, n);
    wp[8] = descale(tmp11 + tmp2, n);
    wp[48] = descale(tmp11 - tmp2, n);
    wp[16] = descale(tmp12 + tmp1, n);
    wp[40] = descale(tmp12 - tmp1, n);
    wp[24] = descale(tmp13 + tmp0, n);
    wp[32] = descale(tmp13 - tmp0, n);
  }
  const uint8_t* rl = kRange.idct;
  for (int r = 0; r < 8; r++) {
    const int* wp = ws + 8 * r;
    uint8_t* op = out + (size_t)r * stride;
    const int n = CONST_BITS + PASS1_BITS + 3;
    if (!wp[1] && !wp[2] && !wp[3] && !wp[4] && !wp[5] && !wp[6] && !wp[7]) {
      uint8_t v = rl[descale(wp[0], PASS1_BITS + 3) & 1023];
      for (int c = 0; c < 8; c++) op[c] = v;
      continue;
    }
    int32_t z2 = wp[2], z3 = wp[6];
    int32_t z1 = (z2 + z3) * FIX_0_541196100;
    int32_t tmp2 = z1 + z3 * -FIX_1_847759065;
    int32_t tmp3 = z1 + z2 * FIX_0_765366865;
    int32_t tmp0 = (wp[0] + wp[4]) * (1 << CONST_BITS);
    int32_t tmp1 = (wp[0] - wp[4]) * (1 << CONST_BITS);
    int32_t tmp10 = tmp0 + tmp3, tmp13 = tmp0 - tmp3, tmp11 = tmp1 + tmp2, tmp12 = tmp1 - tmp2;
    tmp0 = wp[7];
    tmp1 = wp[5];
    tmp2 = wp[3];
    tmp3 = wp[1];
    z1 = tmp0 + tmp3;
    z2 = tmp1 + tmp2;
    z3 = tmp0 + tmp2;
    int32_t z4 = tmp1 + tmp3;
    int32_t z5 = (z3 + z4) * FIX_1_175875602;
    tmp0 = tmp0 * FIX_0_298631336;
    tmp1 = tmp1 * FIX_2_053119869;
    tmp2 = tmp2 * FIX_3_072711026;
    tmp3 = tmp3 * FIX_1_501321110;
    z1 = z1 * -FIX_0_899976223;
    z2 = z2 * -FIX_2_562915447;
    z3 = z3 * -FIX_1_961570560;
    z4 = z4 * -FIX_0_390180644;
    z3 += z5;
    z4 += z5;
    tmp0 += z1 + z3;
    tmp1 += z2 + z4;
    tmp2 += z2 + z3;
    tmp3 += z1 + z4;
    op[0] = rl[descale(tmp10 + tmp3, n) & 1023];
    op[7] = rl[descale(tmp10 - tmp3, n) & 1023];
    op[1] = rl[descale(tmp11 + tmp2, n) & 1023];
    op[6] = rl[descale(tmp11 - tmp2, n) & 1023];
    op[2] = rl[descale(tmp12 + tmp1, n) & 1023];
    op[5] = rl[descale(tmp12 - tmp1, n) & 1023];
    op[3] = rl[descale(tmp13 + tmp0, n) & 1023];
    op[4] = rl[descale(tmp13 - tmp0, n) & 1023];
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

// One component's plane of samples after the IDCT: bw*8 x bh*8.
std::vector<uint8_t> reconstruct(Component& c, int fault) {
  int stride = c.bw * 8;
  std::vector<uint8_t> plane((size_t)stride * c.bh * 8);
  auto idct = (fault & kFloatIdct) ? idct_float : idct_islow;
  for (int by = 0; by < c.hib; by++)
    for (int bx = 0; bx < c.wib; bx++)
      idct(c.block(by, bx), c.q, &plane[(size_t)by * 8 * stride + bx * 8], stride);
  return plane;
}

// Upsample a component to full resolution (width x height), as libjpeg's
// jdsample.c does for do_fancy_upsampling.
std::vector<uint8_t> upsample(const Decoder& dec, const Component& c,
                              const std::vector<uint8_t>& plane, int fault) {
  const int W = dec.width, H = dec.height, stride = c.bw * 8;
  int hx = dec.max_h / c.h, vx = dec.max_v / c.v;
  if (dec.max_h % c.h || dec.max_v % c.v) fail("fractional JPEG sampling ratios are not supported");
  std::vector<uint8_t> out((size_t)W * H);
  if (hx == 1 && vx == 1) {
    for (int y = 0; y < H; y++) std::memcpy(&out[(size_t)y * W], &plane[(size_t)y * stride], W);
    return out;
  }
  bool fancy = !(fault & kReplicateUpsample);
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

ColorSpace color_space(const Decoder& dec) {
  if (dec.ncomp == 1) return kGray;
  if (dec.ncomp == 4) return dec.adobe && dec.adobe_transform != 0 ? kYCCK : kCMYK;
  if (dec.jfif) return kYCbCr;
  if (dec.adobe) return dec.adobe_transform == 0 ? kRGB : kYCbCr;
  int a = dec.comps[0].id, b = dec.comps[1].id, c = dec.comps[2].id;
  if (a == 82 && b == 71 && c == 66) return kRGB;
  return kYCbCr;
}

void decode_jpeg(const uint8_t* data, size_t n, uint8_t* out, int fault) {
  Decoder dec(data, n);
  dec.fault = fault;
  dec.run();
  dec.check_no_smoothing();
  const int W = dec.width, H = dec.height;
  std::vector<std::vector<uint8_t>> full(dec.ncomp);
  for (int ci = 0; ci < dec.ncomp; ci++) {
    auto plane = reconstruct(dec.comps[ci], fault);
    full[ci] = upsample(dec, dec.comps[ci], plane, fault);
  }
  ColorSpace cs = color_space(dec);
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
      int nk = 255 - cmyk[3];
      for (int c = 0; c < 3; c++) {  // Pillow's cmyk2rgb
        int t = cmyk[c] * nk + 128;
        out[3 * i + c] = rl[nk - (((t >> 8) + t) >> 8)];
      }
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

// Frame header of a JPEG: size and component count.
int cpt_jpeg_header(const uint8_t* data, long n, int* width, int* height, int* ncomp,
                    char* err, int errlen) {
  try {
    Decoder dec(data, (size_t)n);
    bool has_frame;
    dec.read_header_only(&has_frame);
    if (!has_frame) fail("JPEG file has no frame header");
    *width = dec.width;
    *height = dec.height;
    *ncomp = dec.ncomp;
    return 0;
  } catch (const std::exception& e) {
    return report(e, err, errlen);
  }
}

// Decode into ``out``: height x width bytes (one component, gray) or
// height x width x 3 (RGB; a CMYK or YCCK file converted as Pillow does).
int cpt_jpeg_decode(const uint8_t* data, long n, uint8_t* out, int fault, char* err,
                    int errlen) {
  try {
    decode_jpeg(data, (size_t)n, out, fault);
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
