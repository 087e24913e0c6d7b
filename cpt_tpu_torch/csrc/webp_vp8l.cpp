// WEBP lossless (VP8L) decoder and ALPH chunk decoder of the port's image
// codec (no library beyond the C++ standard one; built by kernels/build.py
// with the host C++ compiler and bound with ctypes by
// utils/image_codec.py).
//
// It gives libwebp 1.6.0's output bit for bit, as Pillow 12.1 reads a WEBP
// file: the header (signature 0x2f, 14-bit sizes, version 0), the four
// transforms (predictor with its 14 modes, cross-colour, subtract-green,
// colour indexing with 1/2/4/8-bit pixel bundling), the meta-Huffman entropy
// image, the colour cache and LZ77 with the 120-entry distance map. The bit
// reader and the end-of-stream rules follow libwebp's VP8LBitReader: a read
// past the data flags the stream, and the image fails if the stream was
// over-read (an ALPH plane coded with only a colour-index transform and no
// cache, libwebp's 8-bit path, fails only if pixels were left undecoded).
//
// An ALPH chunk (the alpha plane of a lossy frame) is raw or VP8L-coded
// (green channel, no header, the frame's size), then unfiltered
// (horizontal, vertical or gradient).
//
// Every entry point returns 0 on success and a negative status with a
// message in ``err`` on failure; ``fault`` selects the named faults that
// the checks use to show their digests can fail (0 in use).

#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <stdexcept>
#include <string>
#include <vector>

namespace {

enum Fault {
  kSelectSwapped = 65536,  // the Select predictor returns the other neighbour
};

struct WebpError : std::runtime_error {
  using std::runtime_error::runtime_error;
};

[[noreturn]] void fail(const std::string& msg) { throw WebpError(msg); }

constexpr int kNumLiteral = 256, kNumLength = 24, kNumDistance = 40;
constexpr int kMaxCacheBits = 11;
constexpr int kMaxCodeLength = 15;
constexpr int kRootBits = 8;      // first-level table of a prefix code
constexpr int kLengthsBits = 7;   // table of the code-length code
enum { GREEN = 0, RED = 1, BLUE = 2, ALPHA = 3, DIST = 4 };
const int kAlphabet[5] = {kNumLiteral + kNumLength, 256, 256, 256, kNumDistance};
const int kCodeLengthOrder[19] = {17, 18, 0, 1, 2, 3, 4, 5, 16, 6,
                                  7, 8, 9, 10, 11, 12, 13, 14, 15};

// The distance map (yoffset << 4 | (8 - xoffset)) of the first 120 codes.
const uint8_t kCodeToPlane[120] = {
    0x18, 0x07, 0x17, 0x19, 0x28, 0x06, 0x27, 0x29, 0x16, 0x1a,
    0x26, 0x2a, 0x38, 0x05, 0x37, 0x39, 0x15, 0x1b, 0x36, 0x3a,
    0x25, 0x2b, 0x48, 0x04, 0x47, 0x49, 0x14, 0x1c, 0x35, 0x3b,
    0x46, 0x4a, 0x24, 0x2c, 0x58, 0x45, 0x4b, 0x34, 0x3c, 0x03,
    0x57, 0x59, 0x13, 0x1d, 0x56, 0x5a, 0x23, 0x2d, 0x44, 0x4c,
    0x55, 0x5b, 0x33, 0x3d, 0x68, 0x02, 0x67, 0x69, 0x12, 0x1e,
    0x66, 0x6a, 0x22, 0x2e, 0x54, 0x5c, 0x43, 0x4d, 0x65, 0x6b,
    0x32, 0x3e, 0x78, 0x01, 0x77, 0x79, 0x53, 0x5d, 0x11, 0x1f,
    0x64, 0x6c, 0x42, 0x4e, 0x76, 0x7a, 0x21, 0x2f, 0x75, 0x7b,
    0x31, 0x3f, 0x63, 0x6d, 0x52, 0x5e, 0x00, 0x74, 0x7c, 0x41,
    0x4f, 0x10, 0x20, 0x62, 0x6e, 0x30, 0x73, 0x7d, 0x51, 0x5f,
    0x40, 0x72, 0x7e, 0x61, 0x6f, 0x50, 0x71, 0x7f, 0x60, 0x70,
};

// ------------------------------------------------------------ bit reader

// libwebp's VP8LBitReader: a 64-bit window over the data, LSB first. Its
// fast refill is the byte-wise one taken in bulk, so the byte-wise path
// alone gives the same bits and the same end-of-stream points.
struct BitReader {
  uint64_t val = 0;
  const uint8_t* buf;
  size_t len, pos;
  int bit_pos = 0;
  bool eos = false;

  BitReader(const uint8_t* data, size_t n) : buf(data), len(n) {
    const size_t k = n < 8 ? n : 8;
    for (size_t i = 0; i < k; ++i) val |= (uint64_t)data[i] << (8 * i);
    pos = k;
  }
  bool at_end() const { return eos || (pos == len && bit_pos > 64); }
  void set_eos() {
    eos = true;
    bit_pos = 0;
  }
  void shift_bytes() {
    while (bit_pos >= 8 && pos < len) {
      val >>= 8;
      val |= (uint64_t)buf[pos] << 56;
      ++pos;
      bit_pos -= 8;
    }
    if (at_end()) set_eos();
  }
  uint32_t prefetch() const { return (uint32_t)(val >> (bit_pos & 63)); }
  uint32_t read(int n) {
    if (!eos && n <= 24) {
      const uint32_t v = prefetch() & ((1u << n) - 1);
      bit_pos += n;
      shift_bytes();
      return v;
    }
    set_eos();
    return 0;
  }
  void fill() {
    if (bit_pos >= 32) shift_bytes();
  }
};

// ---------------------------------------------------------- prefix codes

struct HuffCode {
  uint8_t bits;
  uint16_t value;
};

uint32_t next_key(uint32_t key, int len) {
  uint32_t step = 1u << (len - 1);
  while (key & step) step >>= 1;
  return step ? (key & (step - 1)) + step : key;
}

void replicate(HuffCode* table, int step, int end, HuffCode code) {
  do {
    end -= step;
    table[end] = code;
  } while (end > 0);
}

int next_table_bits(const int* count, int len, int root_bits) {
  int left = 1 << (len - root_bits);
  while (len < kMaxCodeLength) {
    left -= count[len];
    if (left <= 0) break;
    ++len;
    left <<= 1;
  }
  return len - root_bits;
}

// libwebp's BuildHuffmanTable: a root table of ``root_bits`` and second-
// level tables, into ``out`` (cleared) when it is not null. Returns false
// unless the lengths make a complete prefix code or name exactly one symbol
// (a code that reads no bits).
bool build_table(int root_bits, const int* lengths, int n, std::vector<HuffCode>* out) {
  int count[kMaxCodeLength + 1] = {0};
  int offset[kMaxCodeLength + 1];
  for (int s = 0; s < n; ++s) {
    if (lengths[s] > kMaxCodeLength) return false;
    ++count[lengths[s]];
  }
  if (count[0] == n) return false;
  offset[1] = 0;
  for (int len = 1; len < kMaxCodeLength; ++len) {
    if (count[len] > (1 << len)) return false;
    offset[len + 1] = offset[len] + count[len];
  }
  std::vector<int> sorted(n);
  for (int s = 0; s < n; ++s) {
    if (lengths[s] > 0) sorted[offset[lengths[s]]++] = s;
  }
  int total = 1 << root_bits;
  if (out) out->assign(total, HuffCode{0, 0});
  if (offset[kMaxCodeLength] == 1) {  // one symbol: no bits
    if (out) replicate(out->data(), 1, total, HuffCode{0, (uint16_t)sorted[0]});
    return true;
  }
  // first pass sizes the second-level tables; the second fills them
  for (int pass = 0; pass < 2; ++pass) {
    if (pass == 1 && !out) break;
    int cnt[kMaxCodeLength + 1];
    std::memcpy(cnt, count, sizeof(cnt));
    HuffCode* root = pass ? out->data() : nullptr;
    int table_at = 0;
    uint32_t low = 0xffffffffu, mask = (uint32_t)(1 << root_bits) - 1, key = 0;
    int num_nodes = 1, num_open = 1, table_bits = root_bits, table_size = 1 << root_bits;
    int symbol = 0, grown = 1 << root_bits;
    int len, step;
    for (len = 1, step = 2; len <= root_bits; ++len, step <<= 1) {
      num_open <<= 1;
      num_nodes += num_open;
      num_open -= cnt[len];
      if (num_open < 0) return false;
      for (; cnt[len] > 0; --cnt[len]) {
        if (root) {
          replicate(&root[key], step, table_size, HuffCode{(uint8_t)len, (uint16_t)sorted[symbol]});
        }
        ++symbol;
        key = next_key(key, len);
      }
    }
    for (len = root_bits + 1, step = 2; len <= kMaxCodeLength; ++len, step <<= 1) {
      num_open <<= 1;
      num_nodes += num_open;
      num_open -= cnt[len];
      if (num_open < 0) return false;
      for (; cnt[len] > 0; --cnt[len]) {
        if ((key & mask) != low) {
          table_at += table_size;
          table_bits = next_table_bits(cnt, len, root_bits);
          table_size = 1 << table_bits;
          grown += table_size;
          low = key & mask;
          if (root) {
            root[low].bits = (uint8_t)(table_bits + root_bits);
            root[low].value = (uint16_t)(table_at - (int)low);
          }
        }
        if (root) {
          replicate(&root[table_at + (key >> root_bits)], step, table_size,
                    HuffCode{(uint8_t)(len - root_bits), (uint16_t)sorted[symbol]});
        }
        ++symbol;
        key = next_key(key, len);
      }
    }
    if (num_nodes != 2 * offset[kMaxCodeLength] - 1) return false;
    if (pass == 0 && out) {
      out->assign(grown, HuffCode{0, 0});
    }
  }
  return true;
}

int read_symbol(const HuffCode* table, BitReader& br) {
  uint32_t val = br.prefetch();
  table += val & ((1u << kRootBits) - 1);
  const int nbits = table->bits - kRootBits;
  if (nbits > 0) {
    br.bit_pos += kRootBits;
    val = br.prefetch();
    table += table->value;
    table += val & ((1u << nbits) - 1);
  }
  br.bit_pos += table->bits;
  return table->value;
}

// ----------------------------------------------------------- the decoder

int subsample(int size, int bits) { return (size + (1 << bits) - 1) >> bits; }

struct Group {
  std::vector<HuffCode> trees[5];
};

struct Transform {
  int type = 0, bits = 0, xsize = 0, ysize = 0;
  std::vector<uint32_t> data;
};

struct Lossless {
  BitReader br;
  int fault;
  Transform transforms[4];
  int num_transforms = 0;
  unsigned seen = 0;

  Lossless(const uint8_t* data, size_t n, int fault_) : br(data, n), fault(fault_) {}

  [[noreturn]] void broken(const char* what) {
    fail(std::string("broken WEBP lossless bitstream (") + what + ")");
  }

  // One prefix code of ``alphabet`` symbols; ``out`` null only checks it.
  void read_code(int alphabet, std::vector<int>& lengths, std::vector<HuffCode>* out) {
    std::fill(lengths.begin(), lengths.begin() + alphabet, 0);
    bool ok = true;
    if (br.read(1)) {  // simple: one or two symbols
      const int num = (int)br.read(1) + 1;
      const int first_bits = br.read(1) ? 8 : 1;
      int s = (int)br.read(first_bits);
      if (s < alphabet) lengths[s] = 1;
      if (num == 2) {
        s = (int)br.read(8);
        if (s < alphabet) lengths[s] = 1;
      }
    } else {
      int cl_lengths[19] = {0};
      const int num_codes = (int)br.read(4) + 4;
      for (int i = 0; i < num_codes; ++i) cl_lengths[kCodeLengthOrder[i]] = (int)br.read(3);
      ok = read_code_lengths(cl_lengths, alphabet, lengths);
    }
    ok = ok && !br.eos;
    if (!ok || !build_table(kRootBits, lengths.data(), alphabet, out)) {
      broken("prefix code");
    }
  }

  bool read_code_lengths(const int* cl_lengths, int num_symbols, std::vector<int>& lengths) {
    std::vector<HuffCode> table;
    if (!build_table(kLengthsBits, cl_lengths, 19, &table)) return false;
    int max_symbol;
    if (br.read(1)) {
      const int length_bits = 2 + 2 * (int)br.read(3);
      max_symbol = 2 + (int)br.read(length_bits);
      if (max_symbol > num_symbols) return false;
    } else {
      max_symbol = num_symbols;
    }
    int prev = 8, symbol = 0;
    while (symbol < num_symbols) {
      if (max_symbol-- == 0) break;
      br.fill();
      const HuffCode& p = table[br.prefetch() & ((1u << kLengthsBits) - 1)];
      br.bit_pos += p.bits;
      const int code = p.value;
      if (code < 16) {
        lengths[symbol++] = code;
        if (code) prev = code;
      } else {
        const int slot = code - 16;
        const int extra[3] = {2, 3, 7}, base[3] = {3, 3, 11};
        const int repeat = (int)br.read(extra[slot]) + base[slot];
        if (symbol + repeat > num_symbols) return false;
        const int v = code == 16 ? prev : 0;
        for (int i = 0; i < repeat; ++i) lengths[symbol++] = v;
      }
    }
    return true;
  }

  // The entropy codes of an image: groups, the meta image (level 0 only),
  // the colour cache bits.
  struct Codes {
    int cache_bits = 0, huff_bits = 0, huff_xsize = 0;
    std::vector<uint32_t> huff_image;  // group of each tile (compact index)
    std::vector<Group> groups;
    std::vector<uint32_t> cache;
  };

  void read_codes(int xsize, int ysize, int cache_bits, bool level0, Codes& c) {
    int num_groups = 1;
    if (level0 && br.read(1)) {
      c.huff_bits = 2 + (int)br.read(3);
      const int hx = subsample(xsize, c.huff_bits), hy = subsample(ysize, c.huff_bits);
      c.huff_image = decode_stream(hx, hy, false);
      c.huff_xsize = hx;
      for (uint32_t& g : c.huff_image) {
        g = (g >> 8) & 0xffff;
        if ((int)g + 1 > num_groups) num_groups = (int)g + 1;
      }
    }
    if (br.eos) broken("entropy image");
    // every group is read and checked; only those the image uses are kept
    std::vector<int> slot(num_groups, -1);
    int used = 0;
    if (c.huff_image.empty()) {
      slot[0] = used++;
    } else {
      for (uint32_t& g : c.huff_image) {
        if (slot[g] < 0) slot[g] = used++;
        g = (uint32_t)slot[g];
      }
    }
    c.groups.assign(used, Group());
    const int green = kAlphabet[GREEN] + (cache_bits > 0 ? 1 << cache_bits : 0);
    std::vector<int> lengths(green);
    for (int i = 0; i < num_groups; ++i) {
      for (int j = 0; j < 5; ++j) {
        const int alphabet = j == GREEN ? green : kAlphabet[j];
        read_code(alphabet, lengths, slot[i] < 0 ? nullptr : &c.groups[slot[i]].trees[j]);
      }
    }
    c.cache_bits = cache_bits;
    if (cache_bits) c.cache.assign((size_t)1 << cache_bits, 0);
  }

  static uint32_t copy_distance(int symbol, BitReader& br) {
    if (symbol < 4) return (uint32_t)symbol + 1;
    const int extra = (symbol - 2) >> 1;
    const uint32_t offset = (uint32_t)(2 + (symbol & 1)) << extra;
    return offset + br.read(extra) + 1;
  }

  static long plane_distance(int xsize, uint32_t code) {
    if (code > 120) return (long)code - 120;
    const int d = kCodeToPlane[code - 1];
    const long dist = (long)(d >> 4) * xsize + (8 - (d & 0xf));
    return dist >= 1 ? dist : 1;
  }

  // LZ77 / prefix-coded pixels of an xsize x ysize image. ``alpha8``: the
  // 8-bit path of an ALPH plane (only the green codes read; the stream may
  // end flagged if every pixel was decoded).
  void decode_pixels(Codes& c, int xsize, int ysize, std::vector<uint32_t>& out, bool alpha8) {
    const long end = (long)xsize * ysize;
    out.assign(end, 0);
    const int mask = c.huff_bits ? (1 << c.huff_bits) - 1 : ~0;
    const int len_limit = kNumLiteral + kNumLength;
    const int cache_limit = len_limit + (c.cache_bits ? 1 << c.cache_bits : 0);
    const int cache_shift = 32 - c.cache_bits;
    long pos = 0, cached = 0;
    int col = 0, row = 0;
    const Group* group = &c.groups[0];
    auto group_at = [&](int x, int y) -> const Group* {
      if (!c.huff_bits) return &c.groups[0];
      return &c.groups[c.huff_image[(size_t)c.huff_xsize * (y >> c.huff_bits) + (x >> c.huff_bits)]];
    };
    auto insert_upto = [&](long upto) {
      if (!c.cache_bits) {
        cached = upto;
        return;
      }
      for (; cached < upto; ++cached) {
        c.cache[(0x1e35a7bdu * out[cached]) >> cache_shift] = out[cached];
      }
    };
    bool ok = true;
    while (pos < end) {
      if (alpha8 && br.eos) break;
      if ((col & mask) == 0) group = group_at(col, row);
      br.fill();
      const int code = read_symbol(group->trees[GREEN].data(), br);
      if (!alpha8 && br.at_end()) break;
      if (code < kNumLiteral) {
        if (alpha8) {
          out[pos] = (uint32_t)code << 8;
        } else {
          const int red = read_symbol(group->trees[RED].data(), br);
          br.fill();
          const int blue = read_symbol(group->trees[BLUE].data(), br);
          const int alpha = read_symbol(group->trees[ALPHA].data(), br);
          if (br.at_end()) break;
          out[pos] = ((uint32_t)alpha << 24) | ((uint32_t)red << 16) | ((uint32_t)code << 8) |
                     (uint32_t)blue;
        }
        ++pos;
        if (++col >= xsize) {
          col = 0;
          ++row;
          insert_upto(pos);
        }
      } else if (code < len_limit) {
        const long length = copy_distance(code - kNumLiteral, br);
        const int dist_symbol = read_symbol(group->trees[DIST].data(), br);
        br.fill();
        const long dist = plane_distance(xsize, copy_distance(dist_symbol, br));
        if (!alpha8 && br.at_end()) break;
        if (pos < dist || end - pos < length) {
          ok = false;
          break;
        }
        for (long i = 0; i < length; ++i) out[pos + i] = out[pos + i - dist];
        pos += length;
        col += (int)(length % xsize);
        row += (int)(length / xsize);
        if (col >= xsize) {
          col -= xsize;
          ++row;
        }
        if (col & mask) group = group_at(col, row);
        insert_upto(pos);
      } else if (code < cache_limit) {
        insert_upto(pos);
        out[pos] = c.cache[code - len_limit];
        ++pos;
        if (++col >= xsize) {
          col = 0;
          ++row;
          insert_upto(pos);
        }
      } else {
        ok = false;
        break;
      }
      if (alpha8) br.eos = br.at_end();
    }
    br.eos = br.at_end();
    if (!ok) broken("backward reference outside the image");
    if (alpha8 ? (br.eos && pos < end) : br.eos) {
      fail("broken WEBP lossless bitstream (data ends before the image)");
    }
  }

  // An entropy-coded image (a transform's or the entropy image's, or the
  // main one at level 0 with its transforms and meta codes).
  std::vector<uint32_t> decode_stream(int xsize, int ysize, bool level0, bool alpha = false) {
    int cache_bits = 0;
    if (br.read(1)) {
      cache_bits = (int)br.read(4);
      if (cache_bits < 1 || cache_bits > kMaxCacheBits) broken("colour cache size");
    }
    Codes c;
    read_codes(xsize, ysize, cache_bits, level0, c);
    std::vector<uint32_t> out;
    bool alpha8 = false;
    if (alpha && num_transforms == 1 && transforms[0].type == 3 && !cache_bits) {
      alpha8 = true;
      for (const Group& g : c.groups) {
        for (int j : {RED, BLUE, ALPHA}) alpha8 = alpha8 && g.trees[j][0].bits == 0;
      }
    }
    decode_pixels(c, xsize, ysize, out, alpha8);
    return out;
  }

  // Level 0: the transforms, then the image (width after colour indexing).
  std::vector<uint32_t> decode_image(int width, int height, bool alpha) {
    int xsize = width;
    while (br.read(1)) {
      const int type = (int)br.read(2);
      if (seen & (1u << type)) broken("a transform used twice");
      seen |= 1u << type;
      Transform& t = transforms[num_transforms++];
      t.type = type;
      t.xsize = xsize;
      t.ysize = height;
      if (type == 0 || type == 1) {
        t.bits = 2 + (int)br.read(3);
        t.data = decode_stream(subsample(xsize, t.bits), subsample(height, t.bits), false);
      } else if (type == 3) {
        const int num_colors = (int)br.read(8) + 1;
        t.bits = num_colors > 16 ? 0 : num_colors > 4 ? 1 : num_colors > 2 ? 2 : 3;
        xsize = subsample(t.xsize, t.bits);
        std::vector<uint32_t> pal = decode_stream(num_colors, 1, false);
        t.data.assign((size_t)1 << (8 >> t.bits), 0);
        uint8_t* dst = reinterpret_cast<uint8_t*>(t.data.data());
        const uint8_t* src = reinterpret_cast<const uint8_t*>(pal.data());
        std::memcpy(dst, src, 4);
        for (int i = 4; i < 4 * num_colors; ++i) dst[i] = (uint8_t)(src[i] + dst[i - 4]);
      }
    }
    std::vector<uint32_t> pix = decode_stream(xsize, height, true, alpha);
    for (int n = num_transforms - 1; n >= 0; --n) inverse(transforms[n], pix, height);
    return pix;
  }

  void inverse(const Transform& t, std::vector<uint32_t>& pix, int height) {
    const int w = t.xsize;
    if (t.type == 2) {  // add green to blue and red
      for (uint32_t& p : pix) {
        const uint32_t g = (p >> 8) & 0xff;
        const uint32_t rb = ((p & 0x00ff00ffu) + ((g << 16) | g)) & 0x00ff00ffu;
        p = (p & 0xff00ff00u) | rb;
      }
    } else if (t.type == 1) {  // cross-colour
      const int tiles = subsample(w, t.bits);
      for (int y = 0; y < height; ++y) {
        for (int x = 0; x < w; ++x) {
          const uint32_t code = t.data[(size_t)(y >> t.bits) * tiles + (x >> t.bits)];
          const int8_t g2r = (int8_t)(code & 0xff), g2b = (int8_t)((code >> 8) & 0xff),
                       r2b = (int8_t)((code >> 16) & 0xff);
          uint32_t& p = pix[(size_t)y * w + x];
          const int8_t green = (int8_t)(p >> 8);
          int r = (p >> 16) & 0xff, b = p & 0xff;
          r = (r + ((g2r * green) >> 5)) & 0xff;
          b += (g2b * green) >> 5;
          b += (r2b * (int8_t)r) >> 5;
          p = (p & 0xff00ff00u) | ((uint32_t)r << 16) | ((uint32_t)b & 0xff);
        }
      }
    } else if (t.type == 0) {
      predictor_inverse(t, pix, height);
    } else {  // colour indexing
      const int in_w = subsample(w, t.bits);
      std::vector<uint32_t> out((size_t)w * height);
      const int per_byte_bits = 8 >> t.bits, count_mask = (1 << t.bits) - 1;
      const uint32_t bit_mask = (1u << per_byte_bits) - 1;
      for (int y = 0; y < height; ++y) {
        const uint32_t* src = &pix[(size_t)y * in_w];
        uint32_t packed = 0;
        for (int x = 0; x < w; ++x) {
          if ((x & count_mask) == 0) packed = (*src++ >> 8) & 0xff;
          out[(size_t)y * w + x] = t.data[packed & bit_mask];
          packed >>= per_byte_bits;
        }
      }
      pix.swap(out);
    }
  }

  static uint32_t add(uint32_t a, uint32_t b) {
    const uint32_t ag = (a & 0xff00ff00u) + (b & 0xff00ff00u);
    const uint32_t rb = (a & 0x00ff00ffu) + (b & 0x00ff00ffu);
    return (ag & 0xff00ff00u) | (rb & 0x00ff00ffu);
  }
  static uint32_t avg2(uint32_t a, uint32_t b) {
    return (((a ^ b) & 0xfefefefeu) >> 1) + (a & b);
  }
  static uint32_t clip255(uint32_t a) { return a < 256 ? a : ~a >> 24; }
  static int sub3(int a, int b, int c) { return std::abs(b - c) - std::abs(a - c); }

  uint32_t select(uint32_t a, uint32_t b, uint32_t c) const {
    int d = 0;
    for (int s = 0; s < 32; s += 8) d += sub3((a >> s) & 0xff, (b >> s) & 0xff, (c >> s) & 0xff);
    const bool first = d <= 0;
    return (first != ((fault & kSelectSwapped) != 0)) ? a : b;
  }

  static uint32_t add_sub_full(uint32_t c0, uint32_t c1, uint32_t c2) {
    uint32_t out = 0;
    for (int s = 0; s < 32; s += 8) {
      const int v = (int)((c0 >> s) & 0xff) + (int)((c1 >> s) & 0xff) - (int)((c2 >> s) & 0xff);
      out |= clip255((uint32_t)v) << s;
    }
    return out;
  }

  static uint32_t add_sub_half(uint32_t c0, uint32_t c1, uint32_t c2) {
    const uint32_t ave = avg2(c0, c1);
    uint32_t out = 0;
    for (int s = 0; s < 32; s += 8) {
      const int a = (int)((ave >> s) & 0xff), b = (int)((c2 >> s) & 0xff);
      out |= clip255((uint32_t)(a + (a - b) / 2)) << s;
    }
    return out;
  }

  uint32_t predict(int mode, const uint32_t* left, const uint32_t* top) const {
    switch (mode) {
      case 1: return *left;
      case 2: return top[0];
      case 3: return top[1];
      case 4: return top[-1];
      case 5: return avg2(avg2(*left, top[1]), top[0]);
      case 6: return avg2(*left, top[-1]);
      case 7: return avg2(*left, top[0]);
      case 8: return avg2(top[-1], top[0]);
      case 9: return avg2(top[0], top[1]);
      case 10: return avg2(avg2(*left, top[-1]), avg2(top[0], top[1]));
      case 11: return select(top[0], *left, top[-1]);
      case 12: return add_sub_full(*left, top[0], top[-1]);
      case 13: return add_sub_half(*left, top[0], top[-1]);
      default: return 0xff000000u;  // 0, and 14, 15 as libwebp pads them
    }
  }

  void predictor_inverse(const Transform& t, std::vector<uint32_t>& pix, int height) {
    const int w = t.xsize, tiles = subsample(w, t.bits);
    uint32_t* p = pix.data();
    p[0] = add(p[0], 0xff000000u);
    for (int x = 1; x < w; ++x) p[x] = add(p[x], p[x - 1]);
    for (int y = 1; y < height; ++y) {
      uint32_t* row = p + (size_t)y * w;
      const uint32_t* top = row - w;
      row[0] = add(row[0], top[0]);
      const uint32_t* modes = &t.data[(size_t)(y >> t.bits) * tiles];
      for (int x = 1; x < w; ++x) {
        const int mode = (modes[x >> t.bits] >> 8) & 0xf;
        row[x] = add(row[x], predict(mode, &row[x - 1], &top[x]));
      }
    }
  }
};

// ------------------------------------------------------------- filters

uint8_t gradient(int a, int b, int c) {
  const int g = a + b - c;
  return (uint8_t)((g & ~0xff) == 0 ? g : g < 0 ? 0 : 255);
}

// libwebp's unfilters, row by row (``prev`` null for the first row).
void unfilter(int filter, const uint8_t* prev, const uint8_t* in, uint8_t* out, int width) {
  if (filter == 0) {
    if (in != out) std::memmove(out, in, (size_t)width);
  } else if (filter == 1 || prev == nullptr) {
    uint8_t pred = (filter == 1 && prev) ? prev[0] : 0;
    for (int i = 0; i < width; ++i) {
      out[i] = (uint8_t)(pred + in[i]);
      pred = out[i];
    }
  } else if (filter == 2) {
    for (int i = 0; i < width; ++i) out[i] = (uint8_t)(prev[i] + in[i]);
  } else {
    uint8_t top = prev[0], top_left = top, left = top;
    for (int i = 0; i < width; ++i) {
      top = prev[i];
      left = (uint8_t)(in[i] + gradient(left, top, top_left));
      top_left = top;
      out[i] = left;
    }
  }
}

void decode_alpha(const uint8_t* data, size_t n, int width, int height, int fault, uint8_t* out) {
  if (n <= 1) fail("broken WEBP alpha plane (ALPH chunk without data)");
  const int method = data[0] & 3, filter = (data[0] >> 2) & 3, pre = (data[0] >> 4) & 3;
  if (method > 1 || pre > 1 || (data[0] >> 6) != 0) {
    fail("broken WEBP alpha plane (bad ALPH header)");
  }
  const size_t npix = (size_t)width * height;
  if (method == 0) {
    if (n - 1 < npix) fail("broken WEBP alpha plane (raw data too short)");
    std::memcpy(out, data + 1, npix);
  } else {
    Lossless dec(data + 1, n - 1, fault);
    std::vector<uint32_t> pix = dec.decode_image(width, height, true);
    for (size_t i = 0; i < npix; ++i) out[i] = (uint8_t)(pix[i] >> 8);
  }
  const uint8_t* prev = nullptr;
  for (int y = 0; y < height; ++y) {
    uint8_t* row = out + (size_t)y * width;
    unfilter(filter, prev, row, row, width);
    prev = row;
  }
}

void decode_vp8l(const uint8_t* data, size_t n, int width, int height, int fault, uint8_t* out) {
  if (n < 5 || data[0] != 0x2f || (data[4] >> 5) != 0) {
    fail("broken WEBP lossless bitstream (bad signature)");
  }
  Lossless dec(data, n, fault);
  dec.br.read(8);
  const int w = (int)dec.br.read(14) + 1, h = (int)dec.br.read(14) + 1;
  dec.br.read(1);
  if (dec.br.read(3) != 0 || dec.br.eos) fail("broken WEBP lossless bitstream (bad header)");
  if (w != width || h != height) fail("broken WEBP lossless bitstream (size differs)");
  std::vector<uint32_t> pix = dec.decode_image(width, height, false);
  for (size_t i = 0; i < pix.size(); ++i) {
    const uint32_t p = pix[i];
    out[4 * i] = (uint8_t)(p >> 16);
    out[4 * i + 1] = (uint8_t)(p >> 8);
    out[4 * i + 2] = (uint8_t)p;
    out[4 * i + 3] = (uint8_t)(p >> 24);
  }
}

int report(const std::exception& e, char* err, int errlen) {
  if (err && errlen > 0) std::snprintf(err, (size_t)errlen, "%s", e.what());
  return -1;
}

}  // namespace

extern "C" {

// Decode a VP8L bitstream (``alpha`` 0: the chunk's payload, its header
// included, into height x width x 4 RGBA bytes) or an ALPH chunk's payload
// (``alpha`` 1: into height x width alpha bytes).
int cpt_webp_lossless(const uint8_t* data, long n, int alpha, int width, int height, int fault,
                      uint8_t* out, char* err, int errlen) {
  try {
    if (alpha) {
      decode_alpha(data, (size_t)n, width, height, fault, out);
    } else {
      decode_vp8l(data, (size_t)n, width, height, fault, out);
    }
    return 0;
  } catch (const std::exception& e) {
    return report(e, err, errlen);
  }
}

}  // extern "C"
