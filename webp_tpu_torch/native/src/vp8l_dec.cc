// Native VP8L decoder: the complete lossless pixel path in C++.
//
// Parity with webp_tpu_torch/lossless/decode.py + transforms.py (reference:
// internal/lossless/{decode.go,decode_image.go,decode_transform.go,
// huffman.go}): bit reader, strict canonical Huffman table build
// (over/under-subscription rejected), meta-Huffman entropy image, color
// cache, the LZ77 + Huffman pixel loop, and all four inverse transforms
// (predictor / cross-color / subtract-green / color-indexing with pixel
// unbundling). Returns negative error codes for malformed input; the
// Python layer maps them to BitstreamError.

#include <algorithm>
#include <cstddef>
#include <cstdint>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <vector>

using std::size_t;

namespace {

constexpr int kRootBits = 8;
constexpr int kRootMask = (1 << kRootBits) - 1;
constexpr int kMaxLen = 15;
constexpr int kNumLiteral = 256;
constexpr int kNumLength = 24;
constexpr int kNumDistance = 40;
constexpr int kClCodes = 19;
const uint8_t kClcOrder[kClCodes] = {17, 18, 0, 1, 2,  3,  4,  5, 16,
                                     6,  7,  8, 9, 10, 11, 12, 13, 14, 15};
const uint8_t kClExtraBits[3] = {2, 3, 7};
const uint8_t kClRepeatOffsets[3] = {3, 3, 11};
const int8_t kPlane[120][2] = {
    {0, 1},  {1, 0},  {1, 1},  {-1, 1}, {0, 2},  {2, 0},  {1, 2},  {-1, 2},
    {2, 1},  {-2, 1}, {2, 2},  {-2, 2}, {0, 3},  {3, 0},  {1, 3},  {-1, 3},
    {3, 1},  {-3, 1}, {2, 3},  {-2, 3}, {3, 2},  {-3, 2}, {0, 4},  {4, 0},
    {1, 4},  {-1, 4}, {4, 1},  {-4, 1}, {3, 3},  {-3, 3}, {2, 4},  {-2, 4},
    {4, 2},  {-4, 2}, {0, 5},  {3, 4},  {-3, 4}, {4, 3},  {-4, 3}, {5, 0},
    {1, 5},  {-1, 5}, {5, 1},  {-5, 1}, {2, 5},  {-2, 5}, {5, 2},  {-5, 2},
    {4, 4},  {-4, 4}, {3, 5},  {-3, 5}, {5, 3},  {-5, 3}, {0, 6},  {6, 0},
    {1, 6},  {-1, 6}, {6, 1},  {-6, 1}, {2, 6},  {-2, 6}, {6, 2},  {-6, 2},
    {4, 5},  {-4, 5}, {5, 4},  {-5, 4}, {3, 6},  {-3, 6}, {6, 3},  {-6, 3},
    {0, 7},  {7, 0},  {1, 7},  {-1, 7}, {5, 5},  {-5, 5}, {7, 1},  {-7, 1},
    {4, 6},  {-4, 6}, {6, 4},  {-6, 4}, {2, 7},  {-2, 7}, {7, 2},  {-7, 2},
    {3, 7},  {-3, 7}, {7, 3},  {-7, 3}, {5, 6},  {-5, 6}, {6, 5},  {-6, 5},
    {8, 0},  {4, 7},  {-4, 7}, {7, 4},  {-7, 4}, {8, 1},  {8, 2},  {6, 6},
    {-6, 6}, {8, 3},  {5, 7},  {-5, 7}, {7, 5},  {-7, 5}, {8, 4},  {6, 7},
    {-6, 7}, {7, 6},  {-7, 6}, {8, 5},  {7, 7},  {-7, 7}, {8, 6},  {8, 7}};

inline long SubSampleSize(long size, int bits) {
  return (size + (1L << bits) - 1) >> bits;
}

struct BitReader {
  const uint8_t* data;
  long n;
  long pos = 0;       // next byte to load into the window
  uint64_t val = 0;
  int bit_pos = 64;
  bool eos = false;

  void Init(const uint8_t* d, long size) {
    data = d;
    n = size;
    pos = 0;
    val = 0;
    bit_pos = 64;
    eos = false;
    Fill();
  }
  void Fill() {
    if (bit_pos < 8) return;  // window already full
    // Fast path: reload all needed bytes with one unaligned 64-bit load
    // (the stream is LSB-first, so a little-endian load lands the bytes
    // exactly where the byte-at-a-time loop would put them).
    const int k = bit_pos >> 3;
    if (k && pos + 8 <= n) {
      uint64_t w;
      std::memcpy(&w, data + pos, 8);
      pos += k;
      bit_pos -= k * 8;
      val = k == 8 ? w : (val >> (k * 8)) | (w << ((8 - k) * 8));
      return;  // pos + 8 <= n: nowhere near EOS
    }
    while (bit_pos >= 8) {
      uint64_t byte = pos < n ? data[pos] : 0;
      ++pos;
      val = (val >> 8) | (byte << 56);
      bit_pos -= 8;
    }
    CheckEos(0);
  }
  void CheckEos(int upcoming) {
    const long consumed = pos * 8 - (64 - bit_pos - upcoming);
    if (consumed > n * 8) eos = true;
  }
  uint32_t ReadBits(int nb) {
    if (!nb) return 0;
    Fill();
    if (bit_pos + nb > 64) {
      CheckEos(nb);
      bit_pos = std::min(bit_pos + nb, 64);
      return 0;
    }
    uint32_t v = (uint32_t)((val >> bit_pos) & ((1ULL << nb) - 1));
    bit_pos += nb;
    CheckEos(0);
    return v;
  }
  uint64_t Prefetch() {  // after Fill(): next bits, LSB-first
    return val >> bit_pos;
  }
};

struct HuffTable {
  std::vector<uint8_t> bits;
  std::vector<uint16_t> value;
  int single_symbol = -1;

  inline int Read(BitReader* br) const {
    if (single_symbol >= 0) return single_symbol;
    br->Fill();
    const uint64_t pre = br->Prefetch();
    long idx = (long)(pre & kRootMask);
    int nb = bits[(size_t)idx];
    if (nb > kRootBits) {
      const long off = value[(size_t)idx];
      const long sub =
          off + (long)((pre >> kRootBits) & ((1ULL << (nb - kRootBits)) - 1));
      nb = bits[(size_t)sub];
      br->bit_pos += nb;
      // consumed > n*8 needs pos > n (Fill leaves bit_pos < 8, nb <= 15).
      if (br->pos > br->n) br->CheckEos(0);
      return value[(size_t)sub];
    }
    br->bit_pos += nb;
    if (br->pos > br->n) br->CheckEos(0);
    return value[(size_t)idx];
  }

  // Read without refilling: caller guarantees >= 15 bits are buffered.
  inline int ReadNF(BitReader* br) const {
    if (single_symbol >= 0) return single_symbol;
    const uint64_t pre = br->Prefetch();
    long idx = (long)(pre & kRootMask);
    int nb = bits[(size_t)idx];
    if (nb > kRootBits) {
      const long off = value[(size_t)idx];
      const long sub =
          off + (long)((pre >> kRootBits) & ((1ULL << (nb - kRootBits)) - 1));
      nb = bits[(size_t)sub];
      br->bit_pos += nb;
      if (br->pos > br->n) br->CheckEos(0);
      return value[(size_t)sub];
    }
    br->bit_pos += nb;
    if (br->pos > br->n) br->CheckEos(0);
    return value[(size_t)idx];
  }
};

inline uint32_t ReverseBits(uint32_t code, int len) {
  uint32_t out = 0;
  for (int i = 0; i < len; ++i) {
    out = (out << 1) | (code & 1);
    code >>= 1;
  }
  return out;
}

// Strict canonical table build; false on over/under-subscribed codes.
bool BuildHuffTable(const std::vector<int>& lengths, HuffTable* t) {
  const int n = (int)lengths.size();
  int counts[kMaxLen + 1] = {0};
  for (int l : lengths) {
    if (l < 0 || l > kMaxLen) return false;
    counts[l]++;
  }
  const int num_used = n - counts[0];
  if (num_used == 0) return false;
  if (num_used == 1) {
    int sym = 0;
    for (int i = 0; i < n; ++i)
      if (lengths[(size_t)i] > 0) {
        sym = i;
        break;
      }
    t->single_symbol = sym;
    return true;
  }
  long total = 0;
  for (int l = 1; l <= kMaxLen; ++l)
    total += (long)counts[l] << (kMaxLen - l);
  if (total != 1L << kMaxLen) return false;

  uint32_t next_code[kMaxLen + 1] = {0};
  uint32_t code = 0;
  for (int l = 1; l <= kMaxLen; ++l) {
    code = (code + (uint32_t)counts[l - 1]) << 1;
    next_code[l] = code;
  }
  const int root_size = 1 << kRootBits;
  // First pass: codes + per-prefix max length for subtables.
  std::vector<uint32_t> codes((size_t)n, 0);
  std::vector<int> sub_max((size_t)root_size, 0);
  for (int sym = 0; sym < n; ++sym) {
    const int l = lengths[(size_t)sym];
    if (!l) continue;
    const uint32_t rc = ReverseBits(next_code[l]++, l);
    codes[(size_t)sym] = rc;
    if (l > kRootBits) {
      const int prefix = (int)(rc & kRootMask);
      sub_max[(size_t)prefix] = std::max(sub_max[(size_t)prefix], l);
    }
  }
  long total_size = root_size;
  for (int p = 0; p < root_size; ++p)
    if (sub_max[(size_t)p]) total_size += 1L << (sub_max[(size_t)p] - kRootBits);
  t->bits.assign((size_t)total_size, 0);
  t->value.assign((size_t)total_size, 0);
  t->single_symbol = -1;
  std::vector<long> sub_off((size_t)root_size, 0);
  long off = root_size;
  for (int p = 0; p < root_size; ++p) {
    if (!sub_max[(size_t)p]) continue;
    sub_off[(size_t)p] = off;
    t->bits[(size_t)p] = (uint8_t)sub_max[(size_t)p];
    t->value[(size_t)p] = (uint16_t)off;
    off += 1L << (sub_max[(size_t)p] - kRootBits);
  }
  for (int sym = 0; sym < n; ++sym) {
    const int l = lengths[(size_t)sym];
    if (!l) continue;
    const uint32_t rc = codes[(size_t)sym];
    if (l <= kRootBits) {
      for (long i = rc; i < root_size; i += 1L << l) {
        t->bits[(size_t)i] = (uint8_t)l;
        t->value[(size_t)i] = (uint16_t)sym;
      }
    } else {
      const int prefix = (int)(rc & kRootMask);
      const int m = sub_max[(size_t)prefix];
      const long base = sub_off[(size_t)prefix];
      const long hi = rc >> kRootBits;
      for (long i = hi; i < 1L << (m - kRootBits); i += 1L << (l - kRootBits)) {
        t->bits[(size_t)(base + i)] = (uint8_t)l;
        t->value[(size_t)(base + i)] = (uint16_t)sym;
      }
    }
  }
  return true;
}

inline uint32_t GetCopyDistance(int symbol, BitReader* br) {
  if (symbol < 4) return (uint32_t)symbol + 1;
  const int extra = (symbol - 2) >> 1;
  const uint32_t offset = (uint32_t)(2 + (symbol & 1)) << extra;
  return offset + br->ReadBits(extra) + 1;
}

inline long PlaneCodeToDistance(long xsize, uint32_t plane_code) {
  if (plane_code > 120) return (long)plane_code - 120;
  const int dx = kPlane[plane_code - 1][0];
  const int dy = kPlane[plane_code - 1][1];
  const long d = (long)dy * xsize + dx;
  return d >= 1 ? d : 1;
}

// --------------------------- transforms -----------------------------------

inline uint32_t Avg2(uint32_t a, uint32_t b) {
  return (((a ^ b) & 0xFEFEFEFEu) >> 1) + (a & b);
}

inline uint32_t AddPixels(uint32_t a, uint32_t b) {
  const uint32_t lo = ((a & 0x00FF00FFu) + (b & 0x00FF00FFu)) & 0x00FF00FFu;
  const uint32_t hi = ((a & 0xFF00FF00u) + (b & 0xFF00FF00u)) & 0xFF00FF00u;
  return lo | hi;
}

inline int Clip255i(int v) { return v < 0 ? 0 : (v > 255 ? 255 : v); }

inline uint32_t SelectPred(uint32_t t, uint32_t l, uint32_t tl) {
  int pa_minus_pb = 0;
  for (int s = 0; s < 32; s += 8) {
    const int ac = (int)((t >> s) & 0xFF) - (int)((tl >> s) & 0xFF);
    const int bc = (int)((l >> s) & 0xFF) - (int)((tl >> s) & 0xFF);
    pa_minus_pb += (bc < 0 ? -bc : bc) - (ac < 0 ? -ac : ac);
  }
  return pa_minus_pb <= 0 ? t : l;
}

inline uint32_t ClampAddSubFull(uint32_t l, uint32_t t, uint32_t tl) {
  uint32_t out = 0;
  for (int s = 0; s < 32; s += 8) {
    const int v = (int)((l >> s) & 0xFF) + (int)((t >> s) & 0xFF) -
                  (int)((tl >> s) & 0xFF);
    out |= (uint32_t)Clip255i(v) << s;
  }
  return out;
}

inline uint32_t ClampAddSubHalf(uint32_t l, uint32_t t, uint32_t tl) {
  const uint32_t avg = Avg2(l, t);
  uint32_t out = 0;
  for (int s = 0; s < 32; s += 8) {
    const int va = (int)((avg >> s) & 0xFF), vc = (int)((tl >> s) & 0xFF);
    const int d = va - vc;
    const int ad = d < 0 ? -d : d;
    const int v = va + (d >= 0 ? ad / 2 : -(ad / 2));
    out |= (uint32_t)Clip255i(v) << s;
  }
  return out;
}

void PredictorInverse(std::vector<uint32_t>& img, long w, long h, int bits,
                      const std::vector<uint32_t>& tiles) {
  const long tx = SubSampleSize(w, bits);
  // Row 0: pixel 0 black predictor, rest Left.
  img[0] = AddPixels(img[0], 0xFF000000u);
  for (long x = 1; x < w; ++x) img[(size_t)x] = AddPixels(img[(size_t)x], img[(size_t)x - 1]);
  const long tile = 1L << bits;
  for (long y = 1; y < h; ++y) {
    uint32_t* cur = img.data() + y * w;
    const uint32_t* top = cur - w;
    const uint32_t* mrow = tiles.data() + (y >> bits) * tx;
    cur[0] = AddPixels(cur[0], top[0]);  // col 0: Top
    // Tile-span inner loops: the mode is constant across a tile row, so
    // hoist the 14-way dispatch out of the per-pixel loop.
    for (long x0 = 1; x0 < w;) {
      const long x1 = std::min(((x0 >> bits) + 1) * tile, w);
      const int mode = (int)((mrow[(size_t)(x0 >> bits)] >> 8) & 0xF);
      auto span = [&](auto pf) {
        for (long x = x0; x < x1; ++x) {
          const uint32_t tr = (x + 1 < w) ? top[x + 1] : cur[0];
          cur[x] = AddPixels(cur[x], pf(cur[x - 1], top[x], top[x - 1], tr));
        }
      };
      switch (mode) {
        case 0: span([](uint32_t, uint32_t, uint32_t, uint32_t) {
          return 0xFF000000u; }); break;
        case 1: span([](uint32_t l, uint32_t, uint32_t, uint32_t) {
          return l; }); break;
        case 2: span([](uint32_t, uint32_t t, uint32_t, uint32_t) {
          return t; }); break;
        case 3: span([](uint32_t, uint32_t, uint32_t, uint32_t tr) {
          return tr; }); break;
        case 4: span([](uint32_t, uint32_t, uint32_t tl, uint32_t) {
          return tl; }); break;
        case 5: span([](uint32_t l, uint32_t t, uint32_t, uint32_t tr) {
          return Avg2(Avg2(l, tr), t); }); break;
        case 6: span([](uint32_t l, uint32_t, uint32_t tl, uint32_t) {
          return Avg2(l, tl); }); break;
        case 7: span([](uint32_t l, uint32_t t, uint32_t, uint32_t) {
          return Avg2(l, t); }); break;
        case 8: span([](uint32_t, uint32_t t, uint32_t tl, uint32_t) {
          return Avg2(tl, t); }); break;
        case 9: span([](uint32_t, uint32_t t, uint32_t, uint32_t tr) {
          return Avg2(t, tr); }); break;
        case 10: span([](uint32_t l, uint32_t t, uint32_t tl, uint32_t tr) {
          return Avg2(Avg2(l, tl), Avg2(t, tr)); }); break;
        case 11: span([](uint32_t l, uint32_t t, uint32_t tl, uint32_t) {
          return SelectPred(t, l, tl); }); break;
        case 12: span([](uint32_t l, uint32_t t, uint32_t tl, uint32_t) {
          return ClampAddSubFull(l, t, tl); }); break;
        case 13: span([](uint32_t l, uint32_t t, uint32_t tl, uint32_t) {
          return ClampAddSubHalf(l, t, tl); }); break;
        default: span([](uint32_t, uint32_t, uint32_t, uint32_t) {
          return 0xFF000000u; }); break;
      }
      x0 = x1;
    }
  }
}

void ColorSpaceInverse(std::vector<uint32_t>& img, long w, long h, int bits,
                       const std::vector<uint32_t>& tiles) {
  const long tx = SubSampleSize(w, bits);
  const long tile = 1L << bits;
  for (long y = 0; y < h; ++y) {
    uint32_t* row = img.data() + y * w;
    const uint32_t* trow = tiles.data() + (y >> bits) * tx;
    // Multipliers are constant across each tile span; hoist them.
    for (long x0 = 0; x0 < w;) {
      const long x1 = std::min(((x0 >> bits) + 1) * tile, w);
      const uint32_t m = trow[(size_t)(x0 >> bits)];
      const int g2r = (int8_t)(m & 0xFF);
      const int g2b = (int8_t)((m >> 8) & 0xFF);
      const int r2b = (int8_t)((m >> 16) & 0xFF);
      for (long x = x0; x < x1; ++x) {
        const uint32_t px = row[x];
        const int green = (int8_t)((px >> 8) & 0xFF);
        int red = (int)((px >> 16) & 0xFF);
        int blue = (int)(px & 0xFF);
        red = (red + ((g2r * green) >> 5)) & 0xFF;
        blue = blue + ((g2b * green) >> 5);
        const int red_s = (int8_t)red;
        blue = (blue + ((r2b * red_s) >> 5)) & 0xFF;
        row[x] = (px & 0xFF00FF00u) | ((uint32_t)red << 16) | (uint32_t)blue;
      }
      x0 = x1;
    }
  }
}

void AddGreenInverse(std::vector<uint32_t>& img) {
  for (uint32_t& px : img) {
    const uint32_t g = (px >> 8) & 0xFF;
    const uint32_t r = (((px >> 16) & 0xFF) + g) & 0xFF;
    const uint32_t b = ((px & 0xFF) + g) & 0xFF;
    px = (px & 0xFF00FF00u) | (r << 16) | b;
  }
}

// --------------------------- decoder state --------------------------------

struct Transform {
  int type;
  long xsize, ysize;
  int bits = 0;
  std::vector<uint32_t> data;
};

struct Decoder {
  BitReader br;
  long width = 0, height = 0;
  int has_alpha = 0;
  std::vector<Transform> transforms;
  int transforms_seen = 0;
  int recursion = 0;
  // per-stream:
  std::vector<std::vector<HuffTable>> groups;  // each: 5 tables
  std::vector<uint16_t> huffman_image;
  int huffman_bits = 0;
  long huffman_xsize = 0;
  int cache_bits = 0;

  int err = 0;  // sticky error code

  int ReadHuffmanCode(int alphabet, HuffTable* t);
  int ReadCodeLengths(const HuffTable& cl, int num_symbols,
                      std::vector<int>* lengths);
  int ReadHuffmanCodes(long xsize, long ysize, int cbits, bool allow_rec);
  long StreamHeader(long xsize, long ysize, bool is_level0);
  int ReadTransform(long* xsize, long ysize);
  int DecodeSubImage(long xsize, long ysize, std::vector<uint32_t>* out);
  int DecodeImageData(long w, long h, std::vector<uint32_t>* out);
};

int Decoder::ReadHuffmanCode(int alphabet, HuffTable* t) {
  const int simple = (int)br.ReadBits(1);
  std::vector<int> lengths((size_t)alphabet, 0);
  if (simple == 1) {
    const int num_symbols = (int)br.ReadBits(1) + 1;
    const int first_8bit = (int)br.ReadBits(1);
    const int sym0 = (int)br.ReadBits(first_8bit ? 8 : 1);
    if (sym0 >= alphabet) return -2;
    lengths[(size_t)sym0] = 1;
    if (num_symbols == 2) {
      const int sym1 = (int)br.ReadBits(8);
      if (sym1 >= alphabet) return -2;
      lengths[(size_t)sym1] = 1;
    }
    return BuildHuffTable(lengths, t) ? 0 : -2;
  }
  const int num_codes = (int)br.ReadBits(4) + 4;
  if (num_codes > kClCodes) return -2;
  std::vector<int> cl_lengths(kClCodes, 0);
  for (int i = 0; i < num_codes; ++i)
    cl_lengths[kClcOrder[i]] = (int)br.ReadBits(3);
  HuffTable cl;
  if (!BuildHuffTable(cl_lengths, &cl)) return -2;
  if (ReadCodeLengths(cl, alphabet, &lengths)) return -2;
  return BuildHuffTable(lengths, t) ? 0 : -2;
}

int Decoder::ReadCodeLengths(const HuffTable& cl, int num_symbols,
                             std::vector<int>* lengths) {
  int prev_len = 8;
  long max_symbol = num_symbols;
  if (br.ReadBits(1) == 1) {
    const int length_nbits = 2 + 2 * (int)br.ReadBits(3);
    max_symbol = 2 + (long)br.ReadBits(length_nbits);
    if (max_symbol > num_symbols) return -2;
  }
  long symbol = 0;
  long remaining = max_symbol;
  while (symbol < num_symbols) {
    if (remaining == 0) break;
    --remaining;
    const int code_len = cl.Read(&br);
    if (code_len < 16) {
      (*lengths)[(size_t)symbol++] = code_len;
      if (code_len) prev_len = code_len;
    } else {
      const int slot = code_len - 16;
      if (slot > 2) return -2;
      const long repeat =
          (long)br.ReadBits(kClExtraBits[slot]) + kClRepeatOffsets[slot];
      if (symbol + repeat > num_symbols) return -2;
      const int fill = code_len == 16 ? prev_len : 0;
      for (long i = 0; i < repeat; ++i) (*lengths)[(size_t)symbol++] = fill;
    }
  }
  if (br.eos) return -3;
  return 0;
}

int Decoder::ReadHuffmanCodes(long xsize, long ysize, int cbits,
                              bool allow_rec) {
  long num_groups = 1;
  if (allow_rec && br.ReadBits(1) == 1) {
    const int bits = 2 + (int)br.ReadBits(3);
    const long sw = SubSampleSize(xsize, bits);
    const long sh = SubSampleSize(ysize, bits);
    std::vector<uint32_t> img;
    if (int e = DecodeSubImage(sw, sh, &img)) return e;
    huffman_image.resize(img.size());
    long mx = 0;
    for (size_t i = 0; i < img.size(); ++i) {
      const long m = (long)((img[i] >> 8) & 0xFFFF);
      huffman_image[i] = (uint16_t)m;
      mx = std::max(mx, m);
    }
    num_groups = mx + 1;
    huffman_bits = bits;
    huffman_xsize = sw;
  } else {
    huffman_image.clear();
    huffman_bits = 0;
    huffman_xsize = 0;
  }
  if (num_groups > 65536) return -2;
  groups.assign((size_t)num_groups, {});
  for (auto& g : groups) {
    g.resize(5);
    for (int i = 0; i < 5; ++i) {
      int alphabet;
      if (i == 0)
        alphabet = kNumLiteral + kNumLength + (cbits ? 1 << cbits : 0);
      else if (i == 4)
        alphabet = kNumDistance;
      else
        alphabet = 256;
      if (int e = ReadHuffmanCode(alphabet, &g[(size_t)i])) return e;
    }
  }
  return 0;
}

int Decoder::ReadTransform(long* xsize, long ysize) {
  const int ttype = (int)br.ReadBits(2);
  if (transforms_seen & (1 << ttype)) return -2;
  transforms_seen |= 1 << ttype;
  Transform t;
  t.type = ttype;
  t.xsize = *xsize;
  t.ysize = ysize;
  if (ttype == 0 || ttype == 1) {  // predictor / cross-color
    t.bits = 2 + (int)br.ReadBits(3);
    const long sw = SubSampleSize(*xsize, t.bits);
    const long sh = SubSampleSize(ysize, t.bits);
    if (int e = DecodeSubImage(sw, sh, &t.data)) return e;
  } else if (ttype == 3) {  // color indexing
    const int num_colors = (int)br.ReadBits(8) + 1;
    if (num_colors > 16) t.bits = 0;
    else if (num_colors > 4) t.bits = 1;
    else if (num_colors > 2) t.bits = 2;
    else t.bits = 3;
    *xsize = SubSampleSize(*xsize, t.bits);
    std::vector<uint32_t> pal;
    if (int e = DecodeSubImage(num_colors, 1, &pal)) return e;
    // Delta-coded per byte channel.
    uint32_t acc[4] = {0, 0, 0, 0};
    for (auto& px : pal) {
      uint32_t out = 0;
      for (int c = 0; c < 4; ++c) {
        acc[c] = (acc[c] + ((px >> (8 * c)) & 0xFF)) & 0xFF;
        out |= acc[c] << (8 * c);
      }
      px = out;
    }
    t.data.swap(pal);
  }
  transforms.push_back(std::move(t));
  return 0;
}

long Decoder::StreamHeader(long xsize, long ysize, bool is_level0) {
  long tw = xsize;
  if (is_level0) {
    while (br.ReadBits(1) == 1) {
      if (int e = ReadTransform(&tw, ysize)) {
        err = e;
        return -1;
      }
      if (br.eos) {
        err = -3;
        return -1;
      }
    }
  }
  int cbits = 0;
  if (br.ReadBits(1) == 1) {
    cbits = (int)br.ReadBits(4);
    if (cbits < 1 || cbits > 11) {
      err = -2;
      return -1;
    }
  }
  if (int e = ReadHuffmanCodes(tw, ysize, cbits, is_level0)) {
    err = e;
    return -1;
  }
  cache_bits = cbits;
  return tw;
}

int Decoder::DecodeSubImage(long xsize, long ysize,
                            std::vector<uint32_t>* out) {
  if (++recursion > 2) return -2;
  auto saved_groups = std::move(groups);
  auto saved_img = std::move(huffman_image);
  const int saved_bits = huffman_bits;
  const long saved_xsize = huffman_xsize;
  const int saved_cbits = cache_bits;
  huffman_image.clear();
  huffman_bits = 0;
  const long tw = StreamHeader(xsize, ysize, false);
  int e = tw < 0 ? err : DecodeImageData(xsize, ysize, out);
  groups = std::move(saved_groups);
  huffman_image = std::move(saved_img);
  huffman_bits = saved_bits;
  huffman_xsize = saved_xsize;
  cache_bits = saved_cbits;
  --recursion;
  return e;
}

int Decoder::DecodeImageData(long w, long h, std::vector<uint32_t>* out) {
  const long n = w * h;
  out->assign((size_t)n, 0);
  uint32_t* data = out->data();
  const int cbits = cache_bits;
  const long cache_size = cbits ? 1L << cbits : 0;
  std::vector<uint32_t> cache((size_t)cache_size, 0);
  const int cache_shift = cbits ? 32 - cbits : 0;
  const int len_code_limit = kNumLiteral + kNumLength;
  const long cache_limit = len_code_limit + cache_size;

  const int hbits = huffman_bits;
  const long hxsize = huffman_xsize;
  const long mask = hbits ? (1L << hbits) - 1 : ~0L;

  const std::vector<HuffTable>* group = &groups[0];
  long pos = 0, col = 0, row = 0;
  while (pos < n) {
    if (hbits && (col & mask) == 0) {
      const long idx = huffman_image[(size_t)((row >> hbits) * hxsize +
                                              (col >> hbits))];
      group = (size_t)idx < groups.size() ? &groups[(size_t)idx] : &groups[0];
    }
    const int g = (*group)[0].Read(&br);
    if (g < kNumLiteral) {
      // One refill covers red (<= 15 bits past a fresh Fill); top up
      // once in the middle so blue+alpha (<= 30 more) stay in-window.
      // (The explicit Fill matters when the green table was
      // single-symbol: its Read consumed nothing and skipped filling.)
      br.Fill();
      const int red = (*group)[1].ReadNF(&br);
      if (br.bit_pos > 34) br.Fill();
      const int blue = (*group)[2].ReadNF(&br);
      const int alpha = (*group)[3].ReadNF(&br);
      const uint32_t px = ((uint32_t)alpha << 24) | ((uint32_t)red << 16) |
                          ((uint32_t)g << 8) | (uint32_t)blue;
      data[pos] = px;
      if (cbits) cache[(0x1E35A7BDu * px) >> cache_shift] = px;
      ++pos;
      if (++col >= w) {
        col = 0;
        ++row;
      }
    } else if (g < len_code_limit) {
      const uint32_t length = GetCopyDistance(g - kNumLiteral, &br);
      const int dsym = (*group)[4].Read(&br);
      if (dsym < 0 || dsym >= kNumDistance) return -2;
      const long dist = PlaneCodeToDistance(w, GetCopyDistance(dsym, &br));
      if (dist > pos || (long)length > n - pos) return -2;
      if (cbits) {
        for (uint32_t i = 0; i < length; ++i) {
          const uint32_t px = data[pos - dist];
          data[pos] = px;
          cache[(0x1E35A7BDu * px) >> cache_shift] = px;
          ++pos;
        }
      } else {
        for (uint32_t i = 0; i < length; ++i) {
          data[pos] = data[pos - dist];
          ++pos;
        }
      }
      col = pos % w;
      row = pos / w;
      if (hbits && (col & mask) != 0 && pos < n) {
        const long idx = huffman_image[(size_t)((row >> hbits) * hxsize +
                                                (col >> hbits))];
        group = (size_t)idx < groups.size() ? &groups[(size_t)idx]
                                            : &groups[0];
      }
    } else if (g < cache_limit) {
      data[pos] = cache[(size_t)(g - len_code_limit)];
      ++pos;
      if (++col >= w) {
        col = 0;
        ++row;
      }
    } else {
      return -2;
    }
    if (br.eos) return -3;
  }
  return 0;
}

}  // namespace

extern "C" {

// Decodes a VP8L payload (starting at the 0x2F signature byte) into
// ARGB u32 out[w*h]. Returns 0, or a negative error (-1 signature,
// -2 malformed, -3 truncated, -4 capacity).
int vp8l_decode(const uint8_t* payload, long size, uint32_t* out,
                long cap_px, int* out_w, int* out_h, int* out_has_alpha) {
  if (size < 5 || payload[0] != 0x2F) return -1;
  Decoder d;
  d.br.Init(payload + 1, size - 1);
  d.width = (long)d.br.ReadBits(14) + 1;
  d.height = (long)d.br.ReadBits(14) + 1;
  d.has_alpha = (int)d.br.ReadBits(1);
  if (d.br.ReadBits(3) != 0) return -1;
  *out_w = (int)d.width;
  *out_h = (int)d.height;
  *out_has_alpha = d.has_alpha;
  if (d.width * d.height > cap_px) return -4;

  const long tw = d.StreamHeader(d.width, d.height, true);
  if (tw < 0) return d.err;
  std::vector<uint32_t> data;
  if (int e = d.DecodeImageData(tw, d.height, &data)) return e;

  // Inverse transforms in reverse order.
  long cur_w = tw;
  for (auto it = d.transforms.rbegin(); it != d.transforms.rend(); ++it) {
    const Transform& t = *it;
    if (t.type == 2) {
      AddGreenInverse(data);
    } else if (t.type == 0) {
      PredictorInverse(data, cur_w, d.height, t.bits, t.data);
    } else if (t.type == 1) {
      ColorSpaceInverse(data, cur_w, d.height, t.bits, t.data);
    } else if (t.type == 3) {
      // Color indexing: palette lookup + unbundle.
      const long out_w2 = t.xsize;
      std::vector<uint32_t> expanded((size_t)(out_w2 * d.height), 0);
      const int bits = t.bits;
      const long npal = (long)t.data.size();
      if (bits == 0) {
        for (long i = 0; i < (long)data.size(); ++i) {
          const long idx = (long)((data[(size_t)i] >> 8) & 0xFF);
          expanded[(size_t)i] = idx < npal ? t.data[(size_t)idx] : 0;
        }
      } else {
        const int ppb = 1 << bits;       // pixels per byte
        const int bpp = 8 >> bits;       // bits per pixel
        const int m = (1 << bpp) - 1;
        for (long y = 0; y < d.height; ++y) {
          for (long x = 0; x < cur_w; ++x) {
            const uint32_t packed = (data[(size_t)(y * cur_w + x)] >> 8) & 0xFF;
            for (int k = 0; k < ppb; ++k) {
              const long ox = x * ppb + k;
              if (ox >= out_w2) break;
              const long idx = (packed >> (k * bpp)) & m;
              expanded[(size_t)(y * out_w2 + ox)] =
                  idx < npal ? t.data[(size_t)idx] : 0;
            }
          }
        }
      }
      data.swap(expanded);
      cur_w = out_w2;
    }
  }
  if ((long)data.size() != d.width * d.height) return -2;
  std::memcpy(out, data.data(), data.size() * 4);
  return 0;
}

}  // extern "C"
