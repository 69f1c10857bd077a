// VP8 keyframe decoder (native fast path).
//
// Mirrors webp_tpu_torch/lossy/decode.py byte-for-byte (the Python/numpy decoder
// is the conformance oracle, itself differentially tested against libwebp).
// Spec constant tables are passed in from Python to keep one source of truth.

#include <cstdint>
#include <cstring>
#include <cstdio>
#include <cstdlib>
#include <vector>

#include "bitio.h"

namespace webptpu {

static const uint8_t kBands[17] = {0, 1, 2, 3, 6, 4, 5, 6, 6,
                                   6, 6, 6, 6, 6, 6, 7, 0};
static const uint8_t kZigzag[16] = {0, 1, 4, 8, 5, 2, 3, 6,
                                    9, 12, 13, 10, 7, 11, 14, 15};
static const uint8_t kCat3[] = {173, 148, 140};
static const uint8_t kCat4[] = {176, 155, 140, 135};
static const uint8_t kCat5[] = {180, 157, 141, 134, 130};
static const uint8_t kCat6[] = {254, 254, 243, 230, 196, 177,
                                153, 140, 133, 130, 129};
static const uint8_t* kCats[4] = {kCat3, kCat4, kCat5, kCat6};
static const int kCatLens[4] = {3, 4, 5, 11};

struct Tables {
  const uint8_t* coeffs_proba0;   // [4][8][3][11]
  const uint8_t* update_proba;    // [4][8][3][11]
  const int32_t* dc_table;        // [128]
  const int32_t* ac_table;        // [128]
  const uint8_t* bmode_proba;     // [10][10][9]
  const int8_t* ymodes_tree;      // [18]
};

static inline int clampi(int v, int lo, int hi) {
  return v < lo ? lo : (v > hi ? hi : v);
}

struct QuantMatrix {
  int y1_dc, y1_ac, y2_dc, y2_ac, uv_dc, uv_ac;
};

struct FilterInfo {
  int limit = 0, ilevel = 0, hev = 0;
  bool inner = false;
};

struct Decoder {
  Tables t;
  const uint8_t* data;
  size_t n;
  int width = 0, height = 0, mb_w = 0, mb_h = 0;
  // Headers.
  bool use_segment = false, update_map = false, absolute_delta = true;
  int seg_quant[4] = {0, 0, 0, 0};
  int seg_filter[4] = {0, 0, 0, 0};
  int segment_probs[3] = {255, 255, 255};
  bool filter_simple = false;
  int filter_level = 0, filter_sharpness = 0, filter_type = 0;
  bool use_lf_delta = false;
  int ref_lf_delta[4] = {0, 0, 0, 0};
  int mode_lf_delta[4] = {0, 0, 0, 0};
  QuantMatrix dqm[4];
  uint8_t proba[4 * 8 * 3 * 11];
  bool use_skip = false;
  int skip_p = 0;
  std::vector<BoolReader> parts;
  int num_parts = 1;
  BoolReader* br = nullptr;
  std::vector<uint8_t> br_store;

  // Per-MB state.
  std::vector<uint8_t> segment, skip, is_i4, uvmode;
  std::vector<uint8_t> imodes;  // [nmb*16]
  std::vector<int16_t> coeffs;  // per-row: [mb_w*24*16] reused
  // Planes (mb-padded).
  uint8_t *Y, *U, *V;
  int ys, uvs;  // strides

  bool error = false;
};

static inline const uint8_t* P(const Decoder& d, int t_, int b, int c) {
  return d.proba + ((t_ * 8 + b) * 3 + c) * 11;
}

static int ReadOptSigned(BoolReader& br, int nbits) {
  if (!br.get_bit(0x80)) return 0;
  int v = br.get_value(nbits);
  return br.get_bit(0x80) ? -v : v;
}

static bool ParseHeaders(Decoder& d) {
  const uint8_t* data = d.data;
  if (d.n < 10) return false;
  uint32_t bits = data[0] | (data[1] << 8) | (data[2] << 16);
  if (bits & 1) return false;           // not keyframe
  if (((bits >> 1) & 7) > 3) return false;
  if (!((bits >> 4) & 1)) return false;
  uint32_t part0_len = bits >> 5;
  if (data[3] != 0x9D || data[4] != 0x01 || data[5] != 0x2A) return false;
  d.width = (data[6] | (data[7] << 8)) & 0x3FFF;
  d.height = (data[8] | (data[9] << 8)) & 0x3FFF;
  if (!d.width || !d.height) return false;
  d.mb_w = (d.width + 15) >> 4;
  d.mb_h = (d.height + 15) >> 4;
  const uint8_t* buf = data + 10;
  size_t buf_n = d.n - 10;
  if (part0_len > buf_n) return false;
  d.br_store.assign(buf, buf + part0_len);
  static thread_local BoolReader* dummy;
  (void)dummy;
  d.parts.clear();
  BoolReader br(d.br_store.data(), d.br_store.size());

  br.get_bit(0x80);  // colorspace
  br.get_bit(0x80);  // clamp
  d.use_segment = br.get_bit(0x80);
  if (d.use_segment) {
    d.update_map = br.get_bit(0x80);
    if (br.get_bit(0x80)) {
      d.absolute_delta = br.get_bit(0x80);
      for (int s = 0; s < 4; ++s) d.seg_quant[s] = ReadOptSigned(br, 7);
      for (int s = 0; s < 4; ++s) d.seg_filter[s] = ReadOptSigned(br, 6);
    }
    if (d.update_map) {
      for (int s = 0; s < 3; ++s)
        d.segment_probs[s] = br.get_bit(0x80) ? br.get_value(8) : 255;
    }
  }
  d.filter_simple = br.get_bit(0x80);
  d.filter_level = br.get_value(6);
  d.filter_sharpness = br.get_value(3);
  d.use_lf_delta = br.get_bit(0x80);
  if (d.use_lf_delta) {
    if (br.get_bit(0x80)) {
      for (int i = 0; i < 4; ++i)
        if (br.get_bit(0x80)) {
          int v = br.get_value(6);
          d.ref_lf_delta[i] = br.get_bit(0x80) ? -v : v;
        }
      for (int i = 0; i < 4; ++i)
        if (br.get_bit(0x80)) {
          int v = br.get_value(6);
          d.mode_lf_delta[i] = br.get_bit(0x80) ? -v : v;
        }
    }
  }
  d.filter_type = d.filter_level == 0 ? 0 : (d.filter_simple ? 1 : 2);

  int num_parts = 1 << br.get_value(2);
  d.num_parts = num_parts;
  const uint8_t* tok = buf + part0_len;
  size_t tok_n = buf_n - part0_len;
  int last = num_parts - 1;
  if (tok_n < (size_t)(3 * last)) return false;
  const uint8_t* start = tok + 3 * last;
  size_t off = 0, avail = tok_n - 3 * last;
  for (int p = 0; p < last; ++p) {
    size_t psize = tok[p * 3] | (tok[p * 3 + 1] << 8) | (tok[p * 3 + 2] << 16);
    if (off + psize > avail) return false;
    d.parts.emplace_back(start + off, psize);
    off += psize;
  }
  d.parts.emplace_back(start + off, avail - off);

  // Quant.
  int base_q = br.get_value(7);
  int dq_y1_dc = ReadOptSigned(br, 4);
  int dq_y2_dc = ReadOptSigned(br, 4);
  int dq_y2_ac = ReadOptSigned(br, 4);
  int dq_uv_dc = ReadOptSigned(br, 4);
  int dq_uv_ac = ReadOptSigned(br, 4);
  for (int s = 0; s < 4; ++s) {
    int q;
    if (d.use_segment) {
      q = d.seg_quant[s];
      if (!d.absolute_delta) q += base_q;
    } else {
      q = base_q;
    }
    QuantMatrix& m = d.dqm[s];
    m.y1_dc = d.t.dc_table[clampi(q + dq_y1_dc, 0, 127)];
    m.y1_ac = d.t.ac_table[clampi(q, 0, 127)];
    m.y2_dc = d.t.dc_table[clampi(q + dq_y2_dc, 0, 127)] * 2;
    m.y2_ac = (d.t.ac_table[clampi(q + dq_y2_ac, 0, 127)] * 101581) >> 16;
    if (m.y2_ac < 8) m.y2_ac = 8;
    m.uv_dc = d.t.dc_table[clampi(q + dq_uv_dc, 0, 117)];
    m.uv_ac = d.t.ac_table[clampi(q + dq_uv_ac, 0, 127)];
  }

  br.get_bit(0x80);  // update_proba
  for (int i = 0; i < 4 * 8 * 3 * 11; ++i)
    d.proba[i] = br.get_bit(d.t.update_proba[i]) ? (uint8_t)br.get_value(8)
                                                 : d.t.coeffs_proba0[i];
  d.use_skip = br.get_bit(0x80);
  d.skip_p = d.use_skip ? br.get_value(8) : 0;

  // Mode records for all MBs (keyframe layout: trailing part of partition 0).
  int nmb = d.mb_w * d.mb_h;
  d.segment.assign(nmb, 0);
  d.skip.assign(nmb, 0);
  d.is_i4.assign(nmb, 0);
  d.uvmode.assign(nmb, 0);
  d.imodes.assign((size_t)nmb * 16, 0);
  std::vector<uint8_t> top(d.mb_w * 4, 0);
  uint8_t left[4] = {0, 0, 0, 0};
  for (int y = 0; y < d.mb_h; ++y) {
    memset(left, 0, 4);
    for (int x = 0; x < d.mb_w; ++x) {
      int mb = y * d.mb_w + x;
      if (d.update_map) {
        int seg;
        if (!br.get_bit(d.segment_probs[0]))
          seg = br.get_bit(d.segment_probs[1]);
        else
          seg = 2 + br.get_bit(d.segment_probs[2]);
        d.segment[mb] = (uint8_t)seg;
      }
      if (d.use_skip) d.skip[mb] = (uint8_t)br.get_bit(d.skip_p);
      if (!br.get_bit(145)) {
        d.is_i4[mb] = 1;
        for (int by = 0; by < 4; ++by) {
          int ymode = left[by];
          for (int bx = 0; bx < 4; ++bx) {
            const uint8_t* prob =
                d.t.bmode_proba + (top[x * 4 + bx] * 10 + ymode) * 9;
            int i = d.t.ymodes_tree[br.get_bit(prob[0])];
            while (i > 0) i = d.t.ymodes_tree[2 * i + br.get_bit(prob[i])];
            ymode = -i;
            top[x * 4 + bx] = (uint8_t)ymode;
            d.imodes[(size_t)mb * 16 + by * 4 + bx] = (uint8_t)ymode;
          }
          left[by] = (uint8_t)ymode;
        }
      } else {
        int ymode;
        if (br.get_bit(156))
          ymode = br.get_bit(128) ? 1 : 3;  // TM : H
        else
          ymode = br.get_bit(163) ? 2 : 0;  // V : DC
        d.imodes[(size_t)mb * 16] = (uint8_t)ymode;
        for (int k = 0; k < 4; ++k) top[x * 4 + k] = (uint8_t)ymode;
        for (int k = 0; k < 4; ++k) left[k] = (uint8_t)ymode;
      }
      int uv;
      if (!br.get_bit(142))
        uv = 0;
      else if (!br.get_bit(114))
        uv = 2;
      else
        uv = br.get_bit(183) ? 1 : 3;
      d.uvmode[mb] = (uint8_t)uv;
    }
  }
  return true;
}

// --- Coefficients ---------------------------------------------------------

static int GetCoeffs(BoolReader& br, const Decoder& d, int ptype, int ctx,
                     int dq0, int dq1, int n, int16_t* out) {
  const uint8_t* p = P(d, ptype, kBands[n], ctx);
  while (n < 16) {
    if (!br.get_bit(p[0])) return n;
    while (!br.get_bit(p[1])) {
      n++;
      if (n == 16) return 16;
      p = P(d, ptype, kBands[n], 0);
    }
    int v, next_ctx;
    if (!br.get_bit(p[2])) {
      v = 1;
      next_ctx = 1;
    } else {
      if (!br.get_bit(p[3])) {
        v = br.get_bit(p[4]) ? 3 + br.get_bit(p[5]) : 2;
      } else if (!br.get_bit(p[6])) {
        if (!br.get_bit(p[7]))
          v = 5 + br.get_bit(159);
        else {
          v = 7 + 2 * br.get_bit(165);
          v += br.get_bit(145);
        }
      } else {
        int bit1 = br.get_bit(p[8]);
        int bit0 = br.get_bit(p[9 + bit1]);
        int cat = 2 * bit1 + bit0;
        v = 0;
        for (int i = 0; i < kCatLens[cat]; ++i)
          v = v + v + br.get_bit(kCats[cat][i]);
        v += 3 + (8 << cat);
      }
      next_ctx = 2;
    }
    int dq = (n == 0) ? dq0 : dq1;
    int sv = br.get_bit(0x80) ? -v : v;
    out[kZigzag[n]] = (int16_t)(sv * dq);
    n++;
    if (n == 16) return 16;
    p = P(d, ptype, kBands[n], next_ctx);
  }
  return 16;
}

static void TransformWHT(const int16_t* in, int16_t* out /*[16 blocks][16]*/) {
  int tmp[16];
  for (int i = 0; i < 4; ++i) {
    int a0 = in[0 + i] + in[12 + i];
    int a1 = in[4 + i] + in[8 + i];
    int a2 = in[4 + i] - in[8 + i];
    int a3 = in[0 + i] - in[12 + i];
    tmp[0 + i] = a0 + a1;
    tmp[8 + i] = a0 - a1;
    tmp[4 + i] = a3 + a2;
    tmp[12 + i] = a3 - a2;
  }
  for (int i = 0; i < 4; ++i) {
    int dc = tmp[i * 4 + 0] + 3;
    int a0 = dc + tmp[i * 4 + 3];
    int a1 = tmp[i * 4 + 1] + tmp[i * 4 + 2];
    int a2 = tmp[i * 4 + 1] - tmp[i * 4 + 2];
    int a3 = dc - tmp[i * 4 + 3];
    out[(i * 4 + 0) * 16] = (int16_t)((a0 + a1) >> 3);
    out[(i * 4 + 1) * 16] = (int16_t)((a3 + a2) >> 3);
    out[(i * 4 + 2) * 16] = (int16_t)((a0 - a1) >> 3);
    out[(i * 4 + 3) * 16] = (int16_t)((a3 - a2) >> 3);
  }
}

// --- IDCT + add ------------------------------------------------------------

static inline uint8_t clip8(int v) { return (uint8_t)(v < 0 ? 0 : v > 255 ? 255 : v); }
#define MUL1(a) ((((a) * 20091) >> 16) + (a))
#define MUL2(a) (((a) * 35468) >> 16)

static void IDCTAdd(const int16_t* in, uint8_t* dst, int stride) {
  int tmp[16];
  for (int i = 0; i < 4; ++i) {
    int a = in[i] + in[8 + i];
    int b = in[i] - in[8 + i];
    int c = MUL2(in[4 + i]) - MUL1(in[12 + i]);
    int dd = MUL1(in[4 + i]) + MUL2(in[12 + i]);
    tmp[i] = a + dd;
    tmp[4 + i] = b + c;
    tmp[8 + i] = b - c;
    tmp[12 + i] = a - dd;
  }
  for (int r = 0; r < 4; ++r) {
    int dc = tmp[r * 4] + 4;
    int a = dc + tmp[r * 4 + 2];
    int b = dc - tmp[r * 4 + 2];
    int c = MUL2(tmp[r * 4 + 1]) - MUL1(tmp[r * 4 + 3]);
    int dd = MUL1(tmp[r * 4 + 1]) + MUL2(tmp[r * 4 + 3]);
    uint8_t* o = dst + r * stride;
    o[0] = clip8(o[0] + ((a + dd) >> 3));
    o[1] = clip8(o[1] + ((b + c) >> 3));
    o[2] = clip8(o[2] + ((b - c) >> 3));
    o[3] = clip8(o[3] + ((a - dd) >> 3));
  }
}

// DC-only inverse transform: every output pixel moves by (dc + 4) >> 3
// (the full IDCT of a DC-only block; the common case at mid/low quality).
static void IDCTAddDC(int dc, uint8_t* dst, int stride) {
  const int v = (dc + 4) >> 3;
  for (int r = 0; r < 4; ++r) {
    uint8_t* o = dst + r * stride;
    for (int c = 0; c < 4; ++c) o[c] = clip8(o[c] + v);
  }
}

// --- Prediction (operates directly on the padded planes) -------------------

struct Ctx {
  // Gathered neighbors with border rules applied.
  int top[20];   // top row (+4 topright for luma)
  int left[16];
  int tl;
  bool has_top, has_left;
};

static void GatherCtx(const uint8_t* plane, int stride, int x0, int y0,
                      int size, int mb_x, int mb_y, int mb_w, bool tr,
                      Ctx& c) {
  c.has_top = mb_y > 0;
  c.has_left = mb_x > 0;
  if (c.has_top) {
    const uint8_t* t = plane + (y0 - 1) * stride + x0;
    for (int i = 0; i < size; ++i) c.top[i] = t[i];
    if (tr) {
      if (mb_x >= mb_w - 1)
        for (int i = 0; i < 4; ++i) c.top[size + i] = t[size - 1];
      else
        for (int i = 0; i < 4; ++i) c.top[size + i] = t[size + i];
    }
    c.tl = c.has_left ? plane[(y0 - 1) * stride + x0 - 1] : 129;
  } else {
    for (int i = 0; i < size + (tr ? 4 : 0); ++i) c.top[i] = 127;
    c.tl = 127;
  }
  if (c.has_left) {
    for (int i = 0; i < size; ++i) c.left[i] = plane[(y0 + i) * stride + x0 - 1];
  } else {
    for (int i = 0; i < size; ++i) c.left[i] = 129;
  }
}

static void PredBlock(uint8_t* dst, int stride, const Ctx& c, int size,
                      int mode) {
  if (mode == 0) {  // DC with border variants
    int dc, shift = (size == 16) ? 5 : 4;
    if (c.has_top && c.has_left) {
      int s = size;
      for (int i = 0; i < size; ++i) s += c.top[i] + c.left[i];
      dc = s >> shift;
    } else if (c.has_top) {
      int s = size >> 1;
      for (int i = 0; i < size; ++i) s += c.top[i];
      dc = s >> (shift - 1);
    } else if (c.has_left) {
      int s = size >> 1;
      for (int i = 0; i < size; ++i) s += c.left[i];
      dc = s >> (shift - 1);
    } else {
      dc = 0x80;
    }
    for (int y = 0; y < size; ++y) memset(dst + y * stride, dc, size);
  } else if (mode == 2) {  // V
    for (int y = 0; y < size; ++y)
      for (int x = 0; x < size; ++x) dst[y * stride + x] = (uint8_t)c.top[x];
  } else if (mode == 3) {  // H
    for (int y = 0; y < size; ++y) memset(dst + y * stride, c.left[y], size);
  } else {  // TM
    for (int y = 0; y < size; ++y)
      for (int x = 0; x < size; ++x)
        dst[y * stride + x] = clip8(c.left[y] + c.top[x] - c.tl);
  }
}

static inline int avg2(int a, int b) { return (a + b + 1) >> 1; }
static inline int avg3(int a, int b, int c) { return (a + 2 * b + c + 2) >> 2; }

// 4x4 predictors; t/l/tl/tr from surrounding already-reconstructed pixels.
static void Pred4(uint8_t* o, int stride, int mode, const int* t, const int* l,
                  int tl, const int* tr) {
  int t0 = t[0], t1 = t[1], t2 = t[2], t3 = t[3];
  int l0 = l[0], l1 = l[1], l2 = l[2], l3 = l[3];
  int t4 = tr[0], t5 = tr[1], t6 = tr[2], t7 = tr[3];
  auto S = [&](int y, int x, int v) { o[y * stride + x] = (uint8_t)v; };
  switch (mode) {
    case 0: {  // B_DC
      int dc = (t0 + t1 + t2 + t3 + l0 + l1 + l2 + l3 + 4) >> 3;
      for (int y = 0; y < 4; ++y) memset(o + y * stride, dc, 4);
      break;
    }
    case 1:  // B_TM
      for (int y = 0; y < 4; ++y)
        for (int x = 0; x < 4; ++x) S(y, x, clip8(l[y] + t[x] - tl));
      break;
    case 2: {  // B_VE
      int v0 = avg3(tl, t0, t1), v1 = avg3(t0, t1, t2), v2 = avg3(t1, t2, t3),
          v3 = avg3(t2, t3, t4);
      for (int y = 0; y < 4; ++y) {
        S(y, 0, v0); S(y, 1, v1); S(y, 2, v2); S(y, 3, v3);
      }
      break;
    }
    case 3: {  // B_HE
      int v0 = avg3(tl, l0, l1), v1 = avg3(l0, l1, l2), v2 = avg3(l1, l2, l3),
          v3 = avg3(l2, l3, l3);
      for (int x = 0; x < 4; ++x) {
        S(0, x, v0); S(1, x, v1); S(2, x, v2); S(3, x, v3);
      }
      break;
    }
    case 4:  // B_RD
      S(3, 0, avg3(l3, l2, l1));
      S(2, 0, avg3(l2, l1, l0)); S(3, 1, avg3(l2, l1, l0));
      S(1, 0, avg3(l1, l0, tl)); S(2, 1, avg3(l1, l0, tl)); S(3, 2, avg3(l1, l0, tl));
      S(0, 0, avg3(l0, tl, t0)); S(1, 1, avg3(l0, tl, t0)); S(2, 2, avg3(l0, tl, t0)); S(3, 3, avg3(l0, tl, t0));
      S(0, 1, avg3(tl, t0, t1)); S(1, 2, avg3(tl, t0, t1)); S(2, 3, avg3(tl, t0, t1));
      S(0, 2, avg3(t0, t1, t2)); S(1, 3, avg3(t0, t1, t2));
      S(0, 3, avg3(t1, t2, t3));
      break;
    case 5:  // B_VR
      S(0, 0, avg2(tl, t0)); S(2, 1, avg2(tl, t0));
      S(0, 1, avg2(t0, t1)); S(2, 2, avg2(t0, t1));
      S(0, 2, avg2(t1, t2)); S(2, 3, avg2(t1, t2));
      S(0, 3, avg2(t2, t3));
      S(1, 0, avg3(l0, tl, t0)); S(3, 1, avg3(l0, tl, t0));
      S(1, 1, avg3(tl, t0, t1)); S(3, 2, avg3(tl, t0, t1));
      S(1, 2, avg3(t0, t1, t2)); S(3, 3, avg3(t0, t1, t2));
      S(1, 3, avg3(t1, t2, t3));
      S(2, 0, avg3(l1, l0, tl));
      S(3, 0, avg3(l2, l1, l0));
      break;
    case 6:  // B_LD
      S(0, 0, avg3(t0, t1, t2));
      S(0, 1, avg3(t1, t2, t3)); S(1, 0, avg3(t1, t2, t3));
      S(0, 2, avg3(t2, t3, t4)); S(1, 1, avg3(t2, t3, t4)); S(2, 0, avg3(t2, t3, t4));
      S(0, 3, avg3(t3, t4, t5)); S(1, 2, avg3(t3, t4, t5)); S(2, 1, avg3(t3, t4, t5)); S(3, 0, avg3(t3, t4, t5));
      S(1, 3, avg3(t4, t5, t6)); S(2, 2, avg3(t4, t5, t6)); S(3, 1, avg3(t4, t5, t6));
      S(2, 3, avg3(t5, t6, t7)); S(3, 2, avg3(t5, t6, t7));
      S(3, 3, avg3(t6, t7, t7));
      break;
    case 7:  // B_VL
      S(0, 0, avg2(t0, t1));
      S(0, 1, avg2(t1, t2)); S(2, 0, avg2(t1, t2));
      S(0, 2, avg2(t2, t3)); S(2, 1, avg2(t2, t3));
      S(0, 3, avg2(t3, t4)); S(2, 2, avg2(t3, t4));
      S(1, 0, avg3(t0, t1, t2));
      S(1, 1, avg3(t1, t2, t3)); S(3, 0, avg3(t1, t2, t3));
      S(1, 2, avg3(t2, t3, t4)); S(3, 1, avg3(t2, t3, t4));
      S(1, 3, avg3(t3, t4, t5)); S(3, 2, avg3(t3, t4, t5));
      S(2, 3, avg3(t4, t5, t6));
      S(3, 3, avg3(t5, t6, t7));
      break;
    case 8:  // B_HD
      S(0, 0, avg2(tl, l0));
      S(0, 1, avg3(l0, tl, t0));
      S(0, 2, avg3(tl, t0, t1));
      S(0, 3, avg3(t0, t1, t2));
      S(1, 0, avg2(l0, l1));
      S(1, 1, avg3(tl, l0, l1));
      S(1, 2, avg2(tl, l0));
      S(1, 3, avg3(l0, tl, t0));
      S(2, 0, avg2(l1, l2));
      S(2, 1, avg3(l0, l1, l2));
      S(2, 2, avg2(l0, l1));
      S(2, 3, avg3(tl, l0, l1));
      S(3, 0, avg2(l2, l3));
      S(3, 1, avg3(l1, l2, l3));
      S(3, 2, avg2(l1, l2));
      S(3, 3, avg3(l0, l1, l2));
      break;
    case 9:  // B_HU
      S(0, 0, avg2(l0, l1));
      S(0, 1, avg3(l0, l1, l2));
      S(0, 2, avg2(l1, l2));
      S(0, 3, avg3(l1, l2, l3));
      S(1, 0, avg2(l1, l2));
      S(1, 1, avg3(l1, l2, l3));
      S(1, 2, avg2(l2, l3));
      S(1, 3, avg3(l2, l3, l3));
      S(2, 0, avg2(l2, l3));
      S(2, 1, avg3(l2, l3, l3));
      S(2, 2, l3); S(2, 3, l3);
      S(3, 0, l3); S(3, 1, l3); S(3, 2, l3); S(3, 3, l3);
      break;
  }
}

// --- Loop filter ------------------------------------------------------------

static inline int sclip1(int v) { return v < -128 ? -128 : v > 127 ? 127 : v; }
static inline int sclip2(int v) { return v < -16 ? -16 : v > 15 ? 15 : v; }

static inline bool NeedsFilter(int p1, int p0, int q0, int q1, int t) {
  return 4 * abs(p0 - q0) + abs(p1 - q1) <= t;
}

static void DoFilter2(uint8_t* p, int step) {
  int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  int a = 3 * (q0 - p0) + sclip1(p1 - q1);
  int a1 = sclip2((a + 4) >> 3);
  int a2 = sclip2((a + 3) >> 3);
  p[-step] = clip8(p0 + a2);
  p[0] = clip8(q0 - a1);
}

static void DoFilter4(uint8_t* p, int step) {
  int p1 = p[-2 * step], p0 = p[-step], q0 = p[0], q1 = p[step];
  int a = 3 * (q0 - p0);
  int a1 = sclip2((a + 4) >> 3);
  int a2 = sclip2((a + 3) >> 3);
  int a3 = (a1 + 1) >> 1;
  p[-2 * step] = clip8(p1 + a3);
  p[-step] = clip8(p0 + a2);
  p[0] = clip8(q0 - a1);
  p[step] = clip8(q1 - a3);
}

static void DoFilter6(uint8_t* p, int step) {
  int p2 = p[-3 * step], p1 = p[-2 * step], p0 = p[-step];
  int q0 = p[0], q1 = p[step], q2 = p[2 * step];
  int a = sclip1(3 * (q0 - p0) + sclip1(p1 - q1));
  int a1 = (27 * a + 63) >> 7;
  int a2 = (18 * a + 63) >> 7;
  int a3 = (9 * a + 63) >> 7;
  p[-3 * step] = clip8(p2 + a3);
  p[-2 * step] = clip8(p1 + a2);
  p[-step] = clip8(p0 + a1);
  p[0] = clip8(q0 - a1);
  p[step] = clip8(q1 - a2);
  p[2 * step] = clip8(q2 - a3);
}

static void FilterLoop(uint8_t* base, int hstride, int vstride, int size,
                       int thresh, int ithresh, int hev_t, bool inner) {
  int thresh2 = 2 * thresh + 1;
  for (int i = 0; i < size; ++i) {
    uint8_t* p = base + i * vstride;
    int p3 = p[-4 * hstride], p2 = p[-3 * hstride], p1 = p[-2 * hstride],
        p0 = p[-hstride], q0 = p[0], q1 = p[hstride], q2 = p[2 * hstride],
        q3 = p[3 * hstride];
    if (!NeedsFilter(p1, p0, q0, q1, thresh2)) continue;
    if (abs(p3 - p2) > ithresh || abs(p2 - p1) > ithresh ||
        abs(p1 - p0) > ithresh || abs(q3 - q2) > ithresh ||
        abs(q2 - q1) > ithresh || abs(q1 - q0) > ithresh)
      continue;
    bool hev = abs(p1 - p0) > hev_t || abs(q1 - q0) > hev_t;
    if (hev)
      DoFilter2(p, hstride);
    else if (inner)
      DoFilter4(p, hstride);
    else
      DoFilter6(p, hstride);
  }
}

static void SimpleFilter(uint8_t* base, int hstride, int vstride, int size,
                         int thresh) {
  int thresh2 = 2 * thresh + 1;
  for (int i = 0; i < size; ++i) {
    uint8_t* p = base + i * vstride;
    int p1 = p[-2 * hstride], p0 = p[-hstride], q0 = p[0], q1 = p[hstride];
    if (NeedsFilter(p1, p0, q0, q1, thresh2)) DoFilter2(p, hstride);
  }
}

// --- SIMD normal loop filter (AVX2) -----------------------------------------
//
// The normal filter applies identical branchy per-pixel math across 16
// (luma) or 8+8 (U+V) lanes; lanes are independent, so the whole edge is
// one 16-lane int16 computation with per-lane mask blends. Horizontal
// edges read contiguous rows; vertical edges go through an 8x16 byte
// transpose. Bit-exact with the scalar filters above (asserted by
// vp8_filter_selftest), which remain the portable fallback.
#if defined(__AVX2__)
#include <immintrin.h>

namespace lf {

static inline __m256i C16(__m128i b) { return _mm256_cvtepu8_epi16(b); }
static inline __m128i P16(__m256i v) {
  return _mm256_castsi256_si128(
      _mm256_packus_epi16(v, _mm256_permute2x128_si256(v, v, 0x01)));
}
static inline __m256i Clamp(__m256i x, int lo, int hi) {
  return _mm256_max_epi16(_mm256_set1_epi16((short)lo),
                          _mm256_min_epi16(_mm256_set1_epi16((short)hi), x));
}

struct Edge {  // int16 lanes across the edge
  __m256i p3, p2, p1, p0, q0, q1, q2, q3;
};

static inline bool Core(Edge& e, int thresh, int ithresh, int hev_t,
                        bool inner) {
  const __m256i t2 = _mm256_set1_epi16((short)(2 * thresh + 1));
  const __m256i it = _mm256_set1_epi16((short)ithresh);
  const __m256i ht = _mm256_set1_epi16((short)hev_t);
  const __m256i dp1p0 = _mm256_abs_epi16(_mm256_sub_epi16(e.p1, e.p0));
  const __m256i dq1q0 = _mm256_abs_epi16(_mm256_sub_epi16(e.q1, e.q0));
  // NeedsFilter: 4*|p0-q0| + |p1-q1| <= 2*thresh+1.
  __m256i lhs = _mm256_add_epi16(
      _mm256_slli_epi16(_mm256_abs_epi16(_mm256_sub_epi16(e.p0, e.q0)), 2),
      _mm256_abs_epi16(_mm256_sub_epi16(e.p1, e.q1)));
  __m256i bad = _mm256_cmpgt_epi16(lhs, t2);
  // Interior smoothness: every neighbor delta <= ithresh.
  __m256i m = _mm256_max_epi16(
      _mm256_abs_epi16(_mm256_sub_epi16(e.p3, e.p2)),
      _mm256_abs_epi16(_mm256_sub_epi16(e.p2, e.p1)));
  m = _mm256_max_epi16(m, dp1p0);
  m = _mm256_max_epi16(m, _mm256_abs_epi16(_mm256_sub_epi16(e.q3, e.q2)));
  m = _mm256_max_epi16(m, _mm256_abs_epi16(_mm256_sub_epi16(e.q2, e.q1)));
  m = _mm256_max_epi16(m, dq1q0);
  bad = _mm256_or_si256(bad, _mm256_cmpgt_epi16(m, it));
  const __m256i apply = _mm256_xor_si256(bad, _mm256_set1_epi16(-1));
  if (_mm256_testz_si256(apply, apply)) return false;  // nothing to filter
  const __m256i hev = _mm256_or_si256(_mm256_cmpgt_epi16(dp1p0, ht),
                                      _mm256_cmpgt_epi16(dq1q0, ht));

  const __m256i base_a = _mm256_mullo_epi16(_mm256_sub_epi16(e.q0, e.p0),
                                            _mm256_set1_epi16(3));
  const __m256i sc1 = Clamp(_mm256_sub_epi16(e.p1, e.q1), -128, 127);
  const __m256i a_h = _mm256_add_epi16(base_a, sc1);

  auto shr3 = [](__m256i x, int add) {
    return _mm256_srai_epi16(_mm256_add_epi16(x, _mm256_set1_epi16((short)add)), 3);
  };
  // DoFilter2 (hev lanes): adjust p0/q0 with a = 3*(q0-p0)+sclip1(p1-q1).
  const __m256i f2a1 = Clamp(shr3(a_h, 4), -16, 15);
  const __m256i f2a2 = Clamp(shr3(a_h, 3), -16, 15);
  const __m256i f2p0 = _mm256_add_epi16(e.p0, f2a2);
  const __m256i f2q0 = _mm256_sub_epi16(e.q0, f2a1);

  const __m256i sel_hev = _mm256_and_si256(apply, hev);
  const __m256i sel_soft = _mm256_andnot_si256(hev, apply);
  if (inner) {
    // DoFilter4 (non-hev lanes): a = 3*(q0-p0); touches p1..q1.
    const __m256i a1 = Clamp(shr3(base_a, 4), -16, 15);
    const __m256i a2 = Clamp(shr3(base_a, 3), -16, 15);
    const __m256i a3 = _mm256_srai_epi16(
        _mm256_add_epi16(a1, _mm256_set1_epi16(1)), 1);
    e.p1 = _mm256_blendv_epi8(e.p1, _mm256_add_epi16(e.p1, a3), sel_soft);
    e.q1 = _mm256_blendv_epi8(e.q1, _mm256_sub_epi16(e.q1, a3), sel_soft);
    e.p0 = _mm256_blendv_epi8(
        _mm256_blendv_epi8(e.p0, _mm256_add_epi16(e.p0, a2), sel_soft),
        f2p0, sel_hev);
    e.q0 = _mm256_blendv_epi8(
        _mm256_blendv_epi8(e.q0, _mm256_sub_epi16(e.q0, a1), sel_soft),
        f2q0, sel_hev);
  } else {
    // DoFilter6 (non-hev lanes): a = sclip1(a_h); touches p2..q2.
    const __m256i a6 = Clamp(a_h, -128, 127);
    auto w = [&](int k) {
      return _mm256_srai_epi16(
          _mm256_add_epi16(_mm256_mullo_epi16(a6, _mm256_set1_epi16((short)k)),
                           _mm256_set1_epi16(63)),
          7);
    };
    const __m256i a1 = w(27), a2 = w(18), a3 = w(9);
    e.p2 = _mm256_blendv_epi8(e.p2, _mm256_add_epi16(e.p2, a3), sel_soft);
    e.q2 = _mm256_blendv_epi8(e.q2, _mm256_sub_epi16(e.q2, a3), sel_soft);
    e.p1 = _mm256_blendv_epi8(e.p1, _mm256_add_epi16(e.p1, a2), sel_soft);
    e.q1 = _mm256_blendv_epi8(e.q1, _mm256_sub_epi16(e.q1, a2), sel_soft);
    e.p0 = _mm256_blendv_epi8(
        _mm256_blendv_epi8(e.p0, _mm256_add_epi16(e.p0, a1), sel_soft),
        f2p0, sel_hev);
    e.q0 = _mm256_blendv_epi8(
        _mm256_blendv_epi8(e.q0, _mm256_sub_epi16(e.q0, a1), sel_soft),
        f2q0, sel_hev);
  }
  return true;
}

// Horizontal edge, 16 contiguous lanes (luma).
static void VEdge16(uint8_t* p, int stride, int t, int it, int ht,
                    bool inner) {
  Edge e;
  e.p3 = C16(_mm_loadu_si128((const __m128i*)(p - 4 * stride)));
  e.p2 = C16(_mm_loadu_si128((const __m128i*)(p - 3 * stride)));
  e.p1 = C16(_mm_loadu_si128((const __m128i*)(p - 2 * stride)));
  e.p0 = C16(_mm_loadu_si128((const __m128i*)(p - stride)));
  e.q0 = C16(_mm_loadu_si128((const __m128i*)(p)));
  e.q1 = C16(_mm_loadu_si128((const __m128i*)(p + stride)));
  e.q2 = C16(_mm_loadu_si128((const __m128i*)(p + 2 * stride)));
  e.q3 = C16(_mm_loadu_si128((const __m128i*)(p + 3 * stride)));
  if (!Core(e, t, it, ht, inner)) return;
  _mm_storeu_si128((__m128i*)(p - 3 * stride), P16(e.p2));
  _mm_storeu_si128((__m128i*)(p - 2 * stride), P16(e.p1));
  _mm_storeu_si128((__m128i*)(p - stride), P16(e.p0));
  _mm_storeu_si128((__m128i*)(p), P16(e.q0));
  _mm_storeu_si128((__m128i*)(p + stride), P16(e.q1));
  _mm_storeu_si128((__m128i*)(p + 2 * stride), P16(e.q2));
}

// Horizontal edge on the chroma pair: 8 U lanes + 8 V lanes.
static void VEdge8UV(uint8_t* u, uint8_t* v, int stride, int t, int it,
                     int ht, bool inner) {
  auto ld = [&](int off) {
    return C16(_mm_unpacklo_epi64(
        _mm_loadl_epi64((const __m128i*)(u + off)),
        _mm_loadl_epi64((const __m128i*)(v + off))));
  };
  Edge e;
  e.p3 = ld(-4 * stride);
  e.p2 = ld(-3 * stride);
  e.p1 = ld(-2 * stride);
  e.p0 = ld(-stride);
  e.q0 = ld(0);
  e.q1 = ld(stride);
  e.q2 = ld(2 * stride);
  e.q3 = ld(3 * stride);
  if (!Core(e, t, it, ht, inner)) return;
  auto st = [&](int off, __m256i x) {
    const __m128i b = P16(x);
    _mm_storel_epi64((__m128i*)(u + off), b);
    _mm_storel_epi64((__m128i*)(v + off), _mm_unpackhi_epi64(b, b));
  };
  st(-3 * stride, e.p2);
  st(-2 * stride, e.p1);
  st(-stride, e.p0);
  st(0, e.q0);
  st(stride, e.q1);
  st(2 * stride, e.q2);
}

// Transposes 16 rows x 8 cols of bytes (rows given as 8-byte loads) into
// 8 column vectors of 16 bytes each.
static inline void Tr16x8(const __m128i r[16], __m128i c[8]) {
  __m128i a[8], b[8], d[8];
  for (int i = 0; i < 8; ++i) a[i] = _mm_unpacklo_epi8(r[2 * i], r[2 * i + 1]);
  for (int i = 0; i < 4; ++i) {
    b[2 * i] = _mm_unpacklo_epi16(a[2 * i], a[2 * i + 1]);
    b[2 * i + 1] = _mm_unpackhi_epi16(a[2 * i], a[2 * i + 1]);
  }
  // b[2k] holds cols 0..3, b[2k+1] cols 4..7 of rows 4k..4k+3.
  for (int i = 0; i < 2; ++i) {
    d[4 * i + 0] = _mm_unpacklo_epi32(b[4 * i + 0], b[4 * i + 2]);  // c0,c1
    d[4 * i + 1] = _mm_unpackhi_epi32(b[4 * i + 0], b[4 * i + 2]);  // c2,c3
    d[4 * i + 2] = _mm_unpacklo_epi32(b[4 * i + 1], b[4 * i + 3]);  // c4,c5
    d[4 * i + 3] = _mm_unpackhi_epi32(b[4 * i + 1], b[4 * i + 3]);  // c6,c7
  }
  // d[j] (rows 0..7), d[4+j] (rows 8..15) each hold two columns.
  for (int j = 0; j < 4; ++j) {
    c[2 * j] = _mm_unpacklo_epi64(d[j], d[4 + j]);
    c[2 * j + 1] = _mm_unpackhi_epi64(d[j], d[4 + j]);
  }
}

// Transposes 8 column vectors of 16 bytes back into 16 rows of 8 bytes.
static inline void Tr8x16(const __m128i c[8], __m128i r2[8]) {
  __m128i a[8], b[8];
  for (int i = 0; i < 4; ++i) a[i] = _mm_unpacklo_epi8(c[2 * i], c[2 * i + 1]);
  for (int i = 0; i < 4; ++i)
    a[4 + i] = _mm_unpackhi_epi8(c[2 * i], c[2 * i + 1]);
  // a[i] = col pairs interleaved over rows 0..7 (i<4) / 8..15 (i>=4).
  for (int h = 0; h < 2; ++h) {
    const __m128i* s = a + 4 * h;
    b[4 * h + 0] = _mm_unpacklo_epi16(s[0], s[1]);  // cols 0-3, 4 rows
    b[4 * h + 1] = _mm_unpackhi_epi16(s[0], s[1]);
    b[4 * h + 2] = _mm_unpacklo_epi16(s[2], s[3]);  // cols 4-7
    b[4 * h + 3] = _mm_unpackhi_epi16(s[2], s[3]);
  }
  for (int h = 0; h < 2; ++h) {
    r2[4 * h + 0] = _mm_unpacklo_epi32(b[4 * h + 0], b[4 * h + 2]);
    r2[4 * h + 1] = _mm_unpackhi_epi32(b[4 * h + 0], b[4 * h + 2]);
    r2[4 * h + 2] = _mm_unpacklo_epi32(b[4 * h + 1], b[4 * h + 3]);
    r2[4 * h + 3] = _mm_unpackhi_epi32(b[4 * h + 1], b[4 * h + 3]);
  }
  // r2[k] now holds rows 2k and 2k+1 (8 bytes each).
}

// Vertical edge through 16 rows (luma): p points at the edge column.
static void HEdge16(uint8_t* p, int stride, int t, int it, int ht,
                    bool inner) {
  __m128i rows[16], cols[8], back[8];
  for (int i = 0; i < 16; ++i)
    rows[i] = _mm_loadl_epi64((const __m128i*)(p + i * stride - 4));
  Tr16x8(rows, cols);
  Edge e;
  e.p3 = C16(cols[0]);
  e.p2 = C16(cols[1]);
  e.p1 = C16(cols[2]);
  e.p0 = C16(cols[3]);
  e.q0 = C16(cols[4]);
  e.q1 = C16(cols[5]);
  e.q2 = C16(cols[6]);
  e.q3 = C16(cols[7]);
  if (!Core(e, t, it, ht, inner)) return;
  cols[1] = P16(e.p2);
  cols[2] = P16(e.p1);
  cols[3] = P16(e.p0);
  cols[4] = P16(e.q0);
  cols[5] = P16(e.q1);
  cols[6] = P16(e.q2);
  Tr8x16(cols, back);
  for (int k = 0; k < 8; ++k) {
    _mm_storel_epi64((__m128i*)(p + (2 * k) * stride - 4), back[k]);
    _mm_storel_epi64((__m128i*)(p + (2 * k + 1) * stride - 4),
                     _mm_unpackhi_epi64(back[k], back[k]));
  }
}

// Vertical edge through 8+8 chroma rows (U stacked over V in the lanes).
static void HEdge8UV(uint8_t* u, uint8_t* v, int stride, int t, int it,
                     int ht, bool inner) {
  __m128i rows[16], cols[8], back[8];
  for (int i = 0; i < 8; ++i)
    rows[i] = _mm_loadl_epi64((const __m128i*)(u + i * stride - 4));
  for (int i = 0; i < 8; ++i)
    rows[8 + i] = _mm_loadl_epi64((const __m128i*)(v + i * stride - 4));
  Tr16x8(rows, cols);
  Edge e;
  e.p3 = C16(cols[0]);
  e.p2 = C16(cols[1]);
  e.p1 = C16(cols[2]);
  e.p0 = C16(cols[3]);
  e.q0 = C16(cols[4]);
  e.q1 = C16(cols[5]);
  e.q2 = C16(cols[6]);
  e.q3 = C16(cols[7]);
  if (!Core(e, t, it, ht, inner)) return;
  cols[1] = P16(e.p2);
  cols[2] = P16(e.p1);
  cols[3] = P16(e.p0);
  cols[4] = P16(e.q0);
  cols[5] = P16(e.q1);
  cols[6] = P16(e.q2);
  Tr8x16(cols, back);
  for (int k = 0; k < 4; ++k) {
    _mm_storel_epi64((__m128i*)(u + (2 * k) * stride - 4), back[k]);
    _mm_storel_epi64((__m128i*)(u + (2 * k + 1) * stride - 4),
                     _mm_unpackhi_epi64(back[k], back[k]));
  }
  for (int k = 0; k < 4; ++k) {
    _mm_storel_epi64((__m128i*)(v + (2 * k) * stride - 4), back[4 + k]);
    _mm_storel_epi64((__m128i*)(v + (2 * k + 1) * stride - 4),
                     _mm_unpackhi_epi64(back[4 + k], back[4 + k]));
  }
}

}  // namespace lf
#define WEBPTPU_LF_SIMD 1
#endif  // __AVX2__

}  // namespace webptpu

using namespace webptpu;

// Token pass: decodes all residual coefficients for every MB
// (dequantized, WHT already applied for I16 DC) plus per-block nz extents.
// Shared by the full native decoder and the parse-only export that feeds
// the TPU reconstruction path. Returns 0, or -2 on premature EOF.
static int TokenPass(Decoder& d, std::vector<int16_t>& coeffs,
                     std::vector<uint8_t>& bnz,
                     std::vector<uint8_t>& has_nz) {
  std::vector<uint8_t> tnz(d.mb_w, 0), tdc(d.mb_w, 0);
  // ---- Pass 1: token decode for all MBs.
  for (int mby = 0; mby < d.mb_h; ++mby) {
    BoolReader& br = d.parts[mby & (d.num_parts - 1)];
    uint32_t lnz = 0;
    uint8_t ldc = 0;
    for (int mbx = 0; mbx < d.mb_w; ++mbx) {
      int mb = mby * d.mb_w + mbx;
      if (d.use_skip && d.skip[mb]) {
        lnz = 0;
        tnz[mbx] = 0;
        if (!d.is_i4[mb]) {
          ldc = 0;
          tdc[mbx] = 0;
        }
        continue;
      }
      const QuantMatrix& q = d.dqm[d.segment[mb] & 3];
      int16_t* dst = &coeffs[(size_t)mb * 24 * 16];
      int first, ptype;
      if (!d.is_i4[mb]) {
        int16_t dc[16] = {0};
        int ctx = tdc[mbx] + ldc;
        int nz = GetCoeffs(br, d, 1, ctx, q.y2_dc, q.y2_ac, 0, dc);
        tdc[mbx] = ldc = nz > 0 ? 1 : 0;
        if (nz > 0) has_nz[mb] = 1;
        TransformWHT(dc, dst);
        first = 1;
        ptype = 0;
      } else {
        first = 0;
        ptype = 3;
      }
      uint32_t t = tnz[mbx] & 0x0F, l = lnz & 0x0F;
      int lb = 0;
      for (int by = 0; by < 4; ++by) {
        lb = l & 1;
        for (int bx = 0; bx < 4; ++bx) {
          int bi = by * 4 + bx;
          int ctx = lb + (t & 1);
          int nz = GetCoeffs(br, d, ptype, ctx, q.y1_dc, q.y1_ac, first,
                             dst + bi * 16);
          bnz[(size_t)mb * 24 + bi] = (uint8_t)nz;
          lb = nz > first ? 1 : 0;
          if (lb) has_nz[mb] = 1;
          t = (t >> 1) | (lb << 7);
        }
        t >>= 4;
        l = (l >> 1) | (lb << 7);
      }
      uint32_t out_t = t, out_l = l >> 4;
      for (int ch = 0; ch <= 2; ch += 2) {
        t = tnz[mbx] >> (4 + ch);
        l = lnz >> (4 + ch);
        for (int by = 0; by < 2; ++by) {
          lb = l & 1;
          for (int bx = 0; bx < 2; ++bx) {
            int bi = 16 + ch * 2 + by * 2 + bx;
            int ctx = lb + (t & 1);
            int nz = GetCoeffs(br, d, 2, ctx, q.uv_dc, q.uv_ac, 0,
                               dst + bi * 16);
            bnz[(size_t)mb * 24 + bi] = (uint8_t)nz;
            lb = nz > 0 ? 1 : 0;
            if (lb) has_nz[mb] = 1;
            t = (t >> 1) | (lb << 3);
          }
          t >>= 2;
          l = (l >> 1) | (lb << 5);
        }
        out_t |= (t << 4) << ch;
        out_l |= (l & 0xF0) << ch;
      }
      tnz[mbx] = (uint8_t)out_t;
      lnz = out_l;
      if (br.eof) return -2;  // premature end of token partition
    }
  }

  return 0;
}

extern "C" {

// Parse-only decode for the TPU reconstruction path: headers + token pass,
// no reconstruction/filter. Exports per-MB dequantized coefficients
// (natural block order, WHT already applied to the I16 DC plane), per-block
// nz extents, per-MB info and the derived loop-filter parameters.
//   out_coeffs : int16[n_mb * 24 * 16]
//   out_bnz    : uint8[n_mb * 24]
//   out_info   : uint8[n_mb * 4]   (is_i4, uvmode, segment, has_nz)
//   out_imodes : uint8[n_mb * 16]
//   out_finfo  : int32[1 + 4*2*4]  (filter_type, then per seg x is_i4:
//                limit, ilevel, hev, inner)
//   dims       : int32[4]          (mb_w, mb_h, width, height)
// The caller must size the out buffers for the dimensions obtained from a
// prior header parse. Returns 0, -1 on header error, -2 on token EOF.
int vp8_parse(const uint8_t* data, long n,
              const uint8_t* coeffs_proba0, const uint8_t* update_proba,
              const int32_t* dc_table, const int32_t* ac_table,
              const uint8_t* bmode_proba, const int8_t* ymodes_tree,
              int16_t* out_coeffs, uint8_t* out_bnz, uint8_t* out_info,
              uint8_t* out_imodes, int32_t* out_finfo, int* dims) {
  Decoder d;
  d.t = {coeffs_proba0, update_proba, dc_table, ac_table, bmode_proba,
         ymodes_tree};
  d.data = data;
  d.n = (size_t)n;
  if (!ParseHeaders(d)) return -1;
  dims[0] = d.mb_w;
  dims[1] = d.mb_h;
  dims[2] = d.width;
  dims[3] = d.height;
  int nmb = d.mb_w * d.mb_h;
  std::vector<int16_t> coeffs((size_t)nmb * 24 * 16, 0);
  std::vector<uint8_t> has_nz(nmb, 0);
  std::vector<uint8_t> bnz((size_t)nmb * 24, 0);
  int rc = TokenPass(d, coeffs, bnz, has_nz);
  if (rc != 0) return rc;
  memcpy(out_coeffs, coeffs.data(), coeffs.size() * sizeof(int16_t));
  memcpy(out_bnz, bnz.data(), bnz.size());
  memcpy(out_imodes, d.imodes.data(), (size_t)nmb * 16);
  for (int mb = 0; mb < nmb; ++mb) {
    out_info[mb * 4 + 0] = d.is_i4[mb];
    out_info[mb * 4 + 1] = d.uvmode[mb];
    out_info[mb * 4 + 2] = d.segment[mb];
    out_info[mb * 4 + 3] = has_nz[mb];
  }
  out_finfo[0] = d.filter_type;
  for (int s = 0; s < 4; ++s) {
    int base;
    if (d.use_segment) {
      base = d.seg_filter[s];
      if (!d.absolute_delta) base += d.filter_level;
    } else {
      base = d.filter_level;
    }
    for (int i4 = 0; i4 <= 1; ++i4) {
      int level = base;
      if (d.use_lf_delta) {
        level += d.ref_lf_delta[0];
        if (i4) level += d.mode_lf_delta[0];
      }
      level = clampi(level, 0, 63);
      int limit = 0, ilevel = 0, hev = 0;
      if (level > 0) {
        ilevel = level;
        if (d.filter_sharpness > 0) {
          ilevel >>= d.filter_sharpness > 4 ? 2 : 1;
          if (ilevel > 9 - d.filter_sharpness) ilevel = 9 - d.filter_sharpness;
        }
        if (ilevel < 1) ilevel = 1;
        limit = 2 * level + ilevel;
        hev = level >= 40 ? 2 : level >= 15 ? 1 : 0;
      }
      int32_t* fo = out_finfo + 1 + (s * 2 + i4) * 4;
      fo[0] = limit;
      fo[1] = ilevel;
      fo[2] = hev;
      fo[3] = i4;
    }
  }
  return 0;
}

// Decodes a VP8 keyframe. Planes y/u/v must be (mb_h*16 x mb_w*16) and
// (mb_h*8 x mb_w*8), caller-allocated. Returns 0 on success.
int vp8_decode(const uint8_t* data, long n,
               const uint8_t* coeffs_proba0, const uint8_t* update_proba,
               const int32_t* dc_table, const int32_t* ac_table,
               const uint8_t* bmode_proba, const int8_t* ymodes_tree,
               uint8_t* y_out, uint8_t* u_out, uint8_t* v_out,
               int* dims /* [mb_w, mb_h, width, height] out */) {
  Decoder d;
  d.t = {coeffs_proba0, update_proba, dc_table, ac_table, bmode_proba,
         ymodes_tree};
  d.data = data;
  d.n = (size_t)n;
  if (!ParseHeaders(d)) return -1;
  dims[0] = d.mb_w;
  dims[1] = d.mb_h;
  dims[2] = d.width;
  dims[3] = d.height;
  int ys = d.mb_w * 16, uvs = d.mb_w * 8;
  d.Y = y_out;
  d.U = u_out;
  d.V = v_out;
  d.ys = ys;
  d.uvs = uvs;

  int nmb = d.mb_w * d.mb_h;
  std::vector<int16_t> coeffs((size_t)nmb * 24 * 16, 0);
  std::vector<uint8_t> has_nz(nmb, 0);
  // Per-block GetCoeffs return (position after the last nonzero) so the
  // reconstruction pass can skip or DC-fast-path empty/DC-only blocks.
  std::vector<uint8_t> bnz((size_t)nmb * 24, 0);

  {
    int rc = TokenPass(d, coeffs, bnz, has_nz);
    if (rc != 0) return rc;
  }
  // ---- Pass 2: reconstruction (raster wavefront on the planes).
  static const int bx_off[16] = {0, 4, 8, 12, 0, 4, 8, 12,
                                 0, 4, 8, 12, 0, 4, 8, 12};
  static const int by_off[16] = {0, 0, 0, 0, 4, 4, 4, 4,
                                 8, 8, 8, 8, 12, 12, 12, 12};
  for (int mby = 0; mby < d.mb_h; ++mby) {
    for (int mbx = 0; mbx < d.mb_w; ++mbx) {
      int mb = mby * d.mb_w + mbx;
      int x0 = mbx * 16, y0 = mby * 16;
      const int16_t* cf = &coeffs[(size_t)mb * 24 * 16];
      if (d.is_i4[mb]) {
        // Per-subblock prediction; top-right rules per spec.
        int mb_tr[4];
        if (mby == 0)
          for (int i = 0; i < 4; ++i) mb_tr[i] = 127;
        else if (mbx >= d.mb_w - 1)
          for (int i = 0; i < 4; ++i) mb_tr[i] = d.Y[(y0 - 1) * ys + x0 + 15];
        else
          for (int i = 0; i < 4; ++i) mb_tr[i] = d.Y[(y0 - 1) * ys + x0 + 16 + i];
        for (int nsub = 0; nsub < 16; ++nsub) {
          int sx = x0 + bx_off[nsub], sy = y0 + by_off[nsub];
          int t[4], l[4], tr[4], tl;
          for (int i = 0; i < 4; ++i) {
            t[i] = (sy > 0) ? d.Y[(sy - 1) * ys + sx + i] : 127;
            l[i] = (sx > 0) ? d.Y[(sy + i) * ys + sx - 1] : 129;
          }
          if (sy == 0) {
            tl = 127;
            for (int i = 0; i < 4; ++i) tr[i] = 127;
          } else {
            tl = (sx > 0) ? d.Y[(sy - 1) * ys + sx - 1] : 129;
            if (bx_off[nsub] == 12) {
              for (int i = 0; i < 4; ++i) tr[i] = mb_tr[i];
            } else {
              for (int i = 0; i < 4; ++i) tr[i] = d.Y[(sy - 1) * ys + sx + 4 + i];
            }
          }
          uint8_t* o = d.Y + sy * ys + sx;
          Pred4(o, ys, d.imodes[(size_t)mb * 16 + nsub], t, l, tl, tr);
          const int bn = bnz[(size_t)mb * 24 + nsub];
          if (bn > 1)
            IDCTAdd(cf + nsub * 16, o, ys);
          else if (bn == 1)
            IDCTAddDC(cf[nsub * 16], o, ys);
        }
      } else {
        Ctx c;
        GatherCtx(d.Y, ys, x0, y0, 16, mbx, mby, d.mb_w, false, c);
        PredBlock(d.Y + y0 * ys + x0, ys, c, 16, d.imodes[(size_t)mb * 16]);
        for (int nsub = 0; nsub < 16; ++nsub) {
          uint8_t* o = d.Y + (y0 + by_off[nsub]) * ys + x0 + bx_off[nsub];
          if (bnz[(size_t)mb * 24 + nsub] > 1)
            IDCTAdd(cf + nsub * 16, o, ys);
          else if (cf[nsub * 16])
            IDCTAddDC(cf[nsub * 16], o, ys);
        }
      }
      // Chroma.
      int cx0 = mbx * 8, cy0 = mby * 8;
      Ctx cu, cv;
      GatherCtx(d.U, uvs, cx0, cy0, 8, mbx, mby, d.mb_w, false, cu);
      GatherCtx(d.V, uvs, cx0, cy0, 8, mbx, mby, d.mb_w, false, cv);
      PredBlock(d.U + cy0 * uvs + cx0, uvs, cu, 8, d.uvmode[mb]);
      PredBlock(d.V + cy0 * uvs + cx0, uvs, cv, 8, d.uvmode[mb]);
      for (int bi = 0; bi < 4; ++bi) {
        int ox = (bi & 1) * 4, oy = (bi >> 1) * 4;
        uint8_t* ou = d.U + (cy0 + oy) * uvs + cx0 + ox;
        uint8_t* ov = d.V + (cy0 + oy) * uvs + cx0 + ox;
        const int nu = bnz[(size_t)mb * 24 + 16 + bi];
        const int nv = bnz[(size_t)mb * 24 + 20 + bi];
        if (nu > 1) IDCTAdd(cf + (16 + bi) * 16, ou, uvs);
        else if (nu == 1) IDCTAddDC(cf[(16 + bi) * 16], ou, uvs);
        if (nv > 1) IDCTAdd(cf + (20 + bi) * 16, ov, uvs);
        else if (nv == 1) IDCTAddDC(cf[(20 + bi) * 16], ov, uvs);
      }
    }
  }

  // ---- Pass 3: loop filter (exact raster order).
  if (d.filter_type > 0) {
    // Precompute per-segment strengths.
    FilterInfo fstr[4][2];
    for (int s = 0; s < 4; ++s) {
      int base;
      if (d.use_segment) {
        base = d.seg_filter[s];
        if (!d.absolute_delta) base += d.filter_level;
      } else {
        base = d.filter_level;
      }
      for (int i4 = 0; i4 <= 1; ++i4) {
        FilterInfo& fi = fstr[s][i4];
        int level = base;
        if (d.use_lf_delta) {
          level += d.ref_lf_delta[0];
          if (i4) level += d.mode_lf_delta[0];
        }
        level = clampi(level, 0, 63);
        if (level > 0) {
          int ilevel = level;
          if (d.filter_sharpness > 0) {
            ilevel >>= d.filter_sharpness > 4 ? 2 : 1;
            if (ilevel > 9 - d.filter_sharpness) ilevel = 9 - d.filter_sharpness;
          }
          if (ilevel < 1) ilevel = 1;
          fi.ilevel = ilevel;
          fi.limit = 2 * level + ilevel;
          fi.hev = level >= 40 ? 2 : level >= 15 ? 1 : 0;
        } else {
          fi.limit = 0;
        }
        fi.inner = i4 != 0;
      }
    }
    for (int mby = 0; mby < d.mb_h; ++mby) {
      for (int mbx = 0; mbx < d.mb_w; ++mbx) {
        int mb = mby * d.mb_w + mbx;
        const FilterInfo& fi = fstr[d.segment[mb] & 3][d.is_i4[mb] ? 1 : 0];
        if (fi.limit == 0) continue;
        bool inner = fi.inner || has_nz[mb];
        int x0 = mbx * 16, y0 = mby * 16;
        int cx0 = mbx * 8, cy0 = mby * 8;
        if (d.filter_type == 1) {
          if (mbx > 0) SimpleFilter(d.Y + y0 * ys + x0, 1, ys, 16, fi.limit + 4);
          if (inner)
            for (int k = 4; k <= 12; k += 4)
              SimpleFilter(d.Y + y0 * ys + x0 + k, 1, ys, 16, fi.limit);
          if (mby > 0) SimpleFilter(d.Y + y0 * ys + x0, ys, 1, 16, fi.limit + 4);
          if (inner)
            for (int k = 4; k <= 12; k += 4)
              SimpleFilter(d.Y + (y0 + k) * ys + x0, ys, 1, 16, fi.limit);
        } else {
          int il = fi.ilevel, hev = fi.hev;
#ifdef WEBPTPU_LF_SIMD
          // Bit-exactness of the lf:: kernels vs FilterLoop is asserted by
          // vp8_filter_selftest (same argument mapping as below).
          if (mbx > 0) {
            lf::HEdge16(d.Y + y0 * ys + x0, ys, fi.limit + 4, il, hev, false);
            lf::HEdge8UV(d.U + cy0 * uvs + cx0, d.V + cy0 * uvs + cx0, uvs,
                         fi.limit + 4, il, hev, false);
          }
          if (inner) {
            for (int k = 4; k <= 12; k += 4)
              lf::HEdge16(d.Y + y0 * ys + x0 + k, ys, fi.limit, il, hev, true);
            lf::HEdge8UV(d.U + cy0 * uvs + cx0 + 4, d.V + cy0 * uvs + cx0 + 4,
                         uvs, fi.limit, il, hev, true);
          }
          if (mby > 0) {
            lf::VEdge16(d.Y + y0 * ys + x0, ys, fi.limit + 4, il, hev, false);
            lf::VEdge8UV(d.U + cy0 * uvs + cx0, d.V + cy0 * uvs + cx0, uvs,
                         fi.limit + 4, il, hev, false);
          }
          if (inner) {
            for (int k = 4; k <= 12; k += 4)
              lf::VEdge16(d.Y + (y0 + k) * ys + x0, ys, fi.limit, il, hev, true);
            lf::VEdge8UV(d.U + (cy0 + 4) * uvs + cx0, d.V + (cy0 + 4) * uvs + cx0,
                         uvs, fi.limit, il, hev, true);
          }
#else
          if (mbx > 0) {
            FilterLoop(d.Y + y0 * ys + x0, 1, ys, 16, fi.limit + 4, il, hev, false);
            FilterLoop(d.U + cy0 * uvs + cx0, 1, uvs, 8, fi.limit + 4, il, hev, false);
            FilterLoop(d.V + cy0 * uvs + cx0, 1, uvs, 8, fi.limit + 4, il, hev, false);
          }
          if (inner) {
            for (int k = 4; k <= 12; k += 4)
              FilterLoop(d.Y + y0 * ys + x0 + k, 1, ys, 16, fi.limit, il, hev, true);
            FilterLoop(d.U + cy0 * uvs + cx0 + 4, 1, uvs, 8, fi.limit, il, hev, true);
            FilterLoop(d.V + cy0 * uvs + cx0 + 4, 1, uvs, 8, fi.limit, il, hev, true);
          }
          if (mby > 0) {
            FilterLoop(d.Y + y0 * ys + x0, ys, 1, 16, fi.limit + 4, il, hev, false);
            FilterLoop(d.U + cy0 * uvs + cx0, uvs, 1, 8, fi.limit + 4, il, hev, false);
            FilterLoop(d.V + cy0 * uvs + cx0, uvs, 1, 8, fi.limit + 4, il, hev, false);
          }
          if (inner) {
            for (int k = 4; k <= 12; k += 4)
              FilterLoop(d.Y + (y0 + k) * ys + x0, ys, 1, 16, fi.limit, il, hev, true);
            FilterLoop(d.U + (cy0 + 4) * uvs + cx0, uvs, 1, 8, fi.limit, il, hev, true);
            FilterLoop(d.V + (cy0 + 4) * uvs + cx0, uvs, 1, 8, fi.limit, il, hev, true);
          }
#endif
        }
      }
    }
  }
  return 0;
}

// Loop-filter self-test: runs the SIMD edge filters against the scalar
// reference on pseudo-random planes for every (thresh, ithresh, hev, inner)
// shape. Returns 0 when bit-exact, else the 1-based case number.
int vp8_filter_selftest(int seed) {
#ifdef WEBPTPU_LF_SIMD
  uint32_t st = (uint32_t)seed * 2654435761u + 12345u;
  auto rnd = [&]() {
    st = st * 1664525u + 1013904223u;
    return (uint8_t)(st >> 24);
  };
  const int W = 64, H = 32;
  std::vector<uint8_t> a((size_t)W * H), b;
  int cse = 0;
  for (int t = 0; t < 64; t += 9) {
    for (int it = 1; it < 10; it += 4) {
      for (int hev = 0; hev <= 2; ++hev) {
        for (int inner = 0; inner <= 1; ++inner) {
          ++cse;
          for (auto& x : a) {
            // Mix smooth and random areas so masks take both branches.
            x = (rnd() & 64) ? rnd() : (uint8_t)(128 + (rnd() & 7));
          }
          b = a;
          // Luma-style 16-row edges.
          FilterLoop(&a[8 * W + 8], 1, W, 16, t, it, hev, inner);
          lf::HEdge16(&b[8 * W + 8], W, t, it, hev, inner);
          FilterLoop(&a[8 * W + 24], W, 1, 16, t, it, hev, inner);
          lf::VEdge16(&b[8 * W + 24], W, t, it, hev, inner);
          // Chroma-style paired 8-row edges (two disjoint regions).
          FilterLoop(&a[4 * W + 44], 1, W, 8, t, it, hev, inner);
          FilterLoop(&a[20 * W + 44], 1, W, 8, t, it, hev, inner);
          lf::HEdge8UV(&b[4 * W + 44], &b[20 * W + 44], W, t, it, hev, inner);
          FilterLoop(&a[18 * W + 52], W, 1, 8, t, it, hev, inner);
          FilterLoop(&a[18 * W + 4], W, 1, 8, t, it, hev, inner);
          lf::VEdge8UV(&b[18 * W + 52], &b[18 * W + 4], W, t, it, hev, inner);
          if (a != b) return cse;
        }
      }
    }
  }
  return 0;
#else
  (void)seed;
  return 0;
#endif
}

}  // extern "C"
