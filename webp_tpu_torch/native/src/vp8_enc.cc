// VP8 encoder host-side entropy coding (native fast path).
//
// Mirrors the JAX package's token writer, stats recorder and probability
// rule (webp_tpu/lossy/encode.py) byte-for-byte; the port's files are held
// against that package's. vp8_code_frame codes a frame's tokens in one
// call, from dense levels or straight from the device's packed ones;
// vp8_write_partition0 writes partition 0 whole, held against its Python
// writer in tests/test_torch_partition0.py.

#include <cstdint>
#include <cstring>

#include "bitio.h"

namespace webptpu {

static const uint8_t kBands[17] = {0, 1, 2, 3, 6, 4, 5, 6, 6,
                                   6, 6, 6, 6, 6, 6, 7, 0};

static const uint8_t kCat3[] = {173, 148, 140};
static const uint8_t kCat4[] = {176, 155, 140, 135};
static const uint8_t kCat5[] = {180, 157, 141, 134, 130};
static const uint8_t kCat6[] = {254, 254, 243, 230, 196, 177,
                                153, 140, 133, 130, 129};
static const uint8_t* kCats[4] = {kCat3, kCat4, kCat5, kCat6};
static const int kCatLens[4] = {3, 4, 5, 11};

struct ProbaView {
  const uint8_t* p;  // [4][8][3][11]
  inline const uint8_t* at(int t, int b, int c) const {
    return p + ((t * 8 + b) * 3 + c) * 11;
  }
};

// The index of a block's last non-zero level at or after first, or -1.
static inline int LastNonZero(const int32_t* lv, int first) {
  for (int i = 15; i >= first; --i)
    if (lv[i]) return i;
  return -1;
}

// Writes one block's coefficient tokens. levels: [16] zigzag.
// Returns nz bit.
static int PutCoeffs(BoolEncoder* bw, const ProbaView& pv, int ptype, int ctx,
                     const int32_t* lv, int first) {
  const int last = LastNonZero(lv, first);
  int n = first;
  const uint8_t* p = pv.at(ptype, kBands[n], ctx);
  if (last < first) {
    bw->put_bit(p[0], 0);
    return 0;
  }
  while (n <= last) {
    bw->put_bit(p[0], 1);
    while (lv[n] == 0) {
      bw->put_bit(p[1], 0);
      n++;
      p = pv.at(ptype, kBands[n], 0);
    }
    bw->put_bit(p[1], 1);
    int v = lv[n] < 0 ? -lv[n] : lv[n];
    int sign = lv[n] < 0;
    int next_ctx;
    if (v == 1) {
      bw->put_bit(p[2], 0);
      next_ctx = 1;
    } else {
      bw->put_bit(p[2], 1);
      if (v <= 4) {
        bw->put_bit(p[3], 0);
        if (v == 2) {
          bw->put_bit(p[4], 0);
        } else {
          bw->put_bit(p[4], 1);
          bw->put_bit(p[5], v - 3);
        }
      } else if (v <= 10) {
        bw->put_bit(p[3], 1);
        bw->put_bit(p[6], 0);
        if (v <= 6) {
          bw->put_bit(p[7], 0);
          bw->put_bit(159, v - 5);
        } else {
          bw->put_bit(p[7], 1);
          bw->put_bit(165, (v - 7) >> 1);
          bw->put_bit(145, (v - 7) & 1);
        }
      } else {
        bw->put_bit(p[3], 1);
        bw->put_bit(p[6], 1);
        int cat = v <= 18 ? 0 : (v <= 34 ? 1 : (v <= 66 ? 2 : 3));
        bw->put_bit(p[8], cat >> 1);
        bw->put_bit(p[9 + (cat >> 1)], cat & 1);
        int extra = v - 3 - (8 << cat);
        int nb = kCatLens[cat];
        for (int b = nb - 1; b >= 0; --b)
          bw->put_bit(kCats[cat][nb - 1 - b], (extra >> b) & 1);
      }
      next_ctx = 2;
    }
    bw->put_bit(0x80, sign);
    n++;
    if (n == 16) return 1;
    p = pv.at(ptype, kBands[n], next_ctx);
  }
  bw->put_bit(p[0], 0);
  return 1;
}

// Records per-branch (bit0,bit1) counts for one block, mirroring PutCoeffs.
static int RecordCoeffs(int64_t* stats, int ptype, int ctx, const int32_t* lv,
                        int first) {
  auto S = [&](int b, int c, int pi, int bit) {
    stats[(((ptype * 8 + b) * 3 + c) * 11 + pi) * 2 + bit]++;
  };
  const int last = LastNonZero(lv, first);
  int n = first;
  if (last < first) {
    S(kBands[n], ctx, 0, 0);
    return 0;
  }
  int cur_ctx = ctx;
  while (n <= last) {
    S(kBands[n], cur_ctx, 0, 1);
    while (lv[n] == 0) {
      S(kBands[n], cur_ctx, 1, 0);
      n++;
      cur_ctx = 0;
    }
    S(kBands[n], cur_ctx, 1, 1);
    int v = lv[n] < 0 ? -lv[n] : lv[n];
    int b = kBands[n], c = cur_ctx;
    int next_ctx;
    if (v == 1) {
      S(b, c, 2, 0);
      next_ctx = 1;
    } else {
      S(b, c, 2, 1);
      if (v <= 4) {
        S(b, c, 3, 0);
        S(b, c, 4, v == 2 ? 0 : 1);
        if (v != 2) S(b, c, 5, v - 3);
      } else if (v <= 10) {
        S(b, c, 3, 1);
        S(b, c, 6, 0);
        S(b, c, 7, v <= 6 ? 0 : 1);
      } else {
        S(b, c, 3, 1);
        S(b, c, 6, 1);
        int cat = v <= 18 ? 0 : (v <= 34 ? 1 : (v <= 66 ? 2 : 3));
        S(b, c, 8, cat >> 1);
        S(b, c, 9 + (cat >> 1), cat & 1);
      }
      next_ctx = 2;
    }
    n++;
    cur_ctx = next_ctx;
  }
  if (n < 16) S(kBands[n], cur_ctx, 0, 0);
  return 1;
}

// One MB's blocks in coding order (Y2 for an I16 MB, the 16 luma, the 4
// U and 4 V blocks) through block(ptype, ctx, levels, first), which
// returns the block's nz bit; updates the non-zero contexts. lv: the MB's
// [24][16] levels, y2: its [16] Y2 levels (read for an I16 MB only).
template <typename FN>
static void WalkMB(const int32_t* lv, const int32_t* y2, bool i4,
                   uint32_t* tnz_io, uint32_t* lnz_io, uint8_t* tdc_io,
                   uint8_t* ldc_io, FN&& block) {
  uint32_t tnz_in = *tnz_io, lnz_in = *lnz_io;
  int first, ptype;
  if (!i4) {
    int ctx = *tdc_io + *ldc_io;
    int nz = block(1, ctx, y2, 0);
    *tdc_io = *ldc_io = (uint8_t)nz;
    first = 1;
    ptype = 0;
  } else {
    first = 0;
    ptype = 3;
  }
  uint32_t tnz = tnz_in & 0x0F, lnz = lnz_in & 0x0F;
  int l = 0;
  for (int y = 0; y < 4; ++y) {
    l = lnz & 1;
    for (int x = 0; x < 4; ++x) {
      int bi = y * 4 + x;
      int ctx = l + (tnz & 1);
      l = block(ptype, ctx, lv + bi * 16, first);
      tnz = (tnz >> 1) | ((uint32_t)l << 7);
    }
    tnz >>= 4;
    lnz = (lnz >> 1) | ((uint32_t)l << 7);
  }
  uint32_t out_tnz = tnz, out_lnz = lnz >> 4;
  for (int ch = 0; ch <= 2; ch += 2) {
    tnz = tnz_in >> (4 + ch);
    lnz = lnz_in >> (4 + ch);
    for (int y = 0; y < 2; ++y) {
      l = lnz & 1;
      for (int x = 0; x < 2; ++x) {
        int bi = 16 + ch * 2 + y * 2 + x;
        int ctx = l + (tnz & 1);
        l = block(2, ctx, lv + bi * 16, 0);
        tnz = (tnz >> 1) | ((uint32_t)l << 3);
      }
      tnz >>= 2;
      lnz = (lnz >> 1) | ((uint32_t)l << 5);
    }
    out_tnz |= (tnz << 4) << ch;
    out_lnz |= (lnz & 0xF0) << ch;
  }
  *tnz_io = out_tnz;
  *lnz_io = out_lnz;
}

// Every MB of the frame in raster order through mb_fn(mb, mb_y, and the
// MB's top and left non-zero contexts, which the token walk keeps); an MB
// skipped under use_skip resets them and is not visited.
template <typename FN>
static void WalkFrame(const uint8_t* is_i4, const uint8_t* skip, int mb_w,
                      int mb_h, int use_skip, FN&& mb_fn) {
  std::vector<uint32_t> top_nz(mb_w, 0);
  std::vector<uint8_t> top_dc(mb_w, 0);
  for (int mb_y = 0; mb_y < mb_h; ++mb_y) {
    uint32_t left_nz = 0;
    uint8_t left_dc = 0;
    for (int mb_x = 0; mb_x < mb_w; ++mb_x) {
      int mb = mb_y * mb_w + mb_x;
      if (use_skip && skip[mb]) {
        left_nz = 0;
        top_nz[mb_x] = 0;
        if (!is_i4[mb]) {
          left_dc = 0;
          top_dc[mb_x] = 0;
        }
        continue;
      }
      mb_fn(mb, mb_y, &top_nz[mb_x], &left_nz, &top_dc[mb_x], &left_dc);
    }
  }
}

// Dense levels: int32 [n_mb][24][16] and Y2 levels int32 [n_mb][16].
struct DenseLevels {
  const int32_t* levels;
  const int32_t* y2;
  const int32_t* mb(int m) { return levels + (size_t)m * 384; }
  const int32_t* mb_y2(int m) { return y2 + (size_t)m * 16; }
  void rewind() {}
};

// A byte of the device's packed levels as its two levels: nibble n is
// n - 8, nibble 0 (an escaped coefficient) is 0.
struct NibblePairs {
  int32_t v[256][2];
  NibblePairs() {
    for (int b = 0; b < 256; ++b) {
      int lo = b & 15, hi = b >> 4;
      v[b][0] = lo ? lo - 8 : 0;
      v[b][1] = hi ? hi - 8 : 0;
    }
  }
};
static const NibblePairs kNibbles;

// The device's packed levels (ops/fastpath.py _pack_levels): packed u8
// [n_mb][24][8], two levels a byte, low nibble first; the blocks whose
// indices esc_idx[0..esc_cnt) lists (ascending) take their 16 levels from
// esc_val [.][16] instead; Y2 levels int16 [n_mb][16]. Each MB is decoded
// when visited, into one MB's buffer; the escape cursor follows the
// raster walk and rewind() restarts it for the next walk.
struct PackedLevels {
  const uint8_t* packed;
  const int32_t* esc_idx;
  const int16_t* esc_val;
  int esc_cnt;
  const int16_t* y2;
  int cursor = 0;
  int32_t lv[384];
  int32_t lv_y2[16];

  const int32_t* mb(int m) {
    const uint8_t* p = packed + (size_t)m * 192;
    for (int i = 0; i < 192; ++i) memcpy(lv + 2 * i, kNibbles.v[p[i]], 8);
    const int first = m * 24, end = first + 24;
    while (cursor < esc_cnt && esc_idx[cursor] < first) ++cursor;
    for (; cursor < esc_cnt && esc_idx[cursor] < end; ++cursor) {
      const int16_t* v = esc_val + (size_t)cursor * 16;
      int32_t* d = lv + (esc_idx[cursor] - first) * 16;
      for (int k = 0; k < 16; ++k) d[k] = v[k];
    }
    return lv;
  }
  const int32_t* mb_y2(int m) {
    const int16_t* v = y2 + (size_t)m * 16;
    for (int k = 0; k < 16; ++k) lv_y2[k] = v[k];
    return lv_y2;
  }
  void rewind() { cursor = 0; }
};

constexpr int kNumProbas = 4 * 8 * 3 * 11;

// The frame's coefficient probabilities from its branch statistics
// [kNumProbas][2] (encode_proba.go optimizeProba): an entry of proba0
// takes n1 / total's probability where that update, signalled at its
// cost under update_proba and 8 bits, codes the entry's bits in fewer
// bits than proba0 does.
static void OptimizeProbas(const int64_t* stats, const uint8_t* proba0,
                           const uint8_t* update_proba,
                           const int32_t* entropy_cost, uint8_t* proba) {
  auto cost = [&](int bit, int p) -> int64_t {
    return entropy_cost[bit ? 255 - p : p];
  };
  for (int i = 0; i < kNumProbas; ++i) {
    proba[i] = proba0[i];
    const int64_t n0 = stats[2 * i], n1 = stats[2 * i + 1];
    const int64_t total = n0 + n1;
    if (total == 0) continue;
    const int old_p = proba0[i], up = update_proba[i];
    int new_p = n1 ? (int)(255 - n1 * 255 / total) : 255;
    new_p = new_p < 1 ? 1 : (new_p > 255 ? 255 : new_p);
    const int64_t old_cost =
        n1 * cost(1, old_p) + n0 * cost(0, old_p) + cost(0, up);
    const int64_t new_cost = n1 * cost(1, new_p) + n0 * cost(0, new_p) +
                             cost(1, up) + 8 * 256;
    if (new_cost < old_cost) proba[i] = (uint8_t)new_p;
  }
}

// The frame's statistics, probabilities and token partitions from the
// levels src gives (DenseLevels or PackedLevels): MB row r goes to
// partition r mod num_parts. Returns the partitions' total bytes and
// their sizes in part_sizes, or minus that total (nothing copied) when
// it exceeds cap.
template <typename Levels>
static long CodeFrame(Levels& src, const uint8_t* is_i4, const uint8_t* skip,
                      int mb_w, int mb_h, int use_skip, int num_parts,
                      const uint8_t* proba0, const uint8_t* update_proba,
                      const int32_t* entropy_cost, uint8_t* proba,
                      int64_t* part_sizes, uint8_t* out, long cap) {
  std::vector<int64_t> stats(kNumProbas * 2, 0);
  WalkFrame(is_i4, skip, mb_w, mb_h, use_skip,
            [&](int mb, int, uint32_t* tnz, uint32_t* lnz, uint8_t* tdc,
                uint8_t* ldc) {
              WalkMB(src.mb(mb), src.mb_y2(mb), is_i4[mb], tnz, lnz, tdc,
                     ldc,
                     [&](int ptype, int ctx, const int32_t* lv, int first) {
                       return RecordCoeffs(stats.data(), ptype, ctx, lv,
                                           first);
                     });
            });
  OptimizeProbas(stats.data(), proba0, update_proba, entropy_cost, proba);
  src.rewind();
  ProbaView pv{proba};
  std::vector<BoolEncoder> bws(num_parts);
  WalkFrame(is_i4, skip, mb_w, mb_h, use_skip,
            [&](int mb, int mb_y, uint32_t* tnz, uint32_t* lnz, uint8_t* tdc,
                uint8_t* ldc) {
              BoolEncoder* bw = &bws[mb_y & (num_parts - 1)];
              WalkMB(src.mb(mb), src.mb_y2(mb), is_i4[mb], tnz, lnz, tdc,
                     ldc,
                     [&](int ptype, int ctx, const int32_t* lv, int first) {
                       return PutCoeffs(bw, pv, ptype, ctx, lv, first);
                     });
            });
  long total = 0;
  for (int k = 0; k < num_parts; ++k) {
    bws[k].finish();
    part_sizes[k] = (int64_t)bws[k].buf.size();
    total += (long)bws[k].buf.size();
  }
  if (total > cap) return -total;
  for (auto& bw : bws) {
    memcpy(out, bw.buf.data(), bw.buf.size());
    out += bw.buf.size();
  }
  return total;
}

}  // namespace webptpu

using namespace webptpu;

extern "C" {

// Writes the per-MB mode records (RFC 6386 §19.3) into a bool writer.
static void write_mb_modes(BoolEncoder* bw, const uint8_t* imodes,
                           const uint8_t* is_i4, const uint8_t* uvmode,
                           const uint8_t* skip, int use_skip, int skip_prob,
                           const uint8_t* bmode_prob, const int8_t* tree,
                           int mb_w, int mb_h, const uint8_t* seg_map,
                           const int32_t* seg_probas, int num_segments) {
  // Precompute tree paths for each mode.
  int path_node[10][8], path_bit[10][8], path_len[10];
  for (int m = 0; m < 10; ++m) path_len[m] = 0;
  // DFS from node 0.
  struct Walk {
    const int8_t* tree;
    int (*pn)[8];
    int (*pb)[8];
    int* pl;
    void rec(int node, int* nodes, int* bits, int depth) {
      for (int bit = 0; bit <= 1; ++bit) {
        int child = tree[2 * node + bit];
        nodes[depth] = node;
        bits[depth] = bit;
        if (child <= 0) {
          int m = -child;
          for (int i = 0; i <= depth; ++i) {
            pn[m][i] = nodes[i];
            pb[m][i] = bits[i];
          }
          pl[m] = depth + 1;
        } else {
          rec(child, nodes, bits, depth + 1);
        }
      }
    }
  } walk{tree, path_node, path_bit, path_len};
  int nodes[8], bits[8];
  walk.rec(0, nodes, bits, 0);

  std::vector<uint8_t> top(mb_w * 4, 0);
  std::vector<uint8_t> left(4, 0);
  for (int mb_y = 0; mb_y < mb_h; ++mb_y) {
    memset(left.data(), 0, 4);
    for (int mb_x = 0; mb_x < mb_w; ++mb_x) {
      int mb = mb_y * mb_w + mb_x;
      if (num_segments > 1) {
        int seg = seg_map[mb];
        if (seg < 2) {
          bw->put_bit(seg_probas[0], 0);
          bw->put_bit(seg_probas[1], seg & 1);
        } else {
          bw->put_bit(seg_probas[0], 1);
          bw->put_bit(seg_probas[2], seg & 1);
        }
      }
      if (use_skip) bw->put_bit(skip_prob, skip[mb] ? 1 : 0);
      if (is_i4[mb]) {
        bw->put_bit(145, 0);
        const uint8_t* modes = imodes + (size_t)mb * 16;
        for (int y = 0; y < 4; ++y) {
          int ymode = left[y];
          for (int x = 0; x < 4; ++x) {
            const uint8_t* probs = bmode_prob + (top[mb_x * 4 + x] * 10 + ymode) * 9;
            int m = modes[y * 4 + x];
            for (int i = 0; i < path_len[m]; ++i)
              bw->put_bit(probs[path_node[m][i]], path_bit[m][i]);
            ymode = m;
            top[mb_x * 4 + x] = m;
          }
          left[y] = ymode;
        }
      } else {
        int mode = imodes[(size_t)mb * 16];
        bw->put_bit(145, 1);
        if (mode == 0) {  // DC
          bw->put_bit(156, 0);
          bw->put_bit(163, 0);
        } else if (mode == 2) {  // V
          bw->put_bit(156, 0);
          bw->put_bit(163, 1);
        } else if (mode == 3) {  // H
          bw->put_bit(156, 1);
          bw->put_bit(128, 0);
        } else {  // TM
          bw->put_bit(156, 1);
          bw->put_bit(128, 1);
        }
        for (int k = 0; k < 4; ++k) top[mb_x * 4 + k] = mode;
        for (int k = 0; k < 4; ++k) left[k] = mode;
      }
      int uv = uvmode[mb];
      if (uv == 0) {
        bw->put_bit(142, 0);
      } else if (uv == 2) {
        bw->put_bit(142, 1);
        bw->put_bit(114, 0);
      } else if (uv == 3) {
        bw->put_bit(142, 1);
        bw->put_bit(114, 1);
        bw->put_bit(183, 0);
      } else {
        bw->put_bit(142, 1);
        bw->put_bit(114, 1);
        bw->put_bit(183, 1);
      }
    }
  }
}

// Writes all of partition 0 in one call: the colour space and clamp
// bits, the segment header (4 quantizers, 4 filter strengths, the 3 tree
// probabilities, 255 = not sent), the filter header, the partition
// count, the quantizer indices, the refresh bit, the 1,056 coefficient-
// probability updates against proba0 under update_proba, the skip flag
// and the MB modes. seg_hdr: quant[4], fstrength[4], probas[3]; seg_map
// is read only when num_segments > 1. Returns the byte count, or minus
// the bytes needed (nothing copied) when they exceed cap.
long vp8_write_partition0(int num_segments, const int32_t* seg_hdr,
                          int filter_simple, int filter_level,
                          int filter_sharpness, int log2_parts, int base_q,
                          int dq_uv_dc, int dq_uv_ac, const uint8_t* proba,
                          const uint8_t* proba0, const uint8_t* update_proba,
                          int use_skip, int skip_prob, const uint8_t* imodes,
                          const uint8_t* is_i4, const uint8_t* uvmode,
                          const uint8_t* skip, const uint8_t* seg_map,
                          const uint8_t* bmode_prob, const int8_t* tree,
                          int mb_w, int mb_h, uint8_t* out, long cap) {
  BoolEncoder bw;
  bw.put_bit(0x80, 0);  // colour space
  bw.put_bit(0x80, 0);  // clamp type
  if (num_segments > 1) {
    bw.put_bit(0x80, 1);  // use_segment
    bw.put_bit(0x80, 1);  // update_map
    bw.put_bit(0x80, 1);  // update feature data
    bw.put_bit(0x80, 1);  // absolute values
    for (int i = 0; i < 4; ++i) {
      bw.put_bit(0x80, 1);
      bw.put_bits((uint32_t)seg_hdr[i], 7);
      bw.put_bit(0x80, 0);  // sign
    }
    for (int i = 4; i < 8; ++i) {
      bw.put_bit(0x80, 1);
      bw.put_bits((uint32_t)seg_hdr[i], 6);
      bw.put_bit(0x80, 0);
    }
    for (int i = 8; i < 11; ++i) {
      if (seg_hdr[i] == 255) {
        bw.put_bit(0x80, 0);
      } else {
        bw.put_bit(0x80, 1);
        bw.put_bits((uint32_t)seg_hdr[i], 8);
      }
    }
  } else {
    bw.put_bit(0x80, 0);
  }
  bw.put_bit(0x80, filter_simple ? 1 : 0);
  bw.put_bits((uint32_t)filter_level, 6);
  bw.put_bits((uint32_t)filter_sharpness, 3);
  bw.put_bit(0x80, 0);  // no loop-filter deltas
  bw.put_bits((uint32_t)log2_parts, 2);
  bw.put_bits((uint32_t)base_q, 7);
  for (int i = 0; i < 3; ++i) bw.put_bit(0x80, 0);  // y1_dc, y2_dc, y2_ac
  for (int delta : {dq_uv_dc, dq_uv_ac}) {
    if (delta) {
      bw.put_bit(0x80, 1);
      bw.put_signed_bits(delta, 4);
    } else {
      bw.put_bit(0x80, 0);
    }
  }
  bw.put_bit(0x80, 0);  // refresh entropy probs (keyframe: ignored)
  for (int i = 0; i < 4 * 8 * 3 * 11; ++i) {
    if (proba[i] != proba0[i]) {
      bw.put_bit(update_proba[i], 1);
      bw.put_bits(proba[i], 8);
    } else {
      bw.put_bit(update_proba[i], 0);
    }
  }
  if (use_skip) {
    bw.put_bit(0x80, 1);
    bw.put_bits((uint32_t)skip_prob, 8);
  } else {
    bw.put_bit(0x80, 0);
  }
  write_mb_modes(&bw, imodes, is_i4, uvmode, skip, use_skip, skip_prob,
                 bmode_prob, tree, mb_w, mb_h, seg_map, seg_hdr + 8,
                 num_segments);
  bw.finish();
  long n = (long)bw.buf.size();
  if (n > cap) return -n;
  memcpy(out, bw.buf.data(), n);
  return n;
}

// Codes one frame's coefficient tokens in one call: records the branch
// statistics, writes the coefficient probabilities [4][8][3][11] into
// proba (OptimizeProbas against proba0, update_proba and entropy_cost
// [256]) and emits every token partition with them, MB row r into
// partition r mod num_parts (a power of 2), their sizes into part_sizes
// [num_parts] and their bytes, one after another, into out. The levels
// are dense (levels int32 [n_mb][24][16], y2 int32 [n_mb][16]; packed
// null) or the device's packed fields (packed u8 [n_mb][24][8], esc_idx
// int32 and esc_val int16 [esc_cnt][16] the escaped blocks in ascending
// block order, y2 int16 [n_mb][16]; levels null). Returns the bytes
// written; minus the bytes needed (nothing copied) when they exceed cap;
// -1 when the escape list is out of order or out of range.
long vp8_code_frame(const int32_t* levels, const uint8_t* packed,
                    const int32_t* esc_idx, const int16_t* esc_val,
                    int esc_cnt, const void* y2, const uint8_t* is_i4,
                    const uint8_t* skip, int mb_w, int mb_h, int use_skip,
                    int num_parts, const uint8_t* proba0,
                    const uint8_t* update_proba, const int32_t* entropy_cost,
                    uint8_t* proba, int64_t* part_sizes, uint8_t* out,
                    long cap) {
  if (!packed) {
    DenseLevels src{levels, (const int32_t*)y2};
    return CodeFrame(src, is_i4, skip, mb_w, mb_h, use_skip, num_parts,
                     proba0, update_proba, entropy_cost, proba, part_sizes,
                     out, cap);
  }
  const long n_blocks = (long)mb_w * mb_h * 24;
  if (esc_cnt < 0) return -1;
  for (int k = 0; k < esc_cnt; ++k) {
    if (esc_idx[k] < 0 || esc_idx[k] >= n_blocks ||
        (k && esc_idx[k] <= esc_idx[k - 1]))
      return -1;
  }
  PackedLevels src{packed, esc_idx, esc_val, esc_cnt, (const int16_t*)y2};
  return CodeFrame(src, is_i4, skip, mb_w, mb_h, use_skip, num_parts,
                   proba0, update_proba, entropy_cost, proba, part_sizes,
                   out, cap);
}

}  // extern "C"
