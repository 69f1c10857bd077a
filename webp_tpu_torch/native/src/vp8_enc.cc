// VP8 encoder host-side entropy coding (native fast path).
//
// Mirrors webp_tpu_torch/lossy/encode.py's token writer / mode writer / stats
// recorder byte-for-byte: the Python implementations are the conformance
// oracle (differentially tested in tests/test_native.py).

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

// Writes one block's coefficient tokens. levels: [16] zigzag.
// Returns nz bit. If bw == nullptr, performs a dry-run (context only).
static int PutCoeffs(BoolWriter* bw, const ProbaView& pv, int ptype, int ctx,
                     const int32_t* lv, int first) {
  int last = -1;
  for (int i = 15; i >= first; --i) {
    if (lv[i]) {
      last = i;
      break;
    }
  }
  int n = first;
  const uint8_t* p = pv.at(ptype, kBands[n], ctx);
  if (last < first) {
    if (bw) bw->put_bit(p[0], 0);
    return 0;
  }
  if (!bw) return 1;
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
  int last = -1;
  for (int i = 15; i >= first; --i) {
    if (lv[i]) {
      last = i;
      break;
    }
  }
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

struct MBArrays {
  const int32_t* levels;     // [nmb][24][16]
  const int32_t* y2_levels;  // [nmb][16]
  const uint8_t* is_i4;      // [nmb]
  const uint8_t* skip;       // [nmb]
  int mb_w, mb_h, use_skip;
};

// One MB's tokens; updates contexts. bw==nullptr -> dry run.
template <typename FN>
static void WalkMB(const MBArrays& a, int mb, uint32_t* tnz_io,
                   uint32_t* lnz_io, uint8_t* tdc_io, uint8_t* ldc_io,
                   FN&& block) {
  const int32_t* lv = a.levels + (size_t)mb * 24 * 16;
  uint32_t tnz_in = *tnz_io, lnz_in = *lnz_io;
  int first, ptype;
  if (!a.is_i4[mb]) {
    int ctx = *tdc_io + *ldc_io;
    int nz = block(1, ctx, a.y2_levels + (size_t)mb * 16, 0);
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

}  // namespace webptpu

using namespace webptpu;

extern "C" {

// Stateful bool writer handle (header bits driven from Python).
void* bw_new() { return new BoolWriter(); }
void bw_free(void* h) { delete (BoolWriter*)h; }
void bw_put_bit(void* h, int prob, int bit) {
  ((BoolWriter*)h)->put_bit(prob, bit);
}
void bw_put_bits(void* h, uint32_t v, int n) { ((BoolWriter*)h)->put_bits(v, n); }
void bw_put_signed_bits(void* h, int v, int n) {
  ((BoolWriter*)h)->put_signed_bits(v, n);
}
long bw_size(void* h) { return (long)((BoolWriter*)h)->buf.size(); }
long bw_finish(void* h, uint8_t* out, long cap) {
  BoolWriter* bw = (BoolWriter*)h;
  bw->finish();
  long n = (long)bw->buf.size();
  if (n > cap) return -1;
  memcpy(out, bw->buf.data(), n);
  return n;
}

// Writes the per-MB mode records into an existing bool writer (partition 0).
static void write_mb_modes_impl(void* h, const uint8_t* imodes,
                       const uint8_t* is_i4, const uint8_t* uvmode,
                       const uint8_t* skip, int use_skip, int skip_prob,
                       const uint8_t* bmode_prob,
                       const int8_t* tree, int mb_w, int mb_h,
                       const uint8_t* seg_map, const uint8_t* seg_probas,
                       int num_segments) {
  BoolWriter* bw = (BoolWriter*)h;
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

// Emits one token partition. Returns byte count or -1 on overflow.
long vp8_emit_tokens(const int32_t* levels, const int32_t* y2_levels,
                     const uint8_t* is_i4, const uint8_t* skip,
                     const uint8_t* proba, int mb_w, int mb_h, int use_skip,
                     int part_idx, int num_parts, uint8_t* out, long cap) {
  MBArrays a{levels, y2_levels, is_i4, skip, mb_w, mb_h, use_skip};
  ProbaView pv{proba};
  BoolWriter bw;
  std::vector<uint32_t> top_nz(mb_w, 0);
  std::vector<uint8_t> top_dc(mb_w, 0);
  for (int mb_y = 0; mb_y < mb_h; ++mb_y) {
    bool mine = (mb_y & (num_parts - 1)) == part_idx;
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
      BoolWriter* target = mine ? &bw : nullptr;
      WalkMB(a, mb, &top_nz[mb_x], &left_nz, &top_dc[mb_x], &left_dc,
             [&](int ptype, int ctx, const int32_t* lv, int first) {
               if (target) return PutCoeffs(target, pv, ptype, ctx, lv, first);
               // Dry run: nz only.
               for (int i = 15; i >= first; --i)
                 if (lv[i]) return 1;
               return 0;
             });
    }
  }
  bw.finish();
  long n = (long)bw.buf.size();
  if (n > cap) return -1;
  memcpy(out, bw.buf.data(), n);
  return n;
}

// Records branch statistics over all MBs: stats [4][8][3][11][2] int64.
void vp8_record_stats(const int32_t* levels, const int32_t* y2_levels,
                      const uint8_t* is_i4, const uint8_t* skip, int mb_w,
                      int mb_h, int use_skip, int64_t* stats) {
  MBArrays a{levels, y2_levels, is_i4, skip, mb_w, mb_h, use_skip};
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
      WalkMB(a, mb, &top_nz[mb_x], &left_nz, &top_dc[mb_x], &left_dc,
             [&](int ptype, int ctx, const int32_t* lv, int first) {
               return RecordCoeffs(stats, ptype, ctx, lv, first);
             });
    }
  }
}

}  // extern "C"

extern "C" void bw_write_mb_modes(void* h, const uint8_t* imodes,
                       const uint8_t* is_i4, const uint8_t* uvmode,
                       const uint8_t* skip, int use_skip, int skip_prob,
                       const uint8_t* bmode_prob,
                       const int8_t* tree, int mb_w, int mb_h) {
  write_mb_modes_impl(h, imodes, is_i4, uvmode, skip, use_skip, skip_prob,
                      bmode_prob, tree, mb_w, mb_h, nullptr, nullptr, 1);
}

extern "C" void bw_write_mb_modes_seg(void* h, const uint8_t* imodes,
                       const uint8_t* is_i4, const uint8_t* uvmode,
                       const uint8_t* skip, int use_skip, int skip_prob,
                       const uint8_t* bmode_prob,
                       const int8_t* tree, int mb_w, int mb_h,
                       const uint8_t* seg_map, const uint8_t* seg_probas,
                       int num_segments) {
  write_mb_modes_impl(h, imodes, is_i4, uvmode, skip, use_skip, skip_prob,
                      bmode_prob, tree, mb_w, mb_h, seg_map, seg_probas,
                      num_segments);
}
