// Decode wavefront kernel: the VP8 reconstruction (IDCT, I16, I4 and
// chroma prediction) and the in-loop filter of every macroblock of a batch
// of frames, in one launch.
//
// Replaces no TPU kernel: the reference's device decode
// (webp_tpu/ops/decode.py) is a jnp step loop with no pallas_call. Its
// plain PyTorch version, the same step loop, and the launch wrapper are
// webp_tpu_torch/ops/decode.py (DecodeFn.plain / wavefront). It was added
// because that step loop on the card ran as ~2,700 tiny ATen kernels per
// step, 222 steps an image at 1536x1024, ~0.8 s an image.
//
// Inputs per image and macroblock (raster order, n_mb = mb_w * mb_h), as
// the host's token parse gives them: coeffs i16 [B, n_mb, 24, 16]
// (dequantized, the WHT already applied; blocks 0-15 luma, 16-19 U, 20-23
// V, each raster 4x4), is_i4 and inner bool [B, n_mb], imodes u8 [B, n_mb,
// 16] (the I16 mode in entry 0, or the 16 subblock modes DC, TM, VE, HE,
// RD, VR, LD, VL, HD, HU), uvmode u8 [B, n_mb], limit, ilevel, hevt i32
// [B, n_mb] (the filter's per-MB parameters); the filter type (0 none,
// 1 simple, 2 normal) as an argument. Outputs: the filtered MB-padded
// planes Y u8 [B, 16 mb_h, 16 mb_w], U and V u8 [B, 8 mb_h, 8 mb_w].
//
// Order (the host decoder's): MB (x, y) runs at step t = x + 2y. Then its
// left MB (x-1, y), the MB above (x, y-1) and the above-right MB (x+1, y-1)
// were all finished at step t-1 or before, and no two MBs of one step
// touch the same pixels. Each MB reconstructs from unfiltered contours,
// then filters at lag 0 in raster order: its vertical edges (the left MB
// edge over the left MB's last 4 columns, then the inner edges), then its
// horizontal ones (the top MB edge over the upper MB's last 4 rows, then
// the inner edges). The simple filter is the host decoder's (luma, p0 and
// q0), not the reference device decode's clamped gather.
//
// Design (kernel 4's pattern, csrc/p2_wavefront.cu, at skew 2):
//
// * A thread block cluster of C blocks per image (C from ops/p2_kernel.py
//   cluster_size: 8 at B = 1 and B = 16, 1 where mb_h = 1). Block `rank`
//   owns the MB rows y with y mod C == rank; each of its SLOTS warps takes
//   one MB at a time (further rounds where a step has more of its rows).
//   One cluster.sync() ends each step.
// * Unfiltered contours on chip. Each block keeps a line (the bottom rows
//   of the row above its rows: W luma, W/2 U, W/2 V bytes) and per owned
//   row a left slot (the right columns of the row's last MB and a corner
//   stash). MB (x, y) reads its top contour from segment x of its own
//   block's line, its above-right strip from segment x+1 (past the last
//   column the top row's pixel 15 repeated), its left column and corner
//   from its row's left slot. At its end it stores its bottom rows into
//   the line of block (y+1) mod C (a remote store), its right columns and
//   its top contour's pixel 15 (the next MB's corner) into the left slot.
//   Who writes what, and when: segment x of a line is written by MB
//   (x, y) at the end of step x+2y, read by (x-1, y+1) at step x+2y+1 and
//   by (x, y+1) at step x+2y+2, and rewritten by (x, y+C) at step
//   x+2y+2C: with C = 1 the reader at x+2y+2 is that rewriter, which
//   reads before it writes. The corner of (x+1, y+1), read at step
//   x+2y+3, would be gone by then with C = 1, so it is taken from the
//   stash. A left slot is written by (x-1, y) at step t-1 and read, then
//   rewritten, by (x, y) at step t.
// * The filter on the frame in device memory. At the start of its step an
//   MB loads the 4 filtered columns of its left MB and the 4 filtered rows
//   of the MB above (ld.global.cg: written by other SMs one step before)
//   while it reconstructs; a warp filters a row a lane (luma on lanes 0-15,
//   U and V rows on 16-31), transposes through shared memory, filters a
//   column a lane, and stores the MB and the two patched strips.
// * Reconstruction on one warp per MB. Lanes 0-15 run the IDCT of luma
//   block `lane` (common.cuh idct4x4, the plain version's integer
//   transform to the bit) and, on an I16 MB, predict and reconstruct it;
//   lanes 16-23 do the same for the 8 chroma blocks. An I4 MB then walks
//   its 10 subblock anti-diagonals, a lane a pixel (two subblocks at once),
//   each lane taking its prediction from common.cuh's I4Contour.
//
// What bounds it on the H100: the chain of dependent steps (222 at
// 1536x1024), not bytes or operations. One image moves ~4.7 MB of
// coefficients in and 2.4 MB of planes out (~2 us at HBM's 3.35 TB/s);
// each step lasts as long as its slowest MB's dependent path (the 10 I4
// groups, then 4 + 4 edge filters a lane) plus one cluster barrier.

#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int SLOTS = 8;                // MB slots (warps) per thread block
constexpr int THREADS = SLOTS * 32;
constexpr unsigned FULL = 0xffffffffu;

// A condition that holds for the whole warp or for none of it, as a vote
// (every branch that encloses a __syncwarp goes through it).
__device__ __forceinline__ bool warp_uniform(bool c) {
  return __any_sync(FULL, c);
}

// A left slot (per owned row): luma corner at 0, right column 1-16; U
// corner 17, column 18-25; V corner 26, column 27-34.
constexpr int LEFT_BYTES = 48;
constexpr int L_Y = 0, L_U = 17, L_V = 26;
// An MB slot: the luma tile (17 rows of TS bytes: row 0 = corner, top
// contour and above-right strip at 17-20, column 0 = left contour, rows
// and columns 1-16 = the MB), the U and V tiles (9 x CS), the I4 modes,
// the luma residuals of an I4 MB (int [16 blocks][16]), and the filter's
// tiles: luma FS x FS (rows and columns -4..15 at 0..19: the left MB's
// last columns, the upper MB's last rows, the MB), U and V FC x FC.
constexpr int TS = 24, CS = 12, FS = 20, FC = 12;
constexpr int S_TY = 0, S_TU = 408, S_TV = 516, S_MODES = 624, S_R = 640,
              S_FY = 1664, S_FU = 2064, S_FV = 2208, SLOT_BYTES = 2352;
static_assert(SLOT_BYTES % 16 == 0 && S_R % 16 == 0, "alignment");

// Returned by the launcher when a cluster of C blocks cannot be resident.
constexpr int CLUSTER_DOES_NOT_FIT = -1;

size_t block_smem(int W, int rows) {
  return (size_t)2 * W + rows * LEFT_BYTES + SLOTS * SLOT_BYTES;
}

__device__ __forceinline__ int sclip1(int v) { return min(max(v, -128), 127); }
__device__ __forceinline__ int sclip2(int v) { return min(max(v, -16), 15); }

// The normal filter across one edge (p3..q3 = v[0..7], lossy/dsp.py's
// edge filters as ops/decode.py _filter_edge spells them): `thresh` is
// 2 * limit + 1, `mb` the macroblock edge's 6-tap form.
__device__ __forceinline__ void filter_normal(int* v, int thresh, int il,
                                              int hev_t, bool mb) {
  const int p3 = v[0], p2 = v[1], p1 = v[2], p0 = v[3];
  const int q0 = v[4], q1 = v[5], q2 = v[6], q3 = v[7];
  const bool ok = 4 * abs(p0 - q0) + abs(p1 - q1) <= thresh &&
                  abs(p3 - p2) <= il && abs(p2 - p1) <= il &&
                  abs(p1 - p0) <= il && abs(q3 - q2) <= il &&
                  abs(q2 - q1) <= il && abs(q1 - q0) <= il;
  if (!ok) return;
  if (abs(p1 - p0) > hev_t || abs(q1 - q0) > hev_t) {
    const int a = 3 * (q0 - p0) + sclip1(p1 - q1);
    v[3] = wtk::clamp255(p0 + sclip2((a + 3) >> 3));
    v[4] = wtk::clamp255(q0 - sclip2((a + 4) >> 3));
  } else if (mb) {
    const int b = sclip1(3 * (q0 - p0) + sclip1(p1 - q1));
    const int b1 = (27 * b + 63) >> 7, b2 = (18 * b + 63) >> 7,
              b3 = (9 * b + 63) >> 7;
    v[1] = wtk::clamp255(p2 + b3);
    v[2] = wtk::clamp255(p1 + b2);
    v[3] = wtk::clamp255(p0 + b1);
    v[4] = wtk::clamp255(q0 - b1);
    v[5] = wtk::clamp255(q1 - b2);
    v[6] = wtk::clamp255(q2 - b3);
  } else {
    const int a = 3 * (q0 - p0);
    const int a1 = sclip2((a + 4) >> 3), a2 = sclip2((a + 3) >> 3);
    const int a3 = (a1 + 1) >> 1;
    v[2] = wtk::clamp255(p1 + a3);
    v[3] = wtk::clamp255(p0 + a2);
    v[4] = wtk::clamp255(q0 - a1);
    v[5] = wtk::clamp255(q1 - a3);
  }
}

// The simple filter across one edge (p1..q1 = v[2..5]; p0, q0 change).
__device__ __forceinline__ void filter_simple(int* v, int thresh) {
  const int p1 = v[2], p0 = v[3], q0 = v[4], q1 = v[5];
  if (4 * abs(p0 - q0) + abs(p1 - q1) > thresh) return;
  const int a = 3 * (q0 - p0) + sclip1(p1 - q1);
  v[3] = wtk::clamp255(p0 + sclip2((a + 3) >> 3));
  v[4] = wtk::clamp255(q0 - sclip2((a + 4) >> 3));
}

// The filter's per-MB parameters.
struct Edges {
  bool edge0;                   // the MB edge (left or top) is filtered
  bool inner;                   // the inner edges are
  int mb_thresh, in_thresh, il, hev;
};

// Filters one line of N = 4 + S pixels (the neighbour's last 4, then the
// MB's S): the MB edge at 4, the inner edges at 8, 12, 16 (below N).
template <int N>
__device__ __forceinline__ void filter_line(int* v, const Edges& e,
                                            bool simple) {
  if (simple) {
    if (e.edge0) filter_simple(v, e.mb_thresh);
    if (e.inner) {
#pragma unroll
      for (int k = 8; k < N; k += 4) filter_simple(v + k - 4, e.in_thresh);
    }
  } else {
    if (e.edge0) filter_normal(v, e.mb_thresh, e.il, e.hev, true);
    if (e.inner) {
#pragma unroll
      for (int k = 8; k < N; k += 4)
        filter_normal(v + k - 4, e.in_thresh, e.il, e.hev, false);
    }
  }
}

__device__ __forceinline__ void bytes4(uint32_t w, int* v) {
#pragma unroll
  for (int k = 0; k < 4; ++k) v[k] = (w >> (8 * k)) & 0xFF;
}

__device__ __forceinline__ uint32_t pack4(const uint8_t* s) {
  return *reinterpret_cast<const uint32_t*>(s);
}

// The kernel's tensors and sizes.
struct Args {
  const int16_t* coeffs;
  const uint8_t *is_i4, *imodes, *uvmode;
  const int *limit, *ilevel, *hevt;
  const uint8_t* inner;
  uint8_t *Y, *U, *V;
  int mb_w, mb_h, C, ftype;
};

// One MB's inputs, loaded one MB ahead: the lane's coefficient block
// (lanes 0-23), its I4 mode (lanes 0-15) and the MB's modes and filter
// parameters.
struct In {
  uint4 c0, c1;
  int i4mode, is_i4, mode16, uvm, limit, il, hev, inner;
};

__device__ __forceinline__ In fetch(const Args& a, size_t m, int lane) {
  In in;
  if (lane < 24) {
    const uint4* c = reinterpret_cast<const uint4*>(a.coeffs + (m * 24 + lane) * 16);
    in.c0 = __ldg(c);
    in.c1 = __ldg(c + 1);
  } else {
    in.c0 = in.c1 = make_uint4(0, 0, 0, 0);
  }
  in.i4mode = a.imodes[m * 16 + (lane & 15)];
  in.mode16 = a.imodes[m * 16];
  in.is_i4 = a.is_i4[m];
  in.uvm = a.uvmode[m];
  in.limit = a.limit[m];
  in.il = a.ilevel[m];
  in.hev = a.hevt[m];
  in.inner = a.inner[m];
  return in;
}

// The MB at (x, y) of image img that a warp works on, and where its
// block's shared memory holds what.
struct Mb {
  int lane, x, y, img;
  bool ht, hl, hb;
  uint8_t* line;                // this block's line: row y-1's bottom rows
  uint8_t* below;               // block (y + 1) mod C's line
  uint8_t* left;                // this row's left slot
  uint8_t* slot;                // this warp's tiles
};

// The 16 residuals of one coefficient block (raster), by common.cuh's
// integer IDCT.
__device__ __forceinline__ void idct_block(const In& in, int* res) {
  const uint32_t w[8] = {in.c0.x, in.c0.y, in.c0.z, in.c0.w,
                         in.c1.x, in.c1.y, in.c1.z, in.c1.w};
  int co[16];
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    co[2 * k] = (int)(int16_t)(w[k] & 0xFFFFu);
    co[2 * k + 1] = (int)w[k] >> 16;
  }
  wtk::idct4x4(co, res);
}

// The DC prediction of a size x size block from its masked contour (tile
// row 0 and column 0, stride ts): ops/fastpath.py _preds4.
template <int kSize>
__device__ __forceinline__ int dc_pred(const uint8_t* T, int ts, bool ht,
                                       bool hl) {
  int st = 0, sl = 0;
#pragma unroll
  for (int k = 1; k <= kSize; ++k) {
    st += T[k];
    sl += T[k * ts];
  }
  constexpr int shift = kSize == 16 ? 5 : 4;
  return (ht && hl) ? (st + sl + kSize) >> shift
         : ht       ? (st + (kSize >> 1)) >> (shift - 1)
         : hl       ? (sl + (kSize >> 1)) >> (shift - 1)
                    : 0x80;
}

// The I4 walk: the 10 subblock anti-diagonals (subblock (r, c) in group
// c + 2r) one after the other; the first subblock of a group on lanes
// 0-15, the second (where there is one) on lanes 16-31, a lane a pixel.
__device__ __forceinline__ void i4_walk(const Mb& k, uint8_t* T) {
  const int h = k.lane >> 4, p = k.lane & 15, pr = p >> 2, pc = p & 3;
  const uint8_t* modes = k.slot + S_MODES;
  const int* R = reinterpret_cast<const int*>(k.slot + S_R);
#pragma unroll
  for (int grp = 0; grp < 10; ++grp) {
    const int r0 = max(0, (grp - 2) / 2), c0 = grp - 2 * r0;
    const bool has2 = r0 + 1 < 4 && c0 - 2 >= 0;
    const int r = h && has2 ? r0 + 1 : r0, c = h && has2 ? c0 - 2 : c0;
    const int blk = r * 4 + c;
    // The subblock's contour: tile row 4r above it, column 4c left of it;
    // the above-right of column 3 is the MB's strip on every row.
    const uint8_t* top = T + 4 * r * TS + 4 * c;
    int l[4], t[4], tr[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      l[j] = top[(1 + j) * TS];
      t[j] = top[1 + j];
      tr[j] = c == 3 ? T[17 + j] : top[5 + j];
    }
    const wtk::I4Contour ctr(l, top[0], t, tr);
    int mode = modes[blk];
    mode = mode > 9 ? 0 : mode;
    const int v = wtk::clamp255(ctr.pred(mode, pr, pc) + R[blk * 16 + p]);
    if (h == 0 || has2) T[(4 * r + 1 + pr) * TS + 4 * c + 1 + pc] = (uint8_t)v;
    __syncwarp();
  }
}

// One MB: its contour, reconstruction, hand-over of its unfiltered edges,
// the loop filter and the stores.
__device__ __forceinline__ void decode_mb(const Args& a, const Mb& k,
                                          const In& in) {
  const int lane = k.lane, x = k.x, y = k.y;
  const int W = a.mb_w * 16, CW = a.mb_w * 8;
  const size_t H = (size_t)a.mb_h * 16, CH = (size_t)a.mb_h * 8;
  uint8_t* TY = k.slot + S_TY;
  uint8_t* TU = k.slot + S_TU;
  uint8_t* TV = k.slot + S_TV;
  uint8_t* FY = k.slot + S_FY;

  // The filter's neighbours, loaded now and used after the
  // reconstruction: the left MB's last 4 columns (a row a lane: luma on
  // 0-15, U on 16-23, V on 24-31) and the upper MB's last 4 rows (luma
  // rows on lanes 0-3, U on 4-7, V on 8-11).
  const bool en = a.ftype > 0 && in.limit > 0;
  const bool fchroma = a.ftype == 2;
  const bool hlf = en && x > 0, htf = en && y > 0;
  const int pl = (lane >> 3) & 1, cr = lane & 7;           // chroma lanes
  uint8_t* cplane = pl ? a.V : a.U;
  uint32_t left_w = 0;
  uint4 top_w = make_uint4(0, 0, 0, 0);
  if (hlf && (lane < 16 || fchroma)) {
    const uint8_t* src =
        lane < 16 ? a.Y + ((size_t)k.img * H + y * 16 + lane) * W + x * 16 - 4
                  : cplane + ((size_t)k.img * CH + y * 8 + cr) * CW + x * 8 - 4;
    left_w = __ldcg(reinterpret_cast<const unsigned int*>(src));
  }
  if (htf && (lane < 4 || (fchroma && lane < 12))) {
    if (lane < 4) {
      top_w = __ldcg(reinterpret_cast<const uint4*>(
          a.Y + ((size_t)k.img * H + y * 16 - 4 + lane) * W + x * 16));
    } else {
      const int cp = (lane - 4) >> 2, r = lane & 3;
      const uint2 w = __ldcg(reinterpret_cast<const uint2*>(
          (cp ? a.V : a.U) + ((size_t)k.img * CH + y * 8 - 4 + r) * CW + x * 8));
      top_w = make_uint4(w.x, w.y, 0, 0);
    }
  }

  // The contour, masked: 127 above the frame, 129 left of it, the corner
  // as ops/fastpath.py _preds4 fills it.
  const int fill_tl = (k.ht && k.hl) ? -1 : (k.ht ? 129 : 127);
  if (lane < 16) {
    TY[1 + lane] = k.ht ? k.line[x * 16 + lane] : 127;
    TY[(1 + lane) * TS] = k.hl ? k.left[L_Y + 1 + lane] : 129;
    k.slot[S_MODES + lane] = (uint8_t)in.i4mode;
    if (lane < 4) {
      const int src = x + 1 < a.mb_w ? (x + 1) * 16 + lane : x * 16 + 15;
      TY[17 + lane] = k.ht ? k.line[src] : 127;
    }
    if (lane == 0) TY[0] = fill_tl < 0 ? k.left[L_Y] : fill_tl;
  } else {
    uint8_t* Tp = pl ? TV : TU;
    const int lo = pl ? L_V : L_U;
    Tp[1 + cr] = k.ht ? k.line[W + pl * CW + x * 8 + cr] : 127;
    Tp[(1 + cr) * CS] = k.hl ? k.left[lo + 1 + cr] : 129;
    if (cr == 0) Tp[0] = fill_tl < 0 ? k.left[lo] : fill_tl;
  }
  __syncwarp();

  // Phase A: the IDCT of every block; I16 luma and chroma reconstructed
  // beside it, an I4 MB's luma residuals kept for the walk.
  const bool i4 = warp_uniform(in.is_i4 != 0);
  if (lane < 24) {
    int res[16];
    idct_block(in, res);
    if (lane < 16) {
      const int blk = lane;
      if (i4) {
        int* R = reinterpret_cast<int*>(k.slot + S_R) + blk * 16;
#pragma unroll
        for (int p = 0; p < 16; ++p) R[p] = res[p];
      } else {
        const int dc = dc_pred<16>(TY, TS, k.ht, k.hl);
        const int mode = min(in.mode16, 3);
#pragma unroll
        for (int p = 0; p < 16; ++p) {
          const int row = (blk >> 2) * 4 + (p >> 2), col = (blk & 3) * 4 + (p & 3);
          const int pred = wtk::pred_dtvh(mode, dc, TY[(1 + row) * TS],
                                          TY[1 + col], TY[0]);
          TY[(1 + row) * TS + 1 + col] = (uint8_t)wtk::clamp255(pred + res[p]);
        }
      }
    } else {
      const int kb = lane - 16, cp = kb >> 2, jb = kb & 3;
      uint8_t* Tp = cp ? TV : TU;
      const int dc = dc_pred<8>(Tp, CS, k.ht, k.hl);
      const int mode = min(in.uvm, 3);
#pragma unroll
      for (int p = 0; p < 16; ++p) {
        const int row = (jb >> 1) * 4 + (p >> 2), col = (jb & 1) * 4 + (p & 3);
        const int pred = wtk::pred_dtvh(mode, dc, Tp[(1 + row) * CS],
                                        Tp[1 + col], Tp[0]);
        Tp[(1 + row) * CS + 1 + col] = (uint8_t)wtk::clamp255(pred + res[p]);
      }
    }
  }
  __syncwarp();
  if (i4) i4_walk(k, TY);

  // Hand the unfiltered edges on: the bottom rows to the line that row
  // y + 1 reads (a store into that block's shared memory, which the
  // step's cluster barrier makes visible), the right columns and the
  // corner stash (this MB's top contour pixel 15, the corner of MB
  // (x + 1, y)) to the row's left slot.
  if (lane < 16) {
    if (k.hb) k.below[x * 16 + lane] = TY[16 * TS + 1 + lane];
    k.left[L_Y + 1 + lane] = TY[(1 + lane) * TS + 16];
    if (lane == 0) k.left[L_Y] = TY[16];
  } else {
    const uint8_t* Tp = pl ? TV : TU;
    const int lo = pl ? L_V : L_U;
    if (k.hb) k.below[W + pl * CW + x * 8 + cr] = Tp[8 * CS + 1 + cr];
    k.left[lo + 1 + cr] = Tp[(1 + cr) * CS + 8];
    if (cr == 0) k.left[lo] = Tp[8];
  }

  // The loop filter. Vertical edges, a row a lane: the left MB's 4 loaded
  // columns, then the MB's own; the result into the filter tile, whose
  // rows 0-3 take the upper MB's loaded rows.
  Edges e;
  e.edge0 = hlf;
  e.inner = en && in.inner;
  e.mb_thresh = 2 * (in.limit + 4) + 1;
  e.in_thresh = 2 * in.limit + 1;
  e.il = in.il;
  e.hev = in.hev;
  const bool simple = a.ftype == 1;
  uint8_t* Fp = k.slot + (pl ? S_FV : S_FU);
  if (lane < 16) {
    int v[20];
    bytes4(left_w, v);
#pragma unroll
    for (int j = 0; j < 16; ++j) v[4 + j] = TY[(1 + lane) * TS + 1 + j];
    filter_line<20>(v, e, simple);
#pragma unroll
    for (int j = 0; j < 20; ++j) FY[(4 + lane) * FS + j] = (uint8_t)v[j];
  } else {
    const uint8_t* Tp = pl ? TV : TU;
    int v[12];
    bytes4(left_w, v);
#pragma unroll
    for (int j = 0; j < 8; ++j) v[4 + j] = Tp[(1 + cr) * CS + 1 + j];
    if (fchroma) filter_line<12>(v, e, false);
#pragma unroll
    for (int j = 0; j < 12; ++j) Fp[(4 + cr) * FC + j] = (uint8_t)v[j];
  }
  if (lane < 4) {
    uint32_t* d = reinterpret_cast<uint32_t*>(FY + lane * FS + 4);
    d[0] = top_w.x, d[1] = top_w.y, d[2] = top_w.z, d[3] = top_w.w;
  } else if (lane < 12) {
    const int cp = (lane - 4) >> 2;
    uint32_t* d = reinterpret_cast<uint32_t*>(k.slot + (cp ? S_FV : S_FU) +
                                              (lane & 3) * FC + 4);
    d[0] = top_w.x, d[1] = top_w.y;
  }
  __syncwarp();
  // Horizontal edges, a column a lane (rows -4..15 of the tile).
  e.edge0 = htf;
  if (lane < 16) {
    int v[20];
#pragma unroll
    for (int j = 0; j < 20; ++j) v[j] = FY[j * FS + 4 + lane];
    filter_line<20>(v, e, simple);
#pragma unroll
    for (int j = 0; j < 20; ++j) FY[j * FS + 4 + lane] = (uint8_t)v[j];
  } else if (fchroma) {
    int v[12];
#pragma unroll
    for (int j = 0; j < 12; ++j) v[j] = Fp[j * FC + 4 + cr];
    filter_line<12>(v, e, false);
#pragma unroll
    for (int j = 0; j < 12; ++j) Fp[j * FC + 4 + cr] = (uint8_t)v[j];
  }
  __syncwarp();

  // The stores: the MB (a row a lane), the left MB's patched columns
  // 12-15 and the upper MB's patched rows 12-15 (column 12 and row 12 are
  // the filters' p3, unchanged).
  if (lane < 16) {
    const uint8_t* s = FY + (4 + lane) * FS;
    uint8_t* d = a.Y + ((size_t)k.img * H + y * 16 + lane) * W + x * 16;
    *reinterpret_cast<uint4*>(d) =
        make_uint4(pack4(s + 4), pack4(s + 8), pack4(s + 12), pack4(s + 16));
    if (hlf) *reinterpret_cast<uint32_t*>(d - 4) = pack4(s);
  } else {
    const uint8_t* s = Fp + (4 + cr) * FC;
    uint8_t* d = cplane + ((size_t)k.img * CH + y * 8 + cr) * CW + x * 8;
    *reinterpret_cast<uint2*>(d) = make_uint2(pack4(s + 4), pack4(s + 8));
    if (hlf && fchroma) *reinterpret_cast<uint32_t*>(d - 4) = pack4(s);
  }
  if (htf && lane < 4) {
    const uint8_t* s = FY + lane * FS;
    *reinterpret_cast<uint4*>(a.Y + ((size_t)k.img * H + y * 16 - 4 + lane) * W +
                              x * 16) =
        make_uint4(pack4(s + 4), pack4(s + 8), pack4(s + 12), pack4(s + 16));
  } else if (htf && fchroma && lane < 12) {
    const int cp = (lane - 4) >> 2, r = lane & 3;
    const uint8_t* s = k.slot + (cp ? S_FV : S_FU) + r * FC;
    *reinterpret_cast<uint2*>((cp ? a.V : a.U) +
                              ((size_t)k.img * CH + y * 8 - 4 + r) * CW + x * 8) =
        make_uint2(pack4(s + 4), pack4(s + 8));
  }
  __syncwarp();
}

// A slot's MB rows, step by step: block `rank` owns the rows y with
// y mod C == rank (C = 1 << lc); in step t, whose MBs are the rows y_lo(t)
// .. last(t) at x = t - 2y, slot s takes the j-th owned row with j mod
// SLOTS == s: first(t), first(t) + SLOTS * C, ... up to last(t).
struct Rows {
  int mb_w, mb_h, lc, rank, slot;
  __device__ int first(int t) const {
    const int y_lo = max(0, (t - mb_w + 2) >> 1);
    return y_lo + ((rank - y_lo) & ((1 << lc) - 1)) + (slot << lc);
  }
  __device__ int last(int t) const { return min(mb_h - 1, t >> 1); }
};

__global__ void __launch_bounds__(THREADS)
    decode_wavefront_kernel(const Args a) {
  extern __shared__ uint4 dw_smem[];
  uint8_t* sm = reinterpret_cast<uint8_t*>(dw_smem);
  cg::cluster_group cluster = cg::this_cluster();
  const int C = a.C;
  const int rank = (int)cluster.block_rank();
  const int W = a.mb_w * 16;
  const int n_rows = (a.mb_h + C - 1) / C;
  uint8_t* line = sm;
  uint8_t* s_left = sm + 2 * W;
  const int tid = threadIdx.x, warp = tid >> 5;
  Mb k;
  k.lane = tid & 31;
  k.img = blockIdx.x / C;
  k.line = line;
  k.slot = s_left + n_rows * LEFT_BYTES + warp * SLOT_BYTES;
  const Rows rows{a.mb_w, a.mb_h, __ffs(C) - 1, rank, warp};
  const int steps = a.mb_w + 2 * (a.mb_h - 1), stride = SLOTS << rows.lc;
  const int cmask = C - 1;
  const size_t mb0 = (size_t)k.img * a.mb_w * a.mb_h;
  auto mb_of = [&](int t, int y) { return mb0 + (size_t)y * a.mb_w + t - 2 * y; };
  // Every block of the cluster running before any block writes another's
  // shared memory.
  cluster.sync();

  In in{};
  bool ahead = false;           // `in` holds this MB's inputs
  for (int t = 0; t < steps; ++t) {
    for (int y = rows.first(t); warp_uniform(y <= rows.last(t)); y += stride) {
      const In cur = ahead ? in : fetch(a, mb_of(t, y), k.lane);
      int nt = t, ny = y + stride;
      if (ny > rows.last(t)) ny = rows.first(++nt);
      ahead = nt < steps && ny <= rows.last(nt);
      if (ahead) in = fetch(a, mb_of(nt, ny), k.lane);
      k.x = t - 2 * y;
      k.y = y;
      k.ht = y > 0;
      k.hl = k.x > 0;
      k.hb = y + 1 < a.mb_h;
      k.below = cluster.map_shared_rank(line, (unsigned)((y + 1) & cmask));
      k.left = s_left + (y >> rows.lc) * LEFT_BYTES;
      decode_mb(a, k, cur);
    }
    cluster.sync();
  }
}

// The launch configuration of a batch of B frames with clusters of C.
struct Launch {
  cudaLaunchAttribute attr[1];
  cudaLaunchConfig_t cfg;
  Launch(int B, int mb_w, int mb_h, int C, cudaStream_t stream) {
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = C;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg = {};
    cfg.gridDim = dim3(B * C, 1, 1);
    cfg.blockDim = dim3(THREADS, 1, 1);
    cfg.dynamicSmemBytes = block_smem(mb_w * 16, (mb_h + C - 1) / C);
    cfg.stream = stream;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
  }
};

// How many clusters of C blocks of this kernel the device can hold at once
// for frames of mb_w x mb_h MBs (into *clusters); a CUDA error code.
int max_clusters(int mb_w, int mb_h, int C, int* clusters) {
  if (C < 1 || C > 8 || (C & (C - 1)) || C > mb_h)
    return (int)cudaErrorInvalidValue;
  const Launch l(1, mb_w, mb_h, C, nullptr);
  cudaError_t err = cudaFuncSetAttribute(
      decode_wavefront_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)l.cfg.dynamicSmemBytes);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveClusters(clusters, decode_wavefront_kernel,
                                             &l.cfg);
}

}  // namespace

extern "C" int decode_wavefront_launch(const void* coeffs, const void* is_i4,
                                       const void* imodes, const void* uvmode,
                                       const void* limit, const void* ilevel,
                                       const void* hevt, const void* inner,
                                       int B, int mb_w, int mb_h, int C,
                                       int filter_type, void* Y, void* U,
                                       void* V, void* stream) {
  if (filter_type < 0 || filter_type > 2) return (int)cudaErrorInvalidValue;
  int clusters = 0;
  const int err0 = max_clusters(mb_w, mb_h, C, &clusters);
  if (err0 != 0) return err0;
  if (clusters < 1) return CLUSTER_DOES_NOT_FIT;
  const Launch l(B, mb_w, mb_h, C, (cudaStream_t)stream);
  const Args a{(const int16_t*)coeffs, (const uint8_t*)is_i4,
               (const uint8_t*)imodes, (const uint8_t*)uvmode,
               (const int*)limit,      (const int*)ilevel,
               (const int*)hevt,       (const uint8_t*)inner,
               (uint8_t*)Y,            (uint8_t*)U,
               (uint8_t*)V,            mb_w,
               mb_h,                   C,
               filter_type};
  cudaError_t err = cudaLaunchKernelEx(&l.cfg, decode_wavefront_kernel, a);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
