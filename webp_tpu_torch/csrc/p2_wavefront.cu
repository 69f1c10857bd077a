// Phase-2 wavefront kernel: the closed-loop reconstruction of every
// macroblock with the modes of phase 1 fixed, and the fused pack of its
// levels; then the escape-list kernel.
//
// Replaces the TPU kernel webp_tpu/ops/pallas_p2.py `kernel` (:155, built
// by `_make_kernel` :123, `pallas_call` :483, driven by `phase2_pack_pallas`
// :531). Plain PyTorch version and launch wrapper:
// webp_tpu_torch/ops/p2_kernel.py (phase2_pack_plain / phase2_pack).
//
// Per macroblock, in skew-1 order (MB (x, y) at step x + y, so that its
// left and top neighbours were done one step before and its top-left two):
// the I16 pipeline (prediction from the reconstructed contour, forward DCT,
// WHT of the 16 DCs, quantization with the segment's rows and the
// trellis-lite rd_drop, inverse WHT and DCT) or, on an I4 macroblock, the
// closed-loop walk over its 16 subblocks with their modes fixed; beside it
// the chroma pipeline. Outputs, at their unskewed [B, n_mb, ...] addresses:
// the nibble plane (a coefficient with |level| > 7 ships as nibble 0), the
// int16 level plane, the y2 levels, and per MB two flag words (escape bits
// of the 16 luma blocks and of the 8 chroma blocks at bits 16-23, a
// non-zero bit at bit 24). The escape-list kernel, launched after it on
// the same stream, turns the flag words and the level plane into the
// ascending escape list and the skip flags.
//
// Design (one launch runs the whole wavefront):
//
// * Several SMs per image: a thread block cluster of C blocks per image
//   (cudaLaunchKernelEx with a cluster dimension; C from
//   ops/p2_kernel.py cluster_size: 8 at B = 16 on 132 SMs, 1 at B = 128;
//   the launcher refuses a cluster that cannot be resident). Block `rank`
//   owns the MB rows y with y mod C == rank, so each step's active rows
//   spread evenly over the cluster, and a block holds SLOTS MB slots of
//   two warps (rows beyond SLOTS in one step run in further rounds). One
//   cluster.sync() ends each step.
// * Contours on chip, no frame buffers. Each block keeps in shared memory a
//   top line (W luma + W chroma bytes) and, per owned row, a left slot (the
//   right column of the row's last MB and a corner stash). Each MB builds
//   its reconstruction in its slot's tile, with its contour in row 0 and
//   column 0. At its end it stores its bottom row into the line of block
//   (y + 1) mod C, the reader's (cluster.map_shared_rank: a remote store,
//   so no MB waits on a remote load), and its right column into its row's
//   left slot. Who writes what, and when:
//     - line segment x of block b: written by MB (x, y) with (y + 1) mod C
//       == b at the end of step x + y; read by MB (x, y + 1), of block b,
//       at the start of step x + y + 1; rewritten by MB (x, y + C) at step
//       x + y + C. With C >= 2 the rewrite comes at least one barrier
//       after the read; with C = 1 the reader and the next writer are one
//       MB, whose lanes read their segment into its tile before they write
//       its bottom row there.
//     - left slot of row y: written by MB (x - 1, y) at the end of step
//       x + y - 1, read and then rewritten by MB (x, y) in step x + y (the
//       barrier orders the two, which may be different warps).
//     - the corner of MB (x, y), the bottom-right pixel of (x - 1, y - 1):
//       in the line it is segment x - 1's pixel 15, which MB (x - 1, y)
//       overwrites in step x + y - 1 (C = 1), or row y + 1 overwrites in the
//       very step x + y where it is read (C = 2). So it is never read from
//       the line: MB (x - 1, y) stashes the top-right pixel of its own top
//       contour (that same pixel) in its row's left slot, beside the right
//       column, before anything can overwrite it.
// * The I4 walk on a full warp, a lane per pixel and coefficient. Its 10
//   dependency groups (planar.py I4_GROUPS: subblock (r, c) in group
//   c + 2r) hold at most two subblocks; lanes 0-15 and 16-31 take one each.
//   A lane reads its three predictor taps at tile offsets from a table
//   built once per block (ops/p2_kernel.py i4_taps, resolved per mode,
//   subblock and pixel) and its DC sum from the contour, selects its
//   prediction by masks (no branch), runs the forward and inverse DCT as
//   two 4-point passes gathered by __shfl_sync inside 4-lane groups (rows)
//   and 16-lane segments (columns), quantizes its own coefficient and
//   writes its reconstructed pixel to the tile and its level to the slot's
//   level buffer. The integer transforms are the same operations as
//   common.cuh's, so the result is the same to the bit.
// * I16 on a full warp the same way: 8 rounds of two blocks, the 16 DCs
//   through the WHT on a lane each (shuffles), then 8 rounds of inverse
//   DCT and reconstruction. Chroma beside luma: the slot's second warp runs
//   the 8 chroma blocks, 4 rounds of two, at the same time as the luma
//   warp.
// * Every branch that encloses a shuffle tests a warp vote (warp_uniform):
//   ptxas then compiles the shuffles as plain SHFL; on conditions it cannot
//   prove uniform it emits serialized collective sequences instead.
//
// What bounds it on the H100: the chain of steps, not the card's rates. At
// the main path's size (1536x1024, B = 16) the bytes in and out (138 MB)
// take 0.04 ms at the HBM rate and the counted integer operations of the
// chosen pipelines (1.6 G) 0.09 ms at the INT32 rate. The 159 steps are
// dependent; each lasts as long as its slowest MB's dependent path (nearly
// every step holds an I4 MB: its 10 groups, each a tile load, the
// prediction, two shuffle passes, one quantization, two shuffle passes and
// a tile store) plus one cluster barrier. Float operations (rd_drop) use
// __fmul_rn/__fsub_rn/__fadd_rn only.

#include <math.h>

#include <cooperative_groups.h>
#include <type_traits>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int SLOTS = 8;                // MBs in flight per thread block
constexpr int THREADS = SLOTS * 64;     // a luma warp and a chroma warp each
constexpr unsigned FULL = 0xffffffffu;

// A condition that holds for the whole warp or for none of it, as a vote:
// ptxas then knows the branch it guards keeps the warp converged, and
// compiles the shuffles inside as plain SHFL rather than as a serialized
// collective sequence (every branch that encloses a shuffle goes through
// it).
__device__ __forceinline__ bool warp_uniform(bool c) {
  return __any_sync(FULL, c);
}

// Shared memory of a block, in bytes: the image's quant rows, the trellis
// weights, the I4 tap table, the top lines, the left slots, the MB slots.
constexpr int SM_QT = 0;                // int [48 * 16]
constexpr int SM_WT = 3072;             // float [16]
constexpr int SM_TAB = 3136;            // u32 [10 modes][16 subblocks][16]
constexpr int SM_LINES = 13376;         // u8 luma [W], U [W/2], V [W/2]
// A left slot (per owned row): luma corner at 0, left column 1-16; U
// corner 17, column 18-25; V corner 26, column 27-34.
constexpr int LEFT_BYTES = 48;
constexpr int L_Y = 0, L_U = 17, L_V = 26;
// An MB slot: the luma tile (17 rows of TS bytes: row 0 = corner and top
// contour, column 0 = left contour, rows/columns 1-16 = the MB), the luma
// source, the U and V tiles (9 x CS) and sources, the luma levels (int16
// [16 blocks][16 zigzag positions]), the chroma levels (int16 [8][16]) and
// the I16 DCs on their way through the WHT (int [2][16]).
constexpr int TS = 20, CS = 12;
constexpr int S_TY = 0, S_SY = 352, S_TU = 608, S_TV = 720, S_SU = 832,
              S_SV = 896, S_LV = 960, S_LVC = 1472, S_DC = 1728,
              SLOT_BYTES = 1856;
static_assert(SM_LINES % 16 == 0 && SLOT_BYTES % 16 == 0, "alignment");

// Returned by the launcher when a cluster of C blocks cannot be resident.
constexpr int CLUSTER_DOES_NOT_FIT = -1;

size_t block_smem(int W, int rows) {
  return (size_t)SM_LINES + 2 * W + rows * LEFT_BYTES + SLOTS * SLOT_BYTES;
}

// Tile offset of contour pixel k of luma subblock (r, c), k indexing
// l3 l2 l1 l0 tl t0 t1 t2 t3 tr0 tr1 tr2 tr3; the above-right of column 3
// is the top MB's pixel 15 (tile row 0, column 16) on every row.
__device__ __forceinline__ int e_off(int k, int r, int c) {
  return k < 4 ? (4 * r + 4 - k) * TS + 4 * c
         : (c == 3 && k >= 9) ? 16
                              : 4 * r * TS + 4 * c + k - 4;
}

// One block's 16 zigzag levels into the int16 level plane and the nibble
// plane (fastpath._pack_levels: an escaping coefficient ships as nibble 0).
// Returns bit 0 = some |level| > 7, bit 1 = some level != 0.
__device__ __forceinline__ unsigned store_levels(const int* lv, int16_t* lv_out,
                                                 uint8_t* pk_out) {
  unsigned esc = 0, nz = 0;
  uint32_t half[8], nib[2] = {0, 0};
#pragma unroll
  for (int k = 0; k < 8; ++k)
    half[k] = ((uint32_t)lv[2 * k] & 0xFFFFu) | ((uint32_t)lv[2 * k + 1] << 16);
#pragma unroll
  for (int zz = 0; zz < 16; ++zz) {
    const int v = lv[zz];
    const bool e = v > 7 || v < -7;
    esc |= e;
    nz |= v != 0;
    nib[zz >> 3] |= (uint32_t)(e ? 0 : v + 8) << (4 * (zz & 7));
  }
  uint4* lo = (uint4*)lv_out;
  lo[0] = make_uint4(half[0], half[1], half[2], half[3]);
  lo[1] = make_uint4(half[4], half[5], half[6], half[7]);
  *(uint2*)pk_out = make_uint2(nib[0], nib[1]);
  return esc | (nz << 1);
}

// store_levels of a block whose levels wait in shared memory (int16 [16]).
__device__ __forceinline__ unsigned store_levels_smem(const int16_t* src,
                                                      int16_t* lv_out,
                                                      uint8_t* pk_out) {
  const uint4 w0 = ((const uint4*)src)[0], w1 = ((const uint4*)src)[1];
  const uint32_t w[8] = {w0.x, w0.y, w0.z, w0.w, w1.x, w1.y, w1.z, w1.w};
  int lv[16];
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    lv[2 * k] = (int)(int16_t)(w[k] & 0xFFFFu);
    lv[2 * k + 1] = (int)w[k] >> 16;
  }
  return store_levels(lv, lv_out, pk_out);
}

// v[i & 3] from four values already computed, by bit masks: no branch
// (the lanes of a warp take different i).
__device__ __forceinline__ int sel4(int i, int v0, int v1, int v2, int v3) {
  const int m1 = -(i & 1), m2 = -((i >> 1) & 1);
  const int lo = v0 ^ ((v0 ^ v1) & m1), hi = v2 ^ ((v2 ^ v3) & m1);
  return lo ^ ((lo ^ hi) & m2);
}

// Forward DCT of the lane's residual d (pixel (pr, pc) of a 4x4 block held
// by 16 lanes): returns the lane's coefficient (common.cuh fdct4x4).
__device__ __forceinline__ int fdct_lane(int d, int pr, int pc) {
  const int d0 = __shfl_sync(FULL, d, 0, 4), d1 = __shfl_sync(FULL, d, 1, 4),
            d2 = __shfl_sync(FULL, d, 2, 4), d3 = __shfl_sync(FULL, d, 3, 4);
  int a0 = d0 + d3, a1 = d1 + d2, a2 = d1 - d2, a3 = d0 - d3;
  const int t = sel4(pc, (a0 + a1) * 8, (a2 * 2217 + a3 * 5352 + 1812) >> 9,
                     (a0 - a1) * 8, (a3 * 2217 - a2 * 5352 + 937) >> 9);
  const int m0 = __shfl_sync(FULL, t, pc, 16),
            m1 = __shfl_sync(FULL, t, 4 + pc, 16),
            m2 = __shfl_sync(FULL, t, 8 + pc, 16),
            m3 = __shfl_sync(FULL, t, 12 + pc, 16);
  a0 = m0 + m3, a1 = m1 + m2, a2 = m1 - m2, a3 = m0 - m3;
  return sel4(pr, (a0 + a1 + 7) >> 4,
              ((a2 * 2217 + a3 * 5352 + 12000) >> 16) + (a3 != 0 ? 1 : 0),
              (a0 - a1 + 7) >> 4, (a3 * 2217 - a2 * 5352 + 51000) >> 16);
}

// Inverse DCT of the lane's dequantized coefficient at raster (pr, pc):
// returns the lane's residual (common.cuh idct4x4).
__device__ __forceinline__ int idct_lane(int v, int pr, int pc) {
  const int i0 = __shfl_sync(FULL, v, pc, 16),
            i1 = __shfl_sync(FULL, v, 4 + pc, 16),
            i2 = __shfl_sync(FULL, v, 8 + pc, 16),
            i3 = __shfl_sync(FULL, v, 12 + pc, 16);
  int a = i0 + i2, b = i0 - i2;
  int cc = wtk::mul2(i1) - wtk::mul1(i3);
  int d = wtk::mul1(i1) + wtk::mul2(i3);
  const int t = sel4(pr, a + d, b + cc, b - cc, a - d);
  const int u0 = __shfl_sync(FULL, t, 0, 4), u1 = __shfl_sync(FULL, t, 1, 4),
            u2 = __shfl_sync(FULL, t, 2, 4), u3 = __shfl_sync(FULL, t, 3, 4);
  const int dc = u0 + 4;
  a = dc + u2, b = dc - u2;
  cc = wtk::mul2(u1) - wtk::mul1(u3);
  d = wtk::mul1(u1) + wtk::mul2(u3);
  return sel4(pc, (a + d) >> 3, (b + cc) >> 3, (b - cc) >> 3, (a - d) >> 3);
}

// Inverse 4x4 WHT of the lane's dequantized y2 coefficient at raster
// (r, c) of a 16-lane segment: returns the lane's DC (common.cuh iwht4x4).
__device__ __forceinline__ int iwht_lane(int v, int r, int c) {
  const int i0 = __shfl_sync(FULL, v, c, 16),
            i1 = __shfl_sync(FULL, v, 4 + c, 16),
            i2 = __shfl_sync(FULL, v, 8 + c, 16),
            i3 = __shfl_sync(FULL, v, 12 + c, 16);
  int a0 = i0 + i3, a1 = i1 + i2, a2 = i1 - i2, a3 = i0 - i3;
  const int t = sel4(r, a0 + a1, a3 + a2, a0 - a1, a3 - a2);
  const int u0 = __shfl_sync(FULL, t, 0, 4), u1 = __shfl_sync(FULL, t, 1, 4),
            u2 = __shfl_sync(FULL, t, 2, 4), u3 = __shfl_sync(FULL, t, 3, 4);
  const int dc = u0 + 3;
  a0 = dc + u3, a1 = u1 + u2, a2 = u1 - u2, a3 = dc - u3;
  return sel4(c, (a0 + a1) >> 3, (a3 + a2) >> 3, (a0 - a1) >> 3,
              (a3 - a2) >> 3);
}

// Forward 4x4 WHT of the lane's DC at raster (r, c) of a 16-lane segment:
// returns the lane's y2 coefficient (common.cuh fwht4x4).
__device__ __forceinline__ int fwht_lane(int d, int r, int c) {
  const int c0 = __shfl_sync(FULL, d, 0, 4), c1 = __shfl_sync(FULL, d, 1, 4),
            c2 = __shfl_sync(FULL, d, 2, 4), c3 = __shfl_sync(FULL, d, 3, 4);
  int a0 = c0 + c2, a1 = c1 + c3, a2 = c1 - c3, a3 = c0 - c2;
  const int t = sel4(c, a0 + a1, a3 + a2, a3 - a2, a0 - a1);
  const int r0 = __shfl_sync(FULL, t, c, 16),
            r1 = __shfl_sync(FULL, t, 4 + c, 16),
            r2 = __shfl_sync(FULL, t, 8 + c, 16),
            r3 = __shfl_sync(FULL, t, 12 + c, 16);
  a0 = r0 + r2, a1 = r1 + r3, a2 = r1 - r3, a3 = r0 - r2;
  return sel4(r, (a0 + a1) >> 1, (a3 + a2) >> 1, (a3 - a2) >> 1,
              (a0 - a1) >> 1);
}

// The kernel's tensors and sizes.
struct Args {
  const uint8_t *Y, *U, *V, *modes, *uvmodes, *is_i4, *i4m;
  const int *seg_map, *qtab;
  const uint16_t* taps;
  int mb_w, mb_h, C;
  float rd16, rd4;
  uint8_t* packed;
  int16_t *levels, *y2;
  int* flags;
};

// Where a block's shared memory holds what (SM_* above), and the MB at
// (x, y) of image img that one of its slots works on.
struct Mb {
  int lane, x, y, img;
  size_t m;                     // raster MB index over the batch
  bool ht, hl, hb;              // a row above, a column left, a row below
  uint8_t* line;                // this block's lines: row y's top contour
  uint8_t* below;               // block (y + 1) mod C's lines
  uint8_t* left;                // this row's left slot
  uint8_t* slot;                // this MB slot's tiles
  const int* qt;                // the image's quant rows
  const uint32_t* tab;          // the I4 tap table
  const float* wt;              // the trellis weights
};

// A luma warp's global inputs of one MB, loaded one MB ahead.
struct LumaIn {
  uint2 src;                    // 8 source pixels of the lane
  int i4, mode, i4mode, seg;
};

__device__ __forceinline__ LumaIn luma_fetch(const Args& a, int img, int x,
                                             int y, int lane) {
  const int W = a.mb_w * 16;
  const size_t m = (size_t)img * a.mb_w * a.mb_h + (size_t)y * a.mb_w + x;
  LumaIn in;
  in.src = *(const uint2*)(a.Y + ((size_t)img * a.mb_h * 16 + y * 16 + (lane >> 1)) * W +
                           x * 16 + (lane & 1) * 8);
  in.i4 = a.is_i4[m];
  in.mode = a.modes[m];
  in.i4mode = a.i4m[m * 16 + (lane & 15)];
  in.seg = a.seg_map[m] & 3;
  return in;
}

// The I4 walk of one MB: its 10 dependency groups (planar.py I4_GROUPS:
// subblock (r, c) in group c + 2r) one after the other, the first subblock
// of a group on lanes 0-15, the second (where there is one) on lanes
// 16-31, a lane per pixel and coefficient. Each subblock's levels go to
// the slot's level buffer.
__device__ __forceinline__ void i4_walk(const Args& a, const Mb& k,
                                        const LumaIn& in, const int* q_y1,
                                        float tlam, uint8_t* T,
                                        const uint8_t* S, int16_t* lvb) {
  const int lane = k.lane;
  const int h = lane >> 4, p = lane & 15, pr = p >> 2, pc = p & 3;
  const int zz = wtk::zigzag_index(p);
  const int q = q_y1[zz], iq = q_y1[16 + zz], bias = q_y1[32 + zz],
            sh = q_y1[48 + zz];
  const float wt = k.wt[zz];
  // Each group's tap word (three tile offsets and the operation; it does
  // not depend on the reconstruction) ahead of the walk.
  uint32_t tw[10];
#pragma unroll
  for (int grp = 0; grp < 10; ++grp) {
    const int r0 = max(0, (grp - 2) / 2), c0 = grp - 2 * r0;
    const bool has2 = r0 + 1 < 4 && c0 - 2 >= 0;
    const int blk = r0 * 4 + c0 + (has2 ? 2 * h : 0);
    const int mode = __shfl_sync(FULL, in.i4mode, blk);
    tw[grp] = k.tab[(mode * 16 + blk) * 16 + p];
  }
  // The lane's pixel in the tile and in the source, relative to its
  // subblock's corner; the second subblock of a group lies 4 rows down and
  // 8 columns left of the first.
  const int pT = (1 + pr) * TS + 1 + pc, pS = pr * 16 + pc;
  const int hT = h * (4 * TS - 8), hS = h * (4 * 16 - 8);
  __syncwarp();
#pragma unroll
  for (int grp = 0; grp < 10; ++grp) {
    const int r0 = max(0, (grp - 2) / 2), c0 = grp - 2 * r0;
    const bool has2 = r0 + 1 < 4 && c0 - 2 >= 0;
    const uint8_t* Tb = T + 4 * r0 * TS + 4 * c0 + (has2 ? hT : 0);
    const uint32_t w = tw[grp];
    const int e0 = T[w & 511], e1 = T[(w >> 9) & 511], e2 = T[(w >> 18) & 511];
    const int dsum = Tb[1] + Tb[2] + Tb[3] + Tb[4] + Tb[TS] + Tb[2 * TS] +
                     Tb[3 * TS] + Tb[4 * TS];
    const int sv = S[4 * r0 * 16 + 4 * c0 + (has2 ? hS : 0) + pS];
    const int pred = sel4((int)(w >> 27), wtk::avg3(e0, e1, e2),
                          wtk::avg2(e0, e1), wtk::clamp255(e0 + e1 - e2),
                          (dsum + 4) >> 3);
    const int co = fdct_lane(sv - pred, pr, pc);
    const int s = wtk::quantize_level(co, q, iq, bias, sh, wt, a.rd4, tlam);
    const int res = idct_lane(s * q, pr, pc);
    if (has2 || h == 0) {
      const_cast<uint8_t*>(Tb)[pT] = (uint8_t)wtk::clamp255(pred + res);
      lvb[(r0 * 4 + c0 + (has2 ? 2 * h : 0)) * 16 + zz] = (int16_t)s;
    }
    __syncwarp();
  }
}

// The I16 pipeline of one MB, a lane per pixel and coefficient: 8 rounds
// of two blocks (lanes 0-15 take block 2j, lanes 16-31 block 2j + 1) for
// the prediction, DCT and quantization, the 16 DCs through the WHT on a
// lane each, then 8 rounds of inverse DCT and reconstruction. The rounds
// of a pass do not depend on one another. Levels go to the slot's level
// buffer; returns whether the lane's y2 level is non-zero.
__device__ __forceinline__ bool i16_mb(const Args& a, const Mb& k,
                                       const LumaIn& in, const int* q_y1,
                                       const int* q_y2, float tlam,
                                       uint8_t* T, const uint8_t* S,
                                       int16_t* lvb) {
  const int lane = k.lane;
  const int h = lane >> 4, p = lane & 15, pr = p >> 2, pc = p & 3;
  int v = lane < 16 ? T[1 + lane] : T[(lane - 15) * TS];
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  const int v2 = __shfl_xor_sync(FULL, v, 16);
  const int st = lane < 16 ? v : v2, sl = lane < 16 ? v2 : v;
  const int dc = (k.ht && k.hl) ? (st + sl + 16) >> 5
                 : k.ht         ? (st + 8) >> 4
                 : k.hl         ? (sl + 8) >> 4
                                : 0x80;
  const int tl = T[0];
  const int zz = wtk::zigzag_index(p);
  const int q = q_y1[zz], iq = q_y1[16 + zz], bias = q_y1[32 + zz],
            sh = q_y1[48 + zz];
  const float wt = k.wt[zz];
  int* dcb = reinterpret_cast<int*>(k.slot + S_DC);
  int pred[8], dq[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int blk = 2 * j + h, row = (blk >> 2) * 4 + pr, col = (blk & 3) * 4 + pc;
    pred[j] = wtk::pred_dtvh(in.mode, dc, T[(1 + row) * TS], T[1 + col], tl);
    const int co = fdct_lane(S[row * 16 + col] - pred[j], pr, pc);
    // The DC goes to the WHT; its level in the block is 0.
    const int s = zz == 0 ? 0
                          : wtk::quantize_level(co, q, iq, bias, sh, wt,
                                                a.rd16, tlam);
    lvb[blk * 16 + zz] = (int16_t)s;
    dq[j] = s * q;
    if (p == 0) dcb[blk] = co;
  }
  __syncwarp();
  // y2: the 16 DCs, a lane each (lanes 16-31 repeat 0-15), through the
  // WHT, its quantization and the inverse WHT.
  const int br = p >> 2, bc = p & 3, zy = wtk::zigzag_index(p);
  const int y2s = wtk::quantize_level(fwht_lane(dcb[p], br, bc), q_y2[zy],
                                      q_y2[16 + zy], q_y2[32 + zy],
                                      q_y2[48 + zy], 0.0f, 0.0f, 0.0f);
  const int rdc = iwht_lane(y2s * q_y2[zy], br, bc);
  if (lane < 16) {
    dcb[16 + p] = rdc;
    a.y2[k.m * 16 + zy] = (int16_t)y2s;
  }
  __syncwarp();
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int blk = 2 * j + h, row = (blk >> 2) * 4 + pr, col = (blk & 3) * 4 + pc;
    const int res = idct_lane(p == 0 ? dcb[16 + blk] : dq[j], pr, pc);
    T[(1 + row) * TS + 1 + col] = (uint8_t)wtk::clamp255(pred[j] + res);
  }
  return lane < 16 && y2s != 0;
}

__device__ __forceinline__ void luma_mb(const Args& a, const Mb& k,
                                        const LumaIn& in) {
  const int lane = k.lane;
  uint8_t* T = k.slot + S_TY;
  uint8_t* S = k.slot + S_SY;
  // The contour into the tile (masked: 127 above the frame, 129 left of
  // it, the corner as planar.py _corner_fill), the source beside it.
  if (lane < 16) T[1 + lane] = k.ht ? k.line[k.x * 16 + lane] : 127;
  else T[(lane - 15) * TS] = k.hl ? k.left[L_Y + lane - 15] : 129;
  if (lane == 0)
    T[0] = (k.ht && k.hl) ? k.left[L_Y] : (k.ht ? 129 : 127);
  *(uint2*)(S + lane * 8) = in.src;
  const int* q_y1 = k.qt + (0 * 16 + in.seg * 4) * 16;
  const int* q_y2 = k.qt + (1 * 16 + in.seg * 4) * 16;
  const float tlam = wtk::trellis_lambda(q_y1);
  __syncwarp();

  int16_t* lvb = reinterpret_cast<int16_t*>(k.slot + S_LV);
  bool y2nz = false;
  if (warp_uniform(in.i4)) {
    i4_walk(a, k, in, q_y1, tlam, T, S, lvb);
    if (lane < 16) a.y2[k.m * 16 + lane] = 0;
  } else {
    y2nz = i16_mb(a, k, in, q_y1, q_y2, tlam, T, S, lvb);
  }
  __syncwarp();
  unsigned f = 0;
  if (lane < 16)
    f = store_levels_smem(lvb + lane * 16, a.levels + (k.m * 24 + lane) * 16,
                          a.packed + (k.m * 24 + lane) * 8);
  const unsigned bits = __ballot_sync(FULL, f & 1u) & 0xFFFFu;
  const bool nz = __ballot_sync(FULL, (f >> 1) || y2nz) != 0;
  __syncwarp();

  // Hand the contour on: the bottom row to the line that row y + 1 reads
  // (a store into that block's shared memory, which the step's cluster
  // barrier makes visible), the right column and the corner stash (this
  // MB's top-right contour pixel, the corner of MB (x + 1, y)) to the
  // row's left slot.
  if (lane < 16) {
    if (k.hb) k.below[k.x * 16 + lane] = T[16 * TS + 1 + lane];
  } else {
    k.left[L_Y + lane - 15] = T[(lane - 15) * TS + 16];
  }
  if (lane == 0) {
    k.left[L_Y] = T[16];
    a.flags[k.m * 2] = (int)(bits | (nz ? 1u << 24 : 0u));
  }
}

// A chroma warp's global inputs of one MB, loaded one MB ahead.
struct ChromaIn {
  uint32_t src;                 // 4 source pixels of the lane
  int mode, seg;
};

__device__ __forceinline__ ChromaIn chroma_fetch(const Args& a, int img, int x,
                                                 int y, int lane) {
  const int CW = a.mb_w * 8;
  const size_t m = (size_t)img * a.mb_w * a.mb_h + (size_t)y * a.mb_w + x;
  const uint8_t* plane = (lane >> 4) ? a.V : a.U;
  ChromaIn in;
  in.src = *(const uint32_t*)(plane + ((size_t)img * a.mb_h * 8 + y * 8 +
                                       ((lane >> 1) & 7)) * CW +
                              x * 8 + (lane & 1) * 4);
  in.mode = a.uvmodes[m];
  in.seg = a.seg_map[m] & 3;
  return in;
}

__device__ __forceinline__ void chroma_mb(const Args& a, const Mb& k,
                                          const ChromaIn& in) {
  const int lane = k.lane, CW = a.mb_w * 8, W = a.mb_w * 16;
  // Lanes 0-15 fill the U tile, 16-31 the V tile: top (8 lanes), then left.
  const int pl = lane >> 4, j8 = lane & 7;
  uint8_t* Tp = k.slot + (pl ? S_TV : S_TU);
  const int lo = pl ? L_V : L_U;
  if ((lane & 8) == 0)
    Tp[1 + j8] = k.ht ? k.line[W + pl * CW + k.x * 8 + j8] : 127;
  else
    Tp[(1 + j8) * CS] = k.hl ? k.left[lo + 1 + j8] : 129;
  if ((lane & 15) == 0)
    Tp[0] = (k.ht && k.hl) ? k.left[lo] : (k.ht ? 129 : 127);
  *(uint32_t*)(k.slot + (pl ? S_SV : S_SU) + (lane & 15) * 4) = in.src;
  const int* q_uv = k.qt + (2 * 16 + in.seg * 4) * 16;
  __syncwarp();

  // The contour sums, a plane side per 8 lanes: U top, U left, V top, V
  // left.
  int v = (lane & 8) == 0 ? Tp[1 + j8] : Tp[(1 + j8) * CS];
#pragma unroll
  for (int o = 4; o > 0; o >>= 1) v += __shfl_xor_sync(FULL, v, o);
  int dcp[2], tlp[2];
#pragma unroll
  for (int pp = 0; pp < 2; ++pp) {
    const int st = __shfl_sync(FULL, v, 16 * pp), sl = __shfl_sync(FULL, v, 16 * pp + 8);
    dcp[pp] = (k.ht && k.hl) ? (st + sl + 8) >> 4
              : k.ht         ? (st + 4) >> 3
              : k.hl         ? (sl + 4) >> 3
                             : 0x80;
    tlp[pp] = k.slot[(pp ? S_TV : S_TU)];
  }
  // 4 rounds of two blocks, a lane per pixel and coefficient (U blocks
  // 0-3, then V blocks 0-3); the rounds do not depend on one another.
  const int h = lane >> 4, p = lane & 15, pr = p >> 2, pc = p & 3;
  const int zz = wtk::zigzag_index(p);
  const int q = q_uv[zz], iq = q_uv[16 + zz], bias = q_uv[32 + zz],
            sh = q_uv[48 + zz];
  int16_t* lvb = reinterpret_cast<int16_t*>(k.slot + S_LVC);
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int pp = j >> 1, blk = 2 * j + h, jb = blk & 3;
    const int row = (jb >> 1) * 4 + pr, col = (jb & 1) * 4 + pc;
    uint8_t* T = k.slot + (pp ? S_TV : S_TU);
    const uint8_t* S = k.slot + (pp ? S_SV : S_SU);
    const int pred = wtk::pred_dtvh(in.mode, dcp[pp], T[(1 + row) * CS],
                                    T[1 + col], tlp[pp]);
    const int co = fdct_lane(S[row * 8 + col] - pred, pr, pc);
    const int s = wtk::quantize_level(co, q, iq, bias, sh, 0.0f, 0.0f, 0.0f);
    lvb[blk * 16 + zz] = (int16_t)s;
    const int res = idct_lane(s * q, pr, pc);
    T[(1 + row) * CS + 1 + col] = (uint8_t)wtk::clamp255(pred + res);
  }
  __syncwarp();
  unsigned f = 0;
  if (lane < 8)
    f = store_levels_smem(lvb + lane * 16, a.levels + (k.m * 24 + 16 + lane) * 16,
                          a.packed + (k.m * 24 + 16 + lane) * 8);
  const unsigned be = __ballot_sync(FULL, f & 1u) & 0xFFu;
  const bool nz = __ballot_sync(FULL, f >> 1) != 0;
  __syncwarp();

  if ((lane & 8) == 0) {
    if (k.hb) k.below[W + pl * CW + k.x * 8 + j8] = Tp[8 * CS + 1 + j8];
  } else {
    k.left[lo + 1 + j8] = Tp[(1 + j8) * CS + 8];
  }
  if ((lane & 15) == 0) k.left[lo] = Tp[8];
  if (lane == 0) a.flags[k.m * 2 + 1] = (int)((be << 16) | (nz ? 1u << 24 : 0u));
}

// A slot's MB rows, step by step: block `rank` owns the rows y with
// y mod C == rank (C = 1 << lc); in step t its slot s takes the j-th of
// them with j mod SLOTS == s, first(t), first(t) + SLOTS * C, ... up to
// last(t).
struct Rows {
  int mb_w, mb_h, lc, rank, slot;
  __device__ int first(int t) const {
    const int y_lo = max(0, t - (mb_w - 1));
    return y_lo + ((rank - y_lo) & ((1 << lc) - 1)) + (slot << lc);
  }
  __device__ int last(int t) const { return min(mb_h - 1, t); }
};

// One warp's whole wavefront: its MBs in step order, each MB's global
// inputs loaded while the one before it runs (when that one is in the same
// step or the step before), one cluster barrier per step.
template <bool kChroma>
__device__ __forceinline__ void run(const Args& a, Mb& k, const Rows& rows,
                                    cg::cluster_group& cluster,
                                    uint8_t* lines, uint8_t* s_left) {
  using In = typename std::conditional<kChroma, ChromaIn, LumaIn>::type;
  auto fetch = [&](int t, int y) -> In {
    if constexpr (kChroma) return chroma_fetch(a, k.img, t - y, y, k.lane);
    else return luma_fetch(a, k.img, t - y, y, k.lane);
  };
  const int steps = a.mb_w + a.mb_h - 1, stride = SLOTS << rows.lc;
  const int cmask = (1 << rows.lc) - 1;
  In in{};
  bool ahead = false;           // `in` holds this MB's inputs
  for (int t = 0; t < steps; ++t) {
    for (int y = rows.first(t); warp_uniform(y <= rows.last(t)); y += stride) {
      const In cur = ahead ? in : fetch(t, y);
      int nt = t, ny = y + stride;
      if (ny > rows.last(t)) ny = rows.first(++nt);
      ahead = nt < steps && ny <= rows.last(nt);
      if (ahead) in = fetch(nt, ny);
      k.x = t - y;
      k.y = y;
      k.m = (size_t)k.img * a.mb_w * a.mb_h + (size_t)y * a.mb_w + k.x;
      k.ht = y > 0;
      k.hl = k.x > 0;
      k.hb = y + 1 < a.mb_h;
      k.below = cluster.map_shared_rank(lines, (unsigned)((y + 1) & cmask));
      k.left = s_left + (y >> rows.lc) * LEFT_BYTES;
      if constexpr (kChroma) chroma_mb(a, k, cur);
      else luma_mb(a, k, cur);
    }
    cluster.sync();
  }
}

__global__ void __launch_bounds__(THREADS, 2) p2_wavefront_kernel(const Args a) {
  extern __shared__ uint4 p2_smem[];
  uint8_t* sm = reinterpret_cast<uint8_t*>(p2_smem);
  cg::cluster_group cluster = cg::this_cluster();
  const int C = a.C;
  const int rank = (int)cluster.block_rank();
  const int img = blockIdx.x / C;
  const int W = a.mb_w * 16;
  const int n_rows = (a.mb_h + C - 1) / C;
  int* s_qt = reinterpret_cast<int*>(sm + SM_QT);
  float* s_wt = reinterpret_cast<float*>(sm + SM_WT);
  uint32_t* s_tab = reinterpret_cast<uint32_t*>(sm + SM_TAB);
  uint8_t* lines = sm + SM_LINES;
  uint8_t* s_left = lines + 2 * W;
  uint8_t* s_slots = s_left + n_rows * LEFT_BYTES;
  const int tid = threadIdx.x;
  for (int i = tid; i < 48 * 16; i += THREADS) s_qt[i] = a.qtab[img * 48 * 16 + i];
  if (tid < 16) s_wt[tid] = wtk::kTrellisW[tid];
  // The tap table with its contour indices resolved to tile offsets, per
  // mode, subblock and pixel: bits 0-8, 9-17, 18-26 and the operation at 27.
  for (int i = tid; i < 10 * 16 * 16; i += THREADS) {
    const int blk = (i >> 4) & 15, r = blk >> 2, c = blk & 3;
    const unsigned tap = a.taps[(i >> 8) * 16 + (i & 15)];
    s_tab[i] = (uint32_t)e_off(tap & 15, r, c) |
               (uint32_t)e_off((tap >> 4) & 15, r, c) << 9 |
               (uint32_t)e_off((tap >> 8) & 15, r, c) << 18 |
               (uint32_t)(tap >> 12) << 27;
  }
  // Staging done, and every block of the cluster running before any block
  // writes another's shared memory.
  cluster.sync();

  const int warp = tid >> 5, slot = warp >> 1;
  Mb k;
  k.lane = tid & 31;
  k.img = img;
  k.line = lines;
  k.slot = s_slots + slot * SLOT_BYTES;
  k.qt = s_qt;
  k.tab = s_tab;
  k.wt = s_wt;
  const Rows rows{a.mb_w, a.mb_h, __ffs(C) - 1, rank, slot};
  if (warp_uniform(warp & 1)) run<true>(a, k, rows, cluster, lines, s_left);
  else run<false>(a, k, rows, cluster, lines, s_left);
}

// The escape list and the skip flags of each image, from the wavefront's
// flag words and level plane: fastpath.escape_list's order and fill (the
// flagged block indices m * 24 + b ascending, cut at K; the rest index 0
// with block 0's levels) and its uncut count. One block per image; each
// thread owns a run of consecutive MBs, and a block-wide exclusive scan of
// the runs' escape counts gives each run its first place in the list.
constexpr int ESC_THREADS = 1024;

__global__ void __launch_bounds__(ESC_THREADS)
p2_escape_kernel(const int* __restrict__ flags,
                 const int16_t* __restrict__ levels, int n_mb, int K,
                 int* __restrict__ esc_idx, int16_t* __restrict__ esc_val,
                 int* __restrict__ esc_cnt, uint8_t* __restrict__ skip) {
  __shared__ int s_warp[ESC_THREADS / 32];
  const int img = blockIdx.x, tid = threadIdx.x, lane = tid & 31;
  const int per = (n_mb + ESC_THREADS - 1) / ESC_THREADS;
  const int lo = min(n_mb, tid * per), hi = min(n_mb, lo + per);
  const size_t mb0 = (size_t)img * n_mb;
  int count = 0;
  for (int m = lo; m < hi; ++m) {
    const int f = flags[(mb0 + m) * 2] | flags[(mb0 + m) * 2 + 1];
    count += __popc(f & 0xFFFFFF);
    skip[mb0 + m] = (f >> 24) == 0;
  }
  // Exclusive scan of the counts over the block: within each warp, then
  // over the warps' totals.
  int incl = count;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const int v = __shfl_up_sync(FULL, incl, o);
    if (lane >= o) incl += v;
  }
  if (lane == 31) s_warp[tid >> 5] = incl;
  __syncthreads();
  if (tid < 32) {
    int w = s_warp[tid];
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int v = __shfl_up_sync(FULL, w, o);
      if (tid >= o) w += v;
    }
    s_warp[tid] = w;
  }
  __syncthreads();
  int place = incl - count + ((tid >> 5) ? s_warp[(tid >> 5) - 1] : 0);
  const int total = s_warp[ESC_THREADS / 32 - 1];
  const uint4* lv = reinterpret_cast<const uint4*>(levels + mb0 * 24 * 16);
  uint4* ev = reinterpret_cast<uint4*>(esc_val + (size_t)img * K * 16);
  int* ei = esc_idx + (size_t)img * K;
  for (int m = lo; m < hi && place < K; ++m) {
    unsigned bits = (unsigned)(flags[(mb0 + m) * 2] | flags[(mb0 + m) * 2 + 1]) & 0xFFFFFFu;
    for (; bits != 0 && place < K; bits &= bits - 1, ++place) {
      const int blk = m * 24 + __ffs(bits) - 1;
      ei[place] = blk;
      ev[place * 2] = lv[blk * 2];
      ev[place * 2 + 1] = lv[blk * 2 + 1];
    }
  }
  for (int i = min(total, K) + tid; i < K; i += ESC_THREADS) {
    ei[i] = 0;
    ev[i * 2] = lv[0];
    ev[i * 2 + 1] = lv[1];
  }
  if (tid == 0) esc_cnt[img] = total;
}

// The launch configuration of a batch of B images with clusters of C.
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

}  // namespace

// How many clusters of C blocks of this kernel the device can hold at once
// for frames of mb_w x mb_h MBs (into *clusters); a CUDA error code.
extern "C" int p2_wavefront_max_clusters(int mb_w, int mb_h, int C,
                                         int* clusters) {
  if (C < 1 || C > 8 || (C & (C - 1)) || C > mb_h)
    return (int)cudaErrorInvalidValue;
  const Launch l(1, mb_w, mb_h, C, nullptr);
  cudaError_t err = cudaFuncSetAttribute(
      p2_wavefront_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)l.cfg.dynamicSmemBytes);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaOccupancyMaxActiveClusters(clusters, p2_wavefront_kernel,
                                             &l.cfg);
}

extern "C" int p2_wavefront_launch(const void* Y, const void* U, const void* V,
                                   const void* modes, const void* uvmodes,
                                   const void* is_i4, const void* i4m,
                                   const void* seg_map, const void* qtab,
                                   const void* taps, int B, int mb_w, int mb_h,
                                   int C, int K, float rd16, float rd4,
                                   void* packed, void* levels, void* y2,
                                   void* flags, void* esc_idx, void* esc_val,
                                   void* esc_cnt, void* skip, void* stream) {
  int clusters = 0;
  const int err0 = p2_wavefront_max_clusters(mb_w, mb_h, C, &clusters);
  if (err0 != 0) return err0;
  if (clusters < 1) return CLUSTER_DOES_NOT_FIT;
  const Launch l(B, mb_w, mb_h, C, (cudaStream_t)stream);
  const Args a{(const uint8_t*)Y,     (const uint8_t*)U,
               (const uint8_t*)V,     (const uint8_t*)modes,
               (const uint8_t*)uvmodes, (const uint8_t*)is_i4,
               (const uint8_t*)i4m,   (const int*)seg_map,
               (const int*)qtab,      (const uint16_t*)taps,
               mb_w, mb_h, C, rd16, rd4, (uint8_t*)packed,
               (int16_t*)levels, (int16_t*)y2, (int*)flags};
  cudaError_t err = cudaLaunchKernelEx(&l.cfg, p2_wavefront_kernel, a);
  if (err != cudaSuccess) return (int)err;
  // The escape list, in stream order after the wavefront.
  cudaLaunchConfig_t ec = {};
  ec.gridDim = dim3(B, 1, 1);
  ec.blockDim = dim3(ESC_THREADS, 1, 1);
  ec.stream = (cudaStream_t)stream;
  err = cudaLaunchKernelEx(&ec, p2_escape_kernel, (const int*)flags,
                           (const int16_t*)levels, mb_w * mb_h, K,
                           (int*)esc_idx, (int16_t*)esc_val, (int*)esc_cnt,
                           (uint8_t*)skip);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
