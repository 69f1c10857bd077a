// Phase-2 wavefront kernel: the closed-loop reconstruction of every
// macroblock with the modes of phase 1 fixed, and the fused pack of its
// levels.
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
// closed-loop walk over its 16 subblocks with their modes fixed; then the
// chroma pipeline. Only the chosen luma pipeline runs: the plain version
// computes both and keeps one. Outputs, at their unskewed [B, n_mb, ...]
// addresses, straight from registers: the nibble plane (a coefficient with
// |level| > 7 ships as nibble 0), the int16 level plane the escape list is
// gathered from, the y2 levels, a 24-bit per-MB escape bitmap and the skip
// flag.
//
// Design. One launch runs the whole wavefront: one thread block per image
// loops over its mb_w + mb_h - 1 anti-diagonals, with a __syncthreads()
// between steps. A half-warp takes one macroblock (one thread per luma 4x4
// block, as p1_mode.cu); the block's GROUPS half-warps stride over the
// step's active MBs. The reconstruction lives in frame buffers in device
// memory (u8 [B, H, W] and 2 x [B, H/2, W/2], allocated by the wrapper;
// 38 MB at 1536x1024 B=16, which fits the 50 MB L2): an MB reads its
// contour straight from the frame where the earlier steps wrote it. That
// takes the place of the TPU kernel's carried bottom rows, right columns
// and corner history, and of the skew and unskew of its inputs and
// outputs. The 16 DCs of an I16 MB meet by half-warp shuffles; the I4 walk
// runs its 10 dependency groups (planar.py I4_GROUPS) one after the other,
// a thread per subblock of the group, ordered by __syncwarp; the escape
// bitmap and the skip flag are half-warp OR reductions.
//
// What bounds it on the H100: not the card's rates but the chain of steps.
// At the main path's size (1536x1024, B = 16) the bytes in and out (138 MB)
// take 0.04 ms at the HBM rate and the counted integer operations of the
// chosen pipelines (1.6 G) 0.09 ms at the INT32 rate; the 159 steps are
// dependent, and each is as long as its slowest MB, an I4 MB whose walk is
// 10 dependent subblock pipelines run by one thread each. The grid holds
// 16 blocks, so 16 of the 132 SMs work. Measured by chip_smoke.py on an
// NVIDIA H100 80GB HBM3 at 700.00 W: 7.8 ms per launch (0.049 ms per step,
// 83x the bound). Spreading an image over several blocks (row bands handing
// over by flags) and a subblock over several threads are the later work
// this design leaves open. Float operations (rd_drop) use
// __fmul_rn/__fsub_rn/__fadd_rn only.

#include <math.h>

#include "common.cuh"

namespace {

constexpr int GROUPS = 32;  // macroblocks in flight per thread block
constexpr int THREADS = GROUPS * 16;

// The masked contour of a macroblock of size s at (x0, y0) in a plane:
// the row above (127 where there is none), the column to the left (129
// where there is none) and the corner (planar.py _corner_fill).
struct Contour {
  const uint8_t* rec;
  int stride, x0, y0;
  bool ht, hl;

  __device__ __forceinline__ int top(int k) const {
    return ht ? (int)rec[(y0 - 1) * stride + x0 + k] : 127;
  }
  __device__ __forceinline__ int left(int k) const {
    return hl ? (int)rec[(y0 + k) * stride + x0 - 1] : 129;
  }
  __device__ __forceinline__ int corner() const {
    return (ht && hl) ? (int)rec[(y0 - 1) * stride + x0 - 1] : (ht ? 129 : 127);
  }
  // DC prediction of an s x s macroblock plane (shift 5 for luma's 16,
  // 4 for chroma's 8); 0x80 with neither neighbour.
  __device__ __forceinline__ int dc(int s, int shift) const {
    int st = 0, sl = 0;
    for (int k = 0; k < s; ++k) {
      st += top(k);
      sl += left(k);
    }
    return (ht && hl) ? (st + sl + s) >> shift
           : ht       ? (st + (s >> 1)) >> (shift - 1)
           : hl       ? (sl + (s >> 1)) >> (shift - 1)
                      : 0x80;
  }
};

__device__ __forceinline__ void load_block(const uint8_t* __restrict__ p,
                                           int stride, int* px) {
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const uint32_t w = *(const uint32_t*)(p + r * stride);
#pragma unroll
    for (int c = 0; c < 4; ++c) px[r * 4 + c] = (w >> (8 * c)) & 0xFF;
  }
}

// pred + residual, clamped, into the reconstruction frame.
__device__ __forceinline__ void store_recon(uint8_t* p, int stride,
                                            const int* pred, const int* res) {
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    uint32_t w = 0;
#pragma unroll
    for (int c = 0; c < 4; ++c)
      w |= (uint32_t)wtk::clamp255(pred[r * 4 + c] + res[r * 4 + c]) << (8 * c);
    *(uint32_t*)(p + r * stride) = w;
  }
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

__global__ void __launch_bounds__(THREADS)
p2_wavefront_kernel(const uint8_t* __restrict__ Y, const uint8_t* __restrict__ U,
                    const uint8_t* __restrict__ V,
                    const uint8_t* __restrict__ modes,
                    const uint8_t* __restrict__ uvmodes,
                    const uint8_t* __restrict__ is_i4,
                    const uint8_t* __restrict__ i4m,
                    const int* __restrict__ seg_map,
                    const int* __restrict__ qtab, int mb_w, int mb_h,
                    float rd16, float rd4, uint8_t* recY, uint8_t* recU,
                    uint8_t* recV, uint8_t* __restrict__ packed,
                    int16_t* __restrict__ levels, int16_t* __restrict__ y2_out,
                    int* __restrict__ bitmap, uint8_t* __restrict__ skip) {
  const int img = blockIdx.x;
  const int W = mb_w * 16, CW = mb_w * 8;
  const int n_mb = mb_w * mb_h;
  const size_t y_off = (size_t)img * mb_h * 16 * W;
  const size_t c_off = (size_t)img * mb_h * 8 * CW;
  const int g = threadIdx.x >> 4;
  const int b = threadIdx.x & 15;
  const unsigned hm = 0xFFFFu << (threadIdx.x & 16);  // this half-warp
  const int* qt = qtab + (size_t)img * 48 * 16;

  for (int t = 0; t < mb_w + mb_h - 1; ++t) {
    const int y_lo = max(0, t - (mb_w - 1)), y_hi = min(mb_h - 1, t);
    for (int y = y_lo + g; y <= y_hi; y += GROUPS) {
      const int x = t - y;
      const size_t m = (size_t)img * n_mb + y * mb_w + x;
      const bool ht = y > 0, hl = x > 0;
      const int seg = seg_map[m] & 3;
      const int* q_y1 = qt + (0 * 16 + seg * 4) * 16;
      const int* q_y2 = qt + (1 * 16 + seg * 4) * 16;
      const int* q_uv = qt + (2 * 16 + seg * 4) * 16;
      const float tlam = wtk::trellis_lambda(q_y1);
      const Contour cy{recY + y_off, W, x * 16, y * 16, ht, hl};
      const uint8_t* srcY = Y + y_off + (size_t)(y * 16) * W + x * 16;
      uint8_t* frY = recY + y_off + (size_t)(y * 16) * W + x * 16;
      int16_t* lv_mb = levels + m * 24 * 16;
      uint8_t* pk_mb = packed + m * 24 * 8;
      unsigned bits = 0, nz = 0;
      int lv[16], dq[16], co[16], pred[16], px[16], res[16];

      if (is_i4[m]) {
        // The I4 walk: group grp holds the subblocks (r, c) with
        // c + 2r = grp; their contours were reconstructed by earlier groups.
        const int trs = ht ? cy.top(15) : 127;  // above-right of column 3
        for (int grp = 0; grp < 10; ++grp) {
          const int r = max(0, (grp - 2) / 2) + b;
          const int c = grp - 2 * r;
          if (r < 4 && c >= 0 && c < 4) {
            const uint8_t* fr = frY + (r * 4 - 1) * W + c * 4;  // row above
            int tv[4], lw[4], trv[4];
#pragma unroll
            for (int i = 0; i < 4; ++i) {
              tv[i] = r == 0 ? cy.top(c * 4 + i) : fr[i];
              lw[i] = c == 0 ? cy.left(r * 4 + i) : frY[(r * 4 + i) * W + c * 4 - 1];
              trv[i] = c == 3 ? trs : (r == 0 ? cy.top(c * 4 + 4 + i) : fr[4 + i]);
            }
            const int tlv = (r == 0 && c == 0) ? cy.corner()
                            : r == 0           ? cy.top(c * 4 - 1)
                            : c == 0           ? cy.left(r * 4 - 1)
                                               : fr[-1];
            const wtk::I4Contour ctr(lw, tlv, tv, trv);
            const int blk = r * 4 + c;
            const int mode = i4m[m * 16 + blk];
#pragma unroll
            for (int rr = 0; rr < 4; ++rr) {
#pragma unroll
              for (int cc = 0; cc < 4; ++cc)
                pred[rr * 4 + cc] = ctr.pred(mode, rr, cc);
            }
            load_block(srcY + (r * 4) * W + c * 4, W, px);
#pragma unroll
            for (int p = 0; p < 16; ++p) px[p] -= pred[p];
            wtk::fdct4x4(px, co);
            wtk::quantize_rd(co, q_y1, 0, rd4, tlam, lv, dq);
            wtk::idct4x4(dq, res);
            store_recon(frY + (r * 4) * W + c * 4, W, pred, res);
            const unsigned f = store_levels(lv, lv_mb + blk * 16, pk_mb + blk * 8);
            bits |= (f & 1u) << blk;
            nz |= f >> 1;
          }
          __syncwarp(hm);
        }
        y2_out[m * 16 + b] = 0;
      } else {
        // I16: thread b owns luma block (br, bc).
        const int br = b >> 2, bc = b & 3;
        const int mode = modes[m];
        const int dc = cy.dc(16, 5), tl = cy.corner();
        int tv[4], lw[4];
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          tv[k] = cy.top(bc * 4 + k);
          lw[k] = cy.left(br * 4 + k);
        }
        load_block(srcY + (br * 4) * W + bc * 4, W, px);
#pragma unroll
        for (int r = 0; r < 4; ++r) {
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            pred[r * 4 + c] = wtk::pred_dtvh(mode, dc, lw[r], tv[c], tl);
            px[r * 4 + c] -= pred[r * 4 + c];
          }
        }
        wtk::fdct4x4(px, co);
        wtk::quantize_rd(co, q_y1, 1, rd16, tlam, lv, dq);
        // y2: every thread gathers the 16 DCs and runs the WHT, its
        // quantization and the inverse WHT itself.
        int dcs[16], wht[16], y2lv[16], y2dq[16], rec_dc[16];
#pragma unroll
        for (int j = 0; j < 16; ++j) dcs[j] = __shfl_sync(hm, co[0], j, 16);
        wtk::fwht4x4(dcs, wht);
        wtk::quantize_rd(wht, q_y2, 0, 0.0f, 0.0f, y2lv, y2dq);
        wtk::iwht4x4(y2dq, rec_dc);
        int my_dc = 0, my_y2 = 0;
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          if (j == b) {
            my_dc = rec_dc[j];
            my_y2 = y2lv[j];
          }
        }
        dq[0] = my_dc;
        wtk::idct4x4(dq, res);
        store_recon(frY + (br * 4) * W + bc * 4, W, pred, res);
        const unsigned f = store_levels(lv, lv_mb + b * 16, pk_mb + b * 8);
        bits |= (f & 1u) << b;
        nz |= (f >> 1) | (my_y2 != 0);
        y2_out[m * 16 + b] = (int16_t)my_y2;
      }

      // Chroma: threads 0-3 take U blocks 0-3, threads 4-7 V blocks 0-3.
      if (b < 8) {
        const int plane = b >> 2, j = b & 3;
        const int cbr = j >> 1, cbc = j & 1;
        uint8_t* rec = (plane ? recV : recU) + c_off;
        const uint8_t* src = (plane ? V : U) + c_off;
        const Contour cc{rec, CW, x * 8, y * 8, ht, hl};
        const int dc = cc.dc(8, 4), tl = cc.corner();
        const int mode = uvmodes[m];
        const size_t at = (size_t)(y * 8 + cbr * 4) * CW + x * 8 + cbc * 4;
        load_block(src + at, CW, px);
#pragma unroll
        for (int r = 0; r < 4; ++r) {
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            pred[r * 4 + c] = wtk::pred_dtvh(mode, dc, cc.left(cbr * 4 + r),
                                             cc.top(cbc * 4 + c), tl);
            px[r * 4 + c] -= pred[r * 4 + c];
          }
        }
        wtk::fdct4x4(px, co);
        wtk::quantize_rd(co, q_uv, 0, 0.0f, 0.0f, lv, dq);
        wtk::idct4x4(dq, res);
        store_recon(rec + at, CW, pred, res);
        const unsigned f =
            store_levels(lv, lv_mb + (16 + b) * 16, pk_mb + (16 + b) * 8);
        bits |= (f & 1u) << (16 + b);
        nz |= f >> 1;
      }

      bits = __reduce_or_sync(hm, bits);
      nz = __reduce_or_sync(hm, nz);
      if (b == 0) {
        bitmap[m] = (int)bits;
        skip[m] = nz ? 0 : 1;
      }
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" int p2_wavefront_launch(const void* Y, const void* U, const void* V,
                                   const void* modes, const void* uvmodes,
                                   const void* is_i4, const void* i4m,
                                   const void* seg_map, const void* qtab, int B,
                                   int mb_w, int mb_h, float rd16, float rd4,
                                   void* recY, void* recU, void* recV,
                                   void* packed, void* levels, void* y2,
                                   void* bitmap, void* skip, void* stream) {
  p2_wavefront_kernel<<<B, THREADS, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)Y, (const uint8_t*)U, (const uint8_t*)V,
      (const uint8_t*)modes, (const uint8_t*)uvmodes, (const uint8_t*)is_i4,
      (const uint8_t*)i4m, (const int*)seg_map, (const int*)qtab, mb_w, mb_h,
      rd16, rd4, (uint8_t*)recY, (uint8_t*)recU, (uint8_t*)recV,
      (uint8_t*)packed, (int16_t*)levels, (int16_t*)y2, (int*)bitmap,
      (uint8_t*)skip);
  return (int)cudaGetLastError();
}
