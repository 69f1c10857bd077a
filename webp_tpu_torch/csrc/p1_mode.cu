// Phase-1 mode-search kernel: the I16 search (4 predictors) and the joint
// U+V search (4 predictors) for every macroblock, with source-pixel
// context.
//
// Replaces the TPU kernel webp_tpu/ops/pallas_p1.py `_kernel` (:173, built
// by `_build_call` :420). Plain PyTorch version and launch wrapper:
// webp_tpu_torch/ops/p1_kernels.py (mode_search_plain / mode_search).
//
// Per MB and I16 mode: prediction, forward DCT of the 16 blocks, WHT of
// their DCs, per-segment quantization of the AC and y2 blocks, the
// band-exact approximate rate, 64 * the transform-domain distortion and,
// with TDisto on, tlsd * the weighted-Hadamard texture difference of the
// reconstruction. The winner is taken at lambda_i16 and its total is
// re-emitted at lambda_mode (the I4-vs-I16 split scale). Then the 4 chroma
// modes over the 8 U/V blocks at lambda_uv.
//
// What bounds it on the H100: integer ALU. Per MB it reads 454 bytes and
// writes 12, and does ~72k integer operations with TDisto on (4 modes x 16
// blocks x DCT, quantizer, rate walk and the TDisto reconstruction, and
// 4 x 8 chroma blocks; the count chip_smoke.py uses for the bound): ~150
// operations per byte against the card's ~5 INT32 operations per byte of
// HBM bandwidth. The design spends threads on arithmetic and keeps
// every intermediate in registers: one block of 256 threads covers 16
// MBs, 16 threads per MB, one per luma 4x4 block. The 16 DCs for the WHT
// are gathered with half-warp shuffles (every thread then runs the small
// y2 transform itself, so no thread waits on another); per-MB rate,
// distortion and texture sums are half-warp integer reductions, whose
// order is free. Source and context rows are staged once per block through
// shared memory with lane-contiguous loads; the rate constants live in
// shared memory. Float scores use __fmul_rn/__fadd_rn only.

#include <math.h>

#include "common.cuh"

namespace {

constexpr int N_SRC = 384;
constexpr int R_SRCY = 0;
constexpr int R_SRCU = 256;
constexpr int N_CTX = 70;
constexpr int C_TOPY = 0, C_LEFTY = 16, C_TLY = 32;
constexpr int C_TOPU = 33;  // U rows: top 33, left 41, tl 49
constexpr int C_PLANE_UV = 17;  // V rows follow at +17: top 50, left 58, tl 66
constexpr int C_HT = 67, C_HL = 68, C_SEG = 69;
constexpr int MB_PER_BLOCK = 16;
constexpr int THREADS = MB_PER_BLOCK * 16;

__global__ void __launch_bounds__(THREADS)
p1_mode_kernel(const uint8_t* __restrict__ src, const uint8_t* __restrict__ ctx,
               const int* __restrict__ qtab, const float* __restrict__ lams,
               const int* __restrict__ rc_g, int L, int n_mb, int use_td,
               int* __restrict__ mode_out, int* __restrict__ uv_out,
               float* __restrict__ score_out) {
  __shared__ int rc[wtk::RC_SIZE];
  __shared__ uint8_t s_src[N_SRC][MB_PER_BLOCK];
  __shared__ uint8_t s_ctx[N_CTX][MB_PER_BLOCK];
  const int tid = threadIdx.x;
  const int lane0 = blockIdx.x * MB_PER_BLOCK;
  for (int i = tid; i < wtk::RC_SIZE; i += THREADS) rc[i] = rc_g[i];
  for (int i = tid; i < N_SRC * MB_PER_BLOCK; i += THREADS) {
    const int r = i / MB_PER_BLOCK, m = i % MB_PER_BLOCK;
    const int l = lane0 + m;
    s_src[r][m] = l < L ? src[(size_t)r * L + l] : 0;
  }
  for (int i = tid; i < N_CTX * MB_PER_BLOCK; i += THREADS) {
    const int r = i / MB_PER_BLOCK, m = i % MB_PER_BLOCK;
    const int l = lane0 + m;
    s_ctx[r][m] = l < L ? ctx[(size_t)r * L + l] : 0;
  }
  __syncthreads();

  // Every thread of the half-warp runs every step (the shuffles need all
  // of them); lanes past L compute on zeros and write nothing.
  const int m = tid >> 4;
  const int b = tid & 15;
  const int lane = lane0 + m;
  const int img = (lane < L ? lane : L - 1) / n_mb;
  const int seg = s_ctx[C_SEG][m] & 3;
  const int* qt = qtab + (size_t)img * 48 * 16;
  const int* q_y1 = qt + (0 * 16 + seg * 4) * 16;
  const int* q_y2 = qt + (1 * 16 + seg * 4) * 16;
  const int* q_uv = qt + (2 * 16 + seg * 4) * 16;
  const float* lam = lams + (size_t)img * 16;
  const float lam16 = lam[seg], lamuv = lam[4 + seg], tlsd = lam[8 + seg],
              lammd = lam[12 + seg];
  const bool ht = s_ctx[C_HT][m] != 0, hl = s_ctx[C_HL][m] != 0;

  // ------------------------------------------------------------------
  // Luma I16: this thread's block (br, bc).
  // ------------------------------------------------------------------
  const int br = b >> 2, bc = b & 3;
  int sum_t = 0, sum_l = 0;
  for (int k = 0; k < 16; ++k) {
    sum_t += ht ? s_ctx[C_TOPY + k][m] : 127;
    sum_l += hl ? s_ctx[C_LEFTY + k][m] : 129;
  }
  const int dc16 = (ht && hl) ? (sum_t + sum_l + 16) >> 5
                   : ht       ? (sum_t + 8) >> 4
                   : hl       ? (sum_l + 8) >> 4
                              : 0x80;
  const int tl_m = (ht && hl) ? (int)s_ctx[C_TLY][m] : (ht ? 129 : 127);
  int tv[4], lv[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    tv[k] = ht ? s_ctx[C_TOPY + bc * 4 + k][m] : 127;
    lv[k] = hl ? s_ctx[C_LEFTY + br * 4 + k][m] : 129;
  }
  int sblk[16];
#pragma unroll
  for (int p = 0; p < 16; ++p) sblk[p] = s_src[R_SRCY + b * 16 + p][m];
  const int ha_src = use_td ? wtk::hadamard_w(sblk) : 0;

  float best_score = INFINITY, best_rate = 0.f, best_D = 0.f;
  int best_mode = 0;
  for (int mode = 0; mode < 4; ++mode) {
    int pred[16], d[16], co[16], dq[16];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        int v;
        if (mode == 0) v = dc16;
        else if (mode == 1) v = wtk::clamp255(lv[r] + tv[c] - tl_m);
        else if (mode == 2) v = tv[c];
        else v = lv[r];
        pred[r * 4 + c] = v;
        d[r * 4 + c] = sblk[r * 4 + c] - v;
      }
    }
    wtk::fdct4x4(d, co);
    int disto_b = 0;
    const int rate_b =
        wtk::quant_rate(co, q_y1, 1, rc + 0 * wtk::RC_PT, dq, disto_b);
    // y2: gather the 16 DCs, WHT, quantize, inverse WHT (every thread).
    int dcs[16], wht[16], y2dq[16], rec_dc[16];
#pragma unroll
    for (int j = 0; j < 16; ++j) dcs[j] = __shfl_sync(0xffffffffu, co[0], j, 16);
    wtk::fwht4x4(dcs, wht);
    int unused = 0;
    const int rate_y2 =
        wtk::quant_rate(wht, q_y2, 0, rc + 1 * wtk::RC_PT, y2dq, unused);
    wtk::iwht4x4(y2dq, rec_dc);
    int my_rec_dc = 0;
#pragma unroll
    for (int j = 0; j < 16; ++j)
      if (j == b) my_rec_dc = rec_dc[j];
    const int e0 = co[0] - my_rec_dc;
    disto_b += e0 * e0;
    const int rate = wtk::sum16(rate_b) + rate_y2 + rc[wtk::RC_FC16 + mode];
    const int disto = wtk::sum16(disto_b);
    int td = -1;
    if (use_td) {
      int rec[16];
      dq[0] = my_rec_dc;
      wtk::idct4x4(dq, rec);
#pragma unroll
      for (int p = 0; p < 16; ++p) rec[p] = wtk::clamp255(pred[p] + rec[p]);
      td = wtk::sum16(abs(wtk::hadamard_w(rec) - ha_src) >> 5);
    }
    const float D = wtk::rd_disto(disto, tlsd, td);
    const float fr = __int2float_rn(rate);
    const float score = wtk::rd_score(fr, lam16, D);
    if (score < best_score) {
      best_score = score;
      best_rate = fr;
      best_D = D;
      best_mode = mode;
    }
  }

  // ------------------------------------------------------------------
  // Chroma: threads 0-3 take U blocks 0-3, threads 4-7 V blocks 0-3.
  // ------------------------------------------------------------------
  const int plane = b >> 2, j = b & 3;
  const int cbr = j >> 1, cbc = j & 1;
  const int c0 = C_TOPU + plane * C_PLANE_UV;
  int ctv[4], clv[4], cdc = 0, ctl = 0;
  int csrc[16];
  if (b < 8) {
    int st = 0, sl = 0;
    for (int k = 0; k < 8; ++k) {
      st += ht ? s_ctx[c0 + k][m] : 127;
      sl += hl ? s_ctx[c0 + 8 + k][m] : 129;
    }
    cdc = (ht && hl) ? (st + sl + 8) >> 4
          : ht       ? (st + 4) >> 3
          : hl       ? (sl + 4) >> 3
                     : 0x80;
    ctl = (ht && hl) ? (int)s_ctx[c0 + 16][m] : (ht ? 129 : 127);
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      ctv[k] = ht ? s_ctx[c0 + cbc * 4 + k][m] : 127;
      clv[k] = hl ? s_ctx[c0 + 8 + cbr * 4 + k][m] : 129;
    }
#pragma unroll
    for (int p = 0; p < 16; ++p) csrc[p] = s_src[R_SRCU + b * 16 + p][m];
  }
  float best_uv_score = INFINITY;
  int best_uv = 0;
  for (int mode = 0; mode < 4; ++mode) {
    int rate_b = 0, disto_b = 0;
    if (b < 8) {
      int d[16], co[16];
#pragma unroll
      for (int r = 0; r < 4; ++r) {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          int v;
          if (mode == 0) v = cdc;
          else if (mode == 1) v = wtk::clamp255(clv[r] + ctv[c] - ctl);
          else if (mode == 2) v = ctv[c];
          else v = clv[r];
          d[r * 4 + c] = csrc[r * 4 + c] - v;
        }
      }
      wtk::fdct4x4(d, co);
      rate_b = wtk::quant_rate(co, q_uv, 0, rc + 2 * wtk::RC_PT, nullptr,
                               disto_b);
    }
    const int rate = rc[wtk::RC_FCUV + mode] + wtk::sum16(rate_b);
    const int disto = wtk::sum16(disto_b);
    const float score = wtk::rd_score(__int2float_rn(rate), lamuv,
                                      wtk::rd_disto(disto, 0.f, -1));
    if (score < best_uv_score) {
      best_uv_score = score;
      best_uv = mode;
    }
  }

  if (b == 0 && lane < L) {
    mode_out[lane] = best_mode;
    uv_out[lane] = best_uv;
    score_out[lane] = wtk::rd_score(best_rate, lammd, best_D);
  }
}

}  // namespace

extern "C" int p1_mode_launch(const void* src, const void* ctx,
                              const void* qtab, const void* lams,
                              const void* rc, int L, int n_mb, int use_td,
                              void* mode, void* uv, void* score,
                              void* stream) {
  const int grid = (L + MB_PER_BLOCK - 1) / MB_PER_BLOCK;
  p1_mode_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)src, (const uint8_t*)ctx, (const int*)qtab,
      (const float*)lams, (const int*)rc, L, n_mb, use_td, (int*)mode,
      (int*)uv, (float*)score);
  return (int)cudaGetLastError();
}
