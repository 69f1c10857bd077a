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
// order is free. The chroma search runs its 8 blocks x 4 modes on all 16
// threads (two modes each), its per-mode sums combined by shuffles. Source
// and context rows are staged once per block through shared memory with
// lane-contiguous loads, the source one MB per row so that a thread reads
// its block with one 16-byte load; each MB's quant rows and the rate
// constants are staged there too, and the zigzag positions fold to
// constants (quant_rate<true>), so the coefficient arrays stay in
// registers. Float scores use __fmul_rn/__fadd_rn only.

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
// 16 bytes of shared memory (16-byte aligned) into v[16].
__device__ __forceinline__ void load16(const uint8_t* p, int* v) {
  const uint4 w = *reinterpret_cast<const uint4*>(p);
  const uint32_t u[4] = {w.x, w.y, w.z, w.w};
#pragma unroll
  for (int k = 0; k < 16; ++k) v[k] = (u[k >> 2] >> (8 * (k & 3))) & 0xFF;
}

constexpr int MB_PER_BLOCK = 16;
constexpr int THREADS = MB_PER_BLOCK * 16;
// The source tile holds one MB per row (a thread reads its 16 pixels with
// one 16-byte load); the quant rows one MB per row as well: its segment's
// y1, y2 and uv rows (q, iq, bias, sharpen; 192 ints), padded so that the
// two MBs of a warp read different banks.
constexpr int SRC_STRIDE = N_SRC + 16;
constexpr int Q_STRIDE = 208;

__global__ void __launch_bounds__(THREADS)
p1_mode_kernel(const uint8_t* __restrict__ src, const uint8_t* __restrict__ ctx,
               const int* __restrict__ qtab, const float* __restrict__ lams,
               const int* __restrict__ rc_g, int L, int n_mb, int use_td,
               int* __restrict__ mode_out, int* __restrict__ uv_out,
               float* __restrict__ score_out) {
  __shared__ int rc[wtk::RC_SIZE];
  __shared__ __align__(16) uint8_t s_src[MB_PER_BLOCK][SRC_STRIDE];
  __shared__ uint8_t s_ctx[N_CTX][MB_PER_BLOCK];
  __shared__ int s_q[MB_PER_BLOCK][Q_STRIDE];
  const int tid = threadIdx.x;
  const int lane0 = blockIdx.x * MB_PER_BLOCK;
  for (int i = tid; i < wtk::RC_SIZE; i += THREADS) rc[i] = rc_g[i];
  for (int i = tid; i < N_SRC * MB_PER_BLOCK; i += THREADS) {
    const int r = i / MB_PER_BLOCK, m = i % MB_PER_BLOCK;
    const int l = lane0 + m;
    s_src[m][r] = l < L ? src[(size_t)r * L + l] : 0;
  }
  for (int i = tid; i < N_CTX * MB_PER_BLOCK; i += THREADS) {
    const int r = i / MB_PER_BLOCK, m = i % MB_PER_BLOCK;
    const int l = lane0 + m;
    s_ctx[r][m] = l < L ? ctx[(size_t)r * L + l] : 0;
  }
  for (int i = tid; i < 192 * MB_PER_BLOCK; i += THREADS) {
    const int m = i / 192, k = i % 192;
    const int l = min(lane0 + m, L - 1);
    const int seg = ctx[(size_t)C_SEG * L + l] & 3;
    s_q[m][k] = qtab[(size_t)(l / n_mb) * 48 * 16 +
                     ((k >> 6) * 16 + seg * 4) * 16 + (k & 63)];
  }
  __syncthreads();

  // Every thread of the half-warp runs every step (the shuffles need all
  // of them); lanes past L compute on zeros and write nothing.
  const int m = tid >> 4;
  const int b = tid & 15;
  const int lane = lane0 + m;
  const int img = (lane < L ? lane : L - 1) / n_mb;
  const int seg = s_ctx[C_SEG][m] & 3;
  const int* q_y1 = s_q[m];
  const int* q_y2 = s_q[m] + 64;
  const int* q_uv = s_q[m] + 128;
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
  load16(&s_src[m][R_SRCY + b * 16], sblk);
  const int ha_src = use_td ? wtk::hadamard_w(sblk) : 0;

  float best_score = INFINITY, best_rate = 0.f, best_D = 0.f;
  int best_mode = 0;
  for (int mode = 0; mode < 4; ++mode) {
    int pred[16], d[16], co[16], dq[16];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int v = wtk::pred_dtvh(mode, dc16, lv[r], tv[c], tl_m);
        pred[r * 4 + c] = v;
        d[r * 4 + c] = sblk[r * 4 + c] - v;
      }
    }
    wtk::fdct4x4(d, co);
    int disto_b = 0;
    const int rate_b =
        wtk::quant_rate<true>(co, q_y1, 1, rc + 0 * wtk::RC_PT, dq, disto_b);
    // y2: gather the 16 DCs, WHT, quantize, inverse WHT (every thread).
    int dcs[16], wht[16], y2dq[16], rec_dc[16];
#pragma unroll
    for (int j = 0; j < 16; ++j) dcs[j] = __shfl_sync(0xffffffffu, co[0], j, 16);
    wtk::fwht4x4(dcs, wht);
    int unused = 0;
    const int rate_y2 =
        wtk::quant_rate<true>(wht, q_y2, 0, rc + 1 * wtk::RC_PT, y2dq, unused);
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
  // Chroma: 8 blocks x 4 modes on the 16 threads. Thread b takes block
  // b & 7 (U blocks 0-3, then V blocks 0-3) under modes 0 and 1 (b < 8) or
  // 2 and 3; each mode's rate and distortion are summed over its 8 threads
  // and swapped across the halves, and the winner is taken in mode order.
  // ------------------------------------------------------------------
  const int blk = b & 7, half = b >> 3;
  const int plane = blk >> 2, j = blk & 3;
  const int cbr = j >> 1, cbc = j & 1;
  const int c0 = C_TOPU + plane * C_PLANE_UV;
  int ctv[4], clv[4];
  int st = 0, sl = 0;
  for (int k = 0; k < 8; ++k) {
    st += ht ? s_ctx[c0 + k][m] : 127;
    sl += hl ? s_ctx[c0 + 8 + k][m] : 129;
  }
  const int cdc = (ht && hl) ? (st + sl + 8) >> 4
                  : ht       ? (st + 4) >> 3
                  : hl       ? (sl + 4) >> 3
                             : 0x80;
  const int ctl = (ht && hl) ? (int)s_ctx[c0 + 16][m] : (ht ? 129 : 127);
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    ctv[k] = ht ? s_ctx[c0 + cbc * 4 + k][m] : 127;
    clv[k] = hl ? s_ctx[c0 + 8 + cbr * 4 + k][m] : 129;
  }
  int csrc[16];
  load16(&s_src[m][R_SRCU + blk * 16], csrc);
  int rate_m[4], disto_m[4];
#pragma unroll
  for (int mm = 0; mm < 2; ++mm) {
    const int mode = half * 2 + mm;
    int d[16], co[16];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        d[r * 4 + c] =
            csrc[r * 4 + c] - wtk::pred_dtvh(mode, cdc, clv[r], ctv[c], ctl);
      }
    }
    wtk::fdct4x4(d, co);
    int disto_b = 0;
    int rate_b = wtk::quant_rate<true>(co, q_uv, 0, rc + 2 * wtk::RC_PT, nullptr,
                                 disto_b);
#pragma unroll
    for (int o = 4; o > 0; o >>= 1) {
      rate_b += __shfl_xor_sync(0xffffffffu, rate_b, o);
      disto_b += __shfl_xor_sync(0xffffffffu, disto_b, o);
    }
    const int rate_o = __shfl_xor_sync(0xffffffffu, rate_b, 8);
    const int disto_o = __shfl_xor_sync(0xffffffffu, disto_b, 8);
    rate_m[mm] = half ? rate_o : rate_b;
    rate_m[2 + mm] = half ? rate_b : rate_o;
    disto_m[mm] = half ? disto_o : disto_b;
    disto_m[2 + mm] = half ? disto_b : disto_o;
  }
  float best_uv_score = INFINITY;
  int best_uv = 0;
#pragma unroll
  for (int mode = 0; mode < 4; ++mode) {
    const int rate = rc[wtk::RC_FCUV + mode] + rate_m[mode];
    const float score = wtk::rd_score(__int2float_rn(rate), lamuv,
                                      wtk::rd_disto(disto_m[mode], 0.f, -1));
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
