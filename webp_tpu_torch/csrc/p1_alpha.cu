// Segment-alpha kernel (phase 0): per-macroblock texture alpha and the
// pre-mix UV alpha from the block-major source rows.
//
// Replaces the TPU kernel webp_tpu/ops/pallas_p1.py `_alpha_kernel` (:500,
// built by `_build_alpha_call` :563). Plain PyTorch version and launch
// wrapper: webp_tpu_torch/ops/p1_kernels.py (alphas_plain / alphas).
//
// Per MB: each 4x4 block is DC-removed (round-half-even of the plane
// mean) and forward-DCT'd; a 32-bin histogram of min(|c| >> 3, 31) gives
// alpha = 510 * last_nonzero_bin // max_count (0 when max_count <= 1).
// Luma (16 blocks) and U+V (8 blocks) are mixed as
// clip(255 - ((3 * luma + uv + 2) >> 2), 0, 255).
//
// What bounds it on the H100: integer ALU. Per MB it reads 384 bytes and
// writes 8, and does ~6.3k integer operations (24 DCTs, 384 histogram
// updates; the count chip_smoke.py uses for the bound): ~16 operations
// per byte, above the card's ~5 INT32 operations per byte of HBM
// bandwidth (64 INT32 lanes x 132 SMs against 3.35 TB/s). The design keeps every thread on
// arithmetic: one block of 256 threads covers 16 macroblocks, 16 threads
// per MB, one per luma 4x4 block (threads 0-7 also take the 8 chroma
// blocks). The tile of source rows is staged once through shared memory
// with lane-contiguous loads; the plane means are half-warp shuffle sums;
// the histograms are shared-memory integer atomics (order-free).

#include "common.cuh"

namespace {

constexpr int N_SRC = 384;
constexpr int R_SRCY = 0;
constexpr int R_SRCU = 256;
constexpr int MB_PER_BLOCK = 16;
constexpr int THREADS = MB_PER_BLOCK * 16;

__device__ __forceinline__ int hist_alpha(const int* h, int b) {
  // Thread b of the MB's half-warp reads bins b and b + 16.
  const int c0 = h[b], c1 = h[b + 16];
  const int mx = wtk::max16(max(c0, c1));
  int last = c1 > 0 ? b + 16 : (c0 > 0 ? b : 0);
  last = max(wtk::max16(last), 1);
  if (mx <= 1) return 0;
  const int a = 510 * last / mx;
  return a < 255 ? a : 255;
}

__global__ void __launch_bounds__(THREADS)
p1_alpha_kernel(const uint8_t* __restrict__ src, int L,
                int* __restrict__ alpha_out, int* __restrict__ uv_out) {
  __shared__ uint8_t s_src[N_SRC][MB_PER_BLOCK];
  __shared__ int hist[MB_PER_BLOCK][2][32];
  const int tid = threadIdx.x;
  const int lane0 = blockIdx.x * MB_PER_BLOCK;
  for (int i = tid; i < N_SRC * MB_PER_BLOCK; i += THREADS) {
    const int r = i / MB_PER_BLOCK, m = i % MB_PER_BLOCK;
    const int l = lane0 + m;
    s_src[r][m] = l < L ? src[(size_t)r * L + l] : 0;
  }
  for (int i = tid; i < MB_PER_BLOCK * 64; i += THREADS)
    (&hist[0][0][0])[i] = 0;
  __syncthreads();

  const int m = tid >> 4;
  const int b = tid & 15;
  int px[16], co[16];

  // Luma block b.
  int s = 0;
#pragma unroll
  for (int p = 0; p < 16; ++p) {
    px[p] = s_src[R_SRCY + b * 16 + p][m];
    s += px[p];
  }
  int dc = (int)rintf(__fmul_rn(__int2float_rn(wtk::sum16(s)), 1.0f / 256.0f));
#pragma unroll
  for (int p = 0; p < 16; ++p) px[p] -= dc;
  wtk::fdct4x4(px, co);
#pragma unroll
  for (int p = 0; p < 16; ++p)
    atomicAdd(&hist[m][0][min(abs(co[p]) >> 3, 31)], 1);

  // Chroma: U blocks 0-3 then V blocks 0-3 (rows R_SRCU + b * 16).
  s = 0;
  if (b < 8) {
#pragma unroll
    for (int p = 0; p < 16; ++p) {
      px[p] = s_src[R_SRCU + b * 16 + p][m];
      s += px[p];
    }
  }
  dc = (int)rintf(__fmul_rn(__int2float_rn(wtk::sum16(s)), 1.0f / 128.0f));
  if (b < 8) {
#pragma unroll
    for (int p = 0; p < 16; ++p) px[p] -= dc;
    wtk::fdct4x4(px, co);
#pragma unroll
    for (int p = 0; p < 16; ++p)
      atomicAdd(&hist[m][1][min(abs(co[p]) >> 3, 31)], 1);
  }
  __syncthreads();

  const int luma = hist_alpha(hist[m][0], b);
  const int uv = hist_alpha(hist[m][1], b);
  const int l = lane0 + m;
  if (b == 0 && l < L) {
    const int a = 255 - ((3 * luma + uv + 2) >> 2);
    alpha_out[l] = a < 0 ? 0 : (a > 255 ? 255 : a);
    uv_out[l] = uv;
  }
}

}  // namespace

extern "C" int p1_alpha_launch(const void* src, int L, void* alpha, void* uv,
                               void* stream) {
  const int grid = (L + MB_PER_BLOCK - 1) / MB_PER_BLOCK;
  p1_alpha_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)src, L, (int*)alpha, (int*)uv);
  return (int)cudaGetLastError();
}
