"""I4 mode-search kernel: the 10-mode 4x4 intra search per luma subblock,
a hand-written CUDA kernel (csrc/i4_search.cu) beside its plain PyTorch
version on the same row layout. Counterpart of webp_tpu/ops/pallas_i4.py.

Layouts (one lane per subblock, N = B * n_sb, image b owns lanes
[b * n_sb, (b+1) * n_sb)):

  data u8 [32, N]  rows 0-15 source pixels (raster p = r*4+c), 16-19
       l3..l0, 20 tl, 21-24 t0..t3, 25-28 tr0..tr3, 29 is_c3 (rightmost
       subblock column of its MB), 30 segment, 31 unused;
  qtab i32 [B, 16, 16]  y1 quant rows, row = seg*4 + param (q, iq, bias,
       sharpen), zigzag columns;
  lams f32 [B, 12]  lambda_i4[4] @0, tlsd[4] @4, lambda_mode[4] @8, per
       segment;
  rc   i32 [RC_SIZE]  rate constants (fastpath.pack_rate_consts).
"""

from __future__ import annotations

import torch

from . import cuda
from .p1_kernels import unpack_rate_consts, wha_p
from .planar import approx_rate_p, fdct4x4_p, idct4x4_p, pred4_all_p, quantize_p

# Modes that read the above-right strip (VE via its smoothing tap, LD,
# VL): banned on the rightmost subblock column, whose strip would come
# from the not yet reconstructed above-right macroblock at skew 1.
TR_MODES = (2, 6, 7)


def i4_scores_plain(data, qtab, lams, rc, n_sb, use_td):
    """Plain version of csrc/i4_search.cu. Returns (mode [N] i32, score
    [N] f32): the mode chosen at lambda_i4 and its total rescored at
    lambda_mode."""
    dev = data.device
    N = data.shape[1]
    d = data.to(torch.int32)
    img = torch.arange(N, device=dev) // n_sb
    seg = d[30].long()
    rt = unpack_rate_consts(rc)
    q = tuple(qtab[img, seg * 4 + p].T.contiguous() for p in range(4))
    lam, tlsd, lam_md = (lams[img, base + seg] for base in (0, 4, 8))
    src = d[0:16].reshape(4, 4, N)
    l = d[16:20].flip(0)                                     # l0..l3
    preds = pred4_all_p(d[21:25], l, d[20], d[25:29])
    is_c3 = d[29] != 0
    ha_src = wha_p(src) if use_td else None
    best_score = torch.full((N,), float("inf"), device=dev)
    best_rate = torch.zeros((N,), device=dev)
    best_D = torch.zeros((N,), device=dev)
    best_mode = torch.zeros((N,), dtype=torch.int32, device=dev)
    for m, pred in enumerate(preds):
        flat = fdct4x4_p(src, pred).reshape(16, N)
        lv, dq = quantize_p(flat, *q)
        disto = ((flat - dq) ** 2).sum(dim=0, dtype=torch.int32)
        rate = (approx_rate_p(lv, 0, 3, rt) + rt.i4mode[m]).to(torch.float32)
        D = 64.0 * disto.to(torch.float32)
        if use_td:
            rec = (pred + idct4x4_p(dq.reshape(4, 4, N))).clamp(0, 255)
            td = (wha_p(rec) - ha_src).abs() >> 5
            D = D + tlsd * td.to(torch.float32)
        score = rate * lam + D
        if m in TR_MODES:
            score = torch.where(is_c3, float("inf"), score)
        better = score < best_score
        best_score = torch.where(better, score, best_score)
        best_rate = torch.where(better, rate, best_rate)
        best_D = torch.where(better, D, best_D)
        best_mode = torch.where(better, m, best_mode)
    return best_mode, best_rate * lam_md + best_D


def i4_scores(data, qtab, lams, rc, n_sb: int, use_td: bool):
    """The I4 search over N = B * n_sb subblock lanes: the CUDA kernel for
    CUDA tensors, the plain version for CPU tensors. Returns (mode [N]
    i32, score [N] f32)."""
    cuda.check("data", data, torch.uint8, (32, None))
    N = data.shape[1]
    if n_sb <= 0 or N % n_sb:
        raise ValueError(f"i4_scores: {N} lanes are not a whole number of "
                         f"{n_sb}-subblock images")
    B = N // n_sb
    cuda.check("qtab", qtab, torch.int32, (B, 16, 16))
    cuda.check("lams", lams, torch.float32, (B, 12))
    cuda.check("rc", rc, torch.int32, (None,))
    if cuda.on_cpu(data, qtab, lams, rc):
        return i4_scores_plain(data, qtab, lams, rc, n_sb, use_td)
    mode = torch.empty((N,), dtype=torch.int32, device=data.device)
    score = torch.empty((N,), dtype=torch.float32, device=data.device)
    if N:
        cuda.launch("i4_search", data, qtab, lams, rc, N, n_sb,
                    bool(use_td), mode, score)
    return mode, score
