"""Phase 0/1 kernels: the segment-alpha kernel and the I16/UV mode-search
kernel, each a hand-written CUDA kernel (csrc/p1_alpha.cu, csrc/p1_mode.cu)
beside its plain PyTorch version on the same row layout.

Counterpart of webp_tpu/ops/pallas_p1.py. Layouts (lanes minor, one lane
per macroblock, L = B * n_mb, image b owns lanes [b * n_mb, (b+1) * n_mb)):

  src  u8 [N_SRC, L]  block-major source pixels: srcY rows 0-255
       (block b = br*4+bc, pixel p = r*4+c at row b*16+p), srcU 256-319,
       srcV 320-383 (block b = br*2+bc);
  ctx  u8 [N_CTX, L]  source-pixel contexts (top/left rows, corner) per
       plane at the C_* rows, the has_top/has_left flags and the segment;
  qtab i32 [B, 48, 16]  quant rows, row = type*16 + seg*4 + param (types
       y1/y2/uv, params q/iq/bias/sharpen), zigzag columns;
  lams f32 [B, 16]  lambda_i16[4] @0, lambda_uv[4] @4, tlsd[4] @8,
       lambda_mode[4] @12, per segment;
  rc   i32 [RC_SIZE]  rate constants (fastpath.pack_rate_consts).

A wrapper runs the plain version for tensors on the CPU and launches the
kernel for tensors on a CUDA device; it never falls back from one to the
other.
"""

from __future__ import annotations

from types import SimpleNamespace

import numpy as np
import torch

from . import cuda
from .fastpath import RC_FC16, RC_FCUV, RC_I4MODE, RC_PT
from .planar import (
    approx_rate_p,
    fdct4x4_p,
    fwht4x4_p,
    idct4x4_p,
    quantize_p,
    wht4x4_p,
)

N_SRC = 384
R_SRCY, R_SRCU, R_SRCV = 0, 256, 320
N_CTX = 70
C_TOPY, C_LEFTY, C_TLY = 0, 16, 32
C_TOPU, C_LEFTU, C_TLU = 33, 41, 49
C_TOPV, C_LEFTV, C_TLV = 50, 58, 66
C_HT, C_HL, C_SEG = 67, 68, 69

WEIGHT_Y = np.array([38, 32, 20, 9, 32, 28, 17, 7,
                     20, 17, 10, 4, 9, 7, 4, 2], np.int32).reshape(4, 4)


def unpack_rate_consts(rc: torch.Tensor):
    """int32 [RC_SIZE] -> namespace of tensors on rc's device: lvlp
    [4, 16, 8], tailp [4, 16, 4], eob1p/eob2p/emptyp [4, 16] (the
    RateTables fields approx_rate_p reads), fc16 [4], fcuv [4],
    i4mode [10]."""
    per = rc[:4 * RC_PT].reshape(4, RC_PT)
    return SimpleNamespace(
        lvlp=per[:, 0:128].reshape(4, 16, 8),
        tailp=per[:, 128:192].reshape(4, 16, 4),
        eob1p=per[:, 192:208], eob2p=per[:, 208:224],
        emptyp=per[:, 224:240],
        fc16=rc[RC_FC16:RC_FC16 + 4], fcuv=rc[RC_FCUV:RC_FCUV + 4],
        i4mode=rc[RC_I4MODE:RC_I4MODE + 10])


def hadamard4_p(x):
    """Planar 4x4 Hadamard transform: [..., 4, 4, N] int32 (columns
    first)."""
    c0, c1, c2, c3 = (x[..., :, 0, :], x[..., :, 1, :],
                      x[..., :, 2, :], x[..., :, 3, :])
    a0, a1 = c0 + c2, c1 + c3
    a2, a3 = c1 - c3, c0 - c2
    t = torch.stack([a0 + a1, a3 + a2, a3 - a2, a0 - a1], dim=-2)
    r0, r1, r2, r3 = (t[..., 0, :, :], t[..., 1, :, :],
                      t[..., 2, :, :], t[..., 3, :, :])
    a0, a1 = r0 + r2, r1 + r3
    a2, a3 = r1 - r3, r0 - r2
    return torch.stack([a0 + a1, a3 + a2, a3 - a2, a0 - a1], dim=-3)


def wha_p(blocks):
    """sum(WEIGHT_Y * |hadamard|) per block: [..., 4, 4, N] -> [..., N]."""
    w = torch.as_tensor(WEIGHT_Y, device=blocks.device).reshape(4, 4, 1)
    return (w * hadamard4_p(blocks.to(torch.int32)).abs()).sum(
        dim=(-3, -2), dtype=torch.int32)


def pred16_m(m, top, left, tl, has_top, has_left):
    """Single I16/UV mode prediction plane [s, s, N] (DC/TM/V/H) from
    top/left [s, N] and tl [N] contexts."""
    s = top.shape[0]
    shift = 5 if s == 16 else 4
    top_m = torch.where(has_top[None, :], top, 127)
    left_m = torch.where(has_left[None, :], left, 129)
    shape = (s, s, top.shape[-1])
    if m == 0:
        sum_t = top_m.sum(dim=0, dtype=torch.int32)
        sum_l = left_m.sum(dim=0, dtype=torch.int32)
        dc = torch.where(
            has_top & has_left, (sum_t + sum_l + s) >> shift,
            torch.where(has_top, (sum_t + (s >> 1)) >> (shift - 1),
                        torch.where(has_left, (sum_l + (s >> 1)) >> (shift - 1),
                                    0x80)))
        return dc[None, None, :].expand(shape)
    if m == 1:
        tl_m = torch.where(has_top & has_left, tl,
                           127 + 2 * has_top.to(torch.int32))
        return (left_m[:, None, :] + top_m[None, :, :]
                - tl_m[None, None, :]).clamp(0, 255)
    if m == 2:
        return top_m[None, :, :].expand(shape)
    return left_m[:, None, :].expand(shape)


# ---------------------------------------------------------------------------
# Kernel 1: segment alphas.
# ---------------------------------------------------------------------------

def _hist_alpha_p(v):
    """v int32 [C, L] (values < 32) -> alpha [L] int32."""
    hist = torch.stack([(v == k).sum(dim=0, dtype=torch.int32)
                        for k in range(32)], dim=0)              # [32, L]
    max_value = hist.amax(dim=0)
    ks = torch.arange(32, dtype=torch.int32, device=v.device)[:, None]
    last_nz = torch.where(hist > 0, ks, 0).amax(dim=0).clamp(min=1)
    alpha = torch.where(max_value > 1,
                        510 * last_nz // max_value.clamp(min=1), 0)
    return alpha.clamp(max=255)


def alphas_plain(src):
    """Plain version of csrc/p1_alpha.cu: src u8 [N_SRC, L] -> (alpha
    [L] i32 mixed texture alpha, uv [L] i32 pre-mix UV alpha)."""
    L = src.shape[1]
    s = src.to(torch.int32)

    def plane_alpha(blocks, n):
        dc = torch.round(blocks.sum(dim=(0, 1, 2)).to(torch.float32)
                         * (1.0 / n)).to(torch.int32)
        co = fdct4x4_p(blocks, dc[None, None, None, :])
        return _hist_alpha_p((co.abs() >> 3).clamp(max=31).reshape(-1, L))

    luma = plane_alpha(s[R_SRCY:R_SRCU].reshape(16, 4, 4, L), 256)
    uv = plane_alpha(s[R_SRCU:N_SRC].reshape(8, 4, 4, L), 128)
    a = (255 - ((3 * luma + uv + 2) >> 2)).clamp(0, 255)
    return a, uv


def alphas(src):
    """Per-MB (alpha, uv alpha) [L] i32 each from the src rows: the CUDA
    kernel for a CUDA tensor, the plain version for a CPU tensor."""
    cuda.check("src", src, torch.uint8, (N_SRC, None))
    if cuda.on_cpu(src):
        return alphas_plain(src)
    L = src.shape[1]
    alpha = torch.empty((L,), dtype=torch.int32, device=src.device)
    uv = torch.empty((L,), dtype=torch.int32, device=src.device)
    if L:
        cuda.launch("p1_alpha", src, L, alpha, uv)
    return alpha, uv


# ---------------------------------------------------------------------------
# Kernel 2: I16 + UV mode search.
# ---------------------------------------------------------------------------

def _lane_rows(qtab, img, seg, tb):
    """Per-lane zigzag quant rows (q, iq, bias, sharpen) [16, L] of type
    tb (0 y1, 1 y2, 2 uv)."""
    return tuple(qtab[img, tb * 16 + seg * 4 + p].T.contiguous()
                 for p in range(4))


def mode_search_plain(src, ctx, qtab, lams, rc, n_mb, use_td):
    """Plain version of csrc/p1_mode.cu. Returns (mode [L] i32, uv [L]
    i32, score [L] f32): the I16 mode chosen at lambda_i16, its total
    rescored at lambda_mode, and the chroma mode chosen at lambda_uv."""
    dev = src.device
    L = src.shape[1]
    img = torch.arange(L, device=dev) // n_mb
    c = ctx.to(torch.int32)
    seg = c[C_SEG].long()
    rt = unpack_rate_consts(rc)
    ht = c[C_HT] != 0
    hl = c[C_HL] != 0

    def lam_of(base):
        return lams[img, base + seg]

    lam16, lamuv, tlsd, lam_md = (lam_of(0), lam_of(4), lam_of(8),
                                  lam_of(12))
    y1, y2, quv = (_lane_rows(qtab, img, seg, tb) for tb in range(3))

    srcY = src[R_SRCY:R_SRCU].to(torch.int32).reshape(16, 4, 4, L)
    top, left, tl = c[C_TOPY:C_LEFTY], c[C_LEFTY:C_TLY], c[C_TLY]
    ha_src = wha_p(srcY) if use_td else None                     # [16, L]
    best_score = torch.full((L,), float("inf"), device=dev)
    best_rate = torch.zeros((L,), device=dev)
    best_D = torch.zeros((L,), device=dev)
    best_mode = torch.zeros((L,), dtype=torch.int32, device=dev)
    for m in range(4):
        pred_p = pred16_m(m, top, left, tl, ht, hl)
        pred_b = pred_p.reshape(4, 4, 4, 4, L).permute(0, 2, 1, 3, 4) \
            .reshape(16, 4, 4, L)
        coeffs = fdct4x4_p(srcY, pred_b)
        flat = coeffs.reshape(16, 16, L)
        wht = fwht4x4_p(flat[:, 0].reshape(4, 4, L))
        y2lv, y2dq = quantize_p(wht.reshape(16, L), *y2)
        rec_dc = wht4x4_p(y2dq.reshape(4, 4, L)).reshape(16, L)
        lv, dq = quantize_p(flat, *y1, first=1)
        dq = dq.clone()
        dq[:, 0] = rec_dc
        disto = ((flat - dq) ** 2).sum(dim=(0, 1), dtype=torch.int32)
        rate = approx_rate_p(lv, 1, 0, rt).sum(dim=0, dtype=torch.int32)
        rate = rate + approx_rate_p(y2lv, 0, 1, rt) + rt.fc16[m]
        D = 64.0 * disto.to(torch.float32)
        if use_td:
            recon = (pred_b + idct4x4_p(dq.reshape(16, 4, 4, L))).clamp(0, 255)
            td = ((wha_p(recon) - ha_src).abs() >> 5).sum(dim=0,
                                                           dtype=torch.int32)
            D = D + tlsd * td.to(torch.float32)
        score = rate.to(torch.float32) * lam16 + D
        better = score < best_score
        best_score = torch.where(better, score, best_score)
        best_rate = torch.where(better, rate.to(torch.float32), best_rate)
        best_D = torch.where(better, D, best_D)
        best_mode = torch.where(better, m, best_mode)
    score_out = best_rate * lam_md + best_D

    planes = []
    for r_src, c_top in ((R_SRCU, C_TOPU), (R_SRCV, C_TOPV)):
        planes.append((src[r_src:r_src + 64].to(torch.int32).reshape(4, 4, 4, L),
                       c[c_top:c_top + 8], c[c_top + 8:c_top + 16],
                       c[c_top + 16]))
    best_uv_score = torch.full((L,), float("inf"), device=dev)
    best_uv = torch.zeros((L,), dtype=torch.int32, device=dev)
    for m in range(4):
        rate = rt.fcuv[m].expand(L)
        disto = torch.zeros((L,), dtype=torch.int32, device=dev)
        for srcc, tp, lf, tlc in planes:
            pred_p = pred16_m(m, tp, lf, tlc, ht, hl)
            pred_b = pred_p.reshape(2, 4, 2, 4, L).permute(0, 2, 1, 3, 4) \
                .reshape(4, 4, 4, L)
            flat = fdct4x4_p(srcc, pred_b).reshape(4, 16, L)
            lv, dq = quantize_p(flat, *quv)
            disto = disto + ((flat - dq) ** 2).sum(dim=(0, 1),
                                                   dtype=torch.int32)
            rate = rate + approx_rate_p(lv, 0, 2, rt).sum(dim=0,
                                                          dtype=torch.int32)
        score = rate.to(torch.float32) * lamuv + 64.0 * disto.to(torch.float32)
        better = score < best_uv_score
        best_uv_score = torch.where(better, score, best_uv_score)
        best_uv = torch.where(better, m, best_uv)
    return best_mode, best_uv, score_out


def mode_search(src, ctx, qtab, lams, rc, n_mb: int, use_td: bool):
    """The I16/UV mode search over L = B * n_mb macroblock lanes: the CUDA
    kernel for CUDA tensors, the plain version for CPU tensors. Returns
    (mode [L] i32, uv [L] i32, score [L] f32)."""
    cuda.check("src", src, torch.uint8, (N_SRC, None))
    L = src.shape[1]
    if n_mb <= 0 or L % n_mb:
        raise ValueError(f"mode_search: {L} lanes are not a whole number "
                         f"of {n_mb}-macroblock images")
    B = L // n_mb
    cuda.check("ctx", ctx, torch.uint8, (N_CTX, L))
    cuda.check("qtab", qtab, torch.int32, (B, 48, 16))
    cuda.check("lams", lams, torch.float32, (B, 16))
    cuda.check("rc", rc, torch.int32, (None,))
    if cuda.on_cpu(src, ctx, qtab, lams, rc):
        return mode_search_plain(src, ctx, qtab, lams, rc, n_mb, use_td)
    mode = torch.empty((L,), dtype=torch.int32, device=src.device)
    uv = torch.empty((L,), dtype=torch.int32, device=src.device)
    score = torch.empty((L,), dtype=torch.float32, device=src.device)
    if L:
        cuda.launch("p1_mode", src, ctx, qtab, lams, rc, L, n_mb,
                    bool(use_td), mode, uv, score)
    return mode, uv, score
