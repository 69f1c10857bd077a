"""Batched planar phase 0 + 1: segment analysis and the parallel I16/UV
mode search, with the fused batch x macroblock axis minor (L = B * n_mb
lanes). Counterpart of webp_tpu/ops/phase1p.py (its kernel-backed path).

This module builds the kernels' row layouts from the YUV planes, runs the
plain versions of kernels 1 and 2 on them (below) and turns their
per-lane outputs back into [B, n_mb] arrays.
"""

from __future__ import annotations

from types import SimpleNamespace

import torch

from .fastpath import RC_FC16, RC_FCUV, RC_I4MODE, RC_PT
from .metrics import WEIGHT_Y
from .planar import (
    _mb_planar,
    approx_rate_p,
    fdct4x4_p,
    fwht4x4_p,
    idct4x4_p,
    quantize_p,
    wht4x4_p,
)


def _src_planar(plane_b, mb_h, mb_w, s):
    """[B, H, W] u8 -> [(s/4)^2, 4, 4, L] u8, L = B * n_mb minor."""
    B = plane_b.shape[0]
    nb = (s // 4) ** 2
    g = _mb_planar(plane_b.to(torch.uint8), mb_h, mb_w, s)
    return g.reshape(B * mb_h * mb_w, nb, 4, 4).permute(1, 2, 3, 0)


def _ctx_planar(src, s, mb_w):
    """Source-pixel contexts from planar src blocks [(s/4)^2, 4, 4, L]:
    (top [s, L], left [s, L], tl [L]) u8 — the bottom row of the MB above
    (lane - mb_w), the right column of the MB to the left (lane - 1) and
    the bottom-right pixel of the MB above-left. Values shifted in across
    a row or image edge land on lanes whose has_top/has_left is False;
    every consumer masks them."""
    nb = s // 4
    L = src.shape[-1]
    blocks = src.reshape(nb, nb, 4, 4, L)
    bot = blocks[nb - 1, :, 3].reshape(s, L)
    rgt = blocks[:, nb - 1, :, 3].reshape(s, L)
    br = blocks[nb - 1, nb - 1, 3, 3]

    def shift(a, k):
        out = torch.zeros_like(a)
        if k < L:
            out[..., k:] = a[..., :L - k]
        return out

    return shift(bot, mb_w), shift(rgt, 1), shift(br, mb_w + 1)


def _flags(mb_w, mb_h, B, device):
    """(has_top, has_left) bool [L]: MB row > 0, MB column > 0."""
    n_mb = mb_w * mb_h
    k = torch.arange(B * n_mb, device=device) % n_mb
    return k >= mb_w, (k % mb_w) > 0


def build_src(Yb, Ub, Vb, mb_w, mb_h):
    """The kernels' shared source rows u8 [N_SRC, L] (counterpart of
    build_src_pallas, without the TPU's tile padding). Returns (src_rows,
    (srcY, srcU, srcV) planar block views)."""
    srcY = _src_planar(Yb, mb_h, mb_w, 16)
    srcU = _src_planar(Ub, mb_h, mb_w, 8)
    srcV = _src_planar(Vb, mb_h, mb_w, 8)
    L = srcY.shape[-1]
    src = torch.cat([srcY.reshape(256, L), srcU.reshape(64, L),
                     srcV.reshape(64, L)]).contiguous()
    return src, (srcY, srcU, srcV)


def alphas_planar(src_rows, B, n_mb):
    """Per-MB texture alphas and UV alphas ([B, n_mb] i32 each) from the
    src rows, through the segment-alpha kernel (alphas_planar_pallas)."""
    a, uv = alphas_plain(src_rows)
    return a.reshape(B, n_mb), uv.reshape(B, n_mb)


def plan_segments_planar(alphas, B, n_mb, quality, sns_strength, num_segs):
    """Per-image k-means segment plans from the alphas.

    alphas: ([B, n_mb] alphas, [B, n_mb] uv alphas). Returns (seg_map
    [B, n_mb] i32, seg_q [B, 4] i32, seg_beta [B, 4] i32, global_uv [B]
    i32 — the mean pre-mix UV alpha)."""
    from .fastpath import _plan_from_histo

    a, uv_al = alphas
    guv = (uv_al.sum(dim=1) // n_mb).to(torch.int32)
    histo = torch.zeros((B, 256), dtype=torch.int64, device=a.device)
    histo.scatter_add_(1, a.long(), torch.ones_like(a, dtype=torch.int64))
    seg_map, seg_q, seg_beta = _plan_from_histo(histo, a, quality,
                                                sns_strength, num_segs)
    return seg_map, seg_q, seg_beta, guv


def build_ctx(srcs, seg_map, mb_w, mb_h):
    """The mode-search kernel's context rows u8 [N_CTX, L] (contours per
    plane, has_top/has_left, segment) from the planar src blocks."""
    srcY, srcU, srcV = srcs
    L = srcY.shape[-1]
    B = L // (mb_w * mb_h)
    ht, hl = _flags(mb_w, mb_h, B, srcY.device)
    rows = []
    for src, s in ((srcY, 16), (srcU, 8), (srcV, 8)):
        top, left, tl = _ctx_planar(src, s, mb_w)
        rows += [top, left, tl[None]]
    rows += [ht[None], hl[None], seg_map.reshape(1, L)]
    return torch.cat([r.to(torch.uint8) for r in rows], dim=0).contiguous()


def phase1_planar(src_rows, srcs, qtabs, lam16_4, lamuv_4, tlsd4, seg_map,
                  mb_w, mb_h, lam_mode4):
    """Batched I16 + UV mode search through the mode-search kernel
    (counterpart of phase1_planar_pallas).

    qtabs: i32 [B, 48, 16] quant rows; lam16_4/lamuv_4/lam_mode4 [B, 4]
    f32 per-segment lambdas; tlsd4 [B, 4] f32 or None (TDisto off);
    seg_map [B, n_mb] i32. Returns (modes [B, n_mb] u8, uvmodes [B, n_mb]
    u8, score [B, n_mb] f32) — the score is the chosen I16 mode's total
    rescored at lambda_mode, the I4-vs-I16 split scale."""
    B, n_mb = seg_map.shape
    ctx = build_ctx(srcs, seg_map, mb_w, mb_h)
    use_td = tlsd4 is not None
    lams = torch.cat([lam16_4, lamuv_4,
                      tlsd4 if use_td else torch.zeros_like(lam16_4),
                      lam_mode4], dim=1).to(torch.float32).contiguous()
    from .fastpath import device_tables

    rc = device_tables(str(src_rows.device)).rate_consts
    mode, uv, score = mode_search_plain(src_rows, ctx, qtabs, lams, rc, n_mb,
                                    use_td)
    return (mode.reshape(B, n_mb).to(torch.uint8),
            uv.reshape(B, n_mb).to(torch.uint8), score.reshape(B, n_mb))


# ---------------------------------------------------------------------------
# The plain versions of kernels 1 and 2 on their row layouts.
# ---------------------------------------------------------------------------

N_SRC = 384
R_SRCY, R_SRCU, R_SRCV = 0, 256, 320
N_CTX = 70
C_TOPY, C_LEFTY, C_TLY = 0, 16, 32
C_TOPU, C_LEFTU, C_TLU = 33, 41, 49
C_TOPV, C_LEFTV, C_TLV = 50, 58, 66
C_HT, C_HL, C_SEG = 67, 68, 69


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


