"""Batched planar phase 0 + 1: segment analysis and the parallel I16/UV
mode search, with the fused batch x macroblock axis minor (L = B * n_mb
lanes). Counterpart of webp_tpu/ops/phase1p.py (its kernel-backed path).

This module builds the kernels' row layouts (ops/p1_kernels.py) from the
YUV planes and turns their per-lane outputs back into [B, n_mb] arrays;
the arithmetic lives in the kernels and their plain versions.
"""

from __future__ import annotations

import torch

from . import p1_kernels as K
from .planar import _mb_planar


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
    a, uv = K.alphas(src_rows)
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
    mode, uv, score = K.mode_search(src_rows, ctx, qtabs, lams, rc, n_mb,
                                    use_td)
    return (mode.reshape(B, n_mb).to(torch.uint8),
            uv.reshape(B, n_mb).to(torch.uint8), score.reshape(B, n_mb))
