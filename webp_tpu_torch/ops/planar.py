"""Planar (lanes-minor) DSP and the phase-2 closed-loop wavefront.

Counterpart of webp_tpu/ops/planar.py. Every tensor keeps its lane axis
(batch x macroblock, N lanes) last; pixel and coefficient indices live on
the leading axes, so every butterfly, zigzag or context slice is a slice
of a leading axis. The integer math is the reference's, op for op.

phase2_planar is the skew-1 wavefront written as a Python step loop over
the n_steps = mb_w + mb_h - 1 anti-diagonals (the reference's lax.scan).
Only the configuration of the batched main path is ported: skew 1, no
trellis, no in-loop search, segments and the I4 walk on.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..lossy import tables as T
from .quant import MAX_LEVEL, QFIX, _WT

ZIGZAG = np.asarray(T.ZIGZAG)
INV_ZIGZAG = np.argsort(ZIGZAG)

C1 = 20091
C2 = 35468


def _mul1(a):
    return ((a * C1) >> 16) + a


def _mul2(a):
    return (a * C2) >> 16


@functools.lru_cache(maxsize=8)
def _index_tensors(device: str):
    return (torch.as_tensor(ZIGZAG, dtype=torch.long, device=device),
            torch.as_tensor(INV_ZIGZAG, dtype=torch.long, device=device),
            torch.as_tensor(_WT, device=device)[:, None])


# ---------------------------------------------------------------------------
# Planar transforms: [..., 4, 4, N] with rows on axis -3, cols on axis -2,
# lanes minor.
# ---------------------------------------------------------------------------

def fdct4x4_p(src, ref):
    d = src.to(torch.int32) - ref.to(torch.int32)
    d0, d1, d2, d3 = d[..., 0, :], d[..., 1, :], d[..., 2, :], d[..., 3, :]
    a0 = d0 + d3
    a1 = d1 + d2
    a2 = d1 - d2
    a3 = d0 - d3
    t0 = (a0 + a1) * 8
    t1 = (a2 * 2217 + a3 * 5352 + 1812) >> 9
    t2 = (a0 - a1) * 8
    t3 = (a3 * 2217 - a2 * 5352 + 937) >> 9
    tmp = torch.stack([t0, t1, t2, t3], dim=-2)
    m0, m1, m2, m3 = (tmp[..., 0, :, :], tmp[..., 1, :, :],
                      tmp[..., 2, :, :], tmp[..., 3, :, :])
    a0 = m0 + m3
    a1 = m1 + m2
    a2 = m1 - m2
    a3 = m0 - m3
    o0 = (a0 + a1 + 7) >> 4
    o2 = (a0 - a1 + 7) >> 4
    o1 = ((a2 * 2217 + a3 * 5352 + 12000) >> 16) + (a3 != 0).to(torch.int32)
    o3 = (a3 * 2217 - a2 * 5352 + 51000) >> 16
    return torch.stack([o0, o1, o2, o3], dim=-3)


def idct4x4_p(coeffs):
    c = coeffs.to(torch.int32)
    i0, i1, i2, i3 = (c[..., 0, :, :], c[..., 1, :, :],
                      c[..., 2, :, :], c[..., 3, :, :])
    a = i0 + i2
    b = i0 - i2
    cc = _mul2(i1) - _mul1(i3)
    d = _mul1(i1) + _mul2(i3)
    tmp = torch.stack([a + d, b + cc, b - cc, a - d], dim=-3)
    dc = tmp[..., 0, :] + 4
    a = dc + tmp[..., 2, :]
    b = dc - tmp[..., 2, :]
    cc = _mul2(tmp[..., 1, :]) - _mul1(tmp[..., 3, :])
    d = _mul1(tmp[..., 1, :]) + _mul2(tmp[..., 3, :])
    return torch.stack([a + d, b + cc, b - cc, a - d], dim=-2) >> 3


def fwht4x4_p(dcs):
    """Forward WHT over sub-block DCs [..., 4, 4, N]."""
    d = dcs.to(torch.int32)
    c0, c1, c2, c3 = d[..., 0, :], d[..., 1, :], d[..., 2, :], d[..., 3, :]
    a0 = c0 + c2
    a1 = c1 + c3
    a2 = c1 - c3
    a3 = c0 - c2
    tmp = torch.stack([a0 + a1, a3 + a2, a3 - a2, a0 - a1], dim=-2)
    r0, r1, r2, r3 = (tmp[..., 0, :, :], tmp[..., 1, :, :],
                      tmp[..., 2, :, :], tmp[..., 3, :, :])
    a0 = r0 + r2
    a1 = r1 + r3
    a2 = r1 - r3
    a3 = r0 - r2
    return torch.stack([a0 + a1, a3 + a2, a3 - a2, a0 - a1], dim=-3) >> 1


def wht4x4_p(coeffs):
    """Inverse WHT [..., 4, 4, N]."""
    c = coeffs.to(torch.int32)
    i0, i1, i2, i3 = (c[..., 0, :, :], c[..., 1, :, :],
                      c[..., 2, :, :], c[..., 3, :, :])
    a0 = i0 + i3
    a1 = i1 + i2
    a2 = i1 - i2
    a3 = i0 - i3
    tmp = torch.stack([a0 + a1, a3 + a2, a0 - a1, a3 - a2], dim=-3)
    dc = tmp[..., 0, :] + 3
    a0 = dc + tmp[..., 3, :]
    a1 = tmp[..., 1, :] + tmp[..., 2, :]
    a2 = tmp[..., 1, :] - tmp[..., 2, :]
    a3 = dc - tmp[..., 3, :]
    return torch.stack([a0 + a1, a3 + a2, a0 - a1, a3 - a2], dim=-2) >> 3


def quantize_p(coeffs, q, iq, bias, sharpen, first: int = 0,
               rd_drop: float = 0.0):
    """coeffs int32 [..., 16, N] raster -> (levels_zz, dequant) same shape.

    q/iq/bias/sharpen: int32 [16, 1] or [16, N] (per-lane segment rows),
    zigzag order."""
    zz, inv, wt = _index_tensors(str(coeffs.device))
    czz = coeffs.index_select(-2, zz)
    sign = czz < 0
    mag = czz.abs() + sharpen
    level = ((mag * iq + bias) >> QFIX).clamp(max=MAX_LEVEL)
    if rd_drop:
        qf = q.to(torch.float32)
        c0 = mag.to(torch.float32)
        dd = wt * (c0 * c0 - (c0 - qf) * (c0 - qf))
        base = torch.floor((qf[..., 0:1, :] + 15.0 * qf[..., 1:2, :] + 8.0)
                           * (1.0 / 16.0))
        tlam = base * base * 0.25
        level = torch.where((level == 1) & (256.0 * dd < rd_drop * tlam),
                            0, level)
    level = torch.where(sign, -level, level)
    if first:
        level = level.clone()
        level[..., 0, :] = 0
    dq_zz = level * q
    return level, dq_zz.index_select(-2, inv)


# ---------------------------------------------------------------------------
# Planar block <-> plane views.
# ---------------------------------------------------------------------------

def plane_to_blocks_p(x, size):
    """[..., S, S, N] -> [..., (S/4)^2, 4, 4, N] raster 4x4 blocks."""
    *lead, S, _, N = x.shape
    b = size // 4
    x = x.reshape(*lead, b, 4, b, 4, N)
    x = torch.movedim(x, -3, -4)
    return x.reshape(*lead, b * b, 4, 4, N)


def blocks_to_plane_p(x, size):
    *lead, nb, _, _, N = x.shape
    b = size // 4
    x = x.reshape(*lead, b, b, 4, 4, N)
    x = torch.movedim(x, -3, -4)
    return x.reshape(*lead, size, size, N)


# ---------------------------------------------------------------------------
# Planar predictors.
# ---------------------------------------------------------------------------

def _corner_fill(has_top):
    """Missing top-left corner: 129 with a top row, else 127 (int32)."""
    return 127 + 2 * has_top.to(torch.int32)


def preds4_p(size, top, left, tl, has_top, has_left):
    """top/left [s, N], tl/has_* [N] -> [4, s, s, N] preds (DC/TM/V/H)."""
    shift = 5 if size == 16 else 4
    ht = has_top[None, :]
    hl = has_left[None, :]
    top_m = torch.where(ht, top, 127)
    left_m = torch.where(hl, left, 129)
    tl_m = torch.where(has_top & has_left, tl, _corner_fill(has_top))
    sum_t = top_m.sum(dim=0, dtype=torch.int32)
    sum_l = left_m.sum(dim=0, dtype=torch.int32)
    dc = torch.where(
        has_top & has_left, (sum_t + sum_l + size) >> shift,
        torch.where(has_top, (sum_t + (size >> 1)) >> (shift - 1),
                    torch.where(has_left, (sum_l + (size >> 1)) >> (shift - 1),
                                0x80)))
    N = top.shape[-1]
    shape = (size, size, N)
    pred_dc = dc[None, None, :].expand(shape)
    pred_v = top_m[None, :, :].expand(shape)
    pred_h = left_m[:, None, :].expand(shape)
    pred_tm = (left_m[:, None, :] + top_m[None, :, :]
               - tl_m[None, None, :]).clamp(0, 255)
    return torch.stack([pred_dc, pred_tm, pred_v, pred_h], dim=0)


def _a2(a, b):
    return (a + b + 1) >> 1


def _a3(a, b, c):
    return (a + 2 * b + c + 2) >> 2


def _rows_p(*rows):
    """Stack 4 [..., 4, N] rows into [..., 4, 4, N]."""
    return torch.stack(rows, dim=-3)


def pred4_all_p(t, l, tl, tr):
    """Planar 10 B-mode predictions from the 13-pixel contour.

    t/l/tr: [..., 4, N]; tl: [..., N]. Returns list of 10 [..., 4, 4, N]
    in mode order DC, TM, VE, HE, RD, VR, LD, VL, HD, HU."""
    ctx = torch.cat([l.flip(-2), tl[..., None, :], t, tr], dim=-2)  # 13
    s3 = _a3(ctx[..., :-2, :], ctx[..., 1:-1, :], ctx[..., 2:, :])
    s2 = _a2(ctx[..., :-1, :], ctx[..., 1:, :])
    lr = torch.cat([ctx[..., 4:5, :], l, l[..., 3:4, :]], dim=-2)
    s3h = _a3(lr[..., :-2, :], lr[..., 1:-1, :], lr[..., 2:, :])   # 4
    s2h = _a2(lr[..., :-1, :], lr[..., 1:, :])                     # 5
    l3 = l[..., 3, :]

    shape44 = t.shape[:-2] + (4, 4) + t.shape[-1:]
    dc = (t.sum(dim=-2, dtype=torch.int32) + l.sum(dim=-2, dtype=torch.int32)
          + 4) >> 3
    p_dc = dc[..., None, None, :].expand(shape44)
    p_tm = (l[..., :, None, :] + t[..., None, :, :]
            - tl[..., None, None, :]).clamp(0, 255)
    p_ve = s3[..., None, 4:8, :].expand(shape44)
    p_he = s3h[..., :, None, :].expand(shape44)
    p_rd = _rows_p(s3[..., 3:7, :], s3[..., 2:6, :], s3[..., 1:5, :],
                   s3[..., 0:4, :])
    c2 = s2[..., 4:8, :]
    d3 = s3[..., 3:7, :]
    p_vr = _rows_p(c2, d3,
                   torch.cat([s3[..., 2:3, :], c2[..., 0:3, :]], dim=-2),
                   torch.cat([s3[..., 1:2, :], d3[..., 0:3, :]], dim=-2))
    f = torch.cat([s3[..., 5:11, :],
                   _a3(tr[..., 2, :], tr[..., 3, :], tr[..., 3, :])[..., None, :]],
                  dim=-2)
    p_ld = _rows_p(f[..., 0:4, :], f[..., 1:5, :], f[..., 2:6, :],
                   f[..., 3:7, :])
    g2 = s2[..., 5:9, :]
    g3 = s3[..., 5:9, :]
    p_vl = _rows_p(g2, g3,
                   torch.cat([g2[..., 1:4, :], s3[..., 9:10, :]], dim=-2),
                   torch.cat([g3[..., 1:4, :], s3[..., 10:11, :]], dim=-2))
    hd0 = torch.cat([s2h[..., 0:1, :], s3[..., 3:6, :]], dim=-2)
    hd1 = torch.cat([s2h[..., 1:2, :], s3h[..., 0:1, :], hd0[..., 0:2, :]],
                    dim=-2)
    hd2 = torch.cat([s2h[..., 2:3, :], s3h[..., 1:2, :], hd1[..., 0:2, :]],
                    dim=-2)
    hd3 = torch.cat([s2h[..., 3:4, :], s3h[..., 2:3, :], hd2[..., 0:2, :]],
                    dim=-2)
    p_hd = _rows_p(hd0, hd1, hd2, hd3)
    l3b = l3[..., None, :].expand(l3.shape[:-1] + (4,) + l3.shape[-1:])
    hu0 = torch.stack([s2h[..., 1, :], s3h[..., 1, :], s2h[..., 2, :],
                       s3h[..., 2, :]], dim=-2)
    hu1 = torch.cat([hu0[..., 2:4, :], s2h[..., 3:4, :], s3h[..., 3:4, :]],
                    dim=-2)
    hu2 = torch.cat([hu1[..., 2:4, :], l3b[..., 0:2, :]], dim=-2)
    p_hu = _rows_p(hu0, hu1, hu2, l3b)
    return [p_dc, p_tm, p_ve, p_he, p_rd, p_vr, p_ld, p_vl, p_hd, p_hu]


def approx_rate_p(levels, first, pt, rt):
    """Planar approximate block rate: levels [..., 16, N] zigzag -> rate
    [..., N] int32. Band-exact per-position constants plus the per-band
    EOB bit (fastpath.RateTables)."""
    dev = levels.device
    v = levels.abs()
    idx = torch.arange(16, device=dev).reshape(16, 1)
    nzv = (v != 0) & (idx >= first)
    has_any = nzv.any(dim=-2)
    # last nonzero position (0 when none)
    last = torch.where(nzv, idx, -1).amax(dim=-2).clamp(min=0)
    vc = v.clamp(max=7)
    lvl = torch.as_tensor(rt.lvlp[pt], dtype=torch.int32, device=dev)  # [16, 8]
    cost = _lvl_cost(lvl, vc)
    tail = torch.as_tensor(rt.tailp[pt], dtype=torch.int32, device=dev)
    for b, (lo, hi) in enumerate(((8, 11), (11, 19), (19, 35),
                                  (35, 1 << 30))):
        cost = cost + torch.where((v >= lo) & (v < hi), tail[:, b:b + 1], 0)
    in_run = (idx >= first) & (idx <= last[..., None, :])
    total = torch.where(in_run, cost, 0).sum(dim=-2, dtype=torch.int32)
    e1 = torch.as_tensor(rt.eob1p[pt], dtype=torch.int32, device=dev)[:, None]
    e2 = torch.as_tensor(rt.eob2p[pt], dtype=torch.int32, device=dev)[:, None]
    e_pos = torch.where(v == 1, e1, e2)
    eob = torch.where(idx == last[..., None, :], e_pos, 0).sum(
        dim=-2, dtype=torch.int32)
    return torch.where(has_any, total + eob, int(rt.emptyp[pt, first]))


def _lvl_cost(lvl, vc):
    """lvl [16, 8] per-position costs, vc [..., 16, N] in 0..7 ->
    lvl[pos, vc] (the reference's 8-way select chain)."""
    cost = torch.zeros_like(vc)
    for k in range(8):
        cost = cost + torch.where(vc == k, lvl[:, k:k + 1], 0)
    return cost


# ---------------------------------------------------------------------------
# Planar transform pipelines.
# ---------------------------------------------------------------------------

def luma_pipe_p(src_b, pred_b, qp, rd_drop: float = 0.0):
    """src/pred: [16, 4, 4, N] int32; qp: dict of (q, iq, bias, sharpen)
    with [16, 1|N] rows. Returns (lv [16, 16, N], y2lv [16, N],
    recon [16, 4, 4, N])."""
    coeffs = fdct4x4_p(src_b, pred_b)
    N = coeffs.shape[-1]
    flat = coeffs.reshape(16, 16, N)
    wht = fwht4x4_p(flat[:, 0].reshape(4, 4, N))
    y2lv, y2dq = quantize_p(wht.reshape(16, N), *qp["y2"])
    rec_dc = wht4x4_p(y2dq.reshape(4, 4, N)).reshape(16, N)
    lv, dq = quantize_p(flat, *qp["y1"], first=1, rd_drop=rd_drop)
    dq = dq.clone()
    dq[:, 0] = rec_dc
    recon = (pred_b + idct4x4_p(dq.reshape(coeffs.shape))).clamp(0, 255)
    return lv, y2lv, recon


def chroma_pipe_p(src_b, pred_b, qp):
    """[4, 4, 4, N] blocks -> (lv [4, 16, N], recon [4, 4, 4, N])."""
    co = fdct4x4_p(src_b, pred_b)
    flat = co.reshape(4, 16, co.shape[-1])
    lv, dq = quantize_p(flat, *qp["uv"])
    recon = (pred_b + idct4x4_p(dq.reshape(co.shape))).clamp(0, 255)
    return lv, recon


# Anti-diagonal subblock schedule of the I4 walk: (r, c) at substep
# c + 2r; deps (r-1, c), (r, c-1) and (r-1, c+1) are earlier groups.
I4_GROUPS = [[(0, 0)], [(0, 1)], [(0, 2), (1, 0)], [(0, 3), (1, 1)],
             [(1, 2), (2, 0)], [(1, 3), (2, 1)], [(2, 2), (3, 0)],
             [(2, 3), (3, 1)], [(3, 2)], [(3, 3)]]


def i4_reconstruct_p(src_b, modes, topY, leftY, tlY, trs, has_top, has_left,
                     qp_y1, rd_drop: float = 0.0):
    """Planar closed-loop I4 walk with fixed modes.

    src_b: [16, 4, 4, N] int32 raster subblocks; modes: [16, N];
    topY/leftY: [16, N]; tlY: [N]; trs: [4, N]; has_*: [N] bool;
    qp_y1: (q, iq, bias, sharpen) [16, 1|N].
    Returns (lv [16, 16, N] zigzag, recon plane [16, 16, N])."""
    N = src_b.shape[-1]
    top_row = torch.where(has_top[None, :], topY, 127)
    left_col = torch.where(has_left[None, :], leftY, 129)
    tl0 = torch.where(has_top & has_left, tlY, _corner_fill(has_top))
    tr_strip = torch.where(has_top[None, :], trs, 127)

    def ctx_of(work, r, c):
        t = top_row[c * 4:c * 4 + 4] if r == 0 \
            else work[r * 4 - 1, c * 4:c * 4 + 4]
        l = left_col[r * 4:r * 4 + 4] if c == 0 \
            else work[r * 4:r * 4 + 4, c * 4 - 1]
        if r == 0 and c == 0:
            tl = tl0
        elif r == 0:
            tl = top_row[c * 4 - 1]
        elif c == 0:
            tl = left_col[r * 4 - 1]
        else:
            tl = work[r * 4 - 1, c * 4 - 1]
        if c == 3:
            tr = tr_strip
        elif r == 0:
            tr = top_row[c * 4 + 4:c * 4 + 8]
        else:
            tr = work[r * 4 - 1, c * 4 + 4:c * 4 + 8]
        return t, l, tl, tr

    work = torch.zeros((16, 16, N), dtype=torch.int32, device=src_b.device)
    lv_by_n = [None] * 16
    for group in I4_GROUPS:
        g = len(group)
        ctxs = [ctx_of(work, r, c) for (r, c) in group]
        t = torch.stack([cx[0] for cx in ctxs], dim=0)        # [g, 4, N]
        l = torch.stack([cx[1] for cx in ctxs], dim=0)
        tl = torch.stack([cx[2] for cx in ctxs], dim=0)       # [g, N]
        tr = torch.stack([cx[3] for cx in ctxs], dim=0)
        preds = pred4_all_p(t, l, tl, tr)                     # 10 x [g,4,4,N]
        src = torch.stack([src_b[r * 4 + c] for (r, c) in group], dim=0)
        mode = torch.stack([modes[r * 4 + c] for (r, c) in group],
                           dim=0).to(torch.int32)[:, None, None, :]
        pred = preds[0]
        for m in range(1, 10):
            pred = torch.where(mode == m, preds[m], pred)
        co = fdct4x4_p(src, pred).reshape(g, 16, N)
        lv, dq = quantize_p(co, *qp_y1, rd_drop=rd_drop * 3.5)
        rec = (pred + idct4x4_p(dq.reshape(g, 4, 4, N))).clamp(0, 255)
        for i, (r, c) in enumerate(group):
            lv_by_n[r * 4 + c] = lv[i]
            work[r * 4:r * 4 + 4, c * 4:c * 4 + 4] = rec[i]
    return torch.stack(lv_by_n, dim=0), work


# ---------------------------------------------------------------------------
# Batched planar phase 2.
# ---------------------------------------------------------------------------

def _skew_b(a, mb_w, mb_h, n_steps, sk):
    """[B, mb_h, mb_w, K...] -> [n_steps, K..., B * mb_h] via the pad +
    reshape shear (step t, lane (b, y) holds MB x = t - sk*y)."""
    B = a.shape[0]
    tail = tuple(a.shape[3:])
    P = n_steps + sk
    pad = torch.zeros((B, mb_h, P - mb_w) + tail, dtype=a.dtype,
                      device=a.device)
    b = torch.cat([a, pad], dim=2)
    flat = b.reshape(B, mb_h * P, *tail)[:, : mb_h * n_steps]
    c = flat.reshape(B, mb_h, n_steps, *tail)
    nk = len(tail)
    perm = (2,) + tuple(range(3, 3 + nk)) + (0, 1)
    return c.permute(perm).reshape(n_steps, *tail, B * mb_h)


def _unskew_b(c_sk, B, mb_w, mb_h, n_steps, sk):
    """[n_steps, K..., N] -> [B, mb_h * mb_w, K...] (inverse shear)."""
    tail = tuple(c_sk.shape[1:-1])
    nk = len(tail)
    c = c_sk.reshape(n_steps, *tail, B, mb_h)
    perm = (1 + nk, 2 + nk, 0) + tuple(range(1, 1 + nk))
    c = c.permute(perm)                           # [B, mb_h, T, K...]
    flat = c.reshape(B, mb_h * n_steps, *tail)
    pad = torch.zeros((B, mb_h * sk) + tail, dtype=c_sk.dtype,
                      device=c_sk.device)
    flat = torch.cat([flat, pad], dim=1)
    out = flat.reshape(B, mb_h, n_steps + sk, *tail)[:, :, :mb_w]
    return out.reshape(B, mb_h * mb_w, *tail)


def _mb_planar(plane, mb_h, mb_w, s):
    """[B, H, W] -> [B, mb_h, mb_w, (s/4)^2 * 16], block-major pixel
    index (block raster b = br*(s/4)+bc, pixel p = r*4+c)."""
    B = plane.shape[0]
    nb = s // 4
    g = plane.reshape(B, mb_h, nb, 4, mb_w, nb, 4)
    g = g.permute(0, 1, 4, 2, 5, 3, 6)          # [B, mbh, mbw, br, bc, r, c]
    return g.reshape(B, mb_h, mb_w, nb * nb * 16)


def _shift1_p(a):
    """Planar lane shift: a[..., l] <- a[..., l-1] (lane 0 zeros). Lanes
    fuse batch x mb_h; the value leaked across an image boundary lands on
    a y == 0 lane whose has_top is False, so every consumer masks it."""
    out = torch.zeros_like(a)
    out[..., 1:] = a[..., :-1]
    return out


def _seg_rows_planar(seg_rows_k, B, mb_h):
    """[B, 4segs, 4param, 16] -> [4segs, 4param, 16, N] lane-broadcast."""
    N = B * mb_h
    r = seg_rows_k.permute(1, 2, 3, 0)            # [4, 4, 16, B]
    r = r[..., None].expand(*r.shape, mb_h)
    return r.reshape(4, 4, 16, N)


def _seg_select_p(rows4, seg):
    """rows4 [4, ...par..., N], seg [N] -> [...par..., N]."""
    return torch.where(seg == 0, rows4[0],
                       torch.where(seg == 1, rows4[1],
                                   torch.where(seg == 2, rows4[2], rows4[3])))


def phase2_planar(Y, U, V, modes, uvmodes, qp, mb_w, mb_h, rd_drop=0.0,
                  seg=None, i4=None, sk=1, trellis=False, i4_search=None,
                  wire_pack=None):
    """Batched closed-loop reconstruction wavefront (skew 1).

    Y/U/V: [B, H, W] uint8; modes/uvmodes: [B, n_mb];
    seg: (seg_map [B, n_mb], seg_rows {y1/y2/uv: [B, 4, 4, 16]});
    i4: (is_i4 [B, n_mb] bool, i4_modes [B, n_mb, 16] u8).
    Returns (lv24 [B, n_mb, 24, 16] i16, y2 [B, n_mb, 16] i16,
    bottom [B, n_mb, 16], right [B, n_mb, 16]).

    Only the main path's configuration is ported (sk=1, no trellis, no
    in-loop search, no wire packing, segments and I4 on); `qp` is unused
    there. The other configurations raise NotImplementedError.
    """
    if sk != 1 or trellis or i4_search is not None or wire_pack is not None:
        raise NotImplementedError(
            "phase2_planar: only sk=1 without trellis, in-loop search or "
            "wire packing is ported")
    if seg is None or i4 is None:
        raise NotImplementedError(
            "phase2_planar: only the segmented I4 configuration is ported")
    dev = Y.device
    B = Y.shape[0]
    N = B * mb_h
    n_steps = mb_w + sk * (mb_h - 1)
    yy = torch.arange(mb_h, dtype=torch.int32, device=dev).repeat(B)

    def skew(a):
        return _skew_b(a, mb_w, mb_h, n_steps, sk)

    xs_y = skew(_mb_planar(Y.to(torch.uint8), mb_h, mb_w, 16))   # [T,256,N]
    xs_u = skew(_mb_planar(U.to(torch.uint8), mb_h, mb_w, 8))
    xs_v = skew(_mb_planar(V.to(torch.uint8), mb_h, mb_w, 8))
    xs_m = skew(modes.reshape(B, mb_h, mb_w))
    xs_uvm = skew(uvmodes.reshape(B, mb_h, mb_w))
    seg_map, seg_rows = seg
    xs_seg = skew(seg_map.reshape(B, mb_h, mb_w).to(torch.int32))
    rows4 = {k: _seg_rows_planar(seg_rows[k].to(torch.int32), B, mb_h)
             for k in ("y1", "y2", "uv")}
    xs_i4 = skew(i4[0].reshape(B, mb_h, mb_w))
    xs_i4m = skew(i4[1].reshape(B, mb_h, mb_w, 16))

    def sel_mode(preds, mode):
        """preds [4, s, s, N]; mode [N] -> [s, s, N]."""
        m = mode.to(torch.int32)[None, None, :]
        return torch.where(
            m == 0, preds[0],
            torch.where(m == 1, preds[1],
                        torch.where(m == 2, preds[2], preds[3])))

    z16 = torch.zeros((16, N), dtype=torch.int32, device=dev)
    z8 = torch.zeros((8, N), dtype=torch.int32, device=dev)
    z1 = torch.zeros((N,), dtype=torch.int32, device=dev)
    By1, Ry, Cy1, Cy2 = z16, z16, z1, z1
    Bu1, Ru, Cu1, Cu2 = z8, z8, z1, z1
    Bv1, Rv, Cv1, Cv2 = z8, z8, z1, z1
    lv_out = torch.empty((n_steps, 24, 16, N), dtype=torch.int16, device=dev)
    y2_out = torch.empty((n_steps, 16, N), dtype=torch.int16, device=dev)
    bot_out = torch.empty((n_steps, 16, N), dtype=torch.int32, device=dev)
    rgt_out = torch.empty((n_steps, 16, N), dtype=torch.int32, device=dev)
    for t in range(n_steps):
        xcol = t - sk * yy
        valid = (xcol >= 0) & (xcol < mb_w)
        has_left = valid & (xcol > 0)
        has_top = valid & (yy > 0)
        st = xs_seg[t]
        qp_t = {k: tuple(_seg_select_p(rows4[k][:, i], st) for i in range(4))
                for k in ("y1", "y2", "uv")}

        topY = _shift1_p(By1)
        leftY, tlY = Ry, _shift1_p(Cy2)
        predsY = preds4_p(16, topY, leftY, tlY, has_top, has_left)
        predY_b = plane_to_blocks_p(sel_mode(predsY, xs_m[t]), 16)
        src_y = xs_y[t].to(torch.int32).reshape(16, 4, 4, N)
        lv, y2lv, reconY = luma_pipe_p(src_y, predY_b, qp_t, rd_drop=rd_drop)
        rYp = blocks_to_plane_p(reconY, 16)
        # Above-right placeholder: at skew 1 the rightmost subblock column
        # never selects a strip-reading mode (TR_MODES are banned there).
        trs = topY[15:16].expand(4, N)
        lv_i4, work = i4_reconstruct_p(
            src_y, xs_i4m[t], topY, leftY, tlY, trs, has_top, has_left,
            qp_t["y1"], rd_drop=rd_drop)
        ii_mb = xs_i4[t]
        sel = ii_mb[None, None, :]
        lv = torch.where(sel, lv_i4, lv)
        y2lv = torch.where(ii_mb[None, :], 0, y2lv)
        rYp = torch.where(sel, work, rYp)

        topU = _shift1_p(Bu1)
        leftU, tlU = Ru, _shift1_p(Cu2)
        topV = _shift1_p(Bv1)
        leftV, tlV = Rv, _shift1_p(Cv2)
        predsU = preds4_p(8, topU, leftU, tlU, has_top, has_left)
        predsV = preds4_p(8, topV, leftV, tlV, has_top, has_left)
        src_u = xs_u[t].to(torch.int32).reshape(4, 4, 4, N)
        src_v = xs_v[t].to(torch.int32).reshape(4, 4, 4, N)
        lvu, reconU = chroma_pipe_p(
            src_u, plane_to_blocks_p(sel_mode(predsU, xs_uvm[t]), 8), qp_t)
        lvv, reconV = chroma_pipe_p(
            src_v, plane_to_blocks_p(sel_mode(predsV, xs_uvm[t]), 8), qp_t)
        rU = blocks_to_plane_p(reconU, 8)
        rV = blocks_to_plane_p(reconV, 8)
        # Carries: bottom rows and right columns from step t-1, corners
        # from t-1 and t-2 (skew 1 needs no older history).
        By1, Ry, Cy2, Cy1 = rYp[15], rYp[:, 15], Cy1, rYp[15, 15]
        Bu1, Ru, Cu2, Cu1 = rU[7], rU[:, 7], Cu1, rU[7, 7]
        Bv1, Rv, Cv2, Cv1 = rV[7], rV[:, 7], Cv1, rV[7, 7]
        lv_out[t, :16] = lv
        lv_out[t, 16:20] = lvu
        lv_out[t, 20:] = lvv
        y2_out[t] = y2lv
        bot_out[t] = rYp[15]
        rgt_out[t] = rYp[:, 15]

    def unskew(c_sk):
        return _unskew_b(c_sk, B, mb_w, mb_h, n_steps, sk)

    return unskew(lv_out), unskew(y2_out), unskew(bot_out), unskew(rgt_out)
