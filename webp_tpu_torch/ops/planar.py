"""Planar (lanes-minor) DSP and the phase-2 closed-loop wavefront.

Counterpart of webp_tpu/ops/planar.py. Every tensor keeps its lane axis
(batch x macroblock, N lanes) last; pixel and coefficient indices live on
the leading axes, so every butterfly, zigzag or context slice is a slice
of a leading axis. The integer math is the reference's, op for op.

phase2_planar is the closed-loop wavefront written as a Python step loop
over the anti-diagonals (the reference's lax.scan). At skew 1 without
trellis or in-loop search it is the plain version of kernel 4
(ops/p2_kernel.py), which runs that wavefront on the card; at skew 2
with the trellis (method 5) and the in-loop I4/UV search (method 6) it
is the device program's phase 2 itself, as the reference routes it.
The exact chained rates (exact_rate_p, luma_rate16_p, uv_rate4_p) serve
that search.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from .. import trace
from ..lossy import tables as T
from ..lossy.encode import FIXED_COSTS_I16 as FC16
from ..lossy.encode import FIXED_COSTS_UV as FCUV
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


def first_min(x):
    """(values, indices) of the minimum over axis 0, the first index on
    ties: the winner of the reference's walks that keep a candidate only
    when it is strictly smaller. One reduction (torch.min) on the card,
    where each extra operation is an extra kernel in the step's graph; a
    chain of selects (min_chain) on the CPU, where PyTorch's min over a
    short axis stalls in its thread pool while other processes keep the
    cores busy, as a parallel test run does. tools/first_min_cost.py
    times both forms on either device."""
    if x.device.type != "cpu":
        return torch.min(x, dim=0)
    return min_chain(x)


def min_chain(x):
    """first_min as len(x) - 1 strict-less selects."""
    v = x[0]
    j = torch.zeros(v.shape, dtype=torch.long, device=x.device)
    for i in range(1, x.shape[0]):
        take = x[i] < v
        v = torch.where(take, x[i], v)
        j = torch.where(take, i, j)
    return v, j


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


# ---------------------------------------------------------------------------
# Exact chained rates (the in-loop search of method 6).
# ---------------------------------------------------------------------------

def _exact_rate_tables():
    """Static tables for exact_rate_p, built once from the default probas
    (the same source as the host cost tables, lossy/cost.py): the
    per-position level cost G [4, 16*3*68], the EOB bit at position n and
    at n+1 [4, 16, 3], the not-EOB bit at ctx 0 [4, 16] and the fixed
    level costs."""
    from ..lossy.cost import (ENTROPY_COST, LEVEL_FIXED_COSTS,
                              compute_level_cost_tables)

    proba = np.asarray(T.COEFFS_PROBA0)
    ct = compute_level_cost_tables(proba)                  # [4, 8, 3, 68]
    bands = np.asarray(T.BANDS[:16])
    g = ct[:, bands].reshape(4, 16 * 3 * 68).astype(np.int32)
    p0 = proba[..., 0].astype(np.int64)                    # [4, 8, 3]
    ec = np.asarray(ENTROPY_COST, np.int64)
    eob0 = ec[p0][:, bands].astype(np.int32)               # [4,16,3] bit0 @ n
    bands_next = np.asarray(T.BANDS[1:17])[:16]
    eob_next = ec[p0][:, bands_next].astype(np.int32)      # [4,16,3]
    first_bit = ec[255 - p0][:, bands, 0].astype(np.int32)  # [4,16] bit1@ctx0
    lf = np.asarray(LEVEL_FIXED_COSTS, np.int32)
    return g, eob0, eob_next, first_bit, lf


@functools.lru_cache(maxsize=8)
def _ert_on(device: str):
    return tuple(torch.as_tensor(a, device=device)
                 for a in _exact_rate_tables())


def exact_rate_p(levels, first: int, pt: int, ctx0):
    """Exact residual rate of zigzag level blocks at the default probas
    (the host's residual cost). levels: [..., 16, N] int; ctx0:
    broadcastable [..., N] int in {0, 1, 2}. Returns int32 [..., N].

    The context chain is not recursive (ctx_n = min(|lv[n-1]|, 2)), so the
    whole cost is one gather from a static [16*204] table per position
    plus elementwise masks."""
    dev = levels.device
    g, eob0, eob_next, first_bit, lf = _ert_on(str(dev))
    v = levels.to(torch.int32).abs()                       # [..., 16, N]
    pos = torch.arange(16, device=dev)[:, None]
    nzv = (v != 0) & (pos >= first)
    has = nzv.any(dim=-2)                                  # [..., N]
    last = torch.where(has, torch.where(nzv, pos, -1).amax(dim=-2), first)
    vv = v.clamp(max=67)
    vf = v.clamp(max=2047)
    ctx0 = torch.as_tensor(ctx0, device=dev).to(torch.int64)
    ctx = torch.roll(v, 1, dims=-2).clamp(max=2).to(torch.int64)
    ctx = ctx.clone()
    ctx[..., first, :] = ctx0.expand(ctx.shape[:-2] + ctx.shape[-1:])
    idx = pos * 204 + ctx * 68 + vv
    cost_n = g[pt][idx] + lf[vf.long()]                    # [..., 16, N]
    in_run = (pos >= first) & (pos <= last[..., None, :])
    total = torch.where(in_run, cost_n, 0).sum(dim=-2, dtype=torch.int32)
    # Trailing not-EOB -> EOB bit at band(last+1), ctx from the last level.
    v_last = torch.gather(v, -2, last[..., None, :].long())[..., 0, :]
    eob_ctx = torch.where(v_last == 1, 1, 2)
    eob_term = torch.where(last < 15,
                           eob_next[pt][last.clamp(max=15).long(), eob_ctx],
                           0)
    fb = torch.where(ctx0 == 0, first_bit[pt, first], 0)
    empty = eob0[pt, first][ctx0]
    return torch.where(has, fb + total + eob_term, empty).to(torch.int32)


def luma_rate16_p(lv, tnz, lnz):
    """Exact I16 luma AC rate with the intra-MB nonzero chain (the host's
    LumaRate): lv [16, 16, N] zigzag (first=1, pt=0), tnz/lnz [N] 4-bit
    masks from the above/left MBs."""
    nz = (lv[:, 1:] != 0).any(dim=1)                       # [16, N] bool
    rate = torch.zeros(lv.shape[-1:], dtype=torch.int32, device=lv.device)
    t = [(tnz >> c) & 1 for c in range(4)]
    l = [(lnz >> r) & 1 for r in range(4)]
    for r in range(4):
        for c in range(4):
            bi = r * 4 + c
            rate = rate + exact_rate_p(lv[bi], 1, 0, t[c] + l[r])
            b = nz[bi].to(torch.int32)
            t[c] = b
            l[r] = b
    return rate


def uv_rate4_p(lv, tnz, lnz):
    """Exact one-plane chroma rate with the intra-MB nonzero chain (the
    host's UVRate): lv [4, 16, N] zigzag (first=0, pt=2), tnz/lnz [N]
    2-bit masks from the above/left MBs. Returns (rate [N] i32, t2 [N],
    l2 [N]), t2/l2 the outgoing 2-bit chains (bottom-row / right-column
    block nonzeros)."""
    nz = (lv != 0).any(dim=1)                              # [4, N] bool
    t = [(tnz >> c) & 1 for c in range(2)]
    l = [(lnz >> r) & 1 for r in range(2)]
    rate = torch.zeros(lv.shape[-1:], dtype=torch.int32, device=lv.device)
    for r in range(2):
        for c in range(2):
            bi = r * 2 + c
            rate = rate + exact_rate_p(lv[bi], 0, 2, t[c] + l[r])
            b = nz[bi].to(torch.int32)
            t[c] = b
            l[r] = b
    return rate, t[0] | (t[1] << 1), l[0] | (l[1] << 1)


# Anti-diagonal subblock schedule of the I4 walk: (r, c) at substep
# c + 2r; deps (r-1, c), (r, c-1) and (r-1, c+1) are earlier groups.
I4_GROUPS = [[(0, 0)], [(0, 1)], [(0, 2), (1, 0)], [(0, 3), (1, 1)],
             [(1, 2), (2, 0)], [(1, 3), (2, 1)], [(2, 2), (3, 0)],
             [(2, 3), (3, 1)], [(3, 2)], [(3, 3)]]


@functools.lru_cache(maxsize=8)
def _i4_hdr_costs(device: str):
    from ..lossy.cost import FIXED_COSTS_I4

    return torch.as_tensor(np.asarray(FIXED_COSTS_I4, np.int32).reshape(-1),
                           device=device)


def i4_reconstruct_p(src_b, modes, topY, leftY, tlY, trs, has_top, has_left,
                     qp_y1, rd_drop: float = 0.0, trellis=False, tlam=None,
                     tnz=None, lnz=None, search=False, lam=None, tbm=None,
                     lbm=None):
    """Planar closed-loop I4 walk.

    src_b: [16, 4, 4, N] int32 raster subblocks; modes: [16, N];
    topY/leftY: [16, N]; tlY: [N]; trs: [4, N] above-right strip; has_*:
    [N] bool; qp_y1: (q, iq, bias, sharpen) [16, 1|N].
    trellis: each subblock's levels come from the trellis
    (ops/trellis.py) at lambda tlam [1|N] against the live nonzero
    context; tnz/lnz [N] are the 4-bit nonzero masks of the above/left
    MB's border subblocks (already masked by has_top/has_left).
    search: the walk re-runs the 10-mode RD search per subblock against
    the true reconstructed context (the host's closed-loop
    PickBestIntra4): exact chained rates plus the contextual mode cost
    (tbm/lbm [4, N] the above/left MBs' border modes, None for DC) at
    lambda lam [1|N], pixel SSE x 256; `modes` is ignored. It needs the
    real above-right strip (skew 2).
    Returns (lv [16, 16, N] zigzag, recon plane [16, 16, N], t4 [N],
    l4 [N] (this MB's bottom-row/right-column nonzero masks; zero without
    the trellis), modes_out [16, N] u8, (top modes, left modes) [4, N]
    and (rate sum, SSE sum) [N] of the chosen modes, both None without
    the search)."""
    N = src_b.shape[-1]
    dev = src_b.device
    z = torch.zeros((N,), dtype=torch.int32, device=dev)
    if trellis:
        from .trellis import trellis_p

        t4 = tnz if tnz is not None else z
        l4 = lnz if lnz is not None else z
    else:
        t4 = l4 = z
    if search:
        hdr_tab = _i4_hdr_costs(str(dev))
        tmv = [tbm[c] if tbm is not None else z for c in range(4)]
        lmv = [lbm[r] if lbm is not None else z for r in range(4)]
        rd_rate = z
        rd_disto = z
        ar10 = torch.arange(10, device=dev)
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

    work = torch.zeros((16, 16, N), dtype=torch.int32, device=dev)
    lv_by_n = [None] * 16
    mode_by_n = [None] * 16
    for group in I4_GROUPS:
        g = len(group)
        ctxs = [ctx_of(work, r, c) for (r, c) in group]
        t = torch.stack([cx[0] for cx in ctxs], dim=0)        # [g, 4, N]
        l = torch.stack([cx[1] for cx in ctxs], dim=0)
        tl = torch.stack([cx[2] for cx in ctxs], dim=0)       # [g, N]
        tr = torch.stack([cx[3] for cx in ctxs], dim=0)
        preds = pred4_all_p(t, l, tl, tr)                     # 10 x [g,4,4,N]
        src = torch.stack([src_b[r * 4 + c] for (r, c) in group], dim=0)
        if search:
            pall = torch.stack(preds, dim=0)                  # [10,g,4,4,N]
            co_all = fdct4x4_p(src.expand(pall.shape), pall)
            lv_s, dq_s = quantize_p(co_all.reshape(10, g, 16, N), *qp_y1)
            rec_s = (pall + idct4x4_p(dq_s.reshape(10, g, 4, 4, N))) \
                .clamp(0, 255)
            disto = ((src[None] - rec_s) ** 2).sum(dim=(-3, -2),
                                                    dtype=torch.int32)
            tmode = torch.stack([tmv[c] for (_, c) in group], dim=0)
            lmode = torch.stack([lmv[r] for (r, _) in group], dim=0)
            idx10 = ((tmode * 10 + lmode) * 10)[None] \
                + ar10.reshape(10, 1, 1)                      # [10, g, N]
            hdr = hdr_tab[idx10.long()]
            # Exact chained rates against the live nonzero context (t4/l4
            # before this group's update).
            ctx0_g = torch.stack([((l4 >> r) & 1) + ((t4 >> c) & 1)
                                  for (r, c) in group], dim=0)   # [g, N]
            rate = exact_rate_p(lv_s, 0, 3, ctx0_g) + hdr
            score = (rate.to(torch.float32) * lam
                     + 256.0 * disto.to(torch.float32))
            mode_sel = first_min(score)[1]                    # [g, N]
            msk = ar10.reshape(10, 1, 1) == mode_sel[None]
            rd_rate = rd_rate + torch.where(msk, rate, 0).sum(
                dim=(0, 1), dtype=torch.int32)
            rd_disto = rd_disto + torch.where(msk, disto, 0).sum(
                dim=(0, 1), dtype=torch.int32)
            mode_sel = mode_sel.to(torch.int32)
            for i, (r, c) in enumerate(group):
                tmv[c] = mode_sel[i]
                lmv[r] = mode_sel[i]
            sel4 = mode_sel[None, :, None, None, :].long()
            pred = torch.gather(pall, 0, sel4.expand((1,) + pall.shape[1:]))[0]
            co_f = co_all.reshape(10, g, 16, N)
            co = torch.gather(co_f, 0, mode_sel[None, :, None, :].long()
                              .expand((1, g, 16, N)))[0]
            mode_grp = mode_sel
        else:
            mode = torch.stack([modes[r * 4 + c] for (r, c) in group],
                               dim=0).to(torch.int32)[:, None, None, :]
            pred = preds[0]
            for m in range(1, 10):
                pred = torch.where(mode == m, preds[m], pred)
            co = fdct4x4_p(src, pred).reshape(g, 16, N)
            mode_grp = mode[:, 0, 0, :]
        if trellis:
            ctx0 = torch.stack([((l4 >> r) & 1) + ((t4 >> c) & 1)
                                for (r, c) in group], dim=0)  # [g, N]
            q, iq, _, sharpen = qp_y1
            lv, dq = trellis_p(co, q, iq, sharpen, tlam, ctx0)
            nzb = (lv != 0).any(dim=1).to(torch.int32)        # [g, N]
            for i, (r, c) in enumerate(group):
                t4 = (t4 & ~(1 << c)) | (nzb[i] << c)
                l4 = (l4 & ~(1 << r)) | (nzb[i] << r)
        else:
            lv, dq = quantize_p(co, *qp_y1, rd_drop=rd_drop * 3.5)
        rec = (pred + idct4x4_p(dq.reshape(g, 4, 4, N))).clamp(0, 255)
        for i, (r, c) in enumerate(group):
            lv_by_n[r * 4 + c] = lv[i]
            mode_by_n[r * 4 + c] = mode_grp[i]
            work[r * 4:r * 4 + 4, c * 4:c * 4 + 4] = rec[i]
    if search:
        bm_out = (torch.stack(tmv, dim=0), torch.stack(lmv, dim=0))
        rd_out = (rd_rate, rd_disto)
    else:
        bm_out = rd_out = (None, None)
    return (torch.stack(lv_by_n, dim=0), work, t4, l4,
            torch.stack(mode_by_n, dim=0).to(torch.uint8), bm_out, rd_out)


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


def _lane_lam(lam_b, B, mb_h):
    """Per-image [B, 4] segment lambdas -> lane-broadcast [4, B * mb_h]."""
    lam = torch.as_tensor(lam_b, dtype=torch.float32)
    return lam.T[:, :, None].expand(4, B, mb_h).reshape(4, B * mb_h)


def phase2_planar(Y, U, V, modes, uvmodes, qp, mb_w, mb_h, rd_drop=0.0,
                  seg=None, i4=None, sk=1, trellis=False, i4_search=None,
                  wire_pack=None, graph=False, halos=None, has_above=False):
    """Batched closed-loop reconstruction wavefront, a Python step loop
    over the n_steps = mb_w + sk * (mb_h - 1) anti-diagonals (step t,
    lane (b, y) holds MB x = t - sk * y).

    Y/U/V: [B, H, W] uint8; modes/uvmodes: [B, n_mb];
    qp: quant_params() dict ({y1/y2/uv: 4 x [16]}) when seg is None;
    seg: (seg_map [B, n_mb], seg_rows {y1/y2/uv: [B, 4, 4, 16]}) or None;
    i4: (is_i4 [B, n_mb] bool, i4_modes [B, n_mb, 16] u8) or None (every
    MB I16).
    sk: 1 (the main path) or 2, at which an MB's above-right neighbour is
    reconstructed one step before it, so the I4 walk reads the real
    above-right strip.
    trellis: the I4 subblocks' levels come from the trellis
    (ops/trellis.py); three nonzero-context masks join the carry so its
    rates see the true neighbour contexts.
    i4_search: (rt, lam_i4, lam_i16, lam_uv, lam_mode), python scalars
    (unsegmented) or [B, 4] per-segment lambdas: the I4 walk re-runs the
    10-mode search per subblock against the true context, the I16-vs-I4
    split is taken in the loop on exact rates (both at lam_mode), and the
    4-mode UV search runs in the loop on exact chained chroma rates
    (without lam_uv, 3 elements, it does not); the phase-1 I4 modes,
    split and UV modes are then ignored. Needs sk=2. (rt and lam_i16 keep
    the reference's tuple layout; the exact rates need neither.)
    graph (CUDA tensors only): the first step runs as it is; the next is
    captured once in a CUDA graph (torch.cuda.CUDAGraph) and the graph
    replayed for every further step. The step reads its inputs and writes
    its outputs and carry through static buffers indexed by a step
    counter on the device, so the graph issues the same operations as
    the loop, without the host's cost of launching each of them.
    halos: (hy [B, W], hu [B, W/2], hv [B, W/2]) pixel rows above each
    image's first MB row (a row band of a larger image, ops/fastpath.py
    encode_band and parallel/): with has_above True the first MB row
    predicts from them (its top row and top-left corners) instead of the
    127/129 edge fills; skew 1 only, as the reference's _phase2.
    Returns (lv24 [B, n_mb, 24, 16] i16, y2 [B, n_mb, 16] i16,
    bottom [B, n_mb, 16], right [B, n_mb, 16][, i4_modes [B, n_mb, 16]
    u8, is_i4 [B, n_mb] bool with i4_search][, uvmodes [B, n_mb] u8 with
    its UV search], bottom_u [B, n_mb, 8], bottom_v [B, n_mb, 8]): the
    bottom rows and right columns are the reconstruction's.

    The reference's wire_pack (packing in the skewed layout) is not
    ported and raises NotImplementedError.
    """
    if wire_pack is not None:
        raise NotImplementedError(
            "phase2_planar: wire_pack (packing in the skewed layout) is not "
            "ported; the levels are packed after the unskew "
            "(fastpath._pack_levels)")
    if halos is not None and sk != 1:
        raise ValueError("phase2_planar: halos need skew 1 (the above-right "
                         "strip of a band's first row is not carried)")
    dev = Y.device
    B = Y.shape[0]
    N = B * mb_h
    n_steps = mb_w + sk * (mb_h - 1)
    if i4 is None:
        i4_search = None
    yy = torch.arange(mb_h, dtype=torch.int32, device=dev).repeat(B)
    above = halos is not None and bool(has_above)
    lane0 = yy == 0

    def skew(a):
        return _skew_b(a, mb_w, mb_h, n_steps, sk)

    xs = {"y": skew(_mb_planar(Y.to(torch.uint8), mb_h, mb_w, 16)),
          "u": skew(_mb_planar(U.to(torch.uint8), mb_h, mb_w, 8)),
          "v": skew(_mb_planar(V.to(torch.uint8), mb_h, mb_w, 8)),
          "m": skew(modes.reshape(B, mb_h, mb_w)),
          "uvm": skew(uvmodes.reshape(B, mb_h, mb_w))}
    if seg is not None:
        seg_map, seg_rows = seg
        xs["seg"] = skew(seg_map.reshape(B, mb_h, mb_w).to(torch.int32))
        rows4 = {k: _seg_rows_planar(seg_rows[k].to(torch.int32), B, mb_h)
                 for k in ("y1", "y2", "uv")}
    else:
        qp_p = {k: tuple(torch.as_tensor(a, dtype=torch.int32, device=dev)
                         .reshape(16, 1) for a in qp[k])
                for k in ("y1", "y2", "uv")}
    if i4 is not None:
        xs["i4"] = skew(i4[0].reshape(B, mb_h, mb_w))
        xs["i4m"] = skew(i4[1].reshape(B, mb_h, mb_w, 16))
    if above:
        # Step t's lane (b, 0) holds MB (t, 0): its top row is the halo's
        # segment t, its corner the halo pixel left of that segment.
        for p, h, s in (("y", halos[0], 16), ("u", halos[1], 8),
                        ("v", halos[2], 8)):
            h = h.to(dev, torch.int32).reshape(B, mb_w, s)
            top = torch.zeros((n_steps, s, B, mb_h), dtype=torch.int32,
                              device=dev)
            top[:mb_w, :, :, 0] = h.permute(1, 2, 0)
            corner = torch.zeros((n_steps, B, mb_h), dtype=torch.int32,
                                 device=dev)
            corner[1:mb_w, :, 0] = h[:, :-1, s - 1].T
            xs["h" + p] = top.reshape(n_steps, s, N)
            xs["ht" + p] = corner.reshape(n_steps, N)
    use_tr = trellis and i4 is not None
    search = i4_search is not None
    uv_search = search and len(i4_search) >= 4
    if search:
        lam_of = {}
        for key, pos in (("i4", 1), ("uv", 3), ("mode", 4)):
            if pos >= len(i4_search):
                continue
            v = i4_search[pos]
            lam_of[key] = (_lane_lam(v, B, mb_h).to(dev) if seg is not None
                           else torch.tensor(float(v), device=dev))
        lam_of.setdefault("mode", lam_of["i4"])

    def sel_mode(preds, mode):
        """preds [4, s, s, N]; mode [N] -> [s, s, N]."""
        m = mode.to(torch.int32)[None, None, :]
        return torch.where(
            m == 0, preds[0],
            torch.where(m == 1, preds[1],
                        torch.where(m == 2, preds[2], preds[3])))

    def lam_at(key, st):
        lam = lam_of[key]
        return _seg_select_p(lam, st) if seg is not None else lam

    def older(c, name):
        """The neighbour above's value of carry `name`: from step t-1 at
        skew 1, t-2 at skew 2 (lane-shifted down one MB row)."""
        return _shift1_p(c[name + ("2" if sk == 2 else "1")])

    def above_ctx(x, p, top, tl):
        """A band's first MB row takes its top row and corner from the
        halo."""
        if not above:
            return top, tl
        return (torch.where(lane0[None, :], x["h" + p], top),
                torch.where(lane0, x["ht" + p], tl))

    def step(xcol, x, c):
        """One anti-diagonal: carry c (dict) -> (new carry, outputs)."""
        valid = (xcol >= 0) & (xcol < mb_w)
        has_left = valid & (xcol > 0)
        has_top = valid & ((yy > 0) | lane0) if above else valid & (yy > 0)
        if seg is not None:
            st = x["seg"]
            qp_t = {k: tuple(_seg_select_p(rows4[k][:, i], st)
                             for i in range(4)) for k in ("y1", "y2", "uv")}
        else:
            st = None
            qp_t = qp_p

        topY, tlY = above_ctx(x, "y", older(c, "By"),
                              _shift1_p(c["Cy3" if sk == 2 else "Cy2"]))
        leftY = c["Ry"]
        predsY = preds4_p(16, topY, leftY, tlY, has_top, has_left)
        predY_b = plane_to_blocks_p(sel_mode(predsY, x["m"]), 16)
        src_y = x["y"].to(torch.int32).reshape(16, 4, 4, N)
        lv, y2lv, reconY = luma_pipe_p(src_y, predY_b, qp_t, rd_drop=rd_drop)
        rYp = blocks_to_plane_p(reconY, 16)
        new, ys_extra = {}, []
        if i4 is not None:
            if sk == 2:
                # The above-right MB was reconstructed one step ago; past
                # the last column the strip repeats the top row's last
                # pixel.
                trs = _shift1_p(c["By1"])[0:4]
                edge = topY[15:16].expand(4, N)
                trs = torch.where((xcol + 1 >= mb_w)[None, :], edge, trs)
            else:
                # At skew 1 the rightmost subblock column never selects a
                # strip-reading mode (the I4 search bans them there).
                trs = topY[15:16].expand(4, N)
            kw = {}
            if search:
                kw = dict(search=True, lam=lam_at("i4", st),
                          tbm=torch.where(has_top, older(c, "Bm"), 0),
                          lbm=torch.where(has_left, c["Bml"], 0))
            if use_tr:
                from .trellis import tlam_i4

                tnz = torch.where(has_top, older(c, "Nt"), 0)
                lnz = torch.where(has_left, c["Nl"], 0)
                kw.update(trellis=True, tlam=tlam_i4(qp_t["y1"][0]),
                          tnz=tnz, lnz=lnz)
            else:
                kw.update(rd_drop=rd_drop)
            lv_i4, work, t4, l4, i4m_out, bm_out, rd4 = i4_reconstruct_p(
                src_y, x["i4m"], topY, leftY, tlY, trs, has_top, has_left,
                qp_t["y1"], **kw)
            if search:
                # The closed-loop I16-vs-I4 split: both reconstructions
                # are in hand, scored against the true context (exact I16
                # rate: the AC chain plus the y2 block under its carried
                # DC-nonzero context), both totals at lambda_mode.
                disto16 = ((reconY - src_y) ** 2).sum(dim=(0, 1, 2),
                                                      dtype=torch.int32)
                z1 = torch.zeros((N,), dtype=torch.int32, device=dev)
                tdc = torch.where(has_top, older(c, "Dt"), 0)
                ldc = torch.where(has_left, c["Dl"], 0)
                rate16 = (luma_rate16_p(lv, tnz if use_tr else z1,
                                        lnz if use_tr else z1)
                          + exact_rate_p(y2lv, 0, 1, tdc + ldc))
                m = x["m"].to(torch.int32)
                fc16 = torch.where(m == 0, int(FC16[0]),
                                   torch.where(m == 1, int(FC16[1]),
                                               torch.where(m == 2, int(FC16[2]),
                                                           int(FC16[3]))))
                lammd_t = lam_at("mode", st)
                score16 = ((rate16 + fc16).to(torch.float32) * lammd_t
                           + 256.0 * disto16.to(torch.float32))
                score4 = ((rd4[0] + 211).to(torch.float32) * lammd_t
                          + 256.0 * rd4[1].to(torch.float32))
                ii_mb = score4 < score16
            else:
                ii_mb = x["i4"]
            sel = ii_mb[None, None, :]
            lv = torch.where(sel, lv_i4, lv)
            y2lv = torch.where(ii_mb[None, :], 0, y2lv)
            rYp = torch.where(sel, work, rYp)
        else:
            ii_mb = torch.zeros((N,), dtype=torch.bool, device=dev)

        cU, cV = ("Cu3", "Cv3") if sk == 2 else ("Cu2", "Cv2")
        topU, tlU = above_ctx(x, "u", older(c, "Bu"), _shift1_p(c[cU]))
        topV, tlV = above_ctx(x, "v", older(c, "Bv"), _shift1_p(c[cV]))
        leftU, leftV = c["Ru"], c["Rv"]
        predsU = preds4_p(8, topU, leftU, tlU, has_top, has_left)
        predsV = preds4_p(8, topV, leftV, tlV, has_top, has_left)
        src_u = x["u"].to(torch.int32).reshape(4, 4, 4, N)
        src_v = x["v"].to(torch.int32).reshape(4, 4, 4, N)
        if uv_search:
            # The closed-loop 4-mode UV search with exact chained rates:
            # rate = FIXED_COSTS_UV[m] + UVRate(U) + UVRate(V), score =
            # rate * lambda_uv + 256 * SSE; the first strict minimum wins.
            lamuv_t = lam_at("uv", st)
            t2u = torch.where(has_top, older(c, "Ut"), 0)
            l2u = torch.where(has_left, c["Ul"], 0)
            t2v = torch.where(has_top, older(c, "Vt"), 0)
            l2v = torch.where(has_left, c["Vl"], 0)
            best, uvm_out = None, None
            for m in range(4):
                lvu_m, recU_m = chroma_pipe_p(
                    src_u, plane_to_blocks_p(predsU[m], 8), qp_t)
                lvv_m, recV_m = chroma_pipe_p(
                    src_v, plane_to_blocks_p(predsV[m], 8), qp_t)
                ru, t2u_m, l2u_m = uv_rate4_p(lvu_m, t2u, l2u)
                rv, t2v_m, l2v_m = uv_rate4_p(lvv_m, t2v, l2v)
                disto = (((recU_m - src_u) ** 2).sum(dim=(0, 1, 2),
                                                     dtype=torch.int32)
                         + ((recV_m - src_v) ** 2).sum(dim=(0, 1, 2),
                                                       dtype=torch.int32))
                score = ((ru + rv + int(FCUV[m])).to(torch.float32)
                         * lamuv_t + 256.0 * disto.to(torch.float32))
                cand = (score, lvu_m, lvv_m, recU_m, recV_m,
                        t2u_m, l2u_m, t2v_m, l2v_m)
                if best is None:
                    best = cand
                    uvm_out = torch.zeros((N,), dtype=torch.uint8,
                                          device=dev)
                    continue
                better = cand[0] < best[0]
                uvm_out = torch.where(better, m, uvm_out)
                best = tuple(torch.where(better, cn, b)
                             for b, cn in zip(best, cand))
            (_, lvu, lvv, reconU, reconV,
             ut2_new, ul2_new, vt2_new, vl2_new) = best
        else:
            lvu, reconU = chroma_pipe_p(
                src_u, plane_to_blocks_p(sel_mode(predsU, x["uvm"]), 8), qp_t)
            lvv, reconV = chroma_pipe_p(
                src_v, plane_to_blocks_p(sel_mode(predsV, x["uvm"]), 8), qp_t)
        rU = blocks_to_plane_p(reconU, 8)
        rV = blocks_to_plane_p(reconV, 8)

        # Carries: each "1" value is this step's, "2" the step before's
        # and "3" the one before that (bottom rows B, right columns R,
        # corners C, per plane).
        for p, rec, s in (("y", rYp, 15), ("u", rU, 7), ("v", rV, 7)):
            new["B" + p + "1"], new["B" + p + "2"] = rec[s], c["B" + p + "1"]
            new["R" + p] = rec[:, s]
            new["C" + p + "1"] = rec[s, s]
            new["C" + p + "2"] = c["C" + p + "1"]
            new["C" + p + "3"] = c["C" + p + "2"]
        if use_tr:
            # Border-subblock nonzero masks for the neighbour context
            # chain: I16 blocks count AC only, I4 the trellis masks.
            nz16 = (lv[:, 1:] != 0).any(dim=1).to(torch.int32)  # [16, N]
            t4_16 = (nz16[12] | (nz16[13] << 1) | (nz16[14] << 2)
                     | (nz16[15] << 3))
            l4_16 = (nz16[3] | (nz16[7] << 1) | (nz16[11] << 2)
                     | (nz16[15] << 3))
            new["Nt1"], new["Nt2"] = torch.where(ii_mb, t4, t4_16), c["Nt1"]
            new["Nl"] = torch.where(ii_mb, l4, l4_16)
        if search:
            # The y2 DC-nonzero chain: I16 MBs record any(y2), I4 MBs keep
            # the stale value (the host updates it only for I16 MBs).
            y2nz = (y2lv != 0).any(dim=0).to(torch.int32)
            new["Dt1"], new["Dt2"] = torch.where(ii_mb, tdc, y2nz), c["Dt1"]
            new["Dl"] = torch.where(ii_mb, ldc, y2nz)
            # The I4 mode context chain: I16 MBs pass on their mode value.
            m16 = x["m"].to(torch.int32)[None, :].expand(4, N)
            new["Bm1"] = torch.where(ii_mb, bm_out[0], m16)
            new["Bm2"] = c["Bm1"]
            new["Bml"] = torch.where(ii_mb, bm_out[1], m16)
            ys_extra += [i4m_out, ii_mb]
        if uv_search:
            new["Ut1"], new["Ut2"], new["Ul"] = ut2_new, c["Ut1"], ul2_new
            new["Vt1"], new["Vt2"], new["Vl"] = vt2_new, c["Vt1"], vl2_new
            ys_extra.append(uvm_out)
        lv24 = torch.cat([lv, lvu, lvv], dim=0).to(torch.int16)
        ys = ([lv24, y2lv.to(torch.int16), rYp[15], rYp[:, 15]] + ys_extra
              + [rU[7], rV[7]])
        return new, ys

    z16 = torch.zeros((16, N), dtype=torch.int32, device=dev)
    z8 = torch.zeros((8, N), dtype=torch.int32, device=dev)
    z4 = torch.zeros((4, N), dtype=torch.int32, device=dev)
    z1 = torch.zeros((N,), dtype=torch.int32, device=dev)
    carry = {}
    for p, z in (("y", z16), ("u", z8), ("v", z8)):
        carry.update({"B" + p + "1": z, "B" + p + "2": z, "R" + p: z,
                      "C" + p + "1": z1, "C" + p + "2": z1, "C" + p + "3": z1})
    if use_tr:
        carry.update(Nt1=z1, Nt2=z1, Nl=z1)
    if search:
        carry.update(Dt1=z1, Dt2=z1, Dl=z1, Bm1=z4, Bm2=z4, Bml=z4)
    if uv_search:
        carry.update(Ut1=z1, Ut2=z1, Ul=z1, Vt1=z1, Vt2=z1, Vl=z1)
    carry = {k: v.clone() for k, v in carry.items()}

    # One step reads step t's inputs and writes its outputs and the carry
    # through fixed buffers; t lives on the device (a CUDA graph can
    # replay it).
    t1 = torch.zeros((1,), dtype=torch.long, device=dev)
    outs = []

    def body():
        x = {k: v.index_select(0, t1)[0] for k, v in xs.items()}
        new, ys = step(t1.to(torch.int32) - sk * yy, x, carry)
        if not outs:
            outs.extend(torch.empty((n_steps,) + tuple(y.shape),
                                    dtype=y.dtype, device=dev) for y in ys)
        # A value carried over unchanged (B*2 <- B*1, ...) is copied before
        # its source is overwritten.
        new = {k: v.clone() if any(v is c for c in carry.values()) else v
               for k, v in new.items()}
        for k, v in new.items():
            carry[k].copy_(v)
        for o, y in zip(outs, ys):
            o.index_copy_(0, t1, y[None])
        t1.add_(1)

    body()
    if graph and n_steps > 1:
        g = torch.cuda.CUDAGraph()
        # A capture stream of Y's own card (torch.cuda.graph's default is
        # one stream, made on whichever card was current at its first use).
        with torch.cuda.graph(g, stream=torch.cuda.Stream(dev)):
            body()
        trace.count(trace.PROGRAMS, "built")
        for _ in range(n_steps - 1):
            g.replay()
    else:
        for _ in range(n_steps - 1):
            body()
    return tuple(_unskew_b(o, B, mb_w, mb_h, n_steps, sk) for o in outs)
