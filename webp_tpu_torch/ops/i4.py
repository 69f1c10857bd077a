"""Open-loop I4 (4x4 intra) mode search and the I4-vs-I16 split, batched.
Counterpart of webp_tpu/ops/i4.py (its kernel-backed path,
i4_search_pallas).

The 10-mode search itself is the I4 kernel (ops/i4_kernel.py); this module
builds the kernel's planar subblock rows from the luma planes, puts its
per-subblock scores back in macroblock order and takes the split decision:
an MB goes I4 when the sum of its subblocks' scores plus the I4 signalling
overhead and the contextual mode-cost correction, all at lambda_mode, beats
the I16 score of phase 1.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..lossy.cost import FIXED_COSTS_I4
from . import i4_kernel as K

# Static per-mode signalling cost of the open-loop search: the DC,DC
# context row of FIXED_COSTS_I4.
I4_MODE_COST = np.asarray(FIXED_COSTS_I4)[0, 0].astype(np.int32)
I4_OVERHEAD = 211  # i4 signalling overhead (libwebp constant)


@functools.lru_cache(maxsize=8)
def _mode_cost_tables(device: str):
    return (torch.as_tensor(np.asarray(FIXED_COSTS_I4, np.int32),
                            device=device),                  # [t, l, m]
            torch.as_tensor(I4_MODE_COST, device=device))    # [m]


def ctx_mode_rate_delta(i4_modes):
    """Contextual minus flat I4 mode-signalling rate per MB.

    i4_modes: [..., n_mb, 16] int (subblock raster r*4+c). In-MB top/left
    mode contexts are exact, cross-MB contexts are taken as DC (0), so the
    value depends on the MB alone. Every term is an integer, so the sum is
    exact; returns float32 [..., n_mb]."""
    fc, flat = _mode_cost_tables(str(i4_modes.device))
    g = i4_modes.to(torch.long).reshape(*i4_modes.shape[:-1], 4, 4)
    t_ctx = torch.cat([torch.zeros_like(g[..., :1, :]), g[..., :3, :]], dim=-2)
    l_ctx = torch.cat([torch.zeros_like(g[..., :, :1]), g[..., :, :3]], dim=-1)
    cost = fc[t_ctx, l_ctx, g] - flat[g]
    return cost.sum(dim=(-2, -1)).to(torch.float32)


def _planar_inputs(Yb, seg_map, mb_w, mb_h):
    """The I4 kernel's rows u8 [32, B * n_sb] in subblock GRID order per
    image (lane b * n_sb + sy * SBX + sx).

    Rows 0-15 are the subblock's source pixels; 16-19 l3..l0, 20 tl,
    21-24 t0..t3, 25-28 the above-right strip, 29 is_c3, 30 the segment.
    Every context row is a lane shift of a source row (left = sb-1,
    above = sb-SBX, above-left = sb-SBX-1, above-right = sb-SBX+1) with the
    127/129 edge fills. A rightmost (c3) subblock takes the next MB's strip
    from the row above its whole MB row, the last MB column the rightmost
    pixel of that row, and the top MB row 127."""
    B = Yb.shape[0]
    SBY, SBX = mb_h * 4, mb_w * 4
    n_sb = SBY * SBX
    dev = Yb.device
    g = Yb.to(torch.uint8).reshape(B, SBY, 4, SBX, 4)
    src16 = g.permute(2, 4, 0, 1, 3).reshape(16, B, n_sb)
    s4 = src16.reshape(4, 4, B, n_sb)
    bot = s4[3]                                     # [4c, B, n_sb]
    rgt = s4[:, 3]                                  # [4r, B, n_sb]
    br = src16[15]                                  # [B, n_sb]

    sb = torch.arange(n_sb, device=dev)
    sx = sb % SBX
    top_row0 = sb < SBX
    left_col0 = sx == 0
    last_col = sx == SBX - 1
    sy4 = (sb // SBX) % 4
    mbrow0 = sb < 4 * SBX
    c3_mask = (sb % 4) == 3
    c127 = torch.tensor(127, dtype=torch.uint8, device=dev)
    c129 = torch.tensor(129, dtype=torch.uint8, device=dev)

    def sh(a, k):
        """Lane shift right by k within each image (zero fill)."""
        out = torch.zeros_like(a)
        if k < n_sb:
            out[..., k:] = a[..., :n_sb - k]
        return out

    def sel_by_sy4(mk):
        v = mk(0)
        for k in range(1, 4):
            v = torch.where(sy4 == k, mk(k), v)
        return v

    lrows = [torch.where(left_col0, c129, sh(rgt[i], 1)) for i in (3, 2, 1, 0)]
    tl_f = torch.where(top_row0, c127,
                       torch.where(left_col0, c129, sh(br, SBX + 1)))
    trows = [torch.where(top_row0, c127, sh(bot[j], SBX)) for j in range(4)]
    trrows = []
    for j in range(4):
        interior = sh(bot[j], SBX - 1)
        mb_int = sel_by_sy4(lambda k, j=j: sh(bot[j], (k + 1) * SBX - 1))
        mb_edge = sel_by_sy4(lambda k: sh(bot[3], (k + 1) * SBX))
        c3row = torch.where(mbrow0, c127,
                            torch.where(last_col, mb_edge, mb_int))
        trrows.append(torch.where(c3_mask, c3row,
                                  torch.where(top_row0, c127, interior)))
    is_c3 = c3_mask.to(torch.uint8).expand(B, n_sb)
    seg_grid = seg_map.to(torch.uint8).reshape(B, mb_h, 1, mb_w, 1) \
        .expand(B, mb_h, 4, mb_w, 4).reshape(B, n_sb)
    rows = (lrows + [tl_f] + trows + trrows
            + [is_c3, seg_grid, torch.zeros_like(seg_grid)])
    ctx = torch.stack(rows, dim=0)                  # [16, B, n_sb]
    return torch.cat([src16, ctx], dim=0).reshape(32, B * n_sb).contiguous()


def _seq_sum16(x):
    """Sum over the last axis (16) in sequential order, left to right: the
    order XLA's CPU reduction takes, so the float score rounds alike on
    every device."""
    acc = x[..., 0]
    for k in range(1, 16):
        acc = acc + x[..., k]
    return acc


def i4_search(Yb, seg_map, qtab16, lam4, lam_mode4, tlsd4, i16_score,
              mb_w, mb_h):
    """Batched open-loop I4 search and I4-vs-I16 split (counterpart of
    i4_search_pallas, over the whole batch in one kernel launch).

    Yb: [B, H, W] luma; seg_map: [B, n_mb]; qtab16: i32 [B, 16, 16] y1
    quant rows (seg*4 + param, zigzag columns); lam4/lam_mode4: f32 [B, 4]
    per-segment I4 and split lambdas; tlsd4: f32 [B, 4] or None (TDisto
    off); i16_score: f32 [B, n_mb]. Returns (is_i4 [B, n_mb] bool,
    modes [B, n_mb, 16] u8, i4_score [B, n_mb] f32)."""
    from .fastpath import device_tables

    B = Yb.shape[0]
    n_mb = mb_w * mb_h
    n_sb = 16 * n_mb
    data = _planar_inputs(Yb, seg_map, mb_w, mb_h)
    use_td = tlsd4 is not None
    lams = torch.cat([lam4, tlsd4 if use_td else torch.zeros_like(lam4),
                      lam_mode4], dim=1).to(torch.float32).contiguous()
    rc = device_tables(str(Yb.device)).rate_consts
    mode_g, score_g = K.i4_scores(data, qtab16.to(torch.int32).contiguous(),
                                  lams, rc, n_sb, use_td)

    def to_mb(a):
        return (a.reshape(B, mb_h, 4, mb_w, 4).permute(0, 1, 3, 2, 4)
                .reshape(B, n_mb, 16))

    best_mode = to_mb(mode_g).to(torch.uint8)
    score = to_mb(score_g)
    lam_mb = torch.gather(lam_mode4.to(torch.float32), 1, seg_map.long())
    i4_score = _seq_sum16(score) + I4_OVERHEAD * lam_mb
    i4_score = i4_score + ctx_mode_rate_delta(best_mode) * lam_mb
    return i4_score < i16_score, best_mode, i4_score
