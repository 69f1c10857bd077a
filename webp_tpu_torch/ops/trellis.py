"""Planar (lanes-minor) Viterbi trellis quantization of 4x4 blocks
(PyTorch). Counterpart of webp_tpu/ops/trellis.py.

A 16-position dynamic program over 3 nonzero-context states with two
candidate levels per position, score = rate * lambda + 256 * delta
distortion (the native MB loop's trellis, after the Go reference's
encode_trellis.go TrellisQuantizeBlock).

The rates come from the static default probabilities (COEFFS_PROBA0), so
every per-(position, context) constant folds into numpy tables once
(_rate_consts), and the one data-dependent term, a level's rate, is one
gather from a [16, 3, MAX_LEVEL+1] table per candidate before the DP.

Scores are float32, each a product and then a sum, never fused, in the
reference's order. The reference walks each state's candidates in a
fixed order and keeps the first strict minimum; here the candidates of a
state are stacked in that order and reduced to their first minimum
(planar.first_min): the same winner, in fewer operations.
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from ..lossy import tables as T
from ..lossy.cost import (ENTROPY_COST, LEVEL_FIXED_COSTS,
                          MAX_VARIABLE_LEVEL, variable_level_cost)
from .planar import first_min
from .quant import MAX_LEVEL, QFIX

ZIGZAG = np.asarray(T.ZIGZAG)
INV_ZIGZAG = np.argsort(ZIGZAG)
W_ZZ = np.asarray([30, 27, 19, 11, 27, 24, 17, 10,
                   19, 17, 12, 8, 11, 10, 8, 6])[ZIGZAG]  # per zigzag pos
INF = float(np.float32(3.0e38))


@functools.lru_cache(maxsize=4)
def _rate_consts(ctx_type: int, first: int):
    """Static trellis rate constants for one coefficient type.

    Returns numpy: rate0 [16, 3] (EOB-not-taken + zero-level),
    nz_base [16, 3], eob_next [16, 3] (EOB cost at band(n+1)),
    term0 [3] (initial best terminal per ctx0), and the fused level-rate
    table rtab [16, 3, MAX_LEVEL+1]."""
    proba = np.asarray(T.COEFFS_PROBA0)
    bands = np.asarray(T.BANDS)
    ec = np.asarray(ENTROPY_COST).astype(np.int64)

    rate0 = np.zeros((16, 3), np.int32)
    nz_base = np.zeros((16, 3), np.int32)
    eob_next = np.zeros((16, 3), np.int32)
    rtab = np.zeros((16, 3, MAX_LEVEL + 1), np.int32)
    lfc = np.asarray(LEVEL_FIXED_COSTS)[:MAX_LEVEL + 1].astype(np.int64)
    for n in range(16):
        band = int(bands[n])
        band_next = int(bands[n + 1])
        for pc in range(3):
            p = proba[ctx_type, band, pc]
            not_eob = int(ec[255 - p[0]])
            rate0[n, pc] = not_eob + int(ec[p[1]])
            nz_base[n, pc] = not_eob + int(ec[255 - p[1]])
            eob_next[n, pc] = int(ec[proba[ctx_type, band_next, pc, 0]])
            # A level's variable cost reads min(max(v, 1), 67) only.
            var = np.asarray([variable_level_cost(v, p) for v in
                              range(1, MAX_VARIABLE_LEVEL + 1)], np.int64)
            rtab[n, pc] = lfc + var[np.clip(np.arange(MAX_LEVEL + 1), 1,
                                            MAX_VARIABLE_LEVEL) - 1]
    fb = int(bands[first])
    term0 = np.asarray([int(ec[proba[ctx_type, fb, c, 0]])
                        for c in range(3)], np.int32)
    return rate0, nz_base, eob_next, term0, rtab


@functools.lru_cache(maxsize=8)
def _consts_on(device: str, ctx_type: int, first: int):
    """_rate_consts as tensors on `device`, plus the index tensors."""
    rate0, nz, eobn, term0, rtab = _rate_consts(ctx_type, first)
    f32 = dict(dtype=torch.float32, device=device)
    i32 = dict(dtype=torch.int32, device=device)
    return dict(
        rate0=torch.as_tensor(rate0.astype(np.float32), **f32),   # [16, 3]
        eobn=torch.as_tensor(eobn.astype(np.float32), **f32),     # [16, 3]
        term0=torch.as_tensor(term0.astype(np.float32), **f32),   # [3]
        nz=torch.as_tensor(nz, **i32),                            # [16, 3]
        rtab=torch.as_tensor(rtab.reshape(-1), **i32),
        zz=torch.as_tensor(ZIGZAG, dtype=torch.long, device=device),
        inv=torch.as_tensor(INV_ZIGZAG, dtype=torch.long, device=device),
        wn=torch.as_tensor(W_ZZ.astype(np.int32), **i32).reshape(16, 1),
        row=(torch.arange(16, device=device).reshape(16, 1, 1) * 3
             + torch.arange(3, device=device).reshape(1, 3, 1))
        * (MAX_LEVEL + 1),                                        # [16,3,1]
    )


def _bcast(x, nd):
    """[k, N] or [k] -> broadcastable against [k, *lead, N] (nd dims)."""
    if x.dim() == 1:
        return x.reshape((-1,) + (1,) * (nd - 1))
    return x.reshape((x.shape[0],) + (1,) * (nd - 2) + (x.shape[-1],))


def trellis_p(craw, q, iq, sharpen, tlam, ctx0, ctx_type: int = 3,
              first: int = 0):
    """Planar trellis quantization of 4x4 blocks.

    craw: [..., 16, N] int32 raster coefficients; q/iq/sharpen:
    [16, 1|N] zigzag rows (quantize_p convention); tlam: [1|N] (or a
    scalar) trellis lambda; ctx0: [..., N] int32 in 0..2.
    Returns (lv_zz [..., 16, N] int32 signed, dq_raster [..., 16, N])."""
    dev = craw.device
    k = _consts_on(str(dev), ctx_type, first)
    lam = torch.as_tensor(tlam, dtype=torch.float32, device=dev)
    czz = craw.index_select(-2, k["zz"])
    sign = czz < 0
    c0 = (czz.abs() + sharpen).clamp(min=0)                 # [..., 16, N]
    L0 = ((c0 * iq) >> QFIX).clamp(max=MAX_LEVEL)
    thresh = ((c0 * iq + 65536) >> QFIX).clamp(max=MAX_LEVEL)
    # Candidates stacked on a new leading axis: 0 = L0, 1 = L0 + 1.
    L = torch.stack([L0, L0 + 1])                           # [2, ..., 16, N]
    ok = torch.stack([(L0 > 0) & (L0 <= thresh), L0 + 1 <= thresh])
    err = c0 - L * q
    dd = (k["wn"] * ((err - c0) * (err + c0))).to(torch.float32)
    # Level rates [2, ..., 16, 3, N]; an index past the table (L0 + 1 at
    # MAX_LEVEL + 1) is clamped: that candidate is never ok.
    idx = (k["row"] + L.unsqueeze(-2)).clamp(max=k["rtab"].numel() - 1)
    rate = (k["nz"][..., None] + k["rtab"][idx.long()]).to(torch.float32)
    nc = L.clamp(max=2)
    sgn = torch.where(sign, -1, 1)
    lv_c = (sgn * L).to(torch.int32)                        # [2, ..., 16, N]

    lead = craw.shape[:-2] + craw.shape[-1:]
    nd = len(lead) + 1
    ctx0 = ctx0.clamp(max=2).expand(lead)
    cs = torch.arange(3, device=dev).reshape((3,) + (1,) * len(lead))
    prev = torch.where(ctx0[None] == cs, 0.0, INF)          # [3, ..., N]
    term0 = k["term0"]
    best_term = torch.where(ctx0 == 0, term0[0],
                            torch.where(ctx0 == 1, term0[1], term0[2])) * lam
    best_n = torch.full(lead, -1, dtype=torch.int32, device=dev)
    best_c = torch.zeros(lead, dtype=torch.int32, device=dev)
    path_lv, path_pc, path_ok = [], [], []
    for n in range(first, 16):
        # State 0 (level 0): one candidate per previous state, pc order.
        s0 = prev + _bcast(k["rate0"][n], nd) * lam
        v0, pc0 = first_min(s0)
        # States 1 and 2: (pc, candidate) pairs in pc-major order.
        r_n = rate[..., n, :, :]                            # [2, ..., 3, N]
        r_n = torch.movedim(r_n, -2, 0)                     # [3, 2, ..., N]
        ts = (prev[:, None] + r_n * lam) + 256.0 * dd[..., n, :][None]
        ts = torch.where(ok[..., n, :][None], ts, INF)      # [3, 2, ..., N]
        ts = ts.reshape((6,) + tuple(lead))
        ncn = nc[..., n, :].repeat(3, *([1] * len(lead)))   # [6, ..., N]
        lvn = lv_c[..., n, :]                               # [2, ..., N]
        cur_s, cur_lv, cur_pc = [v0], [torch.zeros_like(lvn[0])], [pc0]
        for c in (1, 2):
            v, j = first_min(torch.where(ncn == c, ts, INF))
            cur_s.append(v)
            cur_lv.append(torch.where(j % 2 == 0, lvn[0], lvn[1]))
            cur_pc.append(j // 2)
        path_lv.append(torch.stack(cur_lv))
        path_pc.append(torch.stack(cur_pc).to(torch.int32))
        path_ok.append(torch.stack(cur_s) < INF)
        for c in (1, 2):
            eob = cur_s[c]
            if n < 15:
                # EOB bit cost at band(n+1) for terminal ctx c
                eob = eob + k["eobn"][n, c] * lam
            take = eob < best_term
            best_term = torch.where(take, eob, best_term)
            best_n = torch.where(take, n, best_n)
            best_c = torch.where(take, c, best_c)
        prev = torch.stack(cur_s)

    # Backtrack (full-width selects; ctx frozen on unset nodes).
    out = [torch.zeros(lead, dtype=torch.int32, device=dev)] * 16
    ctx = best_c.long()
    for n in range(15, first - 1, -1):
        i = n - first
        lv_sel = torch.gather(path_lv[i], 0, ctx[None])[0]
        pc_sel = torch.gather(path_pc[i], 0, ctx[None])[0]
        ok_sel = torch.gather(path_ok[i], 0, ctx[None])[0]
        act = (n <= best_n) & ok_sel
        out[n] = torch.where(act, lv_sel, 0)
        ctx = torch.where(act, pc_sel.long(), ctx)

    lv_zz = torch.stack(out, dim=-2)                        # [..., 16, N]
    dq_zz = lv_zz * q
    return lv_zz, dq_zz.index_select(-2, k["inv"])


def tlam_i4(q_row):
    """Trellis lambda for I4 blocks from the y1 quant row [16, 1|N]
    (host parity: lossy/encode.py, encode.go TLambdaI4)."""
    base = (q_row[0] + 15 * q_row[1] + 8) >> 4
    return ((7 * base * base) >> 3).clamp(min=1).to(torch.float32)
