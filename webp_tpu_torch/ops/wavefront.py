"""The exact-parity wavefront VP8 encoder (PyTorch port of
webp_tpu/ops/wavefront.py), the differential oracle of the device path.

The intra-prediction dependency (left, top, top-right reconstructed
neighbours) makes VP8 mode decision a wavefront. Here the reference's
schedule, skewed diagonals t = mb_x + 2 * mb_y (encode_parallel.go:168),
is a Python loop: every MB of a diagonal runs as one batch of lanes,
with the full 4-mode I16 and UV RD searches on exact chained rates and
the reconstructed context in compact buffers (top row, left column,
top-left corners, nonzero and DC contexts).

Exact-integer parity with the host encoder (lossy/encode.py) on the I16 +
chroma path: the same mode decisions and levels, so the same bitstream
after the host's entropy coding. The device encoder's closed loop is held
against it: phase 2 (kernel 4 and the planar step loop) on the oracle's
modes gives the oracle's levels (tests/test_torch_wavefront.py,
chip_smoke.py phase 13). Plain PyTorch on any device: the reference's is
jnp on every backend, not a Pallas kernel.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..lossy import tables as T
from ..lossy.cost import (
    ENTROPY_COST,
    LEVEL_FIXED_COSTS,
    compute_level_cost_tables,
)
from ..lossy.encode import FIXED_COSTS_I16, FIXED_COSTS_UV
from . import dct
from .fastpath import _block, _preds4, _unblock
from .quant import quantize

ZIGZAG = np.asarray(T.ZIGZAG)
BANDS = np.asarray(T.BANDS[:16])


def _bit_cost_arrays(proba: np.ndarray):
    """p0-related cost constants per (type, band, ctx)."""
    ec = np.asarray(ENTROPY_COST)
    p0 = proba[..., 0].astype(np.int64)  # [4, 8, 3]
    return ec[255 - p0], ec[p0]


@dataclass
class WavefrontTables:
    """Device constants derived from the probability table + quantizers."""

    level_cost: torch.Tensor    # [4, 16, 3 * 68]: per position, ctx, |v|
    cost1_p0: torch.Tensor      # [4, 8, 3]
    cost0_p0: torch.Tensor      # [4, 8, 3]
    bands: torch.Tensor         # [16]
    y1: tuple
    y2: tuple
    uv: tuple
    lambda_i16: int
    lambda_uv: int
    lambda_mode: int

    def to(self, device) -> "WavefrontTables":
        def mv(x):
            if isinstance(x, tuple):
                return tuple(mv(a) for a in x)
            return x.to(device) if isinstance(x, torch.Tensor) else x
        return WavefrontTables(**{k: mv(v) for k, v in vars(self).items()})


def make_tables(proba: np.ndarray, qp, lambdas) -> WavefrontTables:
    """Tables of the probability table `proba` [4, 8, 3, 11], the quant
    rows qp {y1/y2/uv: (q, iq, bias, sharpen)} and the lambdas {i16, uv,
    mode}. The level cost of position n at context c and |level| v
    (clamped to 67) is level_cost[band[n], c, v] + the fixed cost of v."""
    c1, c0 = _bit_cost_arrays(proba)
    lc = np.asarray(compute_level_cost_tables(proba), np.int64)  # [4,8,3,68]
    comb = lc[:, BANDS] + np.asarray(LEVEL_FIXED_COSTS, np.int64)[:68]
    i32 = dict(dtype=torch.int32)
    return WavefrontTables(
        level_cost=torch.as_tensor(comb.reshape(4, 16, 3 * 68), **i32),
        cost1_p0=torch.as_tensor(c1, **i32),
        cost0_p0=torch.as_tensor(c0, **i32),
        bands=torch.as_tensor(BANDS, dtype=torch.long),
        y1=tuple(torch.as_tensor(a, **i32) for a in qp["y1"]),
        y2=tuple(torch.as_tensor(a, **i32) for a in qp["y2"]),
        uv=tuple(torch.as_tensor(a, **i32) for a in qp["uv"]),
        lambda_i16=lambdas["i16"], lambda_uv=lambdas["uv"],
        lambda_mode=lambdas["mode"])


# ---------------------------------------------------------------------------
# Rate model (vectorized GetResidualCost).
# ---------------------------------------------------------------------------

def residual_cost_vec(levels, first, ctx0, ptype, tb: WavefrontTables):
    """Rate of blocks of zigzag levels.

    levels: int32 [..., 16]; first: 0/1; ctx0: int [...] (the first
    coefficient's context); ptype: coefficient type. Returns int32 [...].
    Levels above 67 take the rate of 67 (the reference's clamp; such
    levels are vanishingly rare at practical qualities)."""
    dev = levels.device
    v = levels.abs()
    idx = torch.arange(16, device=dev)
    nzv = (v != 0) & (idx >= first)
    has_any = nzv.any(dim=-1)
    last = torch.where(nzv, idx, -1).amax(dim=-1).clamp(min=0)
    ctx0 = ctx0.long()
    # Position `first` uses ctx0; n > first clip(|level[n-1]|, 0, 2).
    prev_v = torch.cat([torch.zeros_like(v[..., :1]), v[..., :-1]], dim=-1)
    ctx_n = torch.where(idx == first, ctx0[..., None], prev_v.clamp(max=2))
    col = (ctx_n * 68 + v.clamp(max=67)).long()
    cost_n = tb.level_cost[ptype][idx.expand(col.shape), col]
    in_run = (idx >= first) & (idx <= last[..., None])
    total = torch.where(in_run, cost_n, 0).sum(dim=-1, dtype=torch.int32)
    b_first = int(BANDS[first])
    # ctx0 == 0 pays the "has coefficients" bit explicitly.
    extra = torch.where(ctx0 == 0, tb.cost1_p0[ptype, b_first, 0], 0)
    # EOB after the last coefficient (when last < 15).
    last_v = torch.gather(v, -1, last[..., None])[..., 0]
    eob_ctx = torch.where(last_v == 1, 1, 2)
    nb = tb.bands[(last + 1).clamp(max=15)]
    eob = torch.where(last < 15, tb.cost0_p0[ptype][nb, eob_ctx], 0)
    empty_cost = tb.cost0_p0[ptype, b_first][ctx0]
    return torch.where(has_any, total + extra + eob, empty_cost).to(
        torch.int32)


# ---------------------------------------------------------------------------
# Predictions (batched over lanes).
# ---------------------------------------------------------------------------

# The lanes-first mode predictors and the 4x4 block views are fastpath's
# (_preds4, _block, _unblock).


def _pick(a, best):
    """a [L, 4, ...] -> [L, ...] at the chosen mode best [L]."""
    return a[torch.arange(a.shape[0], device=a.device), best]


# ---------------------------------------------------------------------------
# Batched diagonal step. All tensors carry a leading lane axis L.
# ---------------------------------------------------------------------------

def _i16_rd(src_b, top, left, tl, has_top, has_left, tnz, lnz, tdc, ldc, tb):
    """I16 RD for a batch of MBs (src_b [L, 16, 4, 4]): the 4 modes on
    exact chained rates, the first minimum of rate * lambda_i16 + 256 *
    SSE. Returns the decision dict."""
    L = src_b.shape[0]
    pred_b = _block(_preds4(16, top, left, tl, has_top, has_left), 16)
    coeffs = dct.fdct4x4(src_b[:, None], pred_b)            # [L,4,16,4,4]
    flat = coeffs.reshape(L, 4, 16, 16)
    wht = dct.fwht4x4(flat[..., 0].reshape(L, 4, 4, 4)).reshape(L, 4, 16)
    y2_lv, y2_dq = quantize(wht, *tb.y2, ZIGZAG)
    rec_dcs = dct.wht4x4(y2_dq.reshape(L, 4, 4, 4)).reshape(L, 4, 16)
    lv, dq = quantize(flat, *tb.y1, ZIGZAG, first=1)
    dq = dq.clone()
    dq[..., 0] = rec_dcs
    recon = (pred_b + dct.idct4x4(dq.reshape(L, 4, 16, 4, 4))).clamp(0, 255)
    disto = ((src_b[:, None] - recon) ** 2).sum(dim=(2, 3, 4),
                                                dtype=torch.int32)

    y2_rate = residual_cost_vec(y2_lv, 0, (tdc + ldc)[:, None].expand(L, 4),
                                1, tb)
    nzg = (lv[..., 1:] != 0).any(dim=-1).to(torch.int32).reshape(L, 4, 4, 4)
    tnz_bits = torch.stack([(tnz >> x) & 1 for x in range(4)], -1)
    lnz_bits = torch.stack([(lnz >> y) & 1 for y in range(4)], -1)
    top_ctx = torch.cat([tnz_bits[:, None, None, :].expand(L, 4, 1, 4),
                         nzg[:, :, :-1, :]], dim=2)
    left_ctx = torch.cat([lnz_bits[:, None, :, None].expand(L, 4, 4, 1),
                          nzg[:, :, :, :-1]], dim=3)
    ctx0 = (top_ctx + left_ctx).reshape(L, 4, 16)
    rate = residual_cost_vec(lv, 1, ctx0, 0, tb).sum(dim=-1,
                                                     dtype=torch.int32)
    rate = (rate + y2_rate
            + torch.as_tensor(FIXED_COSTS_I16, dtype=torch.int32,
                              device=rate.device)[None, :])
    # float32 scores, as the reference's (the host's are exact integers;
    # near-ties may resolve differently, which only moves a mode choice).
    score = (rate.to(torch.float32) * float(tb.lambda_i16)
             + 256.0 * disto.to(torch.float32))
    best = torch.argmin(score, dim=-1)
    y2_best = _pick(y2_lv, best)
    return {
        "mode": best.to(torch.uint8),
        "lv": _pick(lv, best),
        "y2_lv": y2_best,
        "recon": _unblock(_pick(recon, best), 16),
        "nzg": _pick(nzg, best),                              # [L, 4, 4]
        "y2_nz": (y2_best != 0).any(dim=-1).to(torch.int32),
    }


def _uv_rd(src_u, src_v, tu, lu, tlu, tv, lv_, tlv, has_top, has_left,
           tnz, lnz, tb):
    """Chroma RD: [L, 8, 8] planes -> the best joint mode, its levels,
    reconstruction and nonzero flags."""
    L = src_u.shape[0]
    rate_total = torch.as_tensor(FIXED_COSTS_UV, dtype=torch.int32,
                                 device=src_u.device)[None, :].expand(L, 4)
    disto_total = torch.zeros((L, 4), dtype=torch.int32, device=src_u.device)
    per_plane = []
    for src, top, left, tl, ch in ((src_u, tu, lu, tlu, 0),
                                   (src_v, tv, lv_, tlv, 2)):
        preds = _preds4(8, top, left, tl, has_top, has_left)  # [L, 4, 8, 8]
        sb = _block(src[:, None].expand(L, 4, 8, 8), 8)  # [L,4,4,4,4]
        pb = _block(preds, 8)
        co = dct.fdct4x4(sb, pb).reshape(L, 4, 4, 16)
        lv, dq = quantize(co, *tb.uv, ZIGZAG)
        recon = (pb + dct.idct4x4(dq.reshape(L, 4, 4, 4, 4))).clamp(0, 255)
        disto_total = disto_total + ((sb - recon) ** 2).sum(
            dim=(2, 3, 4), dtype=torch.int32)
        nzb = (lv != 0).any(dim=-1).to(torch.int32).reshape(L, 4, 2, 2)
        tnz_bits = torch.stack([(tnz >> (4 + ch + x)) & 1 for x in range(2)],
                               -1)
        lnz_bits = torch.stack([(lnz >> (4 + ch + y)) & 1 for y in range(2)],
                               -1)
        top_ctx = torch.cat([tnz_bits[:, None, None, :].expand(L, 4, 1, 2),
                             nzb[:, :, :-1, :]], dim=2)
        left_ctx = torch.cat([lnz_bits[:, None, :, None].expand(L, 4, 2, 1),
                              nzb[:, :, :, :-1]], dim=3)
        ctx0 = (top_ctx + left_ctx).reshape(L, 4, 4)
        rate_total = rate_total + residual_cost_vec(lv, 0, ctx0, 2, tb).sum(
            dim=-1, dtype=torch.int32)
        per_plane.append((lv, recon, nzb))
    score = (rate_total.to(torch.float32) * float(tb.lambda_uv)
             + 256.0 * disto_total.to(torch.float32))
    best = torch.argmin(score, dim=-1)
    (lvu, recu, nzu), (lvv, recv, nzv) = per_plane
    return {
        "uvmode": best.to(torch.uint8),
        "lv_u": _pick(lvu, best), "lv_v": _pick(lvv, best),
        "rec_u": _unblock(_pick(recu, best), 8),
        "rec_v": _unblock(_pick(recv, best), 8),
        "nz_u": _pick(nzu, best), "nz_v": _pick(nzv, best),   # [L, 2, 2]
    }


def _nz_pack(nzg, nz_u, nz_v, axis):
    """The nonzero context an MB leaves below ("t": its bottom row) or to
    its right ("l": its right column): luma bits 0-3, U 4-5, V 6-7."""
    if axis == "t":
        y4 = sum(nzg[:, 3, c] << c for c in range(4))
        u2 = (nz_u[:, 1, 0] << 4) | (nz_u[:, 1, 1] << 5)
        v2 = (nz_v[:, 1, 0] << 6) | (nz_v[:, 1, 1] << 7)
    else:
        y4 = sum(nzg[:, r, 3] << r for r in range(4))
        u2 = (nz_u[:, 0, 1] << 4) | (nz_u[:, 1, 1] << 5)
        v2 = (nz_v[:, 0, 1] << 6) | (nz_v[:, 1, 1] << 7)
    return y4 | u2 | v2


def wavefront_encode_fn(mb_w: int, mb_h: int, quality: int):
    """The wavefront encoder for one frame geometry.

    Returns fn(srcY [H, W] u8, srcU, srcV [H/2, W/2]) -> (levels [n_mb,
    24, 16] i32, y2 [n_mb, 16] i32, modes [n_mb] u8, uvmodes [n_mb] u8,
    skip [n_mb] bool), bit-compatible with the host encoder's I16 path; it
    runs on its inputs' device. fn.rgb(rgb [H, W, 3] u8, padded to whole
    MBs) imports YUV on the device first; fn.rgb_batch maps fn.rgb over
    a batch."""
    from ..lossy.encode import quality_to_qindex
    from .pipeline import quant_params

    qp = quant_params(quality)
    q = quality_to_qindex(quality)
    dc_t, ac_t, ac2_t = T.DC_TABLE, T.AC_TABLE, T.AC_TABLE2
    y1dc, y1ac = int(dc_t[q]), int(ac_t[q])
    y2dc = max(8, int(dc_t[q]) * 2)
    q_i4 = (y1dc + 15 * y1ac + 8) >> 4
    q_i16 = (y2dc + 15 * int(ac2_t[q]) + 8) >> 4
    q_uv = (int(dc_t[max(0, min(117, q))]) + 15 * int(ac_t[q]) + 8) >> 4
    lambdas = {  # identical to VP8Encoder.__init__
        "i16": max(3 * q_i16 * q_i16, 1),
        "uv": max((3 * q_uv * q_uv) >> 6, 1),
        "mode": max((1 * q_i4 * q_i4) >> 7, 1),
    }
    tables = make_tables(np.asarray(T.COEFFS_PROBA0), qp, lambdas)
    on = {}

    n_mb = mb_w * mb_h
    Lmax = min(mb_h, mb_w // 2 + 1)
    n_steps = mb_w + 2 * mb_h - 2

    def encode(srcY, srcU, srcV):
        dev = srcY.device
        tb = on.get(str(dev))
        if tb is None:
            tb = on[str(dev)] = tables.to(dev)
        i32 = dict(dtype=torch.int32, device=dev)
        yb = srcY.to(torch.int32).reshape(mb_h, 4, 4, mb_w, 4, 4) \
            .permute(0, 3, 1, 4, 2, 5).reshape(n_mb, 16, 4, 4)
        ub = srcU.to(torch.int32).reshape(mb_h, 8, mb_w, 8).transpose(1, 2) \
            .reshape(n_mb, 8, 8)
        vb = srcV.to(torch.int32).reshape(mb_h, 8, mb_w, 8).transpose(1, 2) \
            .reshape(n_mb, 8, 8)
        top_y = torch.zeros((mb_w, 16), **i32)
        left_y = torch.zeros((mb_h, 16), **i32)
        tl_y = torch.zeros((mb_w, 2), **i32)
        top_u, top_v = (torch.zeros((mb_w, 8), **i32) for _ in range(2))
        left_u, left_v = (torch.zeros((mb_h, 8), **i32) for _ in range(2))
        tl_u, tl_v = (torch.zeros((mb_w, 2), **i32) for _ in range(2))
        top_nz, top_dc = (torch.zeros(mb_w, **i32) for _ in range(2))
        left_nz, left_dc = (torch.zeros(mb_h, **i32) for _ in range(2))
        out_lv = torch.zeros((n_mb, 24, 16), **i32)
        out_y2 = torch.zeros((n_mb, 16), **i32)
        out_modes = torch.zeros(n_mb, dtype=torch.uint8, device=dev)
        out_uv = torch.zeros(n_mb, dtype=torch.uint8, device=dev)
        out_skip = torch.zeros(n_mb, dtype=torch.bool, device=dev)
        for t in range(n_steps):
            # The diagonal's row window: y in [ceil((t - mb_w + 1) / 2),
            # t // 2]; only its valid MBs run (the reference's dropped
            # lanes write nothing).
            ys_np = max(0, (t - mb_w + 2) // 2) + np.arange(Lmax)
            xs_np = t - 2 * ys_np
            ok = (xs_np >= 0) & (xs_np < mb_w) & (ys_np < mb_h)
            ys = torch.as_tensor(ys_np[ok], device=dev)
            xs = torch.as_tensor(xs_np[ok], device=dev)
            mb = ys * mb_w + xs
            has_top, has_left = ys > 0, xs > 0
            par = ys & 1
            tnz = torch.where(has_top, top_nz[xs], 0)
            lnz = torch.where(has_left, left_nz[ys], 0)
            tdc = torch.where(has_top, top_dc[xs], 0)
            ldc = torch.where(has_left, left_dc[ys], 0)
            d16 = _i16_rd(yb[mb], top_y[xs], left_y[ys], tl_y[xs, par],
                          has_top, has_left, tnz, lnz, tdc, ldc, tb)
            duv = _uv_rd(ub[mb], vb[mb], top_u[xs], left_u[ys],
                         tl_u[xs, par], top_v[xs], left_v[ys], tl_v[xs, par],
                         has_top, has_left, tnz, lnz, tb)
            skip = ((d16["lv"] == 0).all(dim=2).all(dim=1)
                    & (d16["y2_lv"] == 0).all(dim=1)
                    & (duv["lv_u"] == 0).all(dim=2).all(dim=1)
                    & (duv["lv_v"] == 0).all(dim=2).all(dim=1))

            # Context updates; the corner of MB (x + 1, y + 1) only inside
            # the frame.
            inner = xs + 1 < mb_w
            xi, pi = xs[inner] + 1, ((ys + 1) & 1)[inner]
            rY, rU, rV = d16["recon"], duv["rec_u"], duv["rec_v"]
            top_y[xs], left_y[ys] = rY[:, 15, :], rY[:, :, 15]
            tl_y[xi, pi] = rY[inner, 15, 15]
            top_u[xs], left_u[ys] = rU[:, 7, :], rU[:, :, 7]
            tl_u[xi, pi] = rU[inner, 7, 7]
            top_v[xs], left_v[ys] = rV[:, 7, :], rV[:, :, 7]
            tl_v[xi, pi] = rV[inner, 7, 7]
            top_nz[xs] = _nz_pack(d16["nzg"], duv["nz_u"], duv["nz_v"], "t")
            left_nz[ys] = _nz_pack(d16["nzg"], duv["nz_u"], duv["nz_v"], "l")
            top_dc[xs] = d16["y2_nz"]
            left_dc[ys] = d16["y2_nz"]
            out_lv[mb] = torch.cat([d16["lv"], duv["lv_u"], duv["lv_v"]],
                                   dim=1)
            out_y2[mb] = d16["y2_lv"]
            out_modes[mb] = d16["mode"]
            out_uv[mb] = duv["uvmode"]
            out_skip[mb] = skip
        return out_lv, out_y2, out_modes, out_uv, out_skip

    def encode_rgb(rgb_padded):
        """uint8 [mb_h * 16, mb_w * 16, 3] (edge-replicated padding): the
        YUV import on the device, then the wavefront."""
        from . import yuv as devyuv

        Y, U, V = devyuv.rgb_to_yuv420(rgb_padded[None])
        return encode(Y[0], U[0], V[0])

    def encode_rgb_batch(rgbs):
        outs = [encode_rgb(r) for r in rgbs]
        return tuple(torch.stack(o) for o in zip(*outs))

    encode.rgb = encode_rgb
    encode.rgb_batch = encode_rgb_batch
    return encode
