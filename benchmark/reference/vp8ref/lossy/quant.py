"""VP8 quantization (encoder side).

QFIX=17 fixed-point bias quantization with per-frequency sharpening,
matching libwebp quant_enc.c semantics (reference: internal/lossy/
encode_quant.go, encode.go:1065-1160).
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from . import tables as T

QFIX = 17
MAX_LEVEL = 2047

# Per-type quantization bias [type][is_ac]; type 0=Y1, 1=Y2, 2=UV.
BIAS_MATRICES = ((96, 110), (96, 108), (110, 115))

# Per-frequency sharpening factors (raster order), Y1 only.
FREQ_SHARPENING = (0, 30, 60, 90, 30, 60, 90, 90, 60, 90, 90, 90, 90, 90, 90, 90)


@dataclass
class SegmentQuant:
    """Expanded quantizer for one coefficient class."""

    q: np.ndarray = None        # [16] dequant steps (dc at 0, ac elsewhere)
    iq: np.ndarray = None       # [16] (1<<QFIX)/q
    bias: np.ndarray = None     # [16]
    zthresh: np.ndarray = None  # [16]
    sharpen: np.ndarray = None  # [16]

    @staticmethod
    def make(dc_quant: int, ac_quant: int, bias_type: int,
             sharpen: bool = False) -> "SegmentQuant":
        sq = SegmentQuant()
        q = np.full(16, ac_quant, dtype=np.int64)
        q[0] = dc_quant
        iq = (1 << QFIX) // q
        b = np.full(16, BIAS_MATRICES[bias_type][1] << (QFIX - 8), dtype=np.int64)
        b[0] = BIAS_MATRICES[bias_type][0] << (QFIX - 8)
        zt = ((1 << QFIX) - 1 - b) // iq
        sh = np.zeros(16, dtype=np.int64)
        if sharpen:
            fs = np.array(FREQ_SHARPENING, dtype=np.int64)
            sh = (fs * q) >> 11
        sq.q, sq.iq, sq.bias, sq.zthresh, sq.sharpen = q, iq, b, zt, sh
        return sq


def quantize_block(coeffs: np.ndarray, sq: SegmentQuant, first: int = 0):
    """Quantizes one (or a batch of) 4x4 coefficient block(s).

    coeffs: int [..., 16] natural (raster) order.
    Returns (levels_zigzag int32 [..., 16], dequantized int32 [..., 16] raster,
    last_nonzero+1 in zigzag order as int [...]).
    """
    zz = T.ZIGZAG
    c = coeffs.reshape(-1, 16).astype(np.int64)
    # Reorder to zigzag.
    czz = c[:, zz]
    sign = czz < 0
    mag = np.abs(czz) + sq.sharpen[None, :]
    level = (mag * sq.iq[None, :] + sq.bias[None, :]) >> QFIX
    level = np.minimum(level, MAX_LEVEL)
    # Zero-threshold shortcut parity: values below zthresh quantize to 0
    # already via the bias formula; explicit check unnecessary.
    level = np.where(sign, -level, level)
    if first:
        level[:, 0] = 0
    out = np.zeros_like(c)
    out[:, zz] = level * sq.q[None, :]
    nz = (level != 0)
    last = np.where(nz.any(axis=1), 16 - np.argmax(nz[:, ::-1], axis=1), 0)
    shape = coeffs.shape[:-1]
    return (level.astype(np.int32).reshape(*shape, 16),
            out.astype(np.int32).reshape(*shape, 16),
            last.reshape(shape))


# Per-frequency trellis distortion weights (zigzag position).
WEIGHT_TRELLIS = (30, 27, 19, 11, 27, 24, 17, 10,
                  19, 17, 12, 8, 11, 10, 8, 6)
RD_DISTO_MULT = 256


def trellis_quantize_block(coeffs: np.ndarray, sq: SegmentQuant, first: int,
                           ctx_type: int, ctx0: int, proba: np.ndarray,
                           lam: int):
    """Viterbi-optimal quantization of one 4x4 block (parity with reference
    encode_trellis.go TrellisQuantizeBlock: 3 context states x 2 level
    candidates per position, score = rate*lambda + 256*delta_distortion).

    coeffs: int [16] raster order. Returns (levels_zigzag [16] int32,
    dequant [16] int32 raster).
    """
    from . import tables as T
    from .cost import ENTROPY_COST, LEVEL_FIXED_COSTS, variable_level_cost

    zz = T.ZIGZAG
    bands = T.BANDS
    ec = ENTROPY_COST
    ctx0 = min(ctx0, 2)
    INF = 1 << 62

    prev_score = [INF, INF, INF]
    prev_score[ctx0] = 0
    path = [[None] * 3 for _ in range(16)]

    first_band = int(bands[first])
    p00 = int(proba[ctx_type, first_band, ctx0, 0])
    best_terminal = int(ec[p00]) * lam
    best_last_n = -1
    best_last_ctx = -1

    for n in range(first, 16):
        zig = int(zz[n])
        band_next = int(bands[n + 1])
        raw = int(coeffs[zig])
        sign = -1 if raw < 0 else 1
        raw = abs(raw)
        c0 = max(0, raw + int(sq.sharpen[n]))
        quant = int(sq.q[n])
        iquant = int(sq.iq[n])
        L0 = min((c0 * iquant) >> 17, MAX_LEVEL)
        thresh = min((c0 * iquant + 65536) >> 17, MAX_LEVEL)
        weight = WEIGHT_TRELLIS[zig]
        c0sq = c0 * c0

        cands = []
        if 0 < L0 <= thresh:
            err = c0 - L0 * quant
            cands.append((L0, weight * (err * err - c0sq), min(L0, 2)))
        if L0 + 1 <= thresh:
            L1 = L0 + 1
            err = c0 - L1 * quant
            cands.append((L1, weight * (err * err - c0sq), min(L1, 2)))

        cur_score = [INF, INF, INF]
        cur_entry = [None, None, None]
        for pc in range(3):
            if prev_score[pc] >= INF:
                continue
            p = proba[ctx_type, bands[n], pc]
            not_eob = int(ec[255 - p[0]])
            # level = 0
            rate0 = not_eob + int(ec[p[1]])
            ts = prev_score[pc] + rate0 * lam
            if ts < cur_score[0]:
                cur_score[0] = ts
                cur_entry[0] = (0, pc)
            if cands:
                nonzero = not_eob + int(ec[255 - p[1]])
                for (L, dd, nc) in cands:
                    rate = nonzero + int(LEVEL_FIXED_COSTS[L]) + \
                        variable_level_cost(L, p)
                    ts = prev_score[pc] + rate * lam + RD_DISTO_MULT * dd
                    if ts < cur_score[nc]:
                        cur_score[nc] = ts
                        cur_entry[nc] = (sign * L, pc)
        for c in range(3):
            if cur_entry[c] is not None:
                path[n][c] = cur_entry[c]
        # Terminal checks for nonzero contexts.
        for c in (1, 2):
            if cur_score[c] >= INF:
                continue
            eob = cur_score[c]
            if n < 15:
                eob += int(ec[proba[ctx_type, band_next, c, 0]]) * lam
            if eob < best_terminal:
                best_terminal = eob
                best_last_n = n
                best_last_ctx = c
        prev_score = cur_score

    out = np.zeros(16, dtype=np.int32)
    if best_last_n >= 0:
        ctx = best_last_ctx
        for n in range(best_last_n, first - 1, -1):
            e = path[n][ctx]
            if e is not None:
                out[n] = e[0]
                ctx = e[1]
    dequant = np.zeros(16, dtype=np.int32)
    dequant[zz] = out * np.asarray(sq.q, dtype=np.int32)
    return out, dequant
