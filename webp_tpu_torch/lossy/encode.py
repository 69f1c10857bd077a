"""VP8 (lossy) keyframe encoder.

TPU-first structure: the pixel math (prediction, FDCT/FWHT, quantization,
reconstruction, SSE metrics) is batched array code with a numpy exact
reference here and PyTorch/CUDA device versions in webp_tpu_torch.ops. The serial
boolean entropy coding (headers, modes, tokens) is host-side, mirroring the
Phase-A/Phase-B split the reference uses (encode_parallel.go:168-246).

Behavioral parity with the reference internal/lossy/{encode.go,
encode_frame.go,encode_quant.go,encode_syntax.go,encode_token.go}.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

from ..bitio.bool import BoolWriter
from ..container.riff import WebPError
from . import dsp
from . import tables as T
from .quant import SegmentQuant, quantize_block, MAX_LEVEL


@dataclass
class LossyConfig:
    quality: int = 75
    method: int = 4
    segments: int = 1           # 1..4; >1 runs the alpha/k-means analysis
    filter_strength: int = 60
    filter_sharpness: int = 0
    filter_type: int = 1        # 0 = simple, 1 = complex (strong)
    partitions: int = 0         # log2(token partitions)
    sns_strength: int = 50
    i4_blocks: bool = True      # allow I4 mode decision
    sharp_yuv: bool = False     # device path: on-chip SharpYUV from RGB
    autofilter: bool = False    # search the loop-filter strength (-af)
    partition_limit: int = 0    # 0-100: degrade I4 headers to fit part0
    preprocessing: int = 0      # bit 0: smooth segment map (bit 1 = dither
                                # amplitude, resolved by the caller)


# Fixed mode costs in bits<<8 for I16/UV mode signalling (libwebp cost_enc.c
# VP8FixedCostsI16 / VP8FixedCostsUV).
FIXED_COSTS_I16 = (663, 919, 872, 919)
FIXED_COSTS_UV = (302, 984, 439, 642)


def quality_to_qindex(quality: int) -> int:
    """quality [0..100] -> quantizer index [0..127] (encode.go:1039-1063)."""
    if quality <= 0:
        return 127
    if quality >= 100:
        return 0
    c = quality / 100.0
    linear_c = c * (2.0 / 3.0) if c < 0.75 else 2.0 * c - 1.0
    v = linear_c ** (1.0 / 3.0)
    return max(0, min(127, int(127.0 * (1.0 - v))))


# Filter-strength lookup (libwebp filter_enc.c kLevelsFromDelta) is generated:
# strength s is the smallest level whose filtered delta covers `delta`.
def _filter_strength_from_delta(sharpness: int, delta: int) -> int:
    """Smallest filter level for which the filter modifies a step of `delta`
    (mirrors libwebp VP8FilterStrengthFromDelta's closed form)."""
    pos = max(0, min(63, delta))
    if sharpness == 0:
        return pos
    # For sharpness > 0 the table is generated from the ilevel clamping rule.
    for level in range(64):
        ilevel = level
        ilevel >>= 2 if sharpness > 4 else 1
        ilevel = min(ilevel, 9 - sharpness)
        ilevel = max(1, ilevel)
        if 2 * level + ilevel >= 3 * pos:  # filter limit covers the delta
            return level
    return 63


class VP8Encoder:
    """Encodes Y/U/V planes (uint8, padded to MB multiples) to a VP8 frame."""

    def __init__(self, y: np.ndarray, u: np.ndarray, v: np.ndarray,
                 width: int, height: int, cfg: LossyConfig):
        self.cfg = cfg
        self.width, self.height = width, height
        self.mb_w = (width + 15) >> 4
        self.mb_h = (height + 15) >> 4
        assert y.shape == (self.mb_h * 16, self.mb_w * 16)
        assert u.shape == (self.mb_h * 8, self.mb_w * 8)
        self.srcY, self.srcU, self.srcV = y, u, v

        # Analysis pass: segments + SNS quantizer modulation + UV deltas
        # (encode_analysis.go analysis()/setSegmentParams flow).
        num_segs = max(1, min(4, cfg.segments)) if cfg.method >= 1 else 1
        from .analysis import plan_segments

        self.plan = plan_segments(
            y, u, v, self.mb_w, self.mb_h, cfg.quality, num_segs,
            cfg.sns_strength, cfg.filter_strength, cfg.filter_sharpness,
            preprocessing=getattr(cfg, "preprocessing", 0))
        self.num_segments = self.plan.num_segments
        self.segment_map = self.plan.segment_map.reshape(self.mb_h, self.mb_w)
        self.base_q = self.plan.quant[0]

        # Per-segment quantizers + lambdas (setupSegment, encode.go:1084).
        dc_t, ac_t, ac2_t = T.DC_TABLE, T.AC_TABLE, T.AC_TABLE2
        clip = lambda v, m: max(0, min(m, v))
        self.seg_q = []
        for s in range(4):
            q = self.plan.quant[s]
            y1 = SegmentQuant.make(int(dc_t[q]), int(ac_t[q]), 0, sharpen=True)
            y2dc = max(8, int(dc_t[q]) * 2)
            y2 = SegmentQuant.make(y2dc, int(ac2_t[q]), 1)
            uvq_dc = int(dc_t[clip(q + self.plan.dq_uv_dc, 117)])
            uvq_ac = int(ac_t[clip(q + self.plan.dq_uv_ac, 127)])
            uv = SegmentQuant.make(uvq_dc, uvq_ac, 2)
            y1dc, y1ac = int(dc_t[q]), int(ac_t[q])
            q_i4 = (y1dc + 15 * y1ac + 8) >> 4
            q_i16 = (y2dc + 15 * int(ac2_t[q]) + 8) >> 4
            q_uv = (uvq_dc + 15 * uvq_ac + 8) >> 4
            lam = {
                "i4": max((3 * q_i4 * q_i4) >> 7, 1),
                "i16": max(3 * q_i16 * q_i16, 1),
                "uv": max((3 * q_uv * q_uv) >> 6, 1),
                "mode": max((1 * q_i4 * q_i4) >> 7, 1),
                "i4_penalty": 1000 * q_i4 * q_i4,
            }
            self.seg_q.append((y1, y2, uv, lam))
        # Segment-0 aliases (single-segment fast paths + device encoder).
        self.y1, self.y2, self.uv, lam0 = self.seg_q[0]
        self.lambda_i4 = lam0["i4"]
        self.lambda_i16 = lam0["i16"]
        self.lambda_uv = lam0["uv"]
        self.lambda_mode = lam0["mode"]
        self.i4_penalty = lam0["i4_penalty"]

        # Filter header (encode.go:1276-1320).
        self.filter_sharpness = max(0, min(7, cfg.filter_sharpness))
        self.filter_simple = cfg.filter_type == 0
        self.filter_level = self.plan.fstrength[0] if cfg.filter_strength > 0 else 0

        self.num_parts = 1 << max(0, min(3, cfg.partitions))

        # I4 header-bit budget per MB (libwebp mb_header_limit_ analog,
        # webp_enc.c InitVP8Encoder): partition_limit [0..100] scales the
        # quadratic (100-limit)^2/100^2 factor; at 100 I4 is disabled.
        pl = max(0, min(100, getattr(cfg, "partition_limit", 0)))
        mbs_total = max(1, self.mb_w * self.mb_h)
        self.i4_header_cap = (256 * 510 * 8 * 1024 // mbs_total) \
            * (100 - pl) ** 2 // 10000

        mbs = self.mb_h * self.mb_w
        self.is_i4 = np.zeros((self.mb_h, self.mb_w), dtype=bool)
        self.imodes = np.zeros((self.mb_h, self.mb_w, 16), dtype=np.uint8)
        self.uvmode = np.zeros((self.mb_h, self.mb_w), dtype=np.uint8)
        self.skip = np.zeros((self.mb_h, self.mb_w), dtype=bool)
        # Quantized levels per MB: 24 blocks of 16 (zigzag order) + Y2 block.
        self.levels = np.zeros((self.mb_h, self.mb_w, 24, 16), dtype=np.int32)
        self.y2_levels = np.zeros((self.mb_h, self.mb_w, 16), dtype=np.int32)

        # Reconstruction planes (context for prediction).
        self.recY = np.zeros_like(y)
        self.recU = np.zeros_like(u)
        self.recV = np.zeros_like(v)

    # ------------------------------------------------------------------
    # Per-MB encode: mode pick + transform + quantize + reconstruct.
    # ------------------------------------------------------------------
    def _mb_halo(self, plane, x0, y0, size, mb_x, mb_y, tr_count):
        B = np.zeros((size + 1, size + 1 + tr_count), dtype=np.int32)
        if mb_y == 0:
            B[0, :] = 127
        else:
            B[0, 1 : size + 1] = plane[y0 - 1, x0 : x0 + size]
            B[0, 0] = plane[y0 - 1, x0 - 1] if mb_x > 0 else 129
            if tr_count:
                if mb_x >= self.mb_w - 1:
                    B[0, size + 1 :] = plane[y0 - 1, x0 + size - 1]
                else:
                    B[0, size + 1 :] = plane[y0 - 1, x0 + size : x0 + size + tr_count]
        if mb_x == 0:
            B[1:, 0] = 129
        else:
            B[1 : size + 1, 0] = plane[y0 : y0 + size, x0 - 1]
        return B

    @staticmethod
    def _check_mode(mb_x, mb_y, mode):
        if mode == dsp.DC_PRED:
            if mb_x == 0:
                return dsp.DC_NO_TOPLEFT if mb_y == 0 else dsp.DC_NO_LEFT
            return dsp.DC_NO_TOP if mb_y == 0 else dsp.DC_PRED
        return mode

    def _rd_score(self, lam: int, rate: int, disto: int) -> int:
        return rate * lam + 256 * disto

    def _encode_mb(self, mb_x: int, mb_y: int) -> None:
        from . import cost as C

        y0, x0 = mb_y * 16, mb_x * 16
        src = self.srcY[y0 : y0 + 16, x0 : x0 + 16].astype(np.int32)
        B = self._mb_halo(self.recY, x0, y0, 16, mb_x, mb_y, 4)
        top = B[0, 1:17]
        left = B[1:17, 0]
        topleft = int(B[0, 0])
        ct = self.cost_tables
        proba = self.proba
        seg = int(self.segment_map[mb_y, mb_x])
        y1q, y2q, uvq, lam = self.seg_q[seg]

        # nz contexts from neighbors (for rate estimation).
        tnz = int(self.top_nz[mb_x])
        lnz = int(self.left_nz)
        tdc, ldc = int(self.top_nz_dc[mb_x]), int(self.left_nz_dc)

        # ---- I16: full RD over the 4 whole-block modes. Methods 0-1 pick
        # the mode by prediction-domain SSE and only encode the winner
        # (reference encode.go: low methods run without rd-opt).
        src_b = src.reshape(4, 4, 4, 4).transpose(0, 2, 1, 3).reshape(16, 4, 4)
        if self.cfg.method <= 1:
            best_sse = None
            pick = 0
            for mode in range(4):
                m = self._check_mode(mb_x, mb_y, mode)
                pred = dsp.pred_block(m, 16, top, left, topleft)
                sse = int(((src - pred) ** 2).sum())
                if best_sse is None or sse < best_sse:
                    best_sse, pick = sse, mode
            mode_range = range(pick, pick + 1)
        else:
            mode_range = range(4)
        best = None
        for mode in mode_range:
            m = self._check_mode(mb_x, mb_y, mode)
            pred = dsp.pred_block(m, 16, top, left, topleft)
            pred_b = pred.reshape(4, 4, 4, 4).transpose(0, 2, 1, 3).reshape(16, 4, 4)
            coeffs = dsp.fdct4x4(src_b, pred_b).reshape(16, 16)
            wht = dsp.fwht4x4(coeffs[:, 0].reshape(4, 4)).reshape(16)
            y2_lv, y2_dq, _ = quantize_block(wht, y2q)
            rec_dcs = dsp.wht4x4(y2_dq.reshape(4, 4)).reshape(16)
            lv, dq, _ = quantize_block(coeffs, y1q, first=1)
            dq = dq.copy()
            dq[:, 0] = rec_dcs
            rec = np.clip(pred_b + dsp.idct4x4(dq.reshape(16, 4, 4)), 0, 255)
            disto = int(((src_b - rec) ** 2).sum())
            rate = C.residual_cost(y2_lv, 0, tdc + ldc, 1, ct, proba)
            rate += self._luma_rate(lv, 1, 0, tnz, lnz, ct, proba)
            rate += FIXED_COSTS_I16[mode]
            score = self._rd_score(lam["i16"], rate, disto)
            if best is None or score < best[0]:
                best = (score, mode, lv, y2_lv, rec, coeffs, pred_b, rec_dcs,
                        rate, disto)
        (i16_score, i16_mode, i16_lv, i16_y2lv, rec16,
         i16_coeffs, i16_pred_b, i16_rec_dcs, i16_rate, i16_disto) = best
        # The I4-vs-I16 split compares both candidates at lambda_mode
        # (reference pickBestModeParallel, encode_parallel.go:565-571:
        # bestScore16 = RDScore(disto16, rate16, seg.LambdaMode)); the
        # per-candidate searches above/below keep their own lambdas.
        i16_score_mode = self._rd_score(lam["mode"], i16_rate, i16_disto)

        # Trellis refinement of the chosen I16 AC blocks (method >= 5).
        if self.cfg.method >= 5:
            from .quant import trellis_quantize_block

            tlam = max((  # TLambdaI16 (encode.go:1125)
                ((y1q.q[0] + 15 * y1q.q[1] + 8) >> 4) ** 2) >> 2, 1)
            nzg = np.zeros((4, 4), dtype=np.int32)
            lv_new = i16_lv.copy()
            dq_new = np.zeros((16, 16), dtype=np.int32)
            for bi in range(16):
                by, bx = bi >> 2, bi & 3
                t_ctx = ((tnz >> bx) & 1) if by == 0 else nzg[by - 1, bx]
                l_ctx = ((lnz >> by) & 1) if bx == 0 else nzg[by, bx - 1]
                lvb, dqb = trellis_quantize_block(
                    i16_coeffs[bi], y1q, 1, 0, t_ctx + l_ctx, proba, tlam)
                lv_new[bi] = lvb
                dq_new[bi] = dqb
                nzg[by, bx] = 1 if (lvb[1:] != 0).any() else 0
            dq_new[:, 0] = i16_rec_dcs
            rec16 = np.clip(i16_pred_b + dsp.idct4x4(dq_new.reshape(16, 4, 4)),
                            0, 255)
            i16_lv = lv_new

        use_i4 = False
        if self.cfg.i4_blocks and self.cfg.method >= 3:
            r = self._pick_i4(src, B, mb_x, mb_y, i16_score_mode, tnz, lnz,
                              y1q, lam)
            if r is not None:
                use_i4 = True
                i4_modes, i4_levels, rec4 = r

        if use_i4:
            self.is_i4[mb_y, mb_x] = True
            self.imodes[mb_y, mb_x] = i4_modes
            self.levels[mb_y, mb_x, :16] = i4_levels
            self.y2_levels[mb_y, mb_x] = 0
            self.recY[y0 : y0 + 16, x0 : x0 + 16] = rec4
            luma_nz = int(np.count_nonzero(i4_levels))
        else:
            self.is_i4[mb_y, mb_x] = False
            self.imodes[mb_y, mb_x, 0] = i16_mode
            self.levels[mb_y, mb_x, :16] = i16_lv
            self.y2_levels[mb_y, mb_x] = i16_y2lv
            rec = rec16.reshape(4, 4, 4, 4).transpose(0, 2, 1, 3).reshape(16, 16)
            self.recY[y0 : y0 + 16, x0 : x0 + 16] = rec
            luma_nz = int(np.count_nonzero(i16_lv)) + int(np.count_nonzero(i16_y2lv))

        # ---- Chroma RD: 4 modes with real rates.
        yc0, xc0 = mb_y * 8, mb_x * 8
        srcU = self.srcU[yc0 : yc0 + 8, xc0 : xc0 + 8].astype(np.int32)
        srcV = self.srcV[yc0 : yc0 + 8, xc0 : xc0 + 8].astype(np.int32)
        Bu = self._mb_halo(self.recU, xc0, yc0, 8, mb_x, mb_y, 0)
        Bv = self._mb_halo(self.recV, xc0, yc0, 8, mb_x, mb_y, 0)
        if self.cfg.method <= 1:
            # Prediction-domain SSE pick (same shortcut as I16 above).
            best_sse = None
            pick = 0
            for mode in range(4):
                m = self._check_mode(mb_x, mb_y, mode)
                pu = dsp.pred_block(m, 8, Bu[0, 1:9], Bu[1:9, 0], int(Bu[0, 0]))
                pv = dsp.pred_block(m, 8, Bv[0, 1:9], Bv[1:9, 0], int(Bv[0, 0]))
                sse = int(((srcU - pu) ** 2).sum()) + \
                    int(((srcV - pv) ** 2).sum())
                if best_sse is None or sse < best_sse:
                    best_sse, pick = sse, mode
            uv_range = range(pick, pick + 1)
        else:
            uv_range = range(4)
        best = None
        for mode in uv_range:
            m = self._check_mode(mb_x, mb_y, mode)
            pu = dsp.pred_block(m, 8, Bu[0, 1:9], Bu[1:9, 0], int(Bu[0, 0]))
            pv = dsp.pred_block(m, 8, Bv[0, 1:9], Bv[1:9, 0], int(Bv[0, 0]))
            disto = 0
            rate = FIXED_COSTS_UV[mode]
            lvs = []
            recs = []
            for plane_src, pred, ch in ((srcU, pu, 0), (srcV, pv, 2)):
                sb = plane_src.reshape(2, 4, 2, 4).transpose(0, 2, 1, 3).reshape(4, 4, 4)
                pb = pred.reshape(2, 4, 2, 4).transpose(0, 2, 1, 3).reshape(4, 4, 4)
                coeffs = dsp.fdct4x4(sb, pb).reshape(4, 16)
                lv, dq, _ = quantize_block(coeffs, uvq)
                rec = np.clip(pb + dsp.idct4x4(dq.reshape(4, 4, 4)), 0, 255)
                disto += int(((sb - rec) ** 2).sum())
                rate += self._uv_rate(lv, ch, tnz, lnz, ct, proba)
                lvs.append(lv)
                recs.append(rec)
            score = self._rd_score(lam["uv"], rate, disto)
            if best is None or score < best[0]:
                best = (score, mode, lvs, recs)
        _, uv_mode, lvs, recs = best
        self.uvmode[mb_y, mb_x] = uv_mode
        uv_nz = 0
        for (lv, rec, rec_plane, base) in ((lvs[0], recs[0], self.recU, 16),
                                           (lvs[1], recs[1], self.recV, 20)):
            self.levels[mb_y, mb_x, base : base + 4] = lv
            r8 = rec.reshape(2, 2, 4, 4).transpose(0, 2, 1, 3).reshape(8, 8)
            rec_plane[yc0 : yc0 + 8, xc0 : xc0 + 8] = r8
            uv_nz += int(np.count_nonzero(lv))

        self.skip[mb_y, mb_x] = (luma_nz + uv_nz) == 0
        # Update nz context state (exact, same packing as the token writer).
        out = self._write_mb_tokens(None, mb_x, mb_y, int(self.top_nz[mb_x]),
                                    int(self.left_nz), int(self.top_nz_dc[mb_x]),
                                    int(self.left_nz_dc))
        self.top_nz[mb_x], self.left_nz, self.top_nz_dc[mb_x], self.left_nz_dc = out

    def _luma_rate(self, lv, first, ptype, tnz, lnz, ct, proba) -> int:
        from . import cost as C

        rate = 0
        tnz &= 0x0F
        lnz &= 0x0F
        for y in range(4):
            l = lnz & 1
            for x in range(4):
                bi = y * 4 + x
                ctx = l + (tnz & 1)
                rate += C.residual_cost(lv[bi], first, ctx, ptype, ct, proba)
                l = 1 if (lv[bi][first:] != 0).any() else 0
                tnz = (tnz >> 1) | (l << 7)
            tnz >>= 4
            lnz = (lnz >> 1) | (l << 7)
        return rate

    def _uv_rate(self, lv, ch, tnz_in, lnz_in, ct, proba) -> int:
        from . import cost as C

        rate = 0
        tnz = tnz_in >> (4 + ch)
        lnz = lnz_in >> (4 + ch)
        for y in range(2):
            l = lnz & 1
            for x in range(2):
                bi = y * 2 + x
                ctx = l + (tnz & 1)
                rate += C.residual_cost(lv[bi], 0, ctx, 2, ct, proba)
                l = 1 if (lv[bi] != 0).any() else 0
                tnz = (tnz >> 1) | (l << 3)
            tnz >>= 2
            lnz = (lnz >> 1) | (l << 5)
        return rate

    def _pick_i4(self, src, B, mb_x, mb_y, i16_score, tnz_in, lnz_in,
                 y1q=None, lam=None):
        """Sequential 4x4 RD mode search; None if I16 wins."""
        if y1q is None:
            y1q, lam = self.y1, {"i4": self.lambda_i4,
                                 "mode": self.lambda_mode,
                                 "i4_penalty": self.i4_penalty}
        from . import cost as C

        ct = self.cost_tables
        proba = self.proba
        modes = np.zeros(16, dtype=np.uint8)
        levels = np.zeros((16, 16), dtype=np.int32)
        work = B.copy()
        mb_tr = B[0, 17:21].copy()
        # Mode context (top/left B-modes) for mode signalling cost.
        top_modes = self._top_bmodes[mb_x].copy()
        left_modes = self._left_bmodes.copy()
        # nz context within the MB for rate estimation.
        tnz = tnz_in & 0x0F
        lnz = lnz_in & 0x0F
        total_rate = 211  # i4 signalling overhead (libwebp's constant)
        total_disto = 0
        total_header = 0
        cap = self.i4_header_cap
        if cap <= 0:
            return None
        lam_i4 = lam["i4"]
        # Accumulated-total comparisons against the (lambda_mode-scored)
        # I16 candidate run at lambda_mode too — reference
        # tryI4ModesRDParallel, encode_parallel.go:808.
        lam_mode = lam["mode"]
        for n in range(16):
            r, c = n >> 2, n & 3
            top = work[r * 4, 1 + c * 4 : 5 + c * 4]
            left = work[1 + r * 4 : 5 + r * 4, c * 4]
            topleft = int(work[r * 4, c * 4])
            tr = work[r * 4, 5 + c * 4 : 9 + c * 4] if c < 3 else mb_tr
            sblk = src[r * 4 : r * 4 + 4, c * 4 : c * 4 + 4]
            ctx = (lnz >> r) & 1
            ctx += (tnz >> c) & 1
            tmode = int(top_modes[c])
            lmode = int(left_modes[r])
            best = None
            for mode in range(10):
                pred = dsp.pred_luma4(mode, top, left, topleft, tr)
                coeffs = dsp.fdct4x4(sblk, pred).reshape(16)
                lv, dq, _ = quantize_block(coeffs, y1q)
                rec = np.clip(pred + dsp.idct4x4(dq.reshape(4, 4)), 0, 255)
                disto = int(((sblk - rec) ** 2).sum())
                rate = C.residual_cost(lv, 0, ctx, 3, ct, proba)
                rate += int(C.FIXED_COSTS_I4[tmode, lmode, mode])
                score = self._rd_score(lam_i4, rate, disto)
                if best is None or score < best[0]:
                    best = (score, mode, lv, rec, disto, rate)
            _, mode, lv, rec, disto, rate = best
            if self.cfg.method >= 4:
                from .quant import trellis_quantize_block

                pred = dsp.pred_luma4(int(mode), top, left, topleft, tr)
                coeffs = dsp.fdct4x4(sblk, pred).reshape(16)
                tlam = max((7 * ((y1q.q[0] + 15 * y1q.q[1] + 8) >> 4) ** 2) >> 3, 1)
                lv_t, dq_t = trellis_quantize_block(
                    coeffs, y1q, 0, 3, ctx, proba, int(tlam))
                rec = np.clip(pred + dsp.idct4x4(dq_t.reshape(4, 4)), 0, 255)
                lv = lv_t
            modes[n] = mode
            levels[n] = lv
            work[1 + r * 4 : 5 + r * 4, 1 + c * 4 : 5 + c * 4] = rec
            total_disto += disto
            total_rate += rate
            nz = 1 if (lv != 0).any() else 0
            tnz = (tnz & ~(1 << c)) | (nz << c)
            lnz = (lnz & ~(1 << r)) | (nz << r)
            top_modes[c] = mode
            left_modes[r] = mode
            total_header += int(C.FIXED_COSTS_I4[tmode, lmode, mode])
            if total_header > cap:
                return None
            if self._rd_score(lam_mode, total_rate, total_disto) >= i16_score:
                return None
        if self._rd_score(lam_mode, total_rate, total_disto) >= i16_score:
            return None
        self._top_bmodes[mb_x] = top_modes
        self._left_bmodes = left_modes
        return modes, levels, work[1:17, 1:17]

    # ------------------------------------------------------------------
    # Token writing.
    # ------------------------------------------------------------------
    def _put_coeffs(self, bw: BoolWriter, ptype: int, ctx: int,
                    levels: np.ndarray, first: int) -> int:
        """Writes one block's tokens (levels in zigzag order). Returns 1 if
        the block has any non-zero coefficient (the nz context bit)."""
        proba = self.proba
        bands = T.BANDS
        lv = levels
        last = -1
        for i in range(15, first - 1, -1):
            if lv[i]:
                last = i
                break
        n = first
        p = proba[ptype, bands[n], ctx]
        if last < first:
            bw.put_bit(int(p[0]), 0)
            return 0
        while n <= last:
            bw.put_bit(int(p[0]), 1)
            # Zero run.
            while lv[n] == 0:
                bw.put_bit(int(p[1]), 0)
                n += 1
                p = proba[ptype, bands[n], 0]
            bw.put_bit(int(p[1]), 1)
            v = int(abs(lv[n]))
            sign = lv[n] < 0
            if v == 1:
                bw.put_bit(int(p[2]), 0)
                next_ctx = 1
            else:
                bw.put_bit(int(p[2]), 1)
                if v <= 4:
                    bw.put_bit(int(p[3]), 0)
                    if v == 2:
                        bw.put_bit(int(p[4]), 0)
                    else:
                        bw.put_bit(int(p[4]), 1)
                        bw.put_bit(int(p[5]), v - 3)
                elif v <= 10:
                    bw.put_bit(int(p[3]), 1)
                    bw.put_bit(int(p[6]), 0)
                    if v <= 6:
                        bw.put_bit(int(p[7]), 0)
                        bw.put_bit(159, v - 5)
                    else:
                        bw.put_bit(int(p[7]), 1)
                        bw.put_bit(165, (v - 7) >> 1)
                        bw.put_bit(145, (v - 7) & 1)
                else:
                    bw.put_bit(int(p[3]), 1)
                    bw.put_bit(int(p[6]), 1)
                    if v <= 18:
                        cat = 0
                    elif v <= 34:
                        cat = 1
                    elif v <= 66:
                        cat = 2
                    else:
                        cat = 3
                    bw.put_bit(int(p[8]), cat >> 1)
                    bw.put_bit(int(p[9 + (cat >> 1)]), cat & 1)
                    extra = v - 3 - (8 << cat)
                    nbits = len(T.CAT3456[cat])
                    for b in range(nbits - 1, -1, -1):
                        bw.put_bit(T.CAT3456[cat][nbits - 1 - b], (extra >> b) & 1)
                next_ctx = 2
            bw.put_bit(0x80, 1 if sign else 0)
            n += 1
            if n == 16:
                return 1
            p = proba[ptype, bands[n], next_ctx]
        bw.put_bit(int(p[0]), 0)
        return 1

    def _emit_tokens(self, part_idx: int) -> bytes:
        """Emits token data for all MB rows assigned to partition part_idx."""
        from ..native import api as native

        if native.available():
            nmb = self.mb_h * self.mb_w
            return native.emit_tokens(
                self.levels.reshape(nmb, 24, 16),
                self.y2_levels.reshape(nmb, 16),
                self.is_i4.reshape(nmb), self.skip.reshape(nmb),
                self.proba.astype(np.uint8), self.mb_w, self.mb_h,
                self.use_skip, part_idx, self.num_parts)
        bw = BoolWriter()
        mb_w, mb_h = self.mb_w, self.mb_h
        # nz context state must be tracked per partition from its own rows?
        # No: contexts chain across rows; recompute globally, emit selectively.
        top_nz = np.zeros(mb_w, dtype=np.uint32)
        top_nz_dc = np.zeros(mb_w, dtype=np.uint8)
        for mb_y in range(mb_h):
            mine = (mb_y & (self.num_parts - 1)) == part_idx
            left_nz = 0
            left_nz_dc = 0
            for mb_x in range(mb_w):
                if self.use_skip and self.skip[mb_y, mb_x]:
                    left_nz = 0
                    top_nz[mb_x] = 0
                    if not self.is_i4[mb_y, mb_x]:
                        left_nz_dc = 0
                        top_nz_dc[mb_x] = 0
                    continue
                out = self._write_mb_tokens(
                    bw if mine else None, mb_x, mb_y,
                    int(top_nz[mb_x]), left_nz, int(top_nz_dc[mb_x]), left_nz_dc)
                top_nz[mb_x], left_nz, tdc, left_nz_dc = out
                top_nz_dc[mb_x] = tdc
        return bw.finish()

    def _write_mb_tokens(self, bw, mb_x, mb_y, tnz_in, lnz_in, tdc, ldc):
        """Writes (or dry-runs for context tracking) one MB's tokens."""
        lv = self.levels[mb_y, mb_x]

        class _Null:
            def put_bit(self, p, b):
                return b

        sink = bw if bw is not None else _Null()
        if not self.is_i4[mb_y, mb_x]:
            ctx = tdc + ldc
            nz = self._put_coeffs(sink, 1, ctx, self.y2_levels[mb_y, mb_x], 0)
            tdc = ldc = nz
            first, ptype = 1, 0
        else:
            first, ptype = 0, 3

        tnz = tnz_in & 0x0F
        lnz = lnz_in & 0x0F
        for y in range(4):
            l = lnz & 1
            for x in range(4):
                bi = y * 4 + x
                ctx = l + (tnz & 1)
                l = self._put_coeffs(sink, ptype, ctx, lv[bi], first)
                tnz = (tnz >> 1) | (l << 7)
            tnz >>= 4
            lnz = (lnz >> 1) | (l << 7)
        out_tnz = tnz
        out_lnz = lnz >> 4

        for ch in (0, 2):
            tnz = tnz_in >> (4 + ch)
            lnz = lnz_in >> (4 + ch)
            for y in range(2):
                l = lnz & 1
                for x in range(2):
                    bi = 16 + ch * 2 + y * 2 + x
                    ctx = l + (tnz & 1)
                    l = self._put_coeffs(sink, 2, ctx, lv[bi], 0)
                    tnz = (tnz >> 1) | (l << 3)
                tnz >>= 2
                lnz = (lnz >> 1) | (l << 5)
            out_tnz |= (tnz << 4) << ch
            out_lnz |= (lnz & 0xF0) << ch
        return out_tnz, out_lnz, tdc, ldc

    # ------------------------------------------------------------------
    # Autofilter: in-loop filter strength search (libwebp -af analog).
    # ------------------------------------------------------------------
    def _seg_filter_levels(self, fs: int) -> list:
        """Per-segment filter levels for config strength fs (the same
        formula plan_segments/finalize_device_plan use)."""
        level0 = 5 * max(0, min(100, fs))
        sharp = self.filter_sharpness
        out = []
        for i in range(4):
            q = max(0, min(127, self.plan.quant[i]))
            qstep = int(T.AC_TABLE[q]) >> 2
            base = _filter_strength_from_delta(sharp, qstep)
            f = base * level0 // (256 + self.plan.beta[i])
            out.append(0 if f < 2 else min(f, 63))
        return out

    def _filter_score(self, levels4, coords, inner_map) -> float:
        """Luma SSE vs source of the sampled MB cores after filtering a
        recon copy at the given per-segment levels."""
        sharp = self.filter_sharpness
        infos = []
        for lv in levels4:
            lv = max(0, min(63, lv))
            if lv == 0:
                infos.append(None)
                continue
            il = lv
            if sharp > 0:
                il >>= 2 if sharp > 4 else 1
                il = min(il, 9 - sharp)
            il = max(1, il)
            hev = 2 if lv >= 40 else (1 if lv >= 15 else 0)
            infos.append((2 * lv + il, il, hev))
        Y = self.recY.copy()
        for (mb_y, mb_x) in coords:
            fi = infos[int(self.segment_map[mb_y, mb_x]) & 3]
            if fi is None:
                continue
            limit, il, hev = fi
            inner = inner_map[mb_y, mb_x]
            x0, y0 = mb_x * 16, mb_y * 16
            if self.filter_simple:
                if mb_x > 0:
                    dsp.filter_edge_simple(Y, False, x0, y0, 16, limit + 4)
                if inner:
                    for k in (4, 8, 12):
                        dsp.filter_edge_simple(Y, False, x0 + k, y0, 16, limit)
                if mb_y > 0:
                    dsp.filter_edge_simple(Y, True, y0, x0, 16, limit + 4)
                if inner:
                    for k in (4, 8, 12):
                        dsp.filter_edge_simple(Y, True, y0 + k, x0, 16, limit)
            else:
                if mb_x > 0:
                    dsp.filter_edge_complex(Y, False, x0, y0, 16, limit + 4,
                                            il, hev, False)
                if inner:
                    for k in (4, 8, 12):
                        dsp.filter_edge_complex(Y, False, x0 + k, y0, 16,
                                                limit, il, hev, True)
                if mb_y > 0:
                    dsp.filter_edge_complex(Y, True, y0, x0, 16, limit + 4,
                                            il, hev, False)
                if inner:
                    for k in (4, 8, 12):
                        dsp.filter_edge_complex(Y, True, y0 + k, x0, 16,
                                                limit, il, hev, True)
        sse = 0.0
        for (mb_y, mb_x) in coords:
            y0, x0 = mb_y * 16, mb_x * 16
            d = (Y[y0:y0 + 16, x0:x0 + 16].astype(np.int64)
                 - self.srcY[y0:y0 + 16, x0:x0 + 16].astype(np.int64))
            sse += float((d * d).sum())
        return sse

    def autofilter_search(self) -> None:
        """Searches the filter_strength knob for the setting whose in-loop
        filtered reconstruction is closest to the source (sampled MBs,
        luma), then rewrites the per-segment strengths and header level.
        Stands in for libwebp's autofilter (VP8StoreFilterStats +
        VP8AdjustFilterStrength); the reference Go encoder has no analog,
        so the criterion here is the sampled-core SSE."""
        # Sample at most ~256 MBs on a uniform grid (the reference-style
        # every-other-MB sampling, thinned further for big images).
        step = 1
        while (self.mb_h // step + 1) * (self.mb_w // step + 1) > 256:
            step += 1
        coords = [(y, x) for y in range(0, self.mb_h, step)
                  for x in range(0, self.mb_w, step)]
        inner_map = self.is_i4 | ~self.skip
        cache = {}

        def score_fs(fs):
            lv = tuple(self._seg_filter_levels(fs))
            if lv not in cache:
                cache[lv] = self._filter_score(lv, coords, inner_map)
            return cache[lv]

        coarse = [0, 10, 25, 40, 60, 80, 100]
        best_fs = min(coarse, key=score_fs)
        for fs in range(max(0, best_fs - 8), min(100, best_fs + 8) + 1, 4):
            if score_fs(fs) < score_fs(best_fs):
                best_fs = fs
        new_lv = self._seg_filter_levels(best_fs)
        for i in range(4):
            self.plan.fstrength[i] = new_lv[i]
        self.filter_level = new_lv[0]

    # ------------------------------------------------------------------
    # Syntax: partition 0.
    # ------------------------------------------------------------------
    def _emit_partition0(self) -> bytes:
        """Partition 0 in one native call (native/api.py
        write_partition0): the frame header, the coefficient-probability
        updates of self.proba against COEFFS_PROBA0 and the MB modes."""
        from ..native import api as native

        nmb = self.mb_h * self.mb_w
        plan = self.plan
        return native.write_partition0(
            self.num_segments, plan.quant, plan.fstrength, plan.probas,
            self.filter_simple, self.filter_level, self.filter_sharpness,
            {1: 0, 2: 1, 4: 2, 8: 3}[self.num_parts], self.base_q,
            plan.dq_uv_dc, plan.dq_uv_ac, self.proba, self.num_skip > 0,
            self.skip_proba, self.imodes.reshape(nmb, 16),
            self.is_i4.reshape(nmb), self.uvmode.reshape(nmb),
            self.skip.reshape(nmb), self.segment_map.reshape(nmb),
            self.mb_w, self.mb_h)

    # ------------------------------------------------------------------
    # Probability optimization (parity with encode_proba.go optimizeProba).
    # ------------------------------------------------------------------
    class _StatsSink:
        """put_bit-compatible sink that counts branch events per proba slot."""

        def __init__(self, stats):
            self.stats = stats
            self.slot = None

        def put_bit(self, prob, bit):
            return bit

        def record(self, t, b, c, pi, bit):
            self.stats[t, b, c, pi, bit] += 1

    def _record_stats(self) -> np.ndarray:
        """Counts (bit==0, bit==1) events at every proba branch position."""
        stats = np.zeros((4, 8, 3, 11, 2), dtype=np.int64)
        bands = T.BANDS

        def record(ptype, ctx, levels, first):
            n = first
            last = -1
            for i in range(15, first - 1, -1):
                if levels[i]:
                    last = i
                    break
            if last < first:
                stats[ptype, bands[n], ctx, 0, 0] += 1
                return 0
            # Walk mirrors _put_coeffs branch-for-branch.
            cur_ctx = ctx
            while n <= last:
                stats[ptype, bands[n], cur_ctx, 0, 1] += 1
                while levels[n] == 0:
                    stats[ptype, bands[n], cur_ctx, 1, 0] += 1
                    n += 1
                    cur_ctx = 0
                stats[ptype, bands[n], cur_ctx, 1, 1] += 1
                v = abs(int(levels[n]))
                p = (ptype, bands[n], cur_ctx)
                if v == 1:
                    stats[p[0], p[1], p[2], 2, 0] += 1
                    nxt = 1
                else:
                    stats[p[0], p[1], p[2], 2, 1] += 1
                    if v <= 4:
                        stats[p[0], p[1], p[2], 3, 0] += 1
                        stats[p[0], p[1], p[2], 4, 0 if v == 2 else 1] += 1
                        if v != 2:
                            stats[p[0], p[1], p[2], 5, v - 3] += 1
                    elif v <= 10:
                        stats[p[0], p[1], p[2], 3, 1] += 1
                        stats[p[0], p[1], p[2], 6, 0] += 1
                        stats[p[0], p[1], p[2], 7, 0 if v <= 6 else 1] += 1
                    else:
                        stats[p[0], p[1], p[2], 3, 1] += 1
                        stats[p[0], p[1], p[2], 6, 1] += 1
                        cat = 0 if v <= 18 else (1 if v <= 34 else (2 if v <= 66 else 3))
                        stats[p[0], p[1], p[2], 8, cat >> 1] += 1
                        stats[p[0], p[1], p[2], 9 + (cat >> 1), cat & 1] += 1
                    nxt = 2
                n += 1
                cur_ctx = nxt
            if n < 16:
                stats[ptype, bands[n], cur_ctx, 0, 0] += 1
            return 1

        # Walk all MBs with the same context chaining as the token writer.
        top_nz = np.zeros(self.mb_w, dtype=np.uint32)
        top_nz_dc = np.zeros(self.mb_w, dtype=np.uint8)
        for mb_y in range(self.mb_h):
            left_nz = 0
            left_nz_dc = 0
            for mb_x in range(self.mb_w):
                if self.use_skip and self.skip[mb_y, mb_x]:
                    left_nz = 0
                    top_nz[mb_x] = 0
                    if not self.is_i4[mb_y, mb_x]:
                        left_nz_dc = 0
                        top_nz_dc[mb_x] = 0
                    continue
                lv = self.levels[mb_y, mb_x]
                if not self.is_i4[mb_y, mb_x]:
                    ctx = int(top_nz_dc[mb_x]) + left_nz_dc
                    nz = record(1, ctx, self.y2_levels[mb_y, mb_x], 0)
                    top_nz_dc[mb_x] = left_nz_dc = nz
                    first, ptype = 1, 0
                else:
                    first, ptype = 0, 3
                tnz = int(top_nz[mb_x]) & 0x0F
                lnz = left_nz & 0x0F
                for y in range(4):
                    l = lnz & 1
                    for x in range(4):
                        bi = y * 4 + x
                        l = record(ptype, l + (tnz & 1), lv[bi], first)
                        tnz = (tnz >> 1) | (l << 7)
                    tnz >>= 4
                    lnz = (lnz >> 1) | (l << 7)
                out_tnz = tnz
                out_lnz = lnz >> 4
                for ch in (0, 2):
                    tnz = int(top_nz[mb_x]) >> (4 + ch)
                    lnz = left_nz >> (4 + ch)
                    for y in range(2):
                        l = lnz & 1
                        for x in range(2):
                            bi = 16 + ch * 2 + y * 2 + x
                            l = record(2, l + (tnz & 1), lv[bi], 0)
                            tnz = (tnz >> 1) | (l << 3)
                        tnz >>= 2
                        lnz = (lnz >> 1) | (l << 5)
                    out_tnz |= (tnz << 4) << ch
                    out_lnz |= (lnz & 0xF0) << ch
                top_nz[mb_x] = out_tnz
                left_nz = out_lnz
        return stats

    def _optimize_probas(self) -> None:
        from .cost import bit_cost
        from ..native import api as native

        if native.available():
            nmb = self.mb_h * self.mb_w
            stats = native.record_stats(
                self.levels.reshape(nmb, 24, 16),
                self.y2_levels.reshape(nmb, 16),
                self.is_i4.reshape(nmb), self.skip.reshape(nmb),
                self.mb_w, self.mb_h, self.use_skip)
        else:
            stats = self._record_stats()
        proba = T.COEFFS_PROBA0.copy()
        upd = T.COEFFS_UPDATE_PROBA
        for t in range(4):
            for b in range(8):
                for c in range(3):
                    for pi in range(11):
                        n0, n1 = int(stats[t, b, c, pi, 0]), int(stats[t, b, c, pi, 1])
                        total = n0 + n1
                        if total == 0:
                            continue
                        old_p = int(proba[t, b, c, pi])
                        new_p = 255 - n1 * 255 // total if n1 else 255
                        new_p = max(1, min(255, new_p))
                        up = int(upd[t, b, c, pi])
                        old_cost = (n1 * bit_cost(1, old_p) + n0 * bit_cost(0, old_p)
                                    + bit_cost(0, up))
                        new_cost = (n1 * bit_cost(1, new_p) + n0 * bit_cost(0, new_p)
                                    + bit_cost(1, up) + 8 * 256)
                        if new_cost < old_cost:
                            proba[t, b, c, pi] = new_p
        self.proba = proba

    def _native_mb_loop(self) -> bool:
        """Runs the closed-loop MB encode in C++ (vp8_enc_loop.cc).
        Returns False when the native library is unavailable, in which
        case the caller runs the Python oracle loop."""
        from ..native import api as native

        quant = np.zeros((4, 3, 4, 16), dtype=np.int64)
        lam = np.zeros((4, 3), dtype=np.int64)
        for s in range(4):
            y1, y2, uv, l = self.seg_q[s]
            for ci, sq in enumerate((y1, y2, uv)):
                quant[s, ci, 0] = sq.q
                quant[s, ci, 1] = sq.iq
                quant[s, ci, 2] = sq.bias
                quant[s, ci, 3] = sq.sharpen
            lam[s] = (l["i16"], l["i4"], l["uv"])
        out = native.vp8_encode_mbs(
            self.srcY, self.srcU, self.srcV, self.mb_w, self.mb_h,
            self.segment_map, quant, lam, self.proba, self.cost_tables,
            self.cfg.method, self.cfg.i4_blocks and self.cfg.method >= 3,
            self.i4_header_cap)
        if out is None:
            return False
        sh = (self.mb_h, self.mb_w)
        self.levels = out["levels"].reshape(*sh, 24, 16)
        self.y2_levels = out["y2_levels"].reshape(*sh, 16)
        self.is_i4 = out["is_i4"].reshape(sh).astype(bool)
        self.imodes = out["imodes"].reshape(*sh, 16)
        self.uvmode = out["uvmode"].reshape(sh)
        self.skip = out["skip"].reshape(sh).astype(bool)
        self.recY = out["recY"]
        self.recU = out["recU"]
        self.recV = out["recV"]
        return True

    # ------------------------------------------------------------------
    def encode(self) -> bytes:
        self.proba = T.COEFFS_PROBA0.copy()
        from .cost import compute_level_cost_tables

        self.cost_tables = compute_level_cost_tables(self.proba)
        self.top_nz = np.zeros(self.mb_w, dtype=np.uint32)
        self.top_nz_dc = np.zeros(self.mb_w, dtype=np.uint8)
        self._top_bmodes = np.zeros((self.mb_w, 4), dtype=np.uint8)
        self.use_skip = False  # during encode pass, contexts chain as if no skip

        # Wavefront-ordered MB encode. The C++ loop (native/src/
        # vp8_enc_loop.cc) is the production path; the Python loop below is
        # its conformance oracle (bit-identical, tests/test_native_parity.py).
        if not self._native_mb_loop():
            for mb_y in range(self.mb_h):
                self.left_nz = 0
                self.left_nz_dc = 0
                self._left_bmodes = np.zeros(4, dtype=np.uint8)
                for mb_x in range(self.mb_w):
                    self._encode_mb(mb_x, mb_y)
                    if not self.is_i4[mb_y, mb_x]:
                        m = int(self.imodes[mb_y, mb_x, 0])
                        self._top_bmodes[mb_x, :] = m
                        self._left_bmodes[:] = m

        self.num_skip = int(self.skip.sum())
        total = self.mb_h * self.mb_w
        self.skip_proba = max(1, min(255, (total - self.num_skip) * 255 // total)) \
            if self.num_skip > 0 else 0
        self.use_skip = self.num_skip > 0
        if not self.use_skip:
            self.skip[:] = False

        if self.cfg.autofilter:
            self.autofilter_search()

        self._optimize_probas()

        part0 = self._emit_partition0()
        self.stats_part0 = len(part0)
        if len(part0) >= (1 << 19):
            # Partition 0 must fit its 19-bit size field. Halve the I4
            # header budget and redo the mode decision (libwebp
            # VP8EncTokenLoop's overflow recovery).
            if self.i4_header_cap > 0:
                self.i4_header_cap >>= 1
                return self.encode()
            raise WebPError("partition 0 overflow")
        parts = [self._emit_tokens(i) for i in range(self.num_parts)]
        self.stats_parts = [len(p) for p in parts]

        # Frame tag + picture header.
        tag = (0) | (0 << 1) | (1 << 4) | (len(part0) << 5)
        out = bytearray([tag & 0xFF, (tag >> 8) & 0xFF, (tag >> 16) & 0xFF])
        out += bytes([0x9D, 0x01, 0x2A])
        out += int(self.width & 0x3FFF).to_bytes(2, "little")
        out += int(self.height & 0x3FFF).to_bytes(2, "little")
        out += part0
        for p in parts[:-1]:
            out += len(p).to_bytes(3, "little")
        for p in parts:
            out += p
        return bytes(out)
