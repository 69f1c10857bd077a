"""The exact host VP8 (lossy) keyframe encoder: the analysis pass
(lossy/analysis.py), the per-segment quantizers and RD lambdas, the
closed-loop MB encode in C++ (native/src/vp8_enc_loop.cc) and the frame
writer (lossy/frame.py). It is the host backend and the device path's
escape-overflow fallback; the device program (ops/fastpath.py) computes
the same fields on the card.

Behavioral parity with the reference internal/lossy/{encode.go,
encode_frame.go,encode_quant.go,encode_syntax.go,encode_token.go}.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from ..container.riff import WebPError
from ..native import api as native
from . import frame as F
from . import tables as T
from .analysis import plan_segments
from .cost import compute_level_cost_tables
from .quant import SegmentQuant


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


class VP8Encoder:
    """Encodes Y/U/V planes (uint8, padded to MB multiples) to a VP8 frame.
    After encode(): the MB fields levels [mb_h, mb_w, 24, 16], y2_levels,
    imodes, uvmode, is_i4, skip; the reconstruction recY/recU/recV; the
    sizes part0_size and token_sizes."""

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
        self.plan = plan_segments(
            y, u, v, self.mb_w, self.mb_h, cfg.quality, num_segs,
            cfg.sns_strength, cfg.filter_strength, cfg.filter_sharpness,
            preprocessing=cfg.preprocessing)

        # Per-segment quantizers (Y1, Y2, UV: q, iq, bias, sharpen) and the
        # I16, I4 and UV lambdas (setupSegment, encode.go:1084).
        dc_t, ac_t, ac2_t = T.DC_TABLE, T.AC_TABLE, T.AC_TABLE2
        clip = lambda v, m: max(0, min(m, v))
        self.quant = np.zeros((4, 3, 4, 16), dtype=np.int64)
        self.lambdas = np.zeros((4, 3), dtype=np.int64)
        for s in range(4):
            q = self.plan.quant[s]
            y1 = SegmentQuant.make(int(dc_t[q]), int(ac_t[q]), 0, sharpen=True)
            y2dc = max(8, int(dc_t[q]) * 2)
            y2 = SegmentQuant.make(y2dc, int(ac2_t[q]), 1)
            uvq_dc = int(dc_t[clip(q + self.plan.dq_uv_dc, 117)])
            uvq_ac = int(ac_t[clip(q + self.plan.dq_uv_ac, 127)])
            uv = SegmentQuant.make(uvq_dc, uvq_ac, 2)
            for ci, sq in enumerate((y1, y2, uv)):
                self.quant[s, ci] = (sq.q, sq.iq, sq.bias, sq.sharpen)
            q_i4 = (int(dc_t[q]) + 15 * int(ac_t[q]) + 8) >> 4
            q_i16 = (y2dc + 15 * int(ac2_t[q]) + 8) >> 4
            q_uv = (uvq_dc + 15 * uvq_ac + 8) >> 4
            self.lambdas[s] = (max(3 * q_i16 * q_i16, 1),
                               max((3 * q_i4 * q_i4) >> 7, 1),
                               max((3 * q_uv * q_uv) >> 6, 1))

        # I4 header-bit budget per MB (libwebp mb_header_limit_ analog,
        # webp_enc.c InitVP8Encoder): partition_limit [0..100] scales the
        # quadratic (100-limit)^2/100^2 factor; at 100 I4 is disabled.
        pl = max(0, min(100, cfg.partition_limit))
        mbs_total = max(1, self.mb_w * self.mb_h)
        self.i4_header_cap = (256 * 510 * 8 * 1024 // mbs_total) \
            * (100 - pl) ** 2 // 10000

    def _frame(self) -> F.Frame:
        """The closed-loop MB encode in C++ (vp8_enc_loop.cc) at the
        current I4 header budget, as a frame to write."""
        cfg = self.cfg
        proba = T.COEFFS_PROBA0
        out = native.vp8_encode_mbs(
            self.srcY, self.srcU, self.srcV, self.mb_w, self.mb_h,
            self.plan.segment_map, self.quant, self.lambdas, proba,
            compute_level_cost_tables(proba), cfg.method,
            cfg.i4_blocks and cfg.method >= 3, self.i4_header_cap)
        sh = (self.mb_h, self.mb_w)
        self.levels = out["levels"].reshape(*sh, 24, 16)
        self.y2_levels = out["y2_levels"].reshape(*sh, 16)
        self.is_i4 = out["is_i4"].reshape(sh).astype(bool)
        self.imodes = out["imodes"].reshape(*sh, 16)
        self.uvmode = out["uvmode"].reshape(sh)
        self.skip = out["skip"].reshape(sh).astype(bool)
        self.recY, self.recU, self.recV = out["recY"], out["recU"], out["recV"]
        return F.Frame(
            self.width, self.height, self.levels, self.y2_levels,
            self.imodes, self.uvmode, self.is_i4, self.skip, self.plan,
            filter_level=self.plan.fstrength[0], **F.cfg_fields(cfg))

    def encode(self) -> bytes:
        while True:
            f = self._frame()
            F.count_skips(f)
            if self.cfg.autofilter:
                F.autofilter_search(f, self.recY, self.srcY)
            parts = F.code_tokens(f)
            part0 = F.partition0(f)
            if len(part0) < (1 << 19):
                break
            # Partition 0 must fit its 19-bit size field. Halve the I4
            # header budget and redo the mode decision (libwebp
            # VP8EncTokenLoop's overflow recovery).
            if self.i4_header_cap <= 0:
                raise WebPError("partition 0 overflow")
            self.i4_header_cap >>= 1
        self.part0_size, self.token_sizes = len(part0), tuple(map(len, parts))
        return F.assemble(f, part0, parts)
