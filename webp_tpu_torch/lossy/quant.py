"""VP8 quantization (encoder side).

QFIX=17 fixed-point bias quantization with per-frequency sharpening,
matching libwebp quant_enc.c semantics (reference: internal/lossy/
encode_quant.go, encode.go:1065-1160).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

QFIX = 17

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
        sh = np.zeros(16, dtype=np.int64)
        if sharpen:
            fs = np.array(FREQ_SHARPENING, dtype=np.int64)
            sh = (fs * q) >> 11
        sq.q, sq.iq, sq.bias, sq.sharpen = q, iq, b, sh
        return sq
