"""Near-lossless preprocessing (vectorized numpy).

Parity with the reference's internal/lossless/encode_near.go: multi-pass
smoothness-aware value discretization with bounded per-channel deviation.
"""

from __future__ import annotations

import numpy as np

MIN_DIM = 64
MAX_LIMIT_BITS = 5


def near_lossless_bits(quality: int) -> int:
    return MAX_LIMIT_BITS - quality // 20


def _closest_discretized(ch: np.ndarray, bits: int) -> np.ndarray:
    """Banker's-rounding quantization to multiples of 1<<bits per channel."""
    mask = np.uint32((1 << bits) - 1)
    biased = ch + (mask >> np.uint32(1)) + ((ch >> np.uint32(bits)) & np.uint32(1))
    return np.where(biased > 255, np.uint32(0xFF), biased & ~mask)


def _discretize_argb(px: np.ndarray, bits: int) -> np.ndarray:
    out = np.zeros_like(px)
    for s in (0, 8, 16, 24):
        ch = (px >> np.uint32(s)) & np.uint32(0xFF)
        out |= _closest_discretized(ch, bits) << np.uint32(s)
    return out


def _is_near(a: np.ndarray, b: np.ndarray, limit: int) -> np.ndarray:
    ok = np.ones(a.shape, dtype=bool)
    for s in (0, 8, 16, 24):
        d = ((a >> np.uint32(s)) & np.uint32(0xFF)).astype(np.int32) - \
            ((b >> np.uint32(s)) & np.uint32(0xFF)).astype(np.int32)
        ok &= (d < limit) & (d > -limit)
    return ok


def _pass(img: np.ndarray, limit_bits: int) -> np.ndarray:
    h, w = img.shape
    limit = 1 << limit_bits
    out = img.copy()
    if h < 3 or w < 3:
        return out
    c = img[1:-1, 1:-1]
    smooth = (_is_near(c, img[1:-1, :-2], limit)
              & _is_near(c, img[1:-1, 2:], limit)
              & _is_near(c, img[:-2, 1:-1], limit)
              & _is_near(c, img[2:, 1:-1], limit))
    quant = _discretize_argb(c, limit_bits)
    out[1:-1, 1:-1] = np.where(smooth, c, quant)
    return out


def apply_near_lossless(argb: np.ndarray, quality: int) -> np.ndarray:
    """Returns a preprocessed copy of the uint32 ARGB [h, w] image."""
    limit_bits = near_lossless_bits(quality)
    if limit_bits <= 0:
        return argb
    limit_bits = min(limit_bits, MAX_LIMIT_BITS)
    h, w = argb.shape
    if (w < MIN_DIM and h < MIN_DIM) or h < 3:
        return argb
    out = _pass(argb, limit_bits)
    # Subsequent passes at decreasing level (encode_near.go:172-180).
    for bits in range(limit_bits - 1, 0, -1):
        out = _pass(out, bits)
    return out
