"""YUV420 → RGB with fancy (4-tap diamond) chroma upsampling.

Numpy exact-integer version: the plain version of the device's upsample
(webp_tpu_torch/ops/yuv.py). Math parity with the reference's
internal/dsp/{yuv.go,upsample.go} (BT.601
fixed-point constants from libwebp yuv.h; diamond kernel from
UpsampleRgbLinePair_C).
"""

from __future__ import annotations

import numpy as np

K_YSCALE = 19077  # 1.164 in Q14<<2
K_RCR = 26149
K_GCB = 6419
K_GCR = 13320
K_BCB = 33050
K_RBIAS = 14234
K_GBIAS = 8708
K_BBIAS = 17685


def _mult_hi(v, coeff):
    return (v * coeff) >> 8


def yuv_to_rgb(y: np.ndarray, u: np.ndarray, v: np.ndarray) -> np.ndarray:
    """Pointwise YUV→RGB on same-shape int arrays; returns uint8 [..., 3]."""
    y = y.astype(np.int32)
    u = u.astype(np.int32)
    v = v.astype(np.int32)
    yy = _mult_hi(y, K_YSCALE)
    r = yy + _mult_hi(v, K_RCR) - K_RBIAS
    g = yy - _mult_hi(u, K_GCB) - _mult_hi(v, K_GCR) + K_GBIAS
    b = yy + _mult_hi(u, K_BCB) - K_BBIAS
    rgb = np.stack([r, g, b], axis=-1) >> 6
    return np.clip(rgb, 0, 255).astype(np.uint8)


def _upsample_chroma_row(c_near: np.ndarray, c_far: np.ndarray, width: int) -> np.ndarray:
    """Upsamples one chroma component row pair to full width (int32).

    c_near is the chroma row nearest this luma row, c_far the other one.
    Returns int32 [width] of interpolated chroma for this luma row.
    """
    cn = c_near.astype(np.int32)
    cf = c_far.astype(np.int32)
    out = np.empty(width, dtype=np.int32)
    # Column 0: vertical-only interpolation.
    out[0] = (3 * cn[0] + cf[0] + 2) >> 2
    last_pair = (width - 1) >> 1
    if last_pair >= 1:
        tl = cn[: last_pair]      # x-1 entries for x = 1..last_pair
        t = cn[1 : last_pair + 1]
        l = cf[: last_pair]
        c = cf[1 : last_pair + 1]
        avg = tl + t + l + c + 8
        diag12 = (avg + 2 * (t + l)) >> 3
        diag03 = (avg + 2 * (tl + c)) >> 3
        out[1 : 2 * last_pair : 2] = (diag12 + tl) >> 1      # odd columns 2x-1
        out[2 : 2 * last_pair + 1 : 2] = (diag03 + t) >> 1   # even columns 2x
    if width & 1 == 0 and width >= 2:
        out[width - 1] = (3 * cn[(width - 1) >> 1] + cf[(width - 1) >> 1] + 2) >> 2
    return out


def upsample_chroma_fancy(u: np.ndarray, v: np.ndarray, width: int,
                          height: int) -> tuple[np.ndarray, np.ndarray]:
    """Full-plane fancy chroma upsampling (matches buildNRGBA's row loop,
    webp.go:379-450): per-luma-row 4-tap diamond interpolation."""
    ch = u.shape[0]
    U = np.empty((height, width), dtype=np.int32)
    V = np.empty((height, width), dtype=np.int32)
    for r in range(height):
        near = r >> 1
        if r & 1:
            far = min(near + 1, ch - 1)
        else:
            far = max(near - 1, 0)
        U[r] = _upsample_chroma_row(u[near], u[far], width)
        V[r] = _upsample_chroma_row(v[near], v[far], width)
    return U, V


def yuv_to_rgb_fancy(y: np.ndarray, u: np.ndarray, v: np.ndarray) -> np.ndarray:
    """YUV420 planes → RGB uint8 [h, w, 3] with fancy upsampling."""
    h, w = y.shape
    uu, vv = upsample_chroma_fancy(u, v, w, h)
    return yuv_to_rgb(y, uu, vv)
