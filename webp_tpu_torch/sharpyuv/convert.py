"""Sharp RGB -> YUV420 conversion on the host (vectorized numpy): the
port's own copy of webp_tpu/sharpyuv/convert.py.

The SharpYUV algorithm: iterative refinement of a full-res luma plane
("W") and half-res chroma residuals (R-W, G-W, B-W) so that the
reconstructed (fancy-upsampled) image's gamma-aware luminance matches the
source, minimizing 4:2:0 subsampling artifacts. Fixed-point BT.709
transfer tables, the WebP conversion matrix, 2 bits of extra precision
(sfix=2, 10-bit working depth), 4 refinement iterations with convergence
checks. The device conversion (ops/sharpyuv.py) runs the same iteration
in float32 with the transfer curves evaluated directly.

The escape-overflow fallback of a sharp-YUV device encode re-encodes
from these planes (lossy/device_encode.py).
"""

from __future__ import annotations

import numpy as np

YUV_FIX = 16
YUV_HALF = 1 << (YUV_FIX - 1)
SFIX = 2  # extra precision bits for 8-bit input
BIT_DEPTH = 8 + SFIX
MAX_Y = (1 << BIT_DEPTH) - 1
NUM_ITERATIONS = 4

G2L_BITS = 10
G2L_SIZE = 1 << G2L_BITS
L2G_BITS = 9
L2G_SIZE = 1 << L2G_BITS
LINEAR_BITS = 16

# WebP conversion matrix (csp.go:60-64).
RGB_TO_Y = (16839, 33059, 6420, 16 << 16)
RGB_TO_U = (-9719, -19081, 28800, 128 << 16)
RGB_TO_V = (28800, -24116, -4684, 128 << 16)

_g2l = None
_l2g = None
_transfer = None


def _init_tables(transfer: str = "bt709"):
    """Builds the fixed-point transfer tables. The default BT.709/601
    curve matches the reference's kGammaF path; the full CICP set from
    gamma.py (sRGB, PQ, HLG, log, ...) is selectable."""
    global _g2l, _l2g, _transfer
    if _g2l is not None and _transfer == transfer:
        return
    from .gamma import build_tables

    _g2l, _l2g = build_tables(transfer, G2L_SIZE, L2G_SIZE, LINEAR_BITS)
    _transfer = transfer


def _gamma_to_linear(v: np.ndarray) -> np.ndarray:
    """10-bit gamma -> 16-bit linear (direct table hit at BIT_DEPTH=10)."""
    return _g2l[v]


def _linear_to_gamma(value: np.ndarray) -> np.ndarray:
    """16-bit linear -> 10-bit gamma via fixed-point interpolation
    (fixedPointInterpolation with tabPosShiftRight=7, tabValueShift=-6)."""
    tab_pos = value >> 7
    x = value - (tab_pos << 7)
    v0 = _l2g[tab_pos] >> 6
    v1 = _l2g[tab_pos + 1] >> 6
    return v0 + (((v1 - v0) * x + 64) >> 7)


def _rgb_to_gray(r, g, b):
    return (13933 * r + 46871 * g + 4732 * b + YUV_HALF) >> YUV_FIX


def _update_w(rgb10: np.ndarray) -> np.ndarray:
    """Gamma-aware luminance of [..., 3] 10-bit RGB (updateW)."""
    lin = _gamma_to_linear(rgb10)
    gray = _rgb_to_gray(lin[..., 0], lin[..., 1], lin[..., 2])
    return _linear_to_gamma(gray)


def _scale_down(rgb10: np.ndarray) -> np.ndarray:
    """Gamma-aware 2x2 average per channel: [2h, 2w, 3] -> [h, w, 3]."""
    lin = _gamma_to_linear(rgb10)
    acc = (lin[0::2, 0::2] + lin[0::2, 1::2] + lin[1::2, 0::2]
           + lin[1::2, 1::2] + 2) >> 2
    return _linear_to_gamma(acc)


def _update_chroma(rgb10: np.ndarray) -> np.ndarray:
    """Target chroma residuals [h/2, w/2, 3] = scaled RGB - gray."""
    s = _scale_down(rgb10)
    gray = _rgb_to_gray(s[..., 0], s[..., 1], s[..., 2])
    return (s - gray[..., None]).astype(np.int64)


def _interpolate(best_y: np.ndarray, best_uv: np.ndarray) -> np.ndarray:
    """Reconstructs full-res 10-bit RGB = clip(bestY + upsample(bestUV)).

    Vectorized interpolateTwoRows: diamond 9-3-3-1 kernel with the row pair
    structure (even rows pair with prevUV, odd rows with nextUV).
    """
    h, w = best_y.shape
    uvh, uvw = best_uv.shape[:2]
    rows = np.arange(h)
    juv = rows >> 1
    other = np.where(rows & 1 == 0, np.maximum(juv - 1, 0),
                     np.minimum(juv + 1, uvh - 1))
    cur = best_uv[juv]      # [h, uvw, 3]
    oth = best_uv[other]    # [h, uvw, 3]

    out = np.empty((h, w, 3), dtype=np.int64)
    # Column 0.
    out[:, 0] = (3 * cur[:, 0] + oth[:, 0] + 2) >> 2
    filter_len = (w - 1) >> 1
    if filter_len >= 1:
        a0 = cur[:, :filter_len]
        a1 = cur[:, 1 : filter_len + 1]
        b0 = oth[:, :filter_len]
        b1 = oth[:, 1 : filter_len + 1]
        out[:, 1 : 2 * filter_len : 2] = (a0 * 9 + a1 * 3 + b0 * 3 + b1 + 8) >> 4
        out[:, 2 : 2 * filter_len + 1 : 2] = (a1 * 9 + a0 * 3 + b1 * 3 + b0 + 8) >> 4
    if w % 2 == 0 and w >= 2:
        out[:, w - 1] = (3 * cur[:, uvw - 1] + oth[:, uvw - 1] + 2) >> 2
    return np.clip(out + best_y[:, :, None], 0, MAX_Y)


def sharp_rgb_to_yuv420_planes(rgb: np.ndarray, transfer: str = "bt709"):
    """RGB uint8 [h, w, 3] -> (Y [h,w], U, V [(h+1)/2, (w+1)/2]) uint8."""
    _init_tables(transfer)
    height, width = rgb.shape[:2]
    w = (width + 1) & ~1
    h = (height + 1) & ~1
    # Import at 10-bit precision with edge replication to even size.
    pad = np.empty((h, w, 3), dtype=np.int64)
    pad[:height, :width] = rgb
    if w > width:
        pad[:height, width:] = rgb[:, width - 1 :]
    if h > height:
        pad[height:] = pad[height - 1 : height]
    rgb10 = pad << SFIX

    best_y = _rgb_to_gray(rgb10[..., 0], rgb10[..., 1], rgb10[..., 2])
    target_y = _update_w(rgb10)
    target_uv = _update_chroma(rgb10)
    best_uv = target_uv.copy()

    diff_threshold = 3 * w * h
    prev_diff = None
    for it in range(NUM_ITERATIONS):
        rec = _interpolate(best_y, best_uv)
        best_rgb_y = _update_w(rec)
        best_rgb_uv = _update_chroma(rec)
        diff_y = target_y - best_rgb_y
        best_y = np.clip(best_y + diff_y, 0, MAX_Y)
        best_uv = best_uv + (target_uv - best_rgb_uv)
        diff_sum = int(np.abs(diff_y).sum())
        if it > 0 and (diff_sum < diff_threshold or
                       (prev_diff is not None and diff_sum > prev_diff)):
            break
        prev_diff = diff_sum

    # Final conversion (convertWRGBToYUV).
    srounder = 1 << (YUV_FIX + SFIX - 1)
    shift = YUV_FIX + SFIX
    uv_up = np.repeat(np.repeat(best_uv, 2, axis=0), 2, axis=1)[:h, :w]
    r = uv_up[..., 0] + best_y
    g = uv_up[..., 1] + best_y
    b = uv_up[..., 2] + best_y
    yv = (RGB_TO_Y[0] * r + RGB_TO_Y[1] * g + RGB_TO_Y[2] * b
          + (RGB_TO_Y[3] << SFIX) + srounder) >> shift
    Y = np.clip(yv, 0, 255).astype(np.uint8)[:height, :width]
    ur = best_uv[..., 0]
    ug = best_uv[..., 1]
    ub = best_uv[..., 2]
    uvv = (RGB_TO_U[0] * ur + RGB_TO_U[1] * ug + RGB_TO_U[2] * ub
           + (RGB_TO_U[3] << SFIX) + srounder) >> shift
    vvv = (RGB_TO_V[0] * ur + RGB_TO_V[1] * ug + RGB_TO_V[2] * ub
           + (RGB_TO_V[3] << SFIX) + srounder) >> shift
    U = np.clip(uvv, 0, 255).astype(np.uint8)
    V = np.clip(vvv, 0, 255).astype(np.uint8)
    return Y, U, V


def sharp_rgb_to_yuv420(rgb: np.ndarray, transfer: str = "bt709"):
    """Like encoder.rgb_to_yuv420 but using the sharp algorithm; returns
    MB-padded planes ready for VP8Encoder."""
    h, w = rgb.shape[:2]
    mbw, mbh = (w + 15) >> 4, (h + 15) >> 4
    Ys, Us, Vs = sharp_rgb_to_yuv420_planes(rgb, transfer)
    Y = np.zeros((mbh * 16, mbw * 16), dtype=np.uint8)
    U = np.zeros((mbh * 8, mbw * 8), dtype=np.uint8)
    V = np.zeros((mbh * 8, mbw * 8), dtype=np.uint8)
    Y[: Ys.shape[0], : Ys.shape[1]] = Ys
    U[: Us.shape[0], : Us.shape[1]] = Us
    V[: Vs.shape[0], : Vs.shape[1]] = Vs
    _pad_plane(Y, Ys.shape[0], Ys.shape[1])
    _pad_plane(U, Us.shape[0], Us.shape[1])
    _pad_plane(V, Vs.shape[0], Vs.shape[1])
    return Y, U, V


def _pad_plane(p: np.ndarray, h: int, w: int) -> None:
    """Replicates the last column and row of p[:h, :w] into the padding."""
    if w < p.shape[1]:
        p[:h, w:] = p[:h, w - 1 : w]
    if h < p.shape[0]:
        p[h:, :] = p[h - 1 : h, :]
