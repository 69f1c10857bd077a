"""The host YUV import in numpy: per-pixel luma, chroma from
gamma-corrected 2x2 RGB accumulation (libwebp's standard import), planes
padded to whole macroblocks by border replication."""

from __future__ import annotations

import numpy as np


# --- RGB -> YUV420 import (gamma-correct chroma averaging) -----------------

K_RGB_TO_Y = (16839, 33059, 6420)
K_RGB_TO_U = (-9719, -19081, 28800)
K_RGB_TO_V = (28800, -24116, -4684)
YUV_FIX = 16
YUV_HALF = 1 << (YUV_FIX - 1)

# Gamma tables (libwebp picture_csp_enc.c): gamma 0.80 chroma averaging.
K_GAMMA = 0.80
K_GAMMA_FIX = 12
K_GAMMA_SCALE = (1 << K_GAMMA_FIX) - 1
K_GAMMA_TAB_FIX = 7
K_GAMMA_TAB_SCALE = 1 << K_GAMMA_TAB_FIX
K_GAMMA_TAB_SIZE = 1 << (K_GAMMA_FIX - K_GAMMA_TAB_FIX)

_gamma_to_linear = None
_linear_to_gamma = None


def _init_gamma():
    global _gamma_to_linear, _linear_to_gamma
    if _gamma_to_linear is not None:
        return
    g2l = np.empty(256, dtype=np.int64)
    for v in range(256):
        g2l[v] = int((v / 255.0) ** K_GAMMA * K_GAMMA_SCALE + 0.5)
    l2g = np.empty(K_GAMMA_TAB_SIZE + 2, dtype=np.int64)
    scale = K_GAMMA_TAB_SCALE / K_GAMMA_SCALE
    for v in range(K_GAMMA_TAB_SIZE + 1):
        l2g[v] = int((scale * v) ** (1.0 / K_GAMMA) * 255.0 + 0.5)
    l2g[K_GAMMA_TAB_SIZE + 1] = 255
    _gamma_to_linear = g2l
    _linear_to_gamma = l2g


def _linear_to_gamma_interp(base: np.ndarray, shift: int) -> np.ndarray:
    """LinearToGamma on sum-of-4 linear values; returns 4x-scale gamma values
    in [0..1020] (matches reference dsp/yuv.go LinearToGamma)."""
    _init_gamma()
    v = base << shift  # in [0, 4*K_GAMMA_SCALE]
    tab_pos = np.minimum(v >> (K_GAMMA_TAB_FIX + 2), K_GAMMA_TAB_SIZE - 1)
    x = v & ((K_GAMMA_TAB_SCALE << 2) - 1)
    v0 = _linear_to_gamma[tab_pos]
    v1 = _linear_to_gamma[tab_pos + 1]
    y = v1 * x + v0 * ((K_GAMMA_TAB_SCALE << 2) - x)
    return (y + (K_GAMMA_TAB_SCALE >> 1)) >> K_GAMMA_TAB_FIX


def rgb_to_yuv420(rgb: np.ndarray, dithering: float = 0.0):
    """Converts uint8 RGB [h, w, 3] to YUV420 planes padded to MB multiples.

    Per-pixel Y; chroma from gamma-corrected 2x2 RGB accumulation
    (libwebp's lossy/encode.go:671-838 in the Go port). The dithered
    import is not part of the reference: dithering must be 0.
    """
    if dithering > 0.0:
        raise NotImplementedError("the reference has no dithered import")
    h, w = rgb.shape[:2]
    mbw, mbh = (w + 15) >> 4, (h + 15) >> 4
    rgbi = rgb.astype(np.int64)
    red, green, blue = rgbi[..., 0], rgbi[..., 1], rgbi[..., 2]
    rounding = YUV_HALF
    yy = (K_RGB_TO_Y[0] * red + K_RGB_TO_Y[1] * green + K_RGB_TO_Y[2] * blue
          + rounding + (16 << YUV_FIX)) >> YUV_FIX
    Y = np.zeros((mbh * 16, mbw * 16), dtype=np.uint8)
    Y[:h, :w] = np.clip(yy, 0, 255).astype(np.uint8)

    # Chroma: gamma-correct 2x2 accumulation on an even-padded copy.
    we, he = (w + 1) & ~1, (h + 1) & ~1
    pad = np.empty((he, we, 3), dtype=np.uint8)
    pad[:h, :w] = rgb
    if we > w:
        pad[:h, w:] = rgb[:, w - 1 :]
    if he > h:
        pad[h:, :w] = rgb[h - 1 :, :w]
        if we > w:
            pad[h:, w:] = rgb[h - 1 :, w - 1 :]
    _init_gamma()
    lin = _gamma_to_linear[pad]  # [he, we, 3] linear
    acc = (lin[0::2, 0::2] + lin[0::2, 1::2] + lin[1::2, 0::2] + lin[1::2, 1::2])
    # LinearToGamma(acc, 0) per channel -> gamma-domain averaged values.
    gam = _linear_to_gamma_interp(acc, 0)
    rg, gg, bg = gam[..., 0], gam[..., 1], gam[..., 2]
    # ClipUV with rounding = YUV_HALF << 2.
    ru = (K_RGB_TO_U[0] * rg + K_RGB_TO_U[1] * gg + K_RGB_TO_U[2] * bg
          + (YUV_HALF << 2) + (128 << (YUV_FIX + 2))) >> (YUV_FIX + 2)
    rv = (K_RGB_TO_V[0] * rg + K_RGB_TO_V[1] * gg + K_RGB_TO_V[2] * bg
          + (YUV_HALF << 2) + (128 << (YUV_FIX + 2))) >> (YUV_FIX + 2)
    U = np.zeros((mbh * 8, mbw * 8), dtype=np.uint8)
    V = np.zeros((mbh * 8, mbw * 8), dtype=np.uint8)
    ch, cw = he >> 1, we >> 1
    U[:ch, :cw] = np.clip(ru, 0, 255).astype(np.uint8)
    V[:ch, :cw] = np.clip(rv, 0, 255).astype(np.uint8)

    # Replicate border pixels into padding (matches importImage padding).
    _pad_plane(Y, h, w)
    _pad_plane(U, ch, cw)
    _pad_plane(V, ch, cw)
    return Y, U, V


def _pad_plane(p: np.ndarray, h: int, w: int) -> None:
    if w < p.shape[1]:
        p[:h, w:] = p[:h, w - 1 : w]
    if h < p.shape[0]:
        p[h:, :] = p[h - 1 : h, :]
