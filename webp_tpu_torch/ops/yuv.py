"""Device-side RGB -> YUV 4:2:0 import and YUV 4:2:0 -> RGB with fancy
chroma upsampling (PyTorch). Counterpart of webp_tpu/ops/yuv.py: per-pixel
luma, gamma-correct 2x2 chroma accumulation; on the way back the 4-tap
diamond upsample and the BT.601 fixed-point conversion, whose plain
numpy versions are lossy/yuv.py's.

The reference evaluates its two gamma curves with float32 `pow` on the
device. A `pow` that is one ulp off flips a value after the floor, and
CUDA's `pow` is not the CPU's, so the port evaluates each curve once, on
the CPU in float32 with the reference's operation order, over its whole
integer domain (256 inputs, then 0..16380), and looks the values up on
the device. The tests hold both tables against the reference formula.
"""

from __future__ import annotations

import functools

import torch

from ..encoder import K_RGB_TO_U, K_RGB_TO_V, K_RGB_TO_Y, YUV_FIX, YUV_HALF

LIN_MAX = 4 * 4095  # largest sum of four linear values


@functools.lru_cache(maxsize=1)
def gamma_luts_cpu():
    """(to_linear [256], to_gamma4 [LIN_MAX + 1]) int32 on the CPU:
    floor((v/255)^0.8 * 4095 + 0.5) and floor((a/16380)^1.25 * 1020 + 0.5)
    in float32."""
    xf = torch.arange(256, dtype=torch.float32) * (1.0 / 255.0)
    lin = torch.floor(torch.pow(xf, 0.80) * 4095.0 + 0.5).to(torch.int32)
    af = (torch.arange(LIN_MAX + 1, dtype=torch.float32)
          * (1.0 / (4.0 * 4095.0)))
    gam = torch.floor(torch.pow(af, 1.25) * 1020.0 + 0.5).to(torch.int32)
    return lin, gam


@functools.lru_cache(maxsize=4)
def _luts(device: str):
    lin, gam = gamma_luts_cpu()
    return lin.to(device), gam.to(device)


def rgb_planes_to_yuv420(r, g, b):
    """uint8 planes [..., H, W] (H, W even) -> (Y [..., H, W],
    U, V [..., H/2, W/2]) uint8."""
    lin_lut, gam_lut = _luts(str(r.device))
    r = r.to(torch.int32)
    g = g.to(torch.int32)
    b = b.to(torch.int32)
    yy = (K_RGB_TO_Y[0] * r + K_RGB_TO_Y[1] * g + K_RGB_TO_Y[2] * b
          + YUV_HALF + (16 << YUV_FIX)) >> YUV_FIX
    Y = yy.clamp(0, 255).to(torch.uint8)
    gam = []
    for c in (r, g, b):
        lin = lin_lut[c]
        rows = lin[..., 0::2, :] + lin[..., 1::2, :]
        acc = rows[..., 0::2] + rows[..., 1::2]            # <= 16380
        gam.append(gam_lut[acc])
    rg, gg, bg = gam
    ru = (K_RGB_TO_U[0] * rg + K_RGB_TO_U[1] * gg + K_RGB_TO_U[2] * bg
          + (YUV_HALF << 2) + (128 << (YUV_FIX + 2))) >> (YUV_FIX + 2)
    rv = (K_RGB_TO_V[0] * rg + K_RGB_TO_V[1] * gg + K_RGB_TO_V[2] * bg
          + (YUV_HALF << 2) + (128 << (YUV_FIX + 2))) >> (YUV_FIX + 2)
    U = ru.clamp(0, 255).to(torch.uint8)
    V = rv.clamp(0, 255).to(torch.uint8)
    return Y, U, V


def rgb_to_yuv420(rgb):
    """uint8 [..., H, W, 3] (H, W even) -> (Y [..., H, W], U, V
    [..., H/2, W/2])."""
    return rgb_planes_to_yuv420(rgb[..., 0], rgb[..., 1], rgb[..., 2])


def yuv_to_rgb(y, u, v):
    """Pointwise full-resolution YUV -> RGB uint8 [..., 3]."""
    from ..lossy.yuv import (K_BBIAS, K_BCB, K_GBIAS, K_GCB, K_GCR, K_RBIAS,
                             K_RCR, K_YSCALE)

    y = y.to(torch.int32)
    u = u.to(torch.int32)
    v = v.to(torch.int32)
    yy = (y * K_YSCALE) >> 8
    r = yy + ((v * K_RCR) >> 8) - K_RBIAS
    g = yy - ((u * K_GCB) >> 8) - ((v * K_GCR) >> 8) + K_GBIAS
    b = yy + ((u * K_BCB) >> 8) - K_BBIAS
    rgb = torch.stack([r, g, b], dim=-1) >> 6
    return rgb.clamp(0, 255).to(torch.uint8)


def upsample_chroma_fancy(c, height: int, width: int):
    """Fancy 4-tap diamond chroma upsampling: [..., ch, cw] -> [..., H, W]
    int32; each luma row pairs its nearest chroma row with the next one
    away (the first and last rows with themselves)."""
    ch = c.shape[-2]
    c = c.to(torch.int32)
    rows = torch.arange(height, device=c.device)
    near = rows >> 1
    far = torch.where((rows & 1) == 1, (near + 1).clamp_max(ch - 1),
                      (near - 1).clamp_min(0))
    cn = c.index_select(-2, near)                    # [..., H, cw]
    cf = c.index_select(-2, far)
    last_pair = (width - 1) >> 1
    out = torch.zeros(c.shape[:-2] + (height, width), dtype=torch.int32,
                      device=c.device)
    out[..., 0] = (3 * cn[..., 0] + cf[..., 0] + 2) >> 2
    if last_pair >= 1:
        tl = cn[..., :last_pair]
        t = cn[..., 1:last_pair + 1]
        lf = cf[..., :last_pair]
        cc = cf[..., 1:last_pair + 1]
        avg = tl + t + lf + cc + 8
        diag12 = (avg + 2 * (t + lf)) >> 3
        diag03 = (avg + 2 * (tl + cc)) >> 3
        out[..., 1:2 * last_pair:2] = (diag12 + tl) >> 1
        out[..., 2:2 * last_pair + 1:2] = (diag03 + t) >> 1
    if width % 2 == 0 and width >= 2:
        i = (width - 1) >> 1
        out[..., width - 1] = (3 * cn[..., i] + cf[..., i] + 2) >> 2
    return out


def yuv420_to_rgb_fancy(y, u, v):
    """Y [..., H, W], U/V [..., ceil(H/2), ceil(W/2)] -> RGB uint8
    [..., H, W, 3]."""
    h, w = y.shape[-2], y.shape[-1]
    return yuv_to_rgb(y, upsample_chroma_fancy(u, h, w),
                      upsample_chroma_fancy(v, h, w))
