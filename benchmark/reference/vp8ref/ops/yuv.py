"""Device-side RGB -> YUV 4:2:0 import (PyTorch). Counterpart of
webp_tpu/ops/yuv.py: per-pixel luma, gamma-correct 2x2 chroma
accumulation.

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
