"""Device SharpYUV: RGB -> YUV 4:2:0 with iterative luma/chroma
refinement, batched over B (PyTorch). Counterpart of
webp_tpu/ops/sharpyuv.py.

The algorithm of the host converter (sharpyuv/convert.py): refine a
full-res luma plane and half-res chroma residuals so that the
fancy-upsampled reconstruction's gamma-aware luminance matches the
source. The host uses fixed-point gamma tables; the device, like the
reference's, evaluates the BT.709 transfer curves directly in float32.
Everything is elementwise work, 2x2 pooling and static slices in
float32, in the order the reference's compiled CPU program computes it:
XLA folds constant factors together, sums the 2x2 mean's four values in
sequence (the reduction loop's order) and contracts a product that feeds
a sum into one fused multiply-add when the product has a single use in
its fusion, and the port does the same (_fma). XLA recomputes best_y in
each fusion that reads it, so the luma difference target_y - W(rec)
takes the contraction of the fusion it is evaluated in; the port
computes the two forms where they are read (sharp_yuv420). The
convergence early exit is a per-image `done` flag selecting between
states.

The transfer curves' `pow` decides bytes: a result one ulp off flips a
sample now and then. On the CPU the curves take the C library's powf
(native/src/powf_array.cc), which is the reference's float32 pow there
bit for bit; on the card they take CUDA's powf (torch.pow), which is not,
so card planes are held to the CPU's within a tolerance (one level, on
at most one sample in 10^4). The whole-image sums of the early exit are
taken in float64 on both.
"""

from __future__ import annotations

import numpy as np
import torch

MAX_Y = 1023.0  # 10-bit working depth (8 bits + SFIX=2)
NUM_ITERATIONS = 4


def _f32(x: float) -> float:
    """x rounded to float32, as the reference's weakly typed constants."""
    return float(np.float32(x))


# WebP conversion matrix (reference csp.go:60-64).
_RGB_TO_Y = (16839.0, 33059.0, 6420.0, float(16 << 16))
_RGB_TO_U = (-9719.0, -19081.0, 28800.0, float(128 << 16))
_RGB_TO_V = (28800.0, -24116.0, -4684.0, float(128 << 16))
# Rec.709 luminance weights at YUV_FIX scale (sharpyuv.go rgbToGray).
_GRAY = (13933.0, 46871.0, 4732.0)

_A709 = 0.09929682680944
_T709 = 0.018053968510807
_INV_4_5 = _f32(1.0 / 4.5)
_INV_1A = _f32(1.0 / (1.0 + _A709))
_ONE_A = _f32(1.0 + _A709)
_A = _f32(_A709)
_T_LIN = _f32(_T709)
_T_GAM = _f32(_T709 * 4.5)
_E_TO_LIN = _f32(1.0 / 0.45)
_E_FROM_LIN = _f32(0.45)
_EPS = _f32(1e-8)
_INV_MAX_Y = _f32(1.0 / MAX_Y)
_INV_65536 = _f32(1.0 / 65536.0)
_SCALE = _f32(1.0 / float(1 << (16 + 2)))


def _pow(x, e: float):
    """float32 x ** e: the C library's powf on the CPU, CUDA's powf on the
    card."""
    if x.device.type == "cpu":
        from ..native.api import powf_array

        return torch.from_numpy(powf_array(x.numpy(), e))
    return torch.pow(x, e)


def _fma(a, b, c):
    """a * b + c rounded once to float32, as XLA's CPU code contracts a
    product that feeds a sum: the product is exact in float64 and the sum
    rounds to float64 and then to float32 (a double rounding that differs
    from one rounding only when the float64 sum falls exactly halfway
    between two float32 values). a, b or c may be Python floats."""
    def f64(x):
        return x.double() if torch.is_tensor(x) else x
    return (f64(a) * f64(b) + f64(c)).float()


def _dot3(k, r, g, b):
    """k[0]*r + k[1]*g + k[2]*b as XLA's CPU code computes it: the first
    product contracted into the sum with the second, that sum into the
    third product's."""
    return _fma(k[2], b, _fma(k[0], r, k[1] * g))


def _to_linear10(x):
    """BT.709 inverse OETF of g = x / MAX_Y (x at the 10-bit scale). The
    linear branch multiplies x by the folded constant (1/MAX_Y) / 4.5, as
    XLA folds the two constant factors; the curve's g + a is one
    multiply-add of x, as XLA's CPU code contracts it in every fusion
    that evaluates the curve."""
    g = x * _INV_MAX_Y
    lo = x * _f32(_INV_MAX_Y * _INV_4_5)
    hi = _pow(torch.clamp_min(_fma(x, _INV_MAX_Y, _A) * _INV_1A, 0.0),
              _E_TO_LIN)
    return torch.where(g <= _T_GAM, lo, hi)


def _from_linear(v):
    """BT.709 OETF on [0, 1]."""
    lo = 4.5 * v
    hi = _fma(_ONE_A, _pow(torch.clamp_min(v, _EPS), _E_FROM_LIN), -_A)
    return torch.where(v <= _T_LIN, lo, hi)


def _gray(r, g, b):
    return _dot3(_GRAY, r, g, b) * _INV_65536


def _w_unscaled(rgb10):
    """Gamma-aware luminance of [B, h, w, 3] 10-bit-scale RGB, before its
    scaling by MAX_Y -> [B, h, w]."""
    lin = _to_linear10(rgb10)
    return _from_linear(_gray(lin[..., 0], lin[..., 1], lin[..., 2]))


def _update_chroma(rgb10):
    """Target chroma residuals [B, h/2, w/2, 3] = scaled RGB - its gray,
    the scaled RGB a gamma-aware 2x2 average per channel (the four values
    summed in sequence, row by row, as XLA's reduction loop does)."""
    lin = _to_linear10(rgb10)
    acc = (((lin[:, 0::2, 0::2] + lin[:, 0::2, 1::2]) + lin[:, 1::2, 0::2])
           + lin[:, 1::2, 1::2]) * 0.25
    s = _from_linear(acc) * MAX_Y
    return s - _gray(s[..., 0], s[..., 1], s[..., 2])[..., None]


def _interpolate(best_y, best_uv):
    """Full-res RGB = clip(bestY + diamond-upsampled bestUV), 10-bit scale:
    the 9-3-3-1 diamond with even output rows pairing with the previous
    UV row and odd rows with the next (h and w even)."""
    B, h, w = best_y.shape
    uvh, uvw = best_uv.shape[1:3]
    prev = torch.cat([best_uv[:, :1], best_uv[:, :-1]], dim=1)
    nxt = torch.cat([best_uv[:, 1:], best_uv[:, -1:]], dim=1)

    def expand(cur, oth):
        # One output row per UV row: [B, uvh, w, 3].
        a0, a1 = cur[:, :, :-1], cur[:, :, 1:]
        b0, b1 = oth[:, :, :-1], oth[:, :, 1:]
        odd = (_fma(3.0, b0, _fma(9.0, a0, 3.0 * a1)) + b1) * 0.0625
        even = (_fma(3.0, b1, _fma(9.0, a1, 3.0 * a0)) + b0) * 0.0625
        mid = torch.stack([odd, even], dim=3).reshape(B, uvh,
                                                      2 * (uvw - 1), 3)
        first = _fma(3.0, cur[:, :, :1], oth[:, :, :1]) * 0.25
        last = _fma(3.0, cur[:, :, -1:], oth[:, :, -1:]) * 0.25
        return torch.cat([first, mid, last], dim=2)

    rows_even = expand(best_uv, prev)
    rows_odd = expand(best_uv, nxt)
    uv_full = torch.stack([rows_even, rows_odd], dim=2).reshape(B, h, w, 3)
    return torch.clamp(uv_full + best_y[..., None], 0.0, MAX_Y)


def _to_u8(x):
    return torch.clamp(x, 0.0, 255.0).to(torch.uint8)


def sharp_yuv420(rgb):
    """uint8 [B, H, W, 3] (H, W even) -> (Y [B, H, W], U, V [B, H/2, W/2])
    uint8."""
    B, h, w = rgb.shape[:3]
    rgb10 = rgb.to(torch.float32) * 4.0  # SFIX=2

    best_y = _gray(rgb10[..., 0], rgb10[..., 1], rgb10[..., 2])
    w_target = _w_unscaled(rgb10)
    target_uv = _update_chroma(rgb10)
    best_uv = target_uv

    diff_threshold = 3.0 * w * h  # host threshold at the same 10-bit scale
    done = torch.zeros((B,), dtype=torch.bool, device=rgb.device)
    prev_diff = None
    # target_y - W(rec) * MAX_Y: XLA recomputes best_y in each fusion that
    # reads it, and a fusion that evaluates the difference once contracts
    # its first product (form A, fma(Wt, M, -Wr*M)), one that evaluates it
    # twice or more, with its target product shared, the second (form B,
    # fma(-Wr, M, Wt*M)). The interpolation at iteration 1 reads best_y1
    # from fusions of the first kind; every other reader of best_y (the
    # next best_y, later interpolations, the final conversion) recomputes
    # two or more differences. So best_y1 exists in both forms.
    y_rec = best_y      # the best_y the interpolation reads
    for it in range(NUM_ITERATIONS):
        rec = _interpolate(y_rec, best_uv)
        w_rec = _w_unscaled(rec)
        diff_y = _fma(-w_rec, MAX_Y, w_target * MAX_Y)
        new_y = torch.clamp(best_y + diff_y, 0.0, MAX_Y)
        new_uv = best_uv + (target_uv - _update_chroma(rec))
        if it == 0:
            diff_y = _fma(w_target, MAX_Y, -(w_rec * MAX_Y))
            y_rec = torch.clamp(best_y + diff_y, 0.0, MAX_Y)
        best_y = torch.where(done[:, None, None], best_y, new_y)
        best_uv = torch.where(done[:, None, None, None], best_uv, new_uv)
        if it > 0:
            y_rec = best_y
        diff_sum = diff_y.abs().sum(dim=(1, 2), dtype=torch.float64)
        if it > 0:
            done = done | (diff_sum < diff_threshold) | (diff_sum > prev_diff)
        prev_diff = diff_sum

    # Final conversion (convertWRGBToYUV): SFIX-scale fixed-point rounding.
    uv_up = best_uv.repeat_interleave(2, dim=1).repeat_interleave(2, dim=2)
    r = uv_up[..., 0] + best_y
    g = uv_up[..., 1] + best_y
    b = uv_up[..., 2] + best_y

    def conv(k, r, g, b):
        return torch.floor((_dot3(k, r, g, b) + k[3] * 4.0) * _SCALE + 0.5)

    ur, ug, ub = best_uv[..., 0], best_uv[..., 1], best_uv[..., 2]
    return (_to_u8(conv(_RGB_TO_Y, r, g, b)),
            _to_u8(conv(_RGB_TO_U, ur, ug, ub)),
            _to_u8(conv(_RGB_TO_V, ur, ug, ub)))

