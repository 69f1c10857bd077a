"""Quality metrics in PyTorch, on tensors of any device: SSE, PSNR,
weighted-Hadamard TDisto and windowed SSIM (counterpart of
webp_tpu/ops/metrics.py, after the Go reference's internal/dsp/ssim.go).

Two differences from the reference, both deliberate:

  * sse accumulates in int64. The reference sums int32 squared
    differences with jnp.sum, which with JAX's x64 off stays int32 and
    wraps (an all-0 against an all-255 1280x720 plane gives -202,502,144
    where the true value is 59,927,040,000, and its PSNR then reads 99).
    Where the reference's sum stays below 2^31 the two are equal.
  * psnr_from_sse computes in float64 (the reference in float32); the
    two agree within rtol 1e-5.

ssim_plane computes in float32, as the reference actually does: it casts
to float64, but with x64 off that is float32.
"""

from __future__ import annotations

import numpy as np
import torch

# Hadamard weights for TDisto (libwebp kWeightY / enc.c).
WEIGHT_Y = np.array(
    [38, 32, 20, 9, 32, 28, 17, 7, 20, 17, 10, 4, 9, 7, 4, 2], dtype=np.int32
).reshape(4, 4)


def sse(a: torch.Tensor, b: torch.Tensor, axes=None) -> torch.Tensor:
    """Sum of squared differences (int64, never wraps), over `axes` (all
    by default)."""
    d = a.to(torch.int64) - b.to(torch.int64)
    d = d * d
    return d.sum() if axes is None else d.sum(dim=axes)


def psnr_from_sse(sse_val, count) -> torch.Tensor:
    """PSNR in dB (float64) of a sum of squared 8-bit differences over
    `count` samples; 99.0 where the SSE is 0."""
    s = torch.as_tensor(sse_val, dtype=torch.float64)
    n = torch.as_tensor(count, dtype=torch.float64, device=s.device)
    mse = s / n.clamp(min=1)
    return torch.where(
        mse > 0, 10.0 * torch.log10(255.0 * 255.0 / mse.clamp(min=1e-12)),
        torch.full_like(mse, 99.0))


def _hadamard4(x: torch.Tensor) -> torch.Tensor:
    """Weighted-transform inner: 2D 4x4 Hadamard, [..., 4, 4] int32."""
    c0, c1, c2, c3 = x[..., 0], x[..., 1], x[..., 2], x[..., 3]
    a0, a1 = c0 + c2, c1 + c3
    a2, a3 = c1 - c3, c0 - c2
    t = torch.stack([a0 + a1, a3 + a2, a3 - a2, a0 - a1], dim=-1)
    r0, r1, r2, r3 = t[..., 0, :], t[..., 1, :], t[..., 2, :], t[..., 3, :]
    a0, a1 = r0 + r2, r1 + r3
    a2, a3 = r1 - r3, r0 - r2
    return torch.stack([a0 + a1, a3 + a2, a3 - a2, a0 - a1], dim=-2)


# SSIM: plane-level with the hat kernel {1,2,3,4,3,2,1} (VP8_SSIM_KERNEL=3).
_SSIM_K = (1.0, 2.0, 3.0, 4.0, 3.0, 2.0, 1.0)


def _filt(x: torch.Tensor) -> torch.Tensor:
    """The 7x7 hat window's weighted sums over every valid position, as a
    separable sum of shifted slices (rows, then columns)."""
    n = len(_SSIM_K)
    h, w = x.shape
    rows = sum(k * x[:, j: w - n + 1 + j] for j, k in enumerate(_SSIM_K))
    return sum(k * rows[i: h - n + 1 + i] for i, k in enumerate(_SSIM_K))


def ssim_plane(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Mean SSIM over the plane interior (float32; matches libwebp's
    integer SSIMCalculation semantics up to rounding). On 8-bit planes the
    window sums are integers below 2^24, so float32 holds them exactly in
    any summation order."""
    a = a.to(torch.float32)
    b = b.to(torch.float32)
    N = sum(_SSIM_K) ** 2
    w2 = N * N
    C1 = 20.0 * w2
    C2 = 60.0 * w2
    xm = _filt(a)
    ym = _filt(b)
    xxm = _filt(a * a)
    yym = _filt(b * b)
    xym = _filt(a * b)
    sxy = xym * N - xm * ym
    sxx = xxm * N - xm * xm
    syy = yym * N - ym * ym
    num = (2 * xm * ym + C1) * (2 * sxy.clamp(min=0) + C2)
    den = (xm * xm + ym * ym + C1) * (sxx + syy + C2)
    return (num / den).mean()
