"""Batched VP8 transforms on tensors (PyTorch).

Exact integer math (int32) mirroring webp_tpu_torch.lossy.dsp (the numpy
conformance oracle); shapes are [..., 4, 4] with arbitrary leading batch
axes. Counterpart of webp_tpu/ops/dct.py.
"""

from __future__ import annotations

import torch

C1 = 20091
C2 = 35468


def _mul1(a):
    return ((a * C1) >> 16) + a


def _mul2(a):
    return (a * C2) >> 16


def idct4x4(coeffs: torch.Tensor) -> torch.Tensor:
    """Inverse DCT: int32 [..., 4, 4] -> int32 residuals [..., 4, 4]."""
    c = coeffs.to(torch.int32)
    i0, i1, i2, i3 = c[..., 0, :], c[..., 1, :], c[..., 2, :], c[..., 3, :]
    a = i0 + i2
    b = i0 - i2
    cc = _mul2(i1) - _mul1(i3)
    d = _mul1(i1) + _mul2(i3)
    tmp = torch.stack([a + d, b + cc, b - cc, a - d], dim=-2)
    dc = tmp[..., 0] + 4
    a = dc + tmp[..., 2]
    b = dc - tmp[..., 2]
    cc = _mul2(tmp[..., 1]) - _mul1(tmp[..., 3])
    d = _mul1(tmp[..., 1]) + _mul2(tmp[..., 3])
    return torch.stack([a + d, b + cc, b - cc, a - d], dim=-1) >> 3


def fdct4x4(src: torch.Tensor, ref: torch.Tensor) -> torch.Tensor:
    """Forward DCT of (src - ref): [..., 4, 4] -> int32 coefficients."""
    d = src.to(torch.int32) - ref.to(torch.int32)
    d0, d1, d2, d3 = d[..., 0], d[..., 1], d[..., 2], d[..., 3]
    a0 = d0 + d3
    a1 = d1 + d2
    a2 = d1 - d2
    a3 = d0 - d3
    t0 = (a0 + a1) * 8
    t1 = (a2 * 2217 + a3 * 5352 + 1812) >> 9
    t2 = (a0 - a1) * 8
    t3 = (a3 * 2217 - a2 * 5352 + 937) >> 9
    tmp = torch.stack([t0, t1, t2, t3], dim=-1)
    m0, m1, m2, m3 = (tmp[..., 0, :], tmp[..., 1, :], tmp[..., 2, :],
                      tmp[..., 3, :])
    a0 = m0 + m3
    a1 = m1 + m2
    a2 = m1 - m2
    a3 = m0 - m3
    o0 = (a0 + a1 + 7) >> 4
    o2 = (a0 - a1 + 7) >> 4
    o1 = ((a2 * 2217 + a3 * 5352 + 12000) >> 16) + (a3 != 0).to(torch.int32)
    o3 = (a3 * 2217 - a2 * 5352 + 51000) >> 16
    return torch.stack([o0, o1, o2, o3], dim=-2)


def wht4x4(coeffs: torch.Tensor) -> torch.Tensor:
    """Inverse WHT: [..., 4, 4] -> [..., 4, 4] sub-block DC values."""
    c = coeffs.to(torch.int32)
    i0, i1, i2, i3 = c[..., 0, :], c[..., 1, :], c[..., 2, :], c[..., 3, :]
    a0 = i0 + i3
    a1 = i1 + i2
    a2 = i1 - i2
    a3 = i0 - i3
    tmp = torch.stack([a0 + a1, a3 + a2, a0 - a1, a3 - a2], dim=-2)
    dc = tmp[..., 0] + 3
    a0 = dc + tmp[..., 3]
    a1 = tmp[..., 1] + tmp[..., 2]
    a2 = tmp[..., 1] - tmp[..., 2]
    a3 = dc - tmp[..., 3]
    return torch.stack([a0 + a1, a3 + a2, a0 - a1, a3 - a2], dim=-1) >> 3


def fwht4x4(dcs: torch.Tensor) -> torch.Tensor:
    """Forward WHT over sub-block DCs [..., 4, 4]."""
    d = dcs.to(torch.int32)
    c0, c1, c2, c3 = d[..., 0], d[..., 1], d[..., 2], d[..., 3]
    a0 = c0 + c2
    a1 = c1 + c3
    a2 = c1 - c3
    a3 = c0 - c2
    tmp = torch.stack([a0 + a1, a3 + a2, a3 - a2, a0 - a1], dim=-1)
    r0, r1, r2, r3 = (tmp[..., 0, :], tmp[..., 1, :], tmp[..., 2, :],
                      tmp[..., 3, :])
    a0 = r0 + r2
    a1 = r1 + r3
    a2 = r1 - r3
    a3 = r0 - r2
    return torch.stack([a0 + a1, a3 + a2, a3 - a2, a0 - a1], dim=-2) >> 1
