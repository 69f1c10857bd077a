"""Device-side VP8 quantization (PyTorch), with the quantizers of
webp_tpu_torch.lossy.quant. Counterpart of webp_tpu/ops/quant.py."""

from __future__ import annotations

import numpy as np
import torch

QFIX = 17
MAX_LEVEL = 2047

# Per-frequency trellis distortion weights, zigzag order
# (reference encode_trellis.go).
_WT = np.array([30, 27, 19, 11, 27, 24, 17, 10,
                19, 17, 12, 8, 11, 10, 8, 6], np.float32)


def quantize(coeffs: torch.Tensor, q, iq, bias, sharpen, zigzag: np.ndarray,
             first: int = 0, rd_drop: float = 0.0):
    """coeffs int32 [..., 16] raster -> (levels_zz [..., 16], dequant [..., 16]).

    q/iq/bias/sharpen: int32 [16] in zigzag order (SegmentQuant layout),
    tensors on coeffs' device.

    rd_drop > 0 enables the trellis-lite RD dropout: a |level|==1
    coefficient is zeroed when the ~rate it costs (rd_drop, in the <<8 bit
    units of the host cost tables, scaled by the trellis lambda derived
    from this row's q) exceeds the weighted distortion increase.
    """
    dev = coeffs.device
    zz = torch.as_tensor(np.asarray(zigzag), dtype=torch.long, device=dev)
    czz = coeffs.index_select(-1, zz)
    sign = czz < 0
    mag = czz.abs() + sharpen
    level = ((mag * iq + bias) >> QFIX).clamp(max=MAX_LEVEL)
    if rd_drop:
        qf = q.to(torch.float32)
        c0 = mag.to(torch.float32)
        dd = (torch.as_tensor(_WT, device=dev)
              * (c0 * c0 - (c0 - qf) * (c0 - qf)))
        base = torch.floor((qf[..., 0:1] + 15.0 * qf[..., 1:2] + 8.0)
                           * (1.0 / 16.0))
        tlam = base * base * 0.25  # TLambda (lossy/encode.py:236)
        level = torch.where((level == 1) & (256.0 * dd < rd_drop * tlam),
                            0, level)
    level = torch.where(sign, -level, level)
    if first:
        level = level.clone()
        level[..., 0] = 0
    dq_zz = level * q
    inv = torch.as_tensor(np.argsort(np.asarray(zigzag)), dtype=torch.long,
                          device=dev)
    return level, dq_zz.index_select(-1, inv)
