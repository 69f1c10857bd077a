"""Shared device quantizer construction (counterpart of
webp_tpu/ops/pipeline.py)."""

from __future__ import annotations

import torch

from ..lossy import tables as T
from ..lossy.encode import quality_to_qindex
from ..lossy.quant import SegmentQuant


def quant_params(quality: int):
    """Builds quantizer tensors for all three coefficient classes:
    {y1/y2/uv: (q, iq, bias, sharpen)} int32 [16] each, zigzag order."""
    q = quality_to_qindex(quality)
    dc_t, ac_t, ac2_t = T.DC_TABLE, T.AC_TABLE, T.AC_TABLE2
    clip = lambda v, m: max(0, min(m, v))
    y1 = SegmentQuant.make(int(dc_t[q]), int(ac_t[q]), 0, sharpen=True)
    y2 = SegmentQuant.make(max(8, int(dc_t[q]) * 2), int(ac2_t[q]), 1)
    uv = SegmentQuant.make(int(dc_t[clip(q, 117)]), int(ac_t[q]), 2)
    out = {}
    for name, sq in (("y1", y1), ("y2", y2), ("uv", uv)):
        out[name] = tuple(
            torch.as_tensor(v, dtype=torch.int32)
            for v in (sq.q, sq.iq, sq.bias, sq.sharpen)
        )
    return out
