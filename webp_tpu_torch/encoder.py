"""Host RGB -> YUV 4:2:0 import.

The device path converts on the card (ops/yuv.py, whose constants live
here); the host converts with the native importer (native/src/yuv_import.cc)
for the stream's host-YUV uploads and for the exact host encoder that
re-encodes an image whose escape list overflowed the device's capacity
(lossy/device_encode.py).
"""

from __future__ import annotations

import numpy as np

K_RGB_TO_Y = (16839, 33059, 6420)
K_RGB_TO_U = (-9719, -19081, 28800)
K_RGB_TO_V = (28800, -24116, -4684)
YUV_FIX = 16
YUV_HALF = 1 << (YUV_FIX - 1)


def rgb_to_yuv420(rgb: np.ndarray):
    """Converts uint8 RGB [h, w, 3] to YUV420 planes padded to MB multiples
    by border replication: per-pixel integer luma, chroma from
    gamma-corrected 2x2 accumulation (the reference's standard import,
    lossy/encode.go:671-838). Runs the port's native importer, which is
    built with the host coder; a failed build raises."""
    from .native.api import native_yuv_import

    return native_yuv_import(rgb)
