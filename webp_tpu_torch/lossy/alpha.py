"""ALPH alpha-plane codec (decode side; encoder in alpha_enc.py).

Parity with the reference's internal/lossy/alpha.go: 1-byte header
(compression method, filter, preprocessing), raw or VP8L-compressed payload
(alpha stored in the green channel), then one of 4 inverse prediction filters.
"""

from __future__ import annotations

import struct

import numpy as np

from ..container.riff import WebPError

FILTER_NONE, FILTER_HORIZONTAL, FILTER_VERTICAL, FILTER_GRADIENT = range(4)


def _vp8l_header(width: int, height: int) -> bytes:
    bits = (width - 1) | ((height - 1) << 14) | (1 << 28)  # alpha hint set
    return bytes([0x2F]) + struct.pack("<I", bits)


def unfilter_horizontal(a: np.ndarray) -> np.ndarray:
    h, w = a.shape
    out = a.astype(np.uint32)
    # Row-wise prefix sums mod 256; row y's first pixel adds prev row's first.
    out = np.cumsum(out, axis=1, dtype=np.uint32) & 0xFF  # per-row cumsum
    # Chain row heads: out[y,0] += out[y-1,0] cumulatively, propagating to rows.
    heads = np.cumsum(a[:, 0].astype(np.uint32)) & 0xFF
    add = (heads - a[:, 0]) & 0xFF  # amount to add to each row (prev heads sum)
    out = (out + add[:, None]) & 0xFF
    return out.astype(np.uint8)


def unfilter_vertical(a: np.ndarray) -> np.ndarray:
    out = a.astype(np.uint32).copy()
    out[0] = np.cumsum(out[0], dtype=np.uint32) & 0xFF
    out = np.cumsum(out, axis=0, dtype=np.uint32) & 0xFF
    return out.astype(np.uint8)


def unfilter_gradient(a: np.ndarray) -> np.ndarray:
    h, w = a.shape
    out = a.copy()
    row0 = np.cumsum(out[0].astype(np.uint32), dtype=np.uint32) & 0xFF
    out[0] = row0.astype(np.uint8)
    for y in range(1, h):
        prev = out[y - 1].astype(np.int32)
        cur = out[y]
        top = int(prev[0])
        top_left = top
        left = top
        for x in range(w):
            top = int(prev[x])
            pred = left + top - top_left
            pred = 0 if pred < 0 else (255 if pred > 255 else pred)
            left = (int(cur[x]) + pred) & 0xFF
            top_left = top
            cur[x] = left
    return out


UNFILTERS = {
    FILTER_NONE: lambda a: a,
    FILTER_HORIZONTAL: unfilter_horizontal,
    FILTER_VERTICAL: unfilter_vertical,
    FILTER_GRADIENT: unfilter_gradient,
}


def decode_alpha(data: bytes, width: int, height: int) -> np.ndarray:
    """Decodes an ALPH payload to a uint8 [height, width] alpha plane."""
    if len(data) < 1:
        raise WebPError("alpha: empty data")
    header = data[0]
    compression = header & 0x03
    filtering = (header >> 2) & 0x03
    payload = data[1:]
    n = width * height
    if compression == 0:
        if len(payload) < n:
            raise WebPError("alpha: truncated raw data")
        raw = np.frombuffer(payload[:n], dtype=np.uint8).reshape(height, width).copy()
    elif compression == 1:
        from ..lossless.decode import VP8LDecoder

        dec = VP8LDecoder(_vp8l_header(width, height) + payload)
        argb = dec.decode()
        raw = ((argb >> np.uint32(8)) & np.uint32(0xFF)).astype(np.uint8)
        raw = raw[:height, :width].copy()
    else:
        raise WebPError(f"alpha: unknown compression {compression}")
    return UNFILTERS[filtering](raw)
