"""The reference decoder of a lossless configuration: the pixels of a
simple lossless WebP file (RIFF, WEBP, one VP8L chunk), by the
independent decoder vp8ldec (written from RFC 9649). A file of any other
form raises."""

from __future__ import annotations

import numpy as np

from . import vp8ldec


def decode_rgb(data: bytes, loop_filter: bool = True) -> np.ndarray:
    """RGB uint8 [h, w, 3]. VP8L has no loop filter: loop_filter is
    accepted for the decoder role's contract and ignored."""
    return vp8ldec.decode_rgb(data)


def decode_unfiltered(data: bytes):
    """The (R, G, B) uint8 planes of the file: a lossless file's
    reconstruction is its pixels."""
    rgb = vp8ldec.decode_rgb(data)
    return tuple(np.ascontiguousarray(rgb[..., c]) for c in range(3))
