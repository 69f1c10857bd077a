"""The reference decoder: the RGB pixels that `decode(data)` must return
for a simple lossy WebP file (RIFF, WEBP, one VP8 chunk), by the
independent decoder vp8dec (token parse, reconstruction, loop filter,
fancy upsampling), and the partition-0 facts the roofline reads."""

from __future__ import annotations

import numpy as np

from . import vp8dec
from .vp8dec import vp8_payload


def decode_rgb(data: bytes, loop_filter: bool = True) -> np.ndarray:
    """RGB uint8 [h, w, 3]. loop_filter=False leaves the loop filter out
    (the control of the decode cells, which breaks the bitstream's
    filtering)."""
    return vp8dec.decode_rgb(data, loop_filter)


def decode_unfiltered(data: bytes):
    """The reconstruction before the loop filter, (Y, U, V) uint8 on the
    macroblock grid, of a simple lossy file or of a bare VP8 frame."""
    f = vp8dec.decode_frame(vp8_payload(data) if data[:4] == b"RIFF"
                            else data, loop_filter=False)
    return f.y_unfiltered, f.u_unfiltered, f.v_unfiltered


def partition0_modes(data: bytes) -> dict:
    """Counts of I16 and I4 macroblocks in the partition 0 (the header
    and modes alone, no tokens) of a simple lossy file or of a bare VP8
    frame: {"i16": n, "i4": n, "mbs": n}."""
    f = vp8dec.parse(vp8_payload(data) if data[:4] == b"RIFF" else data)
    n = int(f.is_i4.size)
    i4 = int(f.is_i4.sum())
    return {"i16": n - i4, "i4": i4, "mbs": n}
