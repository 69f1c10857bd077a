"""The reference encoder of a lossless configuration: the WebP file that
`encode(img, lossless=True, **options)` must write (a simple RIFF
container with one VP8L frame), by the frozen copy of the lossless
encoder in vp8lref/, and the pixels the file must decode to.

Only the options a lossless configuration sets are followed: lossless
(which must be true), quality, method, exact and near_lossless. Anything
else raises (metadata, the lossy options, backends), so that a
configuration this reference cannot follow never passes as checked.
There is no lossless stream: stream_frame raises.
"""

from __future__ import annotations

import numpy as np

from .vp8lref import encode as E

# encode()'s defaults for the options this reference follows.
DEFAULTS = {"lossless": True, "quality": 75, "method": 4, "exact": False,
            "near_lossless": 100}


def _options(options: dict) -> dict:
    unknown = set(options) - set(DEFAULTS)
    if unknown:
        raise ValueError(f"the lossless reference does not follow options "
                         f"{sorted(unknown)}")
    opts = dict(DEFAULTS, **options)
    if opts["lossless"] is not True:
        raise ValueError("the lossless reference writes VP8L only")
    if not 0 <= int(opts["method"]) <= 6:
        raise ValueError("method is 0-6")
    if not 0 <= int(opts["near_lossless"]) <= 100:
        raise ValueError("near_lossless is 0-100")
    return opts


def _riff(chunk: bytes, payload: bytes) -> bytes:
    pad = b"\0" if len(payload) & 1 else b""
    body = b"WEBP" + chunk + len(payload).to_bytes(4, "little") + payload \
        + pad
    return b"RIFF" + len(body).to_bytes(4, "little") + body


def encode_file(rgb: np.ndarray, options: dict):
    """(file, reconstruction): the file encode(rgb, **options) must write
    and the (R, G, B) uint8 planes it must decode to: the input's, or
    with near_lossless below 100 the pixels after that step."""
    opts = _options(options)
    rgb = np.asarray(rgb)
    if rgb.dtype != np.uint8 or rgb.ndim != 3 or rgb.shape[2] != 3:
        raise ValueError("the lossless reference takes RGB uint8 [h, w, 3]")
    argb = E.prepare(rgb, bool(opts["exact"]), int(opts["near_lossless"]))
    has_alpha = bool(((argb >> np.uint32(24)) != 255).any())
    payload = E.encode_vp8l_argb(argb, quality=int(opts["quality"]),
                                 method=int(opts["method"]),
                                 alpha_hint=has_alpha)
    px = argb.view(np.uint8).reshape(argb.shape + (4,))
    recon = tuple(np.ascontiguousarray(px[..., c]) for c in (2, 1, 0))
    return _riff(b"VP8L", payload), recon


def stream_frame(rgb: np.ndarray, options: dict):
    """Raises: no entry point streams lossless frames."""
    raise ValueError("there is no lossless stream (encode_lossy_stream "
                     "writes VP8 only)")
