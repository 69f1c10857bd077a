"""webp_tpu_torch — the WebP codec's lossy device encode in PyTorch, with
hand-written CUDA kernels for the NVIDIA H100 (sm_90a).

A port of the JAX package webp_tpu, which stays the reference: on the
same inputs this package writes byte-identical WebP files.

    encode(img, device=None, **options) -> bytes
        (webp_tpu.encode(img, backend="device", **options))
    encode_batch(images, quality=75, device=None) -> list[bytes]

device=None runs on the card ("cuda"); device="cpu" runs every kernel's
plain PyTorch version instead. LAST_STATS holds the last encode()'s
EncStats.
"""

from __future__ import annotations

import numpy as np

from .container.riff import WebPError
from .encoder import (PRESETS, EncoderOptions, EncStats, encode,
                      options_for_preset)

__version__ = "0.1.0"

__all__ = ["encode", "encode_batch", "EncoderOptions", "EncStats",
           "PRESETS", "options_for_preset", "WebPError"]


def __getattr__(name):
    if name == "LAST_STATS":
        from . import encoder

        return encoder.LAST_STATS
    raise AttributeError(name)


def encode_batch(images, quality: int = 75, device=None, **options) -> list:
    """Encodes a batch of same-sized RGB images in one device program
    (lossy, skew-1 wavefront) and returns the WebP files. Images whose
    sides are not multiples of 16 are edge-padded for the device and
    cropped by the frame header."""
    from .container import riff as r
    from .lossy.device_encode import encode_lossy_batch, pad_to_macroblocks

    rgbs = np.stack([np.asarray(im)[..., :3] for im in images])
    B, h, w = rgbs.shape[:3]
    rgbs = pad_to_macroblocks(rgbs)
    bitstreams = encode_lossy_batch(rgbs, quality=int(quality),
                                    true_width=w, true_height=h,
                                    device=device, **options)
    return [r.assemble_riff([r.Chunk(r.VP8, b)]) for b in bitstreams]
