"""webp_tpu_torch — the WebP codec (lossy and lossless encode and decode,
alpha) in PyTorch, with hand-written CUDA kernels for the NVIDIA H100
(sm_90a).

A port of the JAX package webp_tpu, which stays the reference: on the
same inputs this package writes byte-identical WebP files and decodes
to identical pixels.

    encode(img, device=None, **options) -> bytes
    encode_batch(images, quality=75, device=None) -> list[bytes]
    decode(data, backend="device", device=None) -> RGB or RGBA uint8
    decode_rgba(data, backend="device", device=None) -> RGBA uint8
    decode_config(data), get_features(data) -> Features

The port's entry points run on the card unless the caller asks for the
CPU: device=None means the card ("cuda"), device="cpu" runs every
kernel's plain PyTorch version instead, and a device backend with no card
raises. So the defaults differ from the reference's, whose backend
default is "host":

  * encode(img) equals webp_tpu.encode(img, backend="device"), and
    encode(img, backend="host") equals webp_tpu.encode(img);
  * decode(data) runs the device decode (its reconstruction, loop filter
    and upsampling on the card), decode(data, backend="host") the native
    decoder; both give webp_tpu.decode(data)'s pixels. VP8L frames and
    ALPH planes decode on the host on every backend.

LAST_STATS holds the last encode()'s EncStats.
"""

from __future__ import annotations

import numpy as np

from .container.parser import Parser, get_features
from .container.riff import Features, FormatType, WebPError
from .encoder import (PRESETS, EncoderOptions, EncStats, encode,
                      options_for_preset)

__version__ = "0.1.0"

__all__ = ["encode", "encode_batch", "decode", "decode_rgba",
           "decode_config", "get_features", "EncoderOptions", "EncStats",
           "Features", "FormatType", "PRESETS", "options_for_preset",
           "WebPError"]


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


def decode_rgba(data: bytes, backend: str = "device",
                device=None) -> np.ndarray:
    """Decodes a WebP file to an RGBA uint8 array [h, w, 4].

    A VP8 frame, backend="device": the host parses the tokens (native
    vp8_parse), the reconstruction, loop filter and upsampling run on
    `device` (None: the card; "cpu": their plain versions).
    backend="host": the native decoder. Both give the same pixels. An
    ALPH plane decodes on the host (lossy/alpha.py) with either backend.

    A VP8L frame decodes in the native VP8L decoder on every backend:
    neither this package nor the reference has a device VP8L decode."""
    if backend not in ("device", "host"):
        raise ValueError(f"webp_tpu_torch: unknown decode backend "
                         f"{backend!r}")
    frames = Parser(data).frames()
    if not frames:
        raise WebPError("webp: no image frame")
    fr = frames[0]
    if fr.is_lossless:
        from .lossless.decode import argb_to_rgba, decode_vp8l

        return argb_to_rgba(decode_vp8l(fr.bitstream)[0])
    if backend == "host":
        from .lossy.decode import decode_vp8_rgba

        return decode_vp8_rgba(fr.bitstream,
                               fr.alpha if fr.has_alpha else None)
    from .lossy.device_decode import decode_vp8_rgb_device

    rgb = decode_vp8_rgb_device(fr.bitstream, device=device)
    h, w = rgb.shape[:2]
    rgba = np.empty((h, w, 4), dtype=np.uint8)
    rgba[..., :3] = rgb
    if fr.has_alpha and fr.alpha:
        from .lossy.alpha import decode_alpha

        rgba[..., 3] = decode_alpha(fr.alpha, w, h)
    else:
        rgba[..., 3] = 255
    return rgba


def decode(data: bytes, backend: str = "device", device=None) -> np.ndarray:
    """Decodes a WebP file: RGBA if the image has alpha, else RGB."""
    rgba = decode_rgba(data, backend=backend, device=device)
    f = get_features(data)
    if f.has_alpha:
        return rgba
    if f.format == FormatType.VP8:
        # A simple lossy file cannot carry alpha.
        return rgba[..., :3]
    if bool((rgba[..., 3] != 255).any()):
        return rgba
    return rgba[..., :3]


def decode_config(data: bytes) -> Features:
    """Parses the headers only: dimensions, format, alpha."""
    return get_features(data)
