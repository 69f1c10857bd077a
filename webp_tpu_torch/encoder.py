"""The single-image entry point and the host RGB -> YUV 4:2:0 import.

Counterpart of webp_tpu/encoder.py, its device branch:

    encode(img, device=None, **options) -> bytes

writes the file webp_tpu.encode(img, backend="device", **options) writes,
byte for byte, for every option this package ports (EncoderOptions,
presets, segments, SNS, filter and partition options, preprocessing and
dithering, methods 0-6, sharp YUV, ICC/EXIF/XMP metadata through VP8X).
Methods 5 and 6 run the closed loop at skew 2 with the trellis, 6 with
the in-loop I4/UV search; use_sharp_yuv imports with the sharp-YUV
refinement on the device. The device
program runs on the card (device=None) or, with device="cpu", as the
kernels' plain versions. Options that need a slice not ported yet raise
NotImplementedError naming the ROADMAP item that brings them.

The device path converts RGB to YUV on the device (ops/yuv.py, whose
constants live here, or ops/sharpyuv.py); the host planes of
rgb_to_yuv420 (or of the host sharp converter) feed only the exact host
encoder that re-encodes an image whose escape list overflowed the
device's capacity (lossy/device_encode.py).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import numpy as np

from .container import riff as r
from .container.riff import WebPError

MAX_DIMENSION = 16383


@dataclass
class EncoderOptions:
    """Mirrors the reference's EncoderOptions (encode.go:42-187). The
    port's backend is "device", its only one."""

    lossless: bool = False
    quality: float = 75.0
    method: int = 4
    target_size: int = 0
    target_psnr: float = 0.0
    segments: int = 4
    sns_strength: int = 50
    filter_strength: int = 60
    filter_sharpness: int = 0
    filter_type: int = 1
    autofilter: bool = False
    alpha_compression: int = 1
    alpha_filtering: int = 1
    alpha_quality: int = 100
    pass_count: int = 1
    preprocessing: int = 0
    partitions: int = 0
    partition_limit: int = 0
    use_sharp_yuv: bool = False
    exact: bool = False
    near_lossless: int = 100
    backend: str = "device"
    dithering: float = 0.0  # 0..1 dither strength for RGB->YUV import
    # Metadata
    iccp: bytes = b""
    exif: bytes = b""
    xmp: bytes = b""


PRESETS = {
    "default": {},
    "picture": dict(sns_strength=80, filter_sharpness=4, filter_strength=35),
    "photo": dict(sns_strength=80, filter_sharpness=3, filter_strength=30),
    "drawing": dict(sns_strength=25, filter_sharpness=6, filter_strength=10),
    "icon": dict(sns_strength=0, filter_strength=0),
    "text": dict(sns_strength=0, filter_strength=0, segments=2),
}


def options_for_preset(preset: str, quality: float = 75.0) -> EncoderOptions:
    if preset not in PRESETS:
        raise WebPError(f"webp: unknown preset {preset!r}")
    return EncoderOptions(quality=quality, **PRESETS[preset])


@dataclass
class EncStats:
    """Per-encode statistics (the reference's EncStats). The device path
    keeps no host reconstruction, so psnr stays 0.0, as in the
    reference."""

    psnr: float = 0.0
    size: int = 0
    quality: float = 0.0
    passes: int = 1
    part0_size: int = 0         # header+modes+proba partition bytes
    token_sizes: tuple = ()     # per token partition
    alpha_size: int = 0         # ALPH payload bytes


LAST_STATS = EncStats()


# --- RGB -> YUV420 import (gamma-correct chroma averaging) -----------------

K_RGB_TO_Y = (16839, 33059, 6420)
K_RGB_TO_U = (-9719, -19081, 28800)
K_RGB_TO_V = (28800, -24116, -4684)
YUV_FIX = 16
YUV_HALF = 1 << (YUV_FIX - 1)


def rgb_to_yuv420(rgb: np.ndarray, dithering: float = 0.0):
    """Converts uint8 RGB [h, w, 3] to YUV420 planes padded to MB multiples
    by border replication: per-pixel integer luma, chroma from
    gamma-corrected 2x2 accumulation (the reference's standard import,
    lossy/encode.go:671-838). Runs the port's native importer, which is
    built with the host coder (a failed build raises). With dithering > 0
    the luma rounding term comes from the VP8Random lagged-Fibonacci
    stream (dithered import, encode.go:690-695): luma is recomputed with it
    and its border replicated again; chroma is not dithered."""
    from .native.api import native_yuv_import

    Y, U, V = native_yuv_import(rgb)
    if dithering > 0.0:
        from .utils.random import random_stream

        h, w = rgb.shape[:2]
        c = rgb[..., :3].astype(np.int64)
        rounding = random_stream(h * w, YUV_FIX, dithering).reshape(h, w)
        yy = (K_RGB_TO_Y[0] * c[..., 0] + K_RGB_TO_Y[1] * c[..., 1]
              + K_RGB_TO_Y[2] * c[..., 2] + rounding
              + (16 << YUV_FIX)) >> YUV_FIX
        Y[:h, :w] = np.clip(yy, 0, 255)
        Y[:h, w:] = Y[:h, w - 1:w]
        Y[h:] = Y[h - 1:h]
    return Y, U, V


# --- Encode entry point -----------------------------------------------------


def _to_array(img) -> np.ndarray:
    a = np.asarray(img)
    if a.dtype != np.uint8 or a.ndim != 3 or a.shape[2] not in (3, 4):
        raise WebPError("webp: encode expects uint8 [h,w,3|4] array")
    return a


def _has_alpha(a: np.ndarray) -> bool:
    return a.shape[2] == 4 and bool((a[..., 3] != 255).any())


def _unported(opts: EncoderOptions, a: np.ndarray) -> Optional[str]:
    """Why these options need a slice that is not ported yet (the ROADMAP
    item that brings it), or None."""
    if opts.backend != "device":
        return (f'backend="{opts.backend}": only the device path is ported '
                "(the host encoder runs only as the escape-overflow "
                "fallback)")
    if opts.lossless:
        return "lossless: the VP8L encoder is ROADMAP item 14"
    if opts.target_size > 0 or opts.target_psnr > 0:
        return ("target_size/target_psnr: rate control needs the decoder, "
                "ROADMAP item 13")
    if opts.autofilter:
        return "autofilter: the device path's autofilter needs the decoder, " \
               "ROADMAP item 13"
    if _has_alpha(a):
        return ("alpha < 255: the ALPH chunk needs the lossless coder, "
                "ROADMAP item 14")
    return None


def encode(img, device=None, **options) -> bytes:
    """Encodes an RGB(A) uint8 array [h, w, 3|4] to a WebP file, the
    device program on `device` (None: the card; "cpu": the plain
    versions). Keyword options are EncoderOptions' fields, or
    options=EncoderOptions(...). An RGBA image whose alpha is 255
    everywhere encodes as RGB."""
    a = _to_array(img)
    opts = options["options"] if isinstance(options.get("options"),
                                            EncoderOptions) \
        else EncoderOptions(**options)
    h, w = a.shape[:2]
    if w == 0 or h == 0 or w > MAX_DIMENSION or h > MAX_DIMENSION:
        raise WebPError("webp: invalid dimensions")
    why = _unported(opts, a)
    if why is not None:
        raise NotImplementedError(f"webp_tpu_torch.encode: {why}")
    return _encode_lossy(a, opts, device)


def _encode_lossy(a: np.ndarray, opts: EncoderOptions, device) -> bytes:
    """The reference's _encode_lossy, device branch: the padded RGB for the
    device, host entropy coding; host YUV planes only for the overflow
    fallback, imported when it is taken."""
    from .lossy.device_encode import pad_to_macroblocks, planeless
    from .lossy.encode import LossyConfig

    global LAST_STATS
    h, w = a.shape[:2]
    rgb = a[..., :3]
    dither = opts.dithering
    if opts.preprocessing & 2 and dither <= 0.0:
        # preprocessing bit 1 = pseudo-random dithering, amplitude from
        # quality (reference encode.go:517: 1.0 - 0.5*(q/100)^4).
        x = max(0.0, min(1.0, opts.quality / 100.0))
        dither = 1.0 - 0.5 * x ** 4
    cfg = LossyConfig(
        quality=int(opts.quality),
        method=opts.method,
        segments=opts.segments,
        filter_strength=opts.filter_strength,
        filter_sharpness=opts.filter_sharpness,
        filter_type=opts.filter_type,
        partitions=opts.partitions,
        sns_strength=opts.sns_strength,
        sharp_yuv=opts.use_sharp_yuv,
        autofilter=bool(opts.autofilter),
        partition_limit=int(opts.partition_limit),
        preprocessing=int(opts.preprocessing),
    )
    enc = planeless(w, h, cfg)
    enc.dithering = dither
    enc.rgb_input = pad_to_macroblocks(rgb[None])[0]
    vp8 = enc.encode(device=device)
    LAST_STATS = EncStats(size=len(vp8), quality=opts.quality, passes=1,
                          part0_size=getattr(enc, "stats_part0", 0),
                          token_sizes=tuple(getattr(enc, "stats_parts", ())))
    if not (opts.iccp or opts.exif or opts.xmp):
        return r.assemble_riff([r.Chunk(r.VP8, vp8)])
    return _assemble_extended(w, h, vp8, opts)


def _assemble_extended(w: int, h: int, vp8: bytes,
                       opts: EncoderOptions) -> bytes:
    """VP8X container with the metadata chunks around the VP8 frame (the
    reference's _assemble_extended without ALPH and VP8L)."""
    flags = ((r.FLAG_ICCP if opts.iccp else 0)
             | (r.FLAG_EXIF if opts.exif else 0)
             | (r.FLAG_XMP if opts.xmp else 0))
    vp8x = flags.to_bytes(4, "little") + (w - 1).to_bytes(3, "little") + \
        (h - 1).to_bytes(3, "little")
    chunks = [r.Chunk(r.VP8X, vp8x)]
    if opts.iccp:
        chunks.append(r.Chunk(r.ICCP, opts.iccp))
    chunks.append(r.Chunk(r.VP8, vp8))
    if opts.exif:
        chunks.append(r.Chunk(r.EXIF, opts.exif))
    if opts.xmp:
        chunks.append(r.Chunk(r.XMP, opts.xmp))
    return r.assemble_riff(chunks)
