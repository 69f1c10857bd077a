"""The single-image entry point and the host RGB -> YUV 4:2:0 import.

Counterpart of webp_tpu/encoder.py:

    encode(img, device=None, **options) -> bytes

writes the file webp_tpu.encode(img, **options) writes, byte for byte,
for every option (EncoderOptions, presets, segments, SNS, filter and
partition options, autofilter, target size and PSNR, preprocessing and
dithering, methods 0-6, sharp YUV, lossless with near-lossless and
exact, alpha through an ALPH chunk, ICC/EXIF/XMP metadata through VP8X),
with one difference of default: the port's
backend is "device" (its entry points run on the card unless the caller
asks for the CPU), the reference's "host". So encode(img) equals
webp_tpu.encode(img, backend="device") and encode(img, backend="host")
equals webp_tpu.encode(img).

backend="device" (or "auto", which the reference also runs on its device
program whenever a device exists) runs the device program on `device`:
the card for None, the kernels' plain versions for "cpu"; with no card,
device=None raises. backend="host" runs the exact host encoder
(lossy/encode.py VP8Encoder with its native MB loop) on host planes.

lossless=True writes a VP8L frame (lossless/encode.py): the per-tile
predictor search runs on `device` with the device backends and in the
native C++ predictor with backend="host" (the same bytes); the rest of
the lossless encoder is host code, as in the reference. One difference
from the reference's bytes: where a Huffman tree's code-length code has
a single used symbol, the port writes 0 bits per run-length token, as
every decoder reads it; the reference writes 1 bit, and its file does
not decode (lossless/huffman_enc.py). An image with alpha < 255 gets an
ALPH chunk beside its VP8 frame, encoded on a host thread while the
lossy frame is encoded (lossy/alpha_enc.py), after the reference's
transparent-area cleanup unless exact=True.

The device path converts RGB to YUV on the device (ops/yuv.py, whose
constants live here, or ops/sharpyuv.py); the host planes of
rgb_to_yuv420 (or of the host sharp converter) feed the host backend,
the device path's autofilter search and the exact host encoder that
re-encodes an image whose escape list overflowed the device's capacity
(lossy/device_encode.py).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .container import riff as r
from .container.riff import WebPError

MAX_DIMENSION = 16383


@dataclass
class EncoderOptions:
    """Mirrors the reference's EncoderOptions (encode.go:42-187). backend:
    "device" (the default: the device program, on the card unless
    encode() is given device="cpu"), "auto" (the same program) or "host"
    (the exact host encoder; the reference's default)."""

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
    """Per-encode statistics (the reference's EncStats). psnr comes from
    the encoder's host reconstruction: the host backend's own, the device
    path's autofilter probe decode, or a rate-controlled encode's decoded
    file; a device encode without autofilter keeps none, so its psnr
    stays 0.0, as in the reference."""

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


BACKENDS = ("device", "auto", "host")


def encode(img, device=None, **options) -> bytes:
    """Encodes an RGB(A) uint8 array [h, w, 3|4] to a WebP file. The
    device backends run on `device` (None: the card; "cpu": the plain
    versions); backend="host" runs on the host whatever `device` says.
    Keyword options are EncoderOptions' fields, or
    options=EncoderOptions(...). An RGBA image whose alpha is 255
    everywhere encodes as RGB."""
    a = _to_array(img)
    opts = options["options"] if isinstance(options.get("options"),
                                            EncoderOptions) \
        else EncoderOptions(**options)
    h, w = a.shape[:2]
    if w == 0 or h == 0 or w > MAX_DIMENSION or h > MAX_DIMENSION:
        raise WebPError("webp: invalid dimensions")
    if opts.backend not in BACKENDS:
        raise ValueError(f"webp_tpu_torch.encode: unknown backend "
                         f"{opts.backend!r} (one of {BACKENDS})")
    if opts.lossless:
        return _encode_lossless(a, opts, device)
    if opts.target_size > 0 or opts.target_psnr > 0:
        return _encode_lossy_rate_controlled(a, opts, device)
    return _encode_lossy(a, opts, device)


def _psnr_of(a: np.ndarray, data: bytes) -> float:
    """PSNR of a file's pixels (the host decoder's) against the image."""
    from . import decode_rgba

    out = decode_rgba(data, backend="host")[..., : a.shape[2]]
    mse = float(np.mean((out.astype(np.float64) - a.astype(np.float64)) ** 2))
    return 99.0 if mse == 0 else 10.0 * np.log10(255.0 ** 2 / mse)


def _encode_lossy_rate_controlled(a: np.ndarray, opts: EncoderOptions,
                                  device) -> bytes:
    """Multi-pass rate control toward target_size / target_psnr (the
    reference's, encoder.py:260-370): the size(quality) curve modelled as
    a power law and stepped by secant in log-log space, the host YUV
    import computed once and reused by every pass, the probes at a
    reduced method (<= 2) and one landing pass at the configured method,
    then corrective passes down while a size target is missed. Works with
    every backend."""
    import math
    from dataclasses import replace

    global LAST_STATS
    q = opts.quality if 0 < opts.quality <= 100 else 75.0
    max_passes = max(3, opts.pass_count) if opts.pass_count > 1 else 3
    yuv_cache: dict = {}
    probe_opts = (replace(opts, method=min(2, opts.method))
                  if opts.method > 2 else opts)
    history = []       # (q, size or psnr)
    best_hit = None    # (q, data, ...) the best result meeting the target
    best_any = None

    def next_q_size(target):
        if len(history) == 1:
            q1, s1 = history[0]
            return q1 * (target / s1) ** 0.8
        (q1, s1), (q2, s2) = history[-2], history[-1]
        if s1 == s2 or q1 == q2:
            return q2 * (target / s2) ** 0.8
        b = (math.log(s2) - math.log(s1)) / (math.log(q2) - math.log(q1))
        if abs(b) < 1e-6:
            return q2 * (target / s2) ** 0.8
        return math.exp(math.log(q2) + (math.log(target) - math.log(s2)) / b)

    def one_pass(o, q_):
        return _encode_lossy(a, replace(o, quality=q_, target_size=0,
                                        target_psnr=0.0), device,
                             _yuv_cache=yuv_cache)

    probes_are_full = probe_opts is opts
    for p in range(max_passes):
        data = one_pass(probe_opts, q)
        if opts.target_size > 0:
            size = len(data)
            history.append((q, size))
            if size <= opts.target_size and \
                    (best_hit is None or q > best_hit[0]):
                best_hit = (q, data)
            if best_any is None or size < len(best_any[1]):
                best_any = (q, data)
            if opts.target_size * 0.95 <= size <= opts.target_size:
                break
            # Aim slightly under, so that the landing zone is [0.95, 1.0].
            q = max(1.0, min(100.0, next_q_size(0.97 * opts.target_size)))
        else:
            psnr = _psnr_of(a, data)
            history.append((q, 10.0 ** (psnr / 10.0)))
            if psnr >= opts.target_psnr and \
                    (best_hit is None or q < best_hit[0]):
                best_hit = (q, data)
            if best_any is None or psnr > best_any[2]:
                best_any = (q, data, psnr)
            if opts.target_psnr <= psnr <= opts.target_psnr + 0.5:
                break
            q = max(1.0, min(100.0,
                             next_q_size(10.0 ** (opts.target_psnr / 10.0))))
        if history and abs(q - history[-1][0]) < 0.5:
            break
    if not probes_are_full:
        # The landing pass at the configured method on the probes' quality
        # (reduced-method probes code slightly larger and at a lower PSNR
        # than the full method at equal q, so the choice is conservative).
        q_land = (best_hit if best_hit is not None else best_any)[0]
        data = one_pass(opts, q_land)
        p += 1
        if opts.target_size > 0 and len(data) <= opts.target_size:
            best_hit = (q_land, data)
        elif opts.target_size > 0:
            best_hit = None          # the cap is missed: corrective passes
            history.append((q_land, len(data)))
        else:
            best_hit = (q_land, data)
    if opts.target_size > 0 and best_hit is None:
        # The size target is a hard cap: passes down until under it.
        q, size = min(history, key=lambda hq: hq[1])
        for _ in range(3):
            q = max(1.0, q * min(0.9, (opts.target_size / size) ** 1.2))
            data = one_pass(opts, q)
            p += 1
            size = len(data)
            if size <= opts.target_size:
                best_hit = (q, data)
                break
            if q <= 1.0:
                break
        if best_hit is None:
            best_hit = (q, data)     # the q = 1 floor: the smallest file
    q_used, data = (best_hit if best_hit is not None else best_any)[:2]
    LAST_STATS = EncStats(psnr=_psnr_of(a, data), size=len(data),
                          quality=q_used, passes=p + 1)
    return data


def _host_planes(rgb, opts: EncoderOptions, dither: float, sharp: bool,
                 cache):
    """The host YUV planes of the image (the host sharp converter's with
    sharp, else the dithered import), reused from `cache` when a previous
    pass of a rate-controlled encode made the same ones."""
    key = ("sharp",) if sharp else ("plain", round(dither, 6))
    if cache is not None and cache.get("key") == key:
        return cache["planes"]
    if sharp:
        from .sharpyuv.convert import sharp_rgb_to_yuv420

        planes = sharp_rgb_to_yuv420(rgb)
    else:
        planes = rgb_to_yuv420(rgb, dithering=dither)
    if cache is not None:
        cache.update(key=key, planes=planes)
    return planes


def _encode_lossy(a: np.ndarray, opts: EncoderOptions, device,
                  _yuv_cache: dict = None) -> bytes:
    """The reference's _encode_lossy. Device backends: the padded RGB goes
    to the device program, host entropy coding; host planes only where
    the autofilter search reads them (the plain dithered import, even
    with sharp YUV, as the reference's), else the overflow fallback
    imports its own when it is taken. Host backend: the exact host
    encoder on host planes (sharp or dithered), PSNR from its
    reconstruction. With alpha < 255: unless exact=True, the
    transparent-area cleanup (reference encode.go:788: the RGB under
    invisible pixels smoothed so that it costs no DCT bits), and the ALPH
    plane encoded on a host thread while the frame is (as the
    reference's; both spend their time in native code or on the card)."""
    if _has_alpha(a):
        from concurrent.futures import ThreadPoolExecutor

        from .lossy.alpha_enc import encode_alpha
        from .utils.alpha import cleanup_transparent_lossy

        frame = a if opts.exact else cleanup_transparent_lossy(a)
        with ThreadPoolExecutor(max_workers=1) as ex:
            alpha_future = ex.submit(
                encode_alpha, a[..., 3], quality=opts.alpha_quality,
                method=opts.alpha_compression,
                filtering=opts.alpha_filtering, effort=opts.method)
            return _encode_lossy_frame(frame, opts, device, _yuv_cache,
                                       alpha_future)
    return _encode_lossy_frame(a, opts, device, _yuv_cache, None)


def _encode_lossy_frame(a: np.ndarray, opts: EncoderOptions, device,
                        _yuv_cache, alpha_future) -> bytes:
    """_encode_lossy's VP8 frame, then the container around it and the
    ALPH payload of alpha_future (None without alpha)."""
    from .lossy.device_encode import (DeviceVP8Encoder, pad_to_macroblocks,
                                      planeless)
    from .lossy.encode import LossyConfig, VP8Encoder

    global LAST_STATS
    h, w = a.shape[:2]
    rgb = a[..., :3]
    use_device = opts.backend in ("device", "auto")
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
    if not use_device:
        Y, U, V = _host_planes(rgb, opts, dither, opts.use_sharp_yuv,
                               _yuv_cache)
        enc = VP8Encoder(Y, U, V, w, h, cfg)
        vp8 = enc.encode()
    else:
        if opts.autofilter:
            Y, U, V = _host_planes(rgb, opts, dither, False, _yuv_cache)
            enc = DeviceVP8Encoder(Y, U, V, w, h, cfg)
        else:
            enc = planeless(w, h, cfg)
        enc.dithering = dither
        enc.rgb_input = pad_to_macroblocks(rgb[None])[0]
        vp8 = enc.encode(device=device)
    # PSNR from the encoder's own reconstruction where it exists on the
    # host (the reference's, lossy/encode.go:1614-1626).
    psnr = 0.0
    rec = enc.recY
    if np.any(rec):
        d = (rec.astype(np.float64) - enc.srcY.astype(np.float64)).ravel()
        se = float(np.dot(d, d))
        psnr = 99.0 if se == 0 else 10.0 * np.log10(255.0 ** 2 * rec.size / se)
    LAST_STATS = EncStats(psnr=psnr, size=len(vp8), quality=opts.quality,
                          passes=1,
                          part0_size=getattr(enc, "stats_part0", 0),
                          token_sizes=tuple(getattr(enc, "stats_parts", ())))
    alpha = b""
    if alpha_future is not None:
        alpha = alpha_future.result()
        LAST_STATS.alpha_size = len(alpha)
    if not (alpha or opts.iccp or opts.exif or opts.xmp):
        return r.assemble_riff([r.Chunk(r.VP8, vp8)])
    return _assemble_extended(w, h, opts, vp8=vp8, alpha=alpha)


def _encode_lossless(a: np.ndarray, opts: EncoderOptions, device) -> bytes:
    """A VP8L frame (the reference's _encode_lossless); the predictor
    search runs on `device` with the device backends, in native C++ with
    backend="host"."""
    from .lossless.encode import HOST, encode_vp8l
    from .lossy.device_encode import _resolve_device

    search = HOST if opts.backend == "host" else _resolve_device(device)
    payload = encode_vp8l(a, quality=int(opts.quality), method=opts.method,
                          exact=opts.exact, near_lossless=opts.near_lossless,
                          search=search)
    if not (opts.iccp or opts.exif or opts.xmp):
        return r.assemble_riff([r.Chunk(r.VP8L, payload)])
    h, w = a.shape[:2]
    return _assemble_extended(w, h, opts, vp8l=payload,
                              vp8l_alpha=_has_alpha(a))


def _assemble_extended(w: int, h: int, opts: EncoderOptions,
                       vp8: bytes = b"", vp8l: bytes = b"",
                       alpha: bytes = b"", vp8l_alpha: bool = False) -> bytes:
    """VP8X container: ICCP, ALPH, the VP8 or VP8L frame, EXIF, XMP."""
    flags = ((r.FLAG_ALPHA if alpha or vp8l_alpha else 0)
             | (r.FLAG_ICCP if opts.iccp else 0)
             | (r.FLAG_EXIF if opts.exif else 0)
             | (r.FLAG_XMP if opts.xmp else 0))
    vp8x = flags.to_bytes(4, "little") + (w - 1).to_bytes(3, "little") + \
        (h - 1).to_bytes(3, "little")
    chunks = [r.Chunk(r.VP8X, vp8x)]
    if opts.iccp:
        chunks.append(r.Chunk(r.ICCP, opts.iccp))
    if alpha:
        chunks.append(r.Chunk(r.ALPH, alpha))
    if vp8:
        chunks.append(r.Chunk(r.VP8, vp8))
    if vp8l:
        chunks.append(r.Chunk(r.VP8L, vp8l))
    if opts.exif:
        chunks.append(r.Chunk(r.EXIF, opts.exif))
    if opts.xmp:
        chunks.append(r.Chunk(r.XMP, opts.xmp))
    return r.assemble_riff(chunks)
