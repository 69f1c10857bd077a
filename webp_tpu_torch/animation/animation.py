"""Animated WebP (ANIM/ANMF): decode, compositor and encoders.

Counterpart of webp_tpu/animation/animation.py (after the Go reference's
animation/animation.go): the frame model, the canvas compositor
(dispose-to-background = transparent black, exact integer alpha blend),
an encoder with identical-frame merging, changed-rect sub-frame encoding,
the kmin/kmax keyframe policy, the per-frame lossy/lossless choice and
the single-frame simple-WebP fallback, and the frame-batch device encode.

Where each part runs (device=None means the card, "cpu" the plain
versions; the files and pixels are the reference's on every backend):

  * decode_animation(data, backend="device"): the lossy frames' VP8
    bitstreams through the device decode stream, in frame order; VP8L
    frames and ALPH planes on host threads beside it. backend="host":
    every frame by the native decoders on a thread pool, as the
    reference does.
  * AnimDecoder(anim, device=None): compositing and disposal on
    `device`, the canvas kept there as a uint8 tensor (elementwise
    PyTorch operations; the reference has no kernel for it).
  * AnimEncoder / encode_animation: frame diffing and the candidate
    choice on the host; lossy frames by the host VP8Encoder, as in the
    reference (neither package has a device lossy path here); the
    lossless candidates' predictor search on `device`, or the native
    predictor with backend="host".
  * encode_animation_device: every unique frame through
    encode_lossy_stream, so through the four kernels once per batch.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass, field
from typing import Iterator, List, Optional, Tuple

import numpy as np
import torch

from ..container import riff as r
from ..container.parser import Parser
from ..container.riff import BlendMethod, DisposeMethod, WebPError
from ..encoder import check_backend
from ..lossy.device_encode import _resolve_device
from ..mux.mux import Muxer, MuxFrame

BACKENDS = ("device", "host")


@dataclass
class Frame:
    """One decoded animation frame (pre-composition)."""

    rgba: np.ndarray  # uint8 [h, w, 4]
    x_offset: int = 0
    y_offset: int = 0
    duration_ms: int = 100
    dispose: DisposeMethod = DisposeMethod.NONE
    blend: BlendMethod = BlendMethod.ALPHA
    has_alpha: bool = False


@dataclass
class Animation:
    canvas_width: int = 0
    canvas_height: int = 0
    loop_count: int = 0
    bgcolor: int = 0
    frames: List[Frame] = field(default_factory=list)


def _decode_frame_pixels(fr) -> np.ndarray:
    """One frame by the native decoders (host)."""
    if fr.is_lossless:
        from ..lossless.decode import argb_to_rgba, decode_vp8l

        argb, _ = decode_vp8l(fr.bitstream)
        return argb_to_rgba(argb)
    from ..lossy.decode import decode_vp8_rgba

    return decode_vp8_rgba(fr.bitstream, fr.alpha if fr.alpha else None)


def _alpha_plane(fr):
    """A lossy frame's alpha plane from its ALPH payload (host), else 255."""
    if not fr.alpha:
        return 255
    from ..container.parser import parse_vp8_dimensions
    from ..lossy.alpha import decode_alpha

    w, h = parse_vp8_dimensions(fr.bitstream)
    return decode_alpha(fr.alpha, w, h)


def _decode_all(raw, backend: str, device) -> list:
    with ThreadPoolExecutor(max_workers=max(1, min(8, len(raw)))) as ex:
        if backend == "host":
            return list(ex.map(_decode_frame_pixels, raw))
        # The host's share (VP8L frames, ALPH planes) runs on the pool
        # while the lossy frames go through the device stream here.
        host = [ex.submit(_decode_frame_pixels if fr.is_lossless
                          else _alpha_plane, fr) for fr in raw]
        lossy = [fr.bitstream for fr in raw if not fr.is_lossless]
        rgbs = iter([])
        if lossy:
            from ..lossy.device_decode import decode_lossy_stream_device

            rgbs = iter(decode_lossy_stream_device(lossy, device=device))
        out = []
        for fr, fut in zip(raw, host):
            if fr.is_lossless:
                out.append(fut.result())
                continue
            rgb = next(rgbs)
            rgba = np.empty(rgb.shape[:2] + (4,), dtype=np.uint8)
            rgba[..., :3] = rgb
            rgba[..., 3] = fut.result()
            out.append(rgba)
        return out


def decode_animation(data: bytes, backend: str = "device",
                     device=None) -> Animation:
    """Parses and pixel-decodes every frame of an animated (or still) WebP.

    backend="device" (the default): the lossy frames' VP8 bitstreams go,
    in frame order, through the device decode stream on `device` (None:
    the card; "cpu": the plain versions); VP8L frames and ALPH planes
    decode on host threads meanwhile. backend="host": every frame by the
    native decoders on a thread pool (the reference's decode_animation,
    which has no backend argument). Both give the reference's pixels.
    Composition happens later, in AnimDecoder.

    On the card each lossy frame is one launch of the decode kernel
    (csrc/decode_wavefront.cu) between its host token parse and the
    upsampling.
    """
    check_backend(backend, "decode_animation", BACKENDS)
    p = Parser(data)
    f = p.features
    anim = Animation(
        canvas_width=f.width or f.canvas_width,
        canvas_height=f.height or f.canvas_height,
        loop_count=f.loop_count,
        bgcolor=f.bgcolor,
    )
    raw = list(p.frames())
    rgbas = _decode_all(raw, backend, device)
    for fr, rgba in zip(raw, rgbas):
        anim.frames.append(Frame(
            rgba=rgba, x_offset=fr.x_offset, y_offset=fr.y_offset,
            duration_ms=fr.duration_ms, dispose=fr.dispose, blend=fr.blend,
            has_alpha=fr.has_alpha,
        ))
    if not anim.frames:
        raise WebPError("webp: no animation frames")
    if anim.canvas_width == 0:
        anim.canvas_width = anim.frames[0].rgba.shape[1]
        anim.canvas_height = anim.frames[0].rgba.shape[0]
    # Frame rectangles must fit the declared canvas (the libwebp demux
    # checks): slice clipping would otherwise composite silently truncated
    # frames from a corrupt file.
    for i, fr in enumerate(anim.frames):
        fh, fw = fr.rgba.shape[:2]
        if (fr.x_offset + fw > anim.canvas_width
                or fr.y_offset + fh > anim.canvas_height):
            raise WebPError(
                f"webp: animation frame {i} exceeds canvas")
    return anim


def alpha_blend(src: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
    """Exact integer alpha blend of uint8 RGBA tensors [..., 4] (the
    reference's, animation.go:1243-1279), on their device. The reference's
    uint64 products stay below 2^42, so int64 holds them."""
    src_a = src[..., 3].to(torch.int64)
    dst_a = dst[..., 3].to(torch.int64)
    dst_factor_a = (dst_a * (256 - src_a)) >> 8
    blend_a = src_a + dst_factor_a
    scale = torch.where(blend_a > 0, (1 << 24) // blend_a.clamp(min=1), 0)
    rgb = ((src[..., :3].to(torch.int64) * src_a[..., None]
            + dst[..., :3].to(torch.int64) * dst_factor_a[..., None])
           * scale[..., None]) >> 24
    out = torch.cat([rgb, blend_a[..., None]], dim=-1).clamp(max=255).to(
        torch.uint8)
    # src fully transparent -> dst; src opaque or dst transparent -> src.
    take_dst = (src_a == 0)[..., None]
    take_src = ((src_a == 255) | (dst_a == 0))[..., None]
    return torch.where(take_dst, dst, torch.where(take_src, src, out))


class AnimDecoder:
    """Canvas compositor over a decoded Animation (animation.go:279-457).
    The canvas and the disposed canvas are uint8 tensors on `device`
    (None: the card; "cpu": the CPU); next() returns a numpy copy."""

    def __init__(self, anim: Animation, device=None):
        if anim.canvas_width <= 0 or anim.canvas_height <= 0:
            raise WebPError("animation: invalid canvas")
        if anim.canvas_width * anim.canvas_height > 1 << 30:
            raise WebPError("animation: canvas too large")
        self.anim = anim
        self.device = _resolve_device(device)
        self.reset()

    def reset(self) -> None:
        h, w = self.anim.canvas_height, self.anim.canvas_width
        self._prev_disposed = torch.zeros((h, w, 4), dtype=torch.uint8,
                                          device=self.device)
        self._pos = 0

    def has_more(self) -> bool:
        return self._pos < len(self.anim.frames)

    def next(self) -> Tuple[np.ndarray, int]:
        """Returns (composited canvas copy, duration_ms)."""
        if not self.has_more():
            raise WebPError("animation: no more frames")
        f = self.anim.frames[self._pos]
        canvas = self._prev_disposed.clone()
        self._composite(canvas, f)
        snap = canvas.to("cpu", copy=True).numpy()
        # Prepare next iteration's base canvas.
        self._prev_disposed = canvas
        if f.dispose == DisposeMethod.BACKGROUND:
            x0, y0 = f.x_offset, f.y_offset
            fh, fw = f.rgba.shape[:2]
            self._prev_disposed = canvas.clone()
            self._prev_disposed[y0: y0 + fh, x0: x0 + fw] = 0
        self._pos += 1
        return snap, f.duration_ms

    def __iter__(self) -> Iterator[Tuple[np.ndarray, int]]:
        self.reset()
        while self.has_more():
            yield self.next()

    def _composite(self, canvas: torch.Tensor, f: Frame) -> None:
        ch, cw = canvas.shape[:2]
        fh, fw = f.rgba.shape[:2]
        x0 = max(0, f.x_offset)
        y0 = max(0, f.y_offset)
        x1 = min(cw, f.x_offset + fw)
        y1 = min(ch, f.y_offset + fh)
        if x1 <= x0 or y1 <= y0:
            return
        src = torch.from_numpy(np.ascontiguousarray(
            f.rgba[y0 - f.y_offset: y1 - f.y_offset,
                   x0 - f.x_offset: x1 - f.x_offset])).to(self.device)
        if f.blend == BlendMethod.NONE:
            canvas[y0:y1, x0:x1] = src
        else:
            canvas[y0:y1, x0:x1] = alpha_blend(src, canvas[y0:y1, x0:x1])


# ---------------------------------------------------------------------------
# Encoding.
# ---------------------------------------------------------------------------

@dataclass
class AnimEncodeOptions:
    """The reference's EncodeOptions (animation.go:484-507)."""

    lossless: bool = False
    quality: float = 75.0
    method: int = 4
    kmin: int = 0  # 0 -> derived from kmax
    kmax: int = 0  # 0 -> default (9 lossy / 17 lossless); 1 -> all keyframes
    allow_mixed: bool = False
    loop_count: int = 0
    bgcolor: int = 0
    minimize_size: bool = False


def _snap_to_even(v: int) -> int:
    return v & ~1


def _changed_rect(prev: np.ndarray, cur: np.ndarray) -> Optional[tuple]:
    """Smallest even-aligned rect where cur differs from prev; None if equal."""
    diff = (prev != cur).any(axis=-1)
    if not diff.any():
        return None
    ys, xs = np.nonzero(diff)
    y0, y1 = int(ys.min()), int(ys.max()) + 1
    x0, x1 = int(xs.min()), int(xs.max()) + 1
    x0 = _snap_to_even(x0)
    y0 = _snap_to_even(y0)
    return x0, y0, x1, y1


class AnimEncoder:
    """Incremental animated-WebP encoder (animation.go:590-1234).

    Frame diffing and the candidate choice run on the host, and so do the
    lossy candidates (the host VP8Encoder, as in the reference, which has
    no device lossy path in its AnimEncoder). The lossless candidates'
    predictor search runs on `device` (None: the card; "cpu": the plain
    version), or in native C++ with backend="host". The files are the
    same on every backend and device."""

    def __init__(self, width: int, height: int,
                 options: Optional[AnimEncodeOptions] = None,
                 device=None, backend: str = "device"):
        from ..lossless.encode import HOST

        check_backend(backend, "AnimEncoder", BACKENDS)
        self.opts = options or AnimEncodeOptions()
        self._search = HOST if backend == "host" else _resolve_device(device)
        self.width = width
        self.height = height
        self.mux = Muxer()
        self.mux.loop_count = self.opts.loop_count
        self.mux.bgcolor = self.opts.bgcolor
        self.mux.canvas_width = width
        self.mux.canvas_height = height
        self._prev_canvas: Optional[np.ndarray] = None
        self._frames_since_key = 0
        # kmin/kmax sanitation (reference sanitizeKeyframeOptions,
        # animation.go:546; minimize_size implies no forced keyframes).
        kmax = self.opts.kmax
        if kmax == 0:
            kmax = 17 if self.opts.lossless else 9
        kmin = self.opts.kmin
        if self.opts.minimize_size or kmax < 0:
            kmax = 1 << 30
            kmin = kmax - 1
        elif kmax == 1:
            kmin, kmax = 0, 0
        elif kmin >= kmax:
            kmin = kmax - 1
        else:
            kmin_limit = kmax // 2 + 1
            if kmin < kmin_limit < kmax:
                kmin = kmin_limit
        if kmax - kmin > 30:
            kmin = kmax - 30
        self.kmin, self.kmax = kmin, kmax
        self._count = 0
        self._prev_rect = (0, 0, width, height)
        self._prev_idx = -1

    # -- internals ----------------------------------------------------
    def _vp8l(self, rgba: np.ndarray) -> bytes:
        from ..lossless.encode import encode_vp8l

        return encode_vp8l(rgba, quality=int(self.opts.quality),
                           method=self.opts.method, search=self._search)

    def _encode_rect(self, rgba: np.ndarray) -> MuxFrame:
        o = self.opts
        lossless_mf = None
        if o.lossless or o.allow_mixed:
            lossless_mf = MuxFrame(bitstream=self._vp8l(rgba),
                                   is_lossless=True)
            if o.lossless:
                return lossless_mf
        from ..encoder import rgb_to_yuv420
        from ..lossy.encode import LossyConfig, VP8Encoder

        h, w = rgba.shape[:2]
        Y, U, V = rgb_to_yuv420(rgba[..., :3])
        cfg = LossyConfig(quality=int(o.quality), method=o.method)
        vp8 = VP8Encoder(Y, U, V, w, h, cfg).encode()
        alpha = b""
        if rgba.shape[2] == 4 and bool((rgba[..., 3] != 255).any()):
            from ..lossy.alpha_enc import encode_alpha

            alpha = encode_alpha(rgba[..., 3], effort=o.method)
        lossy_mf = MuxFrame(bitstream=vp8, alpha=alpha, is_lossless=False)
        if lossless_mf is not None:
            # Mixed mode: try both codecs, keep the smaller frame
            # (reference encodeFrame, animation.go:638).
            lossless_sz = len(lossless_mf.bitstream)
            lossy_sz = len(lossy_mf.bitstream) + len(lossy_mf.alpha or b"")
            if lossless_sz <= lossy_sz:
                return lossless_mf
        return lossy_mf

    def _blend_possible(self, under_sub: np.ndarray,
                        target_sub: np.ndarray) -> bool:
        """Whether alpha-blending the target rect over `under` reproduces
        the target (reference isLossless/isLossyBlendingPossible,
        animation.go:787/815; lossy uses the qualityToMaxDiff threshold)."""
        not_opaque = target_sub[..., 3] != 255
        if not not_opaque.any():
            return True
        if self.opts.lossless:
            # Stricter than the Go reference (which accepts under ==
            # target at any alpha): blending t-over-t drifts alpha upward
            # unless the pixel is fully transparent or opaque, and
            # lossless output must composite bit-exactly.
            ok = ((under_sub == target_sub).all(axis=-1)
                  & (target_sub[..., 3] == 0))
        else:
            # qualityToMaxDiff (animation.go:743): 31*(1-sqrt(q/100)) + val,
            # in Python floats so that the threshold is the same integer.
            val = (max(0.0, min(100.0, self.opts.quality)) / 100.0) ** 0.5
            max_diff = int(31.0 * (1.0 - val) + val + 0.5)
            thr = max_diff * 255
            ta = target_sub[..., 3].astype(np.int32)
            d = np.abs(under_sub[..., :3].astype(np.int32)
                       - target_sub[..., :3].astype(np.int32))
            ok = ((under_sub[..., 3] == target_sub[..., 3])
                  & ((d * ta[..., None]) <= thr).all(axis=-1))
        return bool((ok | ~not_opaque).all())

    def _candidate(self, canvas: np.ndarray, under: np.ndarray):
        """Builds one sub-frame candidate against the given underlying
        canvas state: (rect, MuxFrame, payload_size) or None if identical."""
        rect = _changed_rect(under, canvas)
        if rect is None:
            return None
        x0, y0, x1, y1 = rect
        sub = canvas[y0:y1, x0:x1]
        mf = self._encode_rect(sub)
        mf.blend = (BlendMethod.ALPHA
                    if self._blend_possible(under[y0:y1, x0:x1], sub)
                    else BlendMethod.NONE)
        # Transparent-blend candidate (reference increaseTransparency,
        # animation.go:787): unchanged pixels become transparent and the
        # frame alpha-blends over the underlying canvas — long transparent
        # runs compress far better in VP8L. Valid only when every changed
        # pixel is fully opaque (alpha blending must reduce to overwrite).
        if self.opts.lossless or self.opts.allow_mixed:
            under_sub = under[y0:y1, x0:x1]
            changed = (sub != under_sub).any(axis=-1)
            if changed.any() and bool((sub[..., 3][changed] == 255).all()):
                trans = sub.copy()
                trans[~changed] = 0
                bs = self._vp8l(trans)
                if len(bs) < len(mf.bitstream) + len(mf.alpha or b""):
                    mf = MuxFrame(bitstream=bs, is_lossless=True)
                    mf.blend = BlendMethod.ALPHA
        mf.x_offset, mf.y_offset = x0, y0
        return rect, mf, len(mf.bitstream) + len(mf.alpha or b"")

    def _add_keyframe(self, canvas: np.ndarray, duration_ms: int) -> None:
        mf = self._encode_rect(canvas)
        mf.blend = BlendMethod.NONE
        mf.dispose = DisposeMethod.NONE
        mf.duration_ms = duration_ms
        self.mux.add_frame(mf)
        self._prev_canvas = canvas.copy()
        self._prev_rect = (0, 0, self.width, self.height)
        self._prev_idx = len(self.mux.frames) - 1
        self._frames_since_key = 0
        self._count += 1

    def add_frame(self, canvas: np.ndarray, duration_ms: int) -> None:
        """Adds one full-canvas RGBA frame (reference addOptimizedFrame,
        animation.go:660: identical-frame merge, kmin/kmax keyframe
        policy, dual dispose candidates with retroactive dispose update,
        blend-feasibility flags, >90%-changed keyframe fallback)."""
        canvas = np.asarray(canvas, dtype=np.uint8)
        if canvas.ndim != 3 or canvas.shape[:2] != (self.height, self.width):
            raise WebPError("animation: frame must match canvas size")
        if canvas.shape[2] == 3:
            canvas = np.dstack([canvas, np.full(canvas.shape[:2], 255, np.uint8)])

        if self._prev_canvas is None:
            self._add_keyframe(canvas, duration_ms)
            return

        if np.array_equal(self._prev_canvas, canvas):
            # Identical frame: extend previous duration (animation.go:974),
            # with 24-bit overflow spilling into a 2x2 transparent filler.
            MAXD = (1 << 24) - 1
            prev = self.mux.frames[self._prev_idx]
            new_dur = prev.duration_ms + duration_ms
            if new_dur <= MAXD:
                prev.duration_ms = new_dur
            else:
                rem = new_dur - MAXD
                prev.duration_ms = MAXD
                filler = self._encode_rect(np.zeros((2, 2, 4), np.uint8))
                filler.blend = BlendMethod.ALPHA
                filler.dispose = DisposeMethod.NONE
                filler.duration_ms = rem
                self.mux.add_frame(filler)
                self._prev_idx = len(self.mux.frames) - 1
                self._prev_rect = (0, 0, 2, 2)
            self._frames_since_key += 1
            self._count += 1
            return

        self._frames_since_key += 1
        if self._frames_since_key >= self.kmax:
            self._add_keyframe(canvas, duration_ms)
            return

        # Candidate 1: previous frame keeps DISPOSE_NONE.
        cand_none = self._candidate(canvas, self._prev_canvas)
        # Candidate 2: previous frame retroactively DISPOSE_BACKGROUND.
        px0, py0, px1, py1 = self._prev_rect
        disposed = self._prev_canvas.copy()
        disposed[py0:py1, px0:px1] = 0
        cand_bg = self._candidate(canvas, disposed)

        use_bg = (cand_bg is not None
                  and (cand_none is None or cand_bg[2] < cand_none[2]))
        rect, mf, size = cand_bg if use_bg else cand_none

        # >90% changed -> try a full keyframe, take it if smaller and the
        # kmin spacing allows one (animation.go:927).
        x0, y0, x1, y1 = rect
        if ((x1 - x0) * (y1 - y0) > 0.9 * self.width * self.height
                and self._frames_since_key >= self.kmin):
            kf = self._encode_rect(canvas)
            if len(kf.bitstream) + len(kf.alpha or b"") < size:
                self._add_keyframe(canvas, duration_ms)
                return

        if use_bg:
            self.mux.frames[self._prev_idx].dispose = DisposeMethod.BACKGROUND
        mf.duration_ms = duration_ms
        mf.dispose = DisposeMethod.NONE
        self.mux.add_frame(mf)
        self._prev_canvas = canvas.copy()
        self._prev_rect = rect
        self._prev_idx = len(self.mux.frames) - 1
        self._count += 1

    def assemble(self) -> bytes:
        """Finishes the stream (single frame falls back to simple WebP)."""
        if not self.mux.frames:
            raise WebPError("animation: no frames added")
        if self._count == 1 and len(self.mux.frames) == 1:
            f = self.mux.frames[0]
            if f.x_offset == 0 and f.y_offset == 0 and not f.alpha:
                tag = r.VP8L if f.is_lossless else r.VP8
                return r.assemble_riff([r.Chunk(tag, f.bitstream)])
        return self.mux.assemble()

    close = assemble  # reference naming parity (AnimEncoder.Close)


def encode_animation(frames: List[np.ndarray], durations, device=None,
                     backend: str = "device", **options) -> bytes:
    """Encodes a list of full-canvas RGBA (or RGB) frames with
    AnimEncoder; options are AnimEncodeOptions' fields, device and
    backend AnimEncoder's."""
    if not frames:
        raise WebPError("animation: no frames")
    h, w = np.asarray(frames[0]).shape[:2]
    opts = AnimEncodeOptions(**options)
    enc = AnimEncoder(w, h, opts, device=device, backend=backend)
    if isinstance(durations, int):
        durations = [durations] * len(frames)
    for f, d in zip(frames, durations):
        enc.add_frame(f, d)
    return enc.assemble()


def encode_animation_device(frames: List[np.ndarray], durations,
                            quality: int = 75, loop_count: int = 0,
                            batch: int = 8, device=None,
                            uv_ac: bool = False) -> bytes:
    """Frame-parallel animated-WebP encode on the device: the unique
    frames ride the stream's batch axis (encode_lossy_stream at its
    default host YUV, so the four kernels run once per batch on `device`;
    None means the card, "cpu" the plain versions; uv_ac is the stream's:
    each frame's chroma AC quantizer delta from its mean UV alpha).

    Every frame is stored as a full-canvas ANMF (no sub-rect diffing:
    frames become independent, which is what makes them batchable);
    identical consecutive frames still merge into the previous frame's
    duration. Lossy only, alpha ignored (opaque canvas).
    """
    if not frames:
        raise WebPError("animation: no frames")
    frames = [np.asarray(f, dtype=np.uint8)[..., :3] for f in frames]
    h, w = frames[0].shape[:2]
    if isinstance(durations, int):
        durations = [durations] * len(frames)

    # Identical-frame merge (host, cheap): keep unique runs.
    keep = []      # (frame, duration)
    for f, d in zip(frames, durations):
        if keep and np.array_equal(keep[-1][0], f):
            keep[-1] = (keep[-1][0], keep[-1][1] + d)
        else:
            keep.append((f, int(d)))

    from ..lossy.device_encode import encode_lossy_stream

    bitstreams = encode_lossy_stream([f for f, _ in keep], quality=quality,
                                     batch=batch, device=device, uv_ac=uv_ac)
    mux = Muxer()
    mux.loop_count = loop_count
    mux.canvas_width = w
    mux.canvas_height = h
    for (f, d), bits in zip(keep, bitstreams):
        mux.add_frame(MuxFrame(bitstream=bits, duration_ms=d,
                               blend=BlendMethod.NONE,
                               dispose=DisposeMethod.NONE))
    return mux.assemble()
