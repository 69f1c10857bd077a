"""WebP mux/demux: RIFF assembly and inspection.

Counterpart of webp_tpu/mux/mux.py (after the Go reference's
mux/{mux.go,demux.go}): a Muxer that assembles still or animated WebP
files (simple or VP8X extended form, canvas inference, ANMF sub-chunk
layout) and a Demuxer exposing features, frames, and raw chunks. Host
code on bytes; its files are the reference's byte for byte.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Iterator, List, Optional

from ..container import riff as r
from ..container.parser import Parser, parse_vp8_dimensions, parse_vp8l_dimensions
from ..container.riff import (
    BlendMethod,
    Chunk,
    DisposeMethod,
    Features,
    FrameInfo,
    WebPError,
)


@dataclass
class MuxFrame:
    bitstream: bytes = b""          # VP8 or VP8L payload
    alpha: bytes = b""              # ALPH payload (lossy frames only)
    is_lossless: bool = False
    x_offset: int = 0
    y_offset: int = 0
    duration_ms: int = 100
    dispose: DisposeMethod = DisposeMethod.NONE
    blend: BlendMethod = BlendMethod.ALPHA

    def dimensions(self) -> tuple[int, int]:
        if self.is_lossless:
            w, h, _ = parse_vp8l_dimensions(self.bitstream)
            return w, h
        return parse_vp8_dimensions(self.bitstream)

    def has_alpha(self) -> bool:
        if self.alpha:
            return True
        if self.is_lossless:
            return parse_vp8l_dimensions(self.bitstream)[2]
        return False


class Muxer:
    """Assembles WebP files from frames + metadata (mux.go:28,219)."""

    def __init__(self):
        self.frames: List[MuxFrame] = []
        self.loop_count = 0
        self.bgcolor = 0  # BGRA packed u32 as stored
        self.canvas_width = 0
        self.canvas_height = 0
        self.iccp = b""
        self.exif = b""
        self.xmp = b""

    MAX_DURATION_MS = (1 << 24) - 1
    MAX_LOOP_COUNT = (1 << 16) - 1
    MAX_METADATA_SIZE = 1 << 24

    def add_frame(self, frame: MuxFrame) -> int:
        if len(self.frames) >= r.MAX_FRAMES:
            raise WebPError("webp: too many frames")
        if frame.x_offset % 2 or frame.y_offset % 2:
            raise WebPError("webp: frame offsets must be even")
        self.frames.append(frame)
        return len(self.frames) - 1

    def num_frames(self) -> int:
        return len(self.frames)

    def set_frame_dispose(self, index: int, dispose: DisposeMethod) -> None:
        self.frames[index].dispose = dispose

    def set_frame_duration(self, index: int, duration_ms: int) -> None:
        """Clamped to the 24-bit ANMF field (mux.go:154 SetFrameDuration)."""
        self.frames[index].duration_ms = max(
            0, min(int(duration_ms), self.MAX_DURATION_MS))

    def frame_duration(self, index: int) -> int:
        return self.frames[index].duration_ms

    def frame_blend_mode(self, index: int) -> BlendMethod:
        return self.frames[index].blend

    def set_loop_count(self, count: int) -> None:
        """Clamped to the 16-bit ANIM field (mux.go:85 SetLoopCount)."""
        self.loop_count = max(0, min(int(count), self.MAX_LOOP_COUNT))

    def set_canvas_size(self, width: int, height: int) -> None:
        """Explicit canvas dimensions; when both are > 0 they take priority
        over the extent inferred from frames (mux.go:100 SetCanvasSize).
        Clamped to the 24-bit VP8X maximum."""
        self.canvas_width = min(int(width), r.MAX_DIMENSION + 1)
        self.canvas_height = min(int(height), r.MAX_DIMENSION + 1)

    def add_chunk(self, fourcc: bytes, data: bytes) -> None:
        """Attach a metadata chunk by fourcc (mux.go:185 AddChunk):
        ICCP/EXIF/XMP route to their dedicated slots. Unknown fourccs
        raise (the reference silently drops them; an error is kinder)."""
        if len(data) > self.MAX_METADATA_SIZE:
            raise WebPError("webp: chunk data too large")
        if fourcc == r.ICCP:
            self.iccp = data
        elif fourcc == r.EXIF:
            self.exif = data
        elif fourcc == r.XMP:
            self.xmp = data
        else:
            raise WebPError("webp: unsupported chunk fourcc")

    def _infer_canvas(self) -> tuple[int, int]:
        if self.canvas_width > 0 and self.canvas_height > 0:
            return self.canvas_width, self.canvas_height
        w = self.canvas_width
        h = self.canvas_height
        for f in self.frames:
            fw, fh = f.dimensions()
            w = max(w, f.x_offset + fw)
            h = max(h, f.y_offset + fh)
        return w, h

    def validate(self) -> None:
        """Consistency checks before assembly (mux.go:233 validate /
        libwebp MuxValidate): frames exist and every frame rectangle fits
        the canvas. (A single frame always assembles as a still image
        here; the reference instead treats duration>0 as animated.)"""
        if not self.frames:
            raise WebPError("webp: no frames to assemble")
        w, h = self._infer_canvas()
        for i, f in enumerate(self.frames):
            fw, fh = f.dimensions()
            if f.x_offset + fw > w or f.y_offset + fh > h:
                raise WebPError(
                    f"webp: frame {i} ({fw}x{fh} at {f.x_offset},"
                    f"{f.y_offset}) exceeds canvas ({w}x{h})")

    def assemble(self) -> bytes:
        self.validate()
        animated = len(self.frames) > 1
        has_meta = bool(self.iccp or self.exif or self.xmp)
        any_alpha = any(f.has_alpha() for f in self.frames)
        if not animated and not has_meta and not self.frames[0].alpha:
            f = self.frames[0]
            tag = r.VP8L if f.is_lossless else r.VP8
            return r.assemble_riff([Chunk(tag, f.bitstream)])
        return self._assemble_extended(animated, any_alpha)

    def _assemble_extended(self, animated: bool, any_alpha: bool) -> bytes:
        w, h = self._infer_canvas()
        if w <= 0 or h <= 0 or w > r.MAX_DIMENSION + 1 or h > r.MAX_DIMENSION + 1:
            raise WebPError("webp: invalid canvas size")
        flags = 0
        if any_alpha:
            flags |= r.FLAG_ALPHA
        if animated:
            flags |= r.FLAG_ANIMATION
        if self.iccp:
            flags |= r.FLAG_ICCP
        if self.exif:
            flags |= r.FLAG_EXIF
        if self.xmp:
            flags |= r.FLAG_XMP
        chunks = [Chunk(r.VP8X, flags.to_bytes(4, "little")
                        + (w - 1).to_bytes(3, "little")
                        + (h - 1).to_bytes(3, "little"))]
        if self.iccp:
            chunks.append(Chunk(r.ICCP, self.iccp))
        if animated:
            anim = self.bgcolor.to_bytes(4, "little") + \
                (self.loop_count & 0xFFFF).to_bytes(2, "little")
            chunks.append(Chunk(r.ANIM, anim))
            for f in self.frames:
                chunks.append(Chunk(r.ANMF, self._anmf_payload(f)))
        else:
            f = self.frames[0]
            if f.alpha:
                chunks.append(Chunk(r.ALPH, f.alpha))
            chunks.append(Chunk(r.VP8L if f.is_lossless else r.VP8, f.bitstream))
        if self.exif:
            chunks.append(Chunk(r.EXIF, self.exif))
        if self.xmp:
            chunks.append(Chunk(r.XMP, self.xmp))
        return r.assemble_riff(chunks)

    @staticmethod
    def _anmf_payload(f: MuxFrame) -> bytes:
        fw, fh = f.dimensions()
        out = bytearray()
        out += (f.x_offset // 2).to_bytes(3, "little")
        out += (f.y_offset // 2).to_bytes(3, "little")
        out += (fw - 1).to_bytes(3, "little")
        out += (fh - 1).to_bytes(3, "little")
        out += f.duration_ms.to_bytes(3, "little")
        out.append((int(f.dispose) & 1) | ((int(f.blend) & 1) << 1))
        if f.alpha:
            out += r.write_chunk(r.ALPH, f.alpha)
        out += r.write_chunk(r.VP8L if f.is_lossless else r.VP8, f.bitstream)
        return bytes(out)


class FrameIterator:
    """Sequential frame access (demux.go:188)."""

    def __init__(self, frames: List[FrameInfo]):
        self._frames = frames
        self._i = 0

    def __iter__(self) -> Iterator[FrameInfo]:
        return iter(self._frames)

    def next(self) -> Optional[FrameInfo]:
        if self._i >= len(self._frames):
            return None
        f = self._frames[self._i]
        self._i += 1
        return f


class Demuxer:
    """Read-side view over a parsed container (demux.go:88,125)."""

    def __init__(self, data: bytes):
        self._parser = Parser(data)

    @property
    def features(self) -> Features:
        return self._parser.features

    def num_frames(self) -> int:
        return len(self._parser.frames())

    def frame(self, i: int) -> FrameInfo:
        return self._parser.frames()[i]

    def frames(self) -> FrameIterator:
        return FrameIterator(self._parser.frames())

    def get_chunk(self, fourcc: bytes) -> Optional[bytes]:
        for c in self._parser.chunks():
            if c.tag == fourcc:
                return c.payload
        return None

    def loop_count(self) -> int:
        """ANIM loop count, 0 when not animated (demux.go:178)."""
        return self._parser.features.loop_count

    def background_color(self) -> int:
        """ANIM background color as packed BGRA u32 (demux.go:183)."""
        return self._parser.features.bgcolor

    @property
    def iccp(self) -> bytes:
        return self._parser.parsed.iccp

    @property
    def exif(self) -> bytes:
        return self._parser.parsed.exif

    @property
    def xmp(self) -> bytes:
        return self._parser.parsed.xmp
