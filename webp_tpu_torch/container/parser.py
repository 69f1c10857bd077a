"""Single-pass RIFF → WebP container parser.

Parity with the reference's internal/container/parser.go: walks the
chunk list, extracts Features, the frame table (still image or ANMF frames),
metadata chunks, and validates dimensions/limits. Also parses the VP8 / VP8L
bitstream headers for dimensions (parser.go:463-517).
"""

from __future__ import annotations

import struct
from dataclasses import dataclass, field
from typing import Dict, List, Optional

from . import riff as r
from .riff import (
    BlendMethod,
    Chunk,
    DisposeMethod,
    Features,
    FormatType,
    FrameInfo,
    TruncatedError,
    WebPError,
)


def parse_vp8_dimensions(data: bytes) -> tuple[int, int]:
    """Parses a VP8 keyframe header for (width, height).

    VP8 frame tag: 3 bytes (keyframe bit, version, show_frame, partition0
    size), then the start code 0x9d 0x01 0x2a, then 14-bit w/h with 2-bit
    scale fields (RFC 6386 §9.1).
    """
    if len(data) < 10:
        raise TruncatedError("webp: truncated VP8 header")
    tag = data[0] | data[1] << 8 | data[2] << 16
    keyframe = (tag & 1) == 0
    if not keyframe:
        raise WebPError("webp: VP8 frame is not a keyframe")
    if data[3] != 0x9D or data[4] != 0x01 or data[5] != 0x2A:
        raise WebPError("webp: invalid VP8 start code")
    w = data[6] | data[7] << 8
    h = data[8] | data[9] << 8
    return (w & 0x3FFF, h & 0x3FFF)


def parse_vp8l_dimensions(data: bytes) -> tuple[int, int, bool]:
    """Parses the 5-byte VP8L header for (width, height, alpha_hint)."""
    if len(data) < 5:
        raise TruncatedError("webp: truncated VP8L header")
    if data[0] != r.VP8L_MAGIC_BYTE:
        raise WebPError("webp: invalid VP8L signature")
    bits = data[1] | data[2] << 8 | data[3] << 16 | data[4] << 24
    w = (bits & 0x3FFF) + 1
    h = ((bits >> 14) & 0x3FFF) + 1
    alpha = ((bits >> 28) & 1) != 0
    version = (bits >> 29) & 0x7
    if version != r.VP8L_VERSION:
        raise WebPError("webp: unsupported VP8L version")
    return (w, h, alpha)


def _u24(data: bytes, off: int) -> int:
    return data[off] | data[off + 1] << 8 | data[off + 2] << 16


@dataclass
class ParsedWebP:
    features: Features = field(default_factory=Features)
    frames: List[FrameInfo] = field(default_factory=list)
    chunks: List[Chunk] = field(default_factory=list)
    iccp: bytes = b""
    exif: bytes = b""
    xmp: bytes = b""


class Parser:
    """Parses a complete in-memory WebP file."""

    def __init__(self, data: bytes):
        if len(data) > r.MAX_INPUT_SIZE:
            raise WebPError("webp: input too large")
        self.data = bytes(data)
        self.parsed = ParsedWebP()
        self._parse()

    # -- public views --------------------------------------------------
    @property
    def features(self) -> Features:
        return self.parsed.features

    def frames(self) -> List[FrameInfo]:
        return self.parsed.frames

    def chunks(self) -> List[Chunk]:
        return self.parsed.chunks

    # -- implementation -------------------------------------------------
    def _parse(self) -> None:
        data = self.data
        file_size = r.parse_riff_header(data)
        # Chunks end at 8 + riff_size ("RIFF" + size field = 8 bytes, the
        # size counts everything after it, including the WEBP fourcc).
        end = min(len(data), 8 + file_size)
        off = r.RIFF_HEADER_SIZE
        f = self.parsed.features
        saw_image = False
        n_chunks = 0
        while off + r.CHUNK_HEADER_SIZE <= end:
            tag, size = r.read_chunk_header(data, off)
            payload_off = off + r.CHUNK_HEADER_SIZE
            if payload_off + size > len(data):
                raise TruncatedError("webp: truncated chunk payload")
            payload = data[payload_off : payload_off + size]
            n_chunks += 1
            if n_chunks > r.MAX_CHUNKS:
                raise WebPError("webp: too many chunks")
            self.parsed.chunks.append(Chunk(tag, payload))

            if tag == r.VP8X:
                self._parse_vp8x(payload)
            elif tag == r.VP8 and not saw_image:
                w, h = parse_vp8_dimensions(payload)
                if f.format == FormatType.UNDEFINED:
                    f.format = FormatType.VP8
                    f.width, f.height = w, h
                self.parsed.frames.append(
                    FrameInfo(width=w, height=h, bitstream=payload, is_lossless=False)
                )
                saw_image = True
            elif tag == r.VP8L and not saw_image:
                w, h, alpha = parse_vp8l_dimensions(payload)
                if f.format == FormatType.UNDEFINED:
                    f.format = FormatType.VP8L
                    f.width, f.height = w, h
                f.has_alpha = f.has_alpha or alpha
                self.parsed.frames.append(
                    FrameInfo(
                        width=w, height=h, bitstream=payload,
                        is_lossless=True, has_alpha=alpha,
                    )
                )
                saw_image = True
            elif tag == r.ALPH and not saw_image:
                # Standalone ALPH preceding the VP8 chunk (extended format).
                self._pending_alpha = payload
            elif tag == r.ANIM:
                if len(payload) < 6:
                    raise TruncatedError("webp: truncated ANIM chunk")
                (f.bgcolor,) = struct.unpack_from("<I", payload, 0)
                f.loop_count = payload[4] | payload[5] << 8
            elif tag == r.ANMF:
                if len(self.parsed.frames) >= r.MAX_FRAMES:
                    raise WebPError("webp: too many frames")
                self.parsed.frames.append(self._parse_anmf(payload))
            elif tag == r.ICCP:
                self._check_meta(payload)
                self.parsed.iccp = payload
            elif tag == r.EXIF:
                self._check_meta(payload)
                self.parsed.exif = payload
            elif tag == r.XMP:
                self._check_meta(payload)
                self.parsed.xmp = payload
            # Unknown chunks are preserved in .chunks but otherwise skipped.

            off = payload_off + size + (size & 1)

        # Attach a leading standalone ALPH chunk to the still frame.
        pending = getattr(self, "_pending_alpha", None)
        if pending is not None and self.parsed.frames:
            fr = self.parsed.frames[0]
            if not fr.is_lossless:
                fr.alpha = pending
                fr.has_alpha = True
                f.has_alpha = True

        if f.format == FormatType.UNDEFINED:
            raise WebPError("webp: no image chunk found")
        if f.format == FormatType.VP8X and f.width == 0 and self.parsed.frames:
            # Dimensions from first frame if VP8X canvas missing.
            f.width = self.parsed.frames[0].width
            f.height = self.parsed.frames[0].height
        self._validate_dimensions()

    def _check_meta(self, payload: bytes) -> None:
        if len(payload) > r.MAX_METADATA_SIZE:
            raise WebPError("webp: metadata too large")

    def _parse_vp8x(self, payload: bytes) -> None:
        f = self.parsed.features
        if len(payload) < 10:
            raise TruncatedError("webp: invalid VP8X chunk")
        (flags,) = struct.unpack_from("<I", payload, 0)
        if flags & ~r.ALL_VALID_FLAGS:
            # Reserved bits set: rejected (reference parser.go:161
            # ErrInvalidFlags).
            raise WebPError("webp: invalid VP8X flags")
        f.format = FormatType.VP8X
        f.has_anim = bool(flags & r.FLAG_ANIMATION)
        f.has_xmp = bool(flags & r.FLAG_XMP)
        f.has_exif = bool(flags & r.FLAG_EXIF)
        f.has_alpha = bool(flags & r.FLAG_ALPHA)
        f.has_iccp = bool(flags & r.FLAG_ICCP)
        f.canvas_width = _u24(payload, 4) + 1
        f.canvas_height = _u24(payload, 7) + 1
        f.width = f.canvas_width
        f.height = f.canvas_height

    def _parse_anmf(self, payload: bytes) -> FrameInfo:
        if len(payload) < 16:
            raise TruncatedError("webp: truncated ANMF chunk")
        fr = FrameInfo()
        fr.x_offset = _u24(payload, 0) * 2
        fr.y_offset = _u24(payload, 3) * 2
        fr.width = _u24(payload, 6) + 1
        fr.height = _u24(payload, 9) + 1
        fr.duration_ms = _u24(payload, 12)
        flags = payload[15]
        fr.dispose = DisposeMethod(flags & 1)
        fr.blend = BlendMethod((flags >> 1) & 1)
        # Sub-chunks: optional ALPH, then VP8 or VP8L.
        off = 16
        while off + r.CHUNK_HEADER_SIZE <= len(payload):
            tag, size = r.read_chunk_header(payload, off)
            body = payload[off + r.CHUNK_HEADER_SIZE : off + r.CHUNK_HEADER_SIZE + size]
            if len(body) < size:
                raise TruncatedError("webp: truncated ANMF sub-chunk")
            if tag == r.ALPH:
                fr.alpha = body
                fr.has_alpha = True
            elif tag == r.VP8:
                fr.bitstream = body
                fr.is_lossless = False
            elif tag == r.VP8L:
                fr.bitstream = body
                fr.is_lossless = True
                _, _, alpha = parse_vp8l_dimensions(body)
                fr.has_alpha = fr.has_alpha or alpha
            off += r.CHUNK_HEADER_SIZE + size + (size & 1)
        if not fr.bitstream:
            raise WebPError("webp: ANMF frame without bitstream")
        return fr

    def _validate_dimensions(self) -> None:
        f = self.parsed.features
        if f.width <= 0 or f.height <= 0:
            raise WebPError("webp: invalid image dimensions")
        if f.width > r.MAX_DIMENSION + 1 or f.height > r.MAX_DIMENSION + 1:
            raise WebPError("webp: image dimensions too large")
        if f.width * f.height > r.MAX_IMAGE_AREA:
            raise WebPError("webp: image area too large")


def get_features(data: bytes) -> Features:
    return Parser(data).features
