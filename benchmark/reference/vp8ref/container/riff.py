"""RIFF/WebP container primitives.

TPU-native WebP framework container layer. This is pure host-side code: the
container is byte-level framing, not tensor compute.

Behavioral parity with the reference container layer
(the reference internal/container/{constants.go,riff.go}): FourCC constants,
VP8/VP8L signatures, VP8X feature flags, chunk framing with even-padding, and
DoS limits.
"""

from __future__ import annotations

import struct
from dataclasses import dataclass
from typing import List


def fourcc(s: str) -> bytes:
    assert len(s) == 4
    return s.encode("ascii")


# Container FourCC tags.
RIFF = fourcc("RIFF")
WEBP = fourcc("WEBP")
VP8 = fourcc("VP8 ")
VP8L = fourcc("VP8L")
VP8X = fourcc("VP8X")
ALPH = fourcc("ALPH")
ANIM = fourcc("ANIM")
ANMF = fourcc("ANMF")
ICCP = fourcc("ICCP")
EXIF = fourcc("EXIF")
XMP = fourcc("XMP ")

RIFF_HEADER_SIZE = 12  # 'RIFF' + u32 size + 'WEBP'
CHUNK_HEADER_SIZE = 8  # fourcc + u32 payload size

# VP8 format constants (reference: internal/container/constants.go:28-33).
VP8_SIGNATURE = 0x9D012A
VP8_MAX_PARTITION0 = 1 << 19
VP8_MAX_PARTITION_SIZE = 1 << 24
VP8_FRAME_HEADER_SIZE = 10

# VP8L format constants (constants.go:37-44).
VP8L_MAGIC_BYTE = 0x2F
VP8L_IMAGE_SIZE_BITS = 14
VP8L_VERSION_BITS = 3
VP8L_VERSION = 0

# VP8X feature flags (riff.go:11-19).
FLAG_ANIMATION = 0x00000002
FLAG_XMP = 0x00000004
FLAG_EXIF = 0x00000008
FLAG_ALPHA = 0x00000010
FLAG_ICCP = 0x00000020
ALL_VALID_FLAGS = 0x0000003E

# Hard limits (DoS guards; reference container/parser.go + webp.go:53-56).
MAX_CHUNK_PAYLOAD = (1 << 32) - 10
MAX_INPUT_SIZE = 256 << 20  # 256 MB
MAX_DIMENSION = 16383
MAX_IMAGE_AREA = 1 << 32
MAX_FRAMES = 100_000
MAX_CHUNKS = 100_000
MAX_METADATA_SIZE = 64 << 20

# Alpha constants (constants.go:76-81).
ALPHA_NO_COMPRESSION = 0
ALPHA_LOSSLESS_COMPRESSION = 1
ALPHA_PREPROCESSED_LEVELS = 1


class WebPError(ValueError):
    """Base error for all webp_tpu_torch container/codec failures."""


@dataclass
class Chunk:
    tag: bytes
    payload: bytes


def write_chunk(tag: bytes, payload: bytes) -> bytes:
    """Serializes one chunk with even-size padding."""
    out = tag + struct.pack("<I", len(payload)) + payload
    if len(payload) & 1:
        out += b"\x00"
    return out


def assemble_riff(chunks: List[Chunk]) -> bytes:
    """Wraps chunks in a RIFF/WEBP container."""
    body = b"".join(write_chunk(c.tag, c.payload) for c in chunks)
    return RIFF + struct.pack("<I", 4 + len(body)) + WEBP + body
