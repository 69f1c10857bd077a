"""PNG reading and writing without Pillow, for the command line tool.

read_png(data) returns the array that Pillow gives for the same file as
np.array(im.convert("RGBA" if "A" in im.getbands() else "RGB")), which
is how webp_tpu.cli reads its PNG input. It reads every PNG that the
specification allows: colour types 0, 2, 3, 4 and 6 at each of their
bit depths, the five filter types, Adam7 interlacing, image data split
over several IDAT chunks. Each chunk's CRC is checked and ancillary
chunks are skipped. Where Pillow's conversion surprises, the reader
follows it:

  * gray (1, 2 and 4 bits scaled to 0-255, 8 bits, or 16 bits clipped
    at 255, not scaled) and palette images give RGB; a palette index
    past the PLTE entries gives black;
  * 16-bit RGB, gray+alpha and RGBA keep each sample's high byte;
  * gray+alpha gives RGBA (L, L, L, A);
  * a tRNS chunk is dropped: Pillow opens such a file as L, P, I;16 or
    RGB, with no alpha band.

Whatever it cannot read raises ValueError with the reason; it never
returns guessed pixels. The row unfilter runs in native C++
(native/src/png_unfilter.cc, built at first use; a failed build raises).

write_png(arr) writes 8-bit RGB or RGBA, not interlaced, every row
filtered with Up, compressed by zlib at level 6. Pillow reads its pixels
back unchanged; its bytes are not those Pillow would write.
"""

from __future__ import annotations

import ctypes as ct
import functools
import struct
import zlib

import numpy as np

from .. import _build

SIGNATURE = b"\x89PNG\r\n\x1a\n"

# Colour type -> (samples per pixel, allowed bit depths).
_COLOR_TYPES = {0: (1, (1, 2, 4, 8, 16)), 2: (3, (8, 16)),
                3: (1, (1, 2, 4, 8)), 4: (2, (8, 16)), 6: (4, (8, 16))}

# Adam7 passes: (x0, y0, dx, dy).
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
          (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))


@functools.cache
def _lib():
    lib = _build.load("png")
    lib.png_unfilter.argtypes = [ct.c_void_p, ct.c_void_p, ct.c_long,
                                 ct.c_long, ct.c_long]
    lib.png_unfilter.restype = ct.c_long
    return lib


def is_png(data: bytes) -> bool:
    return data[:8] == SIGNATURE


def _chunks(data: bytes):
    """(tag, payload) of each chunk up to and including IEND, CRCs
    checked."""
    if not is_png(data):
        raise ValueError("PNG: bad signature")
    pos = 8
    while True:
        if pos + 8 > len(data):
            raise ValueError("PNG: truncated (no IEND chunk)")
        length, tag = struct.unpack(">I4s", data[pos:pos + 8])
        end = pos + 8 + length
        if end + 4 > len(data):
            raise ValueError(f"PNG: chunk {tag!r} is truncated")
        payload = data[pos + 8:end]
        (crc,) = struct.unpack(">I", data[end:end + 4])
        if zlib.crc32(tag + payload) != crc:
            raise ValueError(f"PNG: CRC mismatch in chunk {tag!r}")
        yield tag, payload
        if tag == b"IEND":
            return
        pos = end + 4


def is_apng(data: bytes) -> bool:
    """Whether a PNG file is an APNG (has an acTL chunk), which Pillow
    opens as an animation. Reads the chunk headers only."""
    pos = 8
    while pos + 8 <= len(data):
        length, tag = struct.unpack(">I4s", data[pos:pos + 8])
        if tag == b"acTL":
            return True
        if tag in (b"IDAT", b"IEND"):
            return False
        pos += 12 + length
    return False


def _unfilter(raw: np.ndarray, offset: int, rows: int, rowbytes: int,
              bpp: int) -> np.ndarray:
    src = raw[offset:offset + rows * (rowbytes + 1)]
    out = np.empty((rows, rowbytes), np.uint8)
    bad = _lib().png_unfilter(src.ctypes.data, out.ctypes.data, rows,
                              rowbytes, bpp)
    if bad:
        ftype = src[(bad - 1) * (rowbytes + 1)]
        raise ValueError(f"PNG: unknown filter type {ftype} on row "
                         f"{bad - 1}")
    return out


def _samples(rows: np.ndarray, n: int, depth: int) -> np.ndarray:
    """Unfiltered rows [h, rowbytes] -> samples [h, n] (n per row)."""
    if depth == 8:
        return rows[:, :n]
    if depth == 16:
        return rows.view(">u2")[:, :n]
    shifts = np.arange(8 - depth, -1, -depth, dtype=np.uint8)
    s = (rows[:, :, None] >> shifts) & np.uint8((1 << depth) - 1)
    return s.reshape(rows.shape[0], -1)[:, :n]


def read_png(data: bytes) -> np.ndarray:
    """Decodes a PNG file to uint8 [h, w, 3] or, for gray+alpha and RGBA
    files, [h, w, 4]: Pillow's convert("RGB"/"RGBA") array."""
    chunks = _chunks(data)
    tag, ihdr = next(chunks)
    if tag != b"IHDR" or len(ihdr) != 13:
        raise ValueError("PNG: the first chunk is not a 13-byte IHDR")
    w, h, depth, ctype, comp, filt, interlace = struct.unpack(">IIBBBBB",
                                                              ihdr)
    if ctype not in _COLOR_TYPES or depth not in _COLOR_TYPES[ctype][1]:
        raise ValueError(f"PNG: bit depth {depth} is not allowed with "
                         f"colour type {ctype}")
    if not (0 < w < 1 << 31 and 0 < h < 1 << 31):
        raise ValueError(f"PNG: bad dimensions {w}x{h}")
    if comp != 0 or filt != 0 or interlace not in (0, 1):
        raise ValueError(f"PNG: unknown compression {comp}, filter method "
                         f"{filt} or interlace method {interlace}")
    palette, idat = None, []
    for tag, payload in chunks:
        if tag == b"IDAT":
            idat.append(payload)
        elif tag == b"PLTE":
            if len(payload) % 3 or not 3 <= len(payload) <= 768:
                raise ValueError(f"PNG: PLTE of {len(payload)} bytes")
            palette = np.zeros((256, 3), np.uint8)
            palette[:len(payload) // 3] = np.frombuffer(
                payload, np.uint8).reshape(-1, 3)
        elif tag[0] & 0x20 == 0 and tag != b"IEND":
            # A critical chunk (upper-case first letter) this reader does
            # not know, or a second IHDR.
            raise ValueError(f"PNG: unexpected critical chunk {tag!r}")
    if not idat:
        raise ValueError("PNG: no IDAT chunk")
    if ctype == 3 and palette is None:
        raise ValueError("PNG: palette image without a PLTE chunk")

    n = _COLOR_TYPES[ctype][0]
    passes = _ADAM7 if interlace else ((0, 0, 1, 1),)
    geo = []
    for x0, y0, dx, dy in passes:
        pw, ph = (w - x0 + dx - 1) // dx, (h - y0 + dy - 1) // dy
        if pw > 0 and ph > 0:
            geo.append((x0, y0, dx, dy, pw, ph, (pw * n * depth + 7) // 8))
    need = sum(ph * (rb + 1) for *_, ph, rb in geo)
    try:
        raw = zlib.decompressobj().decompress(b"".join(idat), need)
    except zlib.error as e:
        raise ValueError(f"PNG: bad image data: {e}") from None
    if len(raw) < need:
        raise ValueError(f"PNG: truncated image data ({len(raw)} of {need} "
                         f"bytes)")
    raw = np.frombuffer(raw, np.uint8)
    px = np.empty((h, w, n), np.uint16 if depth == 16 else np.uint8)
    off, bpp = 0, max(1, n * depth // 8)
    for x0, y0, dx, dy, pw, ph, rb in geo:
        rows = _unfilter(raw, off, ph, rb, bpp)
        off += ph * (rb + 1)
        px[y0::dy, x0::dx] = _samples(rows, pw * n, depth).reshape(ph, pw, n)

    if ctype == 3:
        return palette[px[..., 0]]
    if depth == 16:
        px = (np.minimum(px, 255) if ctype == 0 else px >> 8).astype(np.uint8)
    elif depth < 8:
        px *= np.uint8(255 // ((1 << depth) - 1))
    if ctype == 0:
        return np.repeat(px, 3, axis=2)
    if ctype == 4:
        return px[..., [0, 0, 0, 1]]
    return px


def _chunk(tag: bytes, payload: bytes) -> bytes:
    return (struct.pack(">I", len(payload)) + tag + payload
            + struct.pack(">I", zlib.crc32(tag + payload)))


def write_png(arr) -> bytes:
    """Encodes uint8 [h, w, 3] (RGB) or [h, w, 4] (RGBA) as a PNG file."""
    a = np.asarray(arr)
    if a.dtype != np.uint8 or a.ndim != 3 or a.shape[2] not in (3, 4) \
            or 0 in a.shape:
        raise ValueError(f"write_png takes uint8 [h, w, 3 or 4], not "
                         f"{a.dtype} {list(a.shape)}")
    h, w, c = a.shape
    rows = a.reshape(h, w * c)
    up = rows.copy()
    up[1:] -= rows[:-1]
    raw = np.empty((h, w * c + 1), np.uint8)
    raw[:, 0] = 2
    raw[:, 1:] = up
    ihdr = struct.pack(">IIBBBBB", w, h, 8, 2 if c == 3 else 6, 0, 0, 0)
    return (SIGNATURE + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(raw.tobytes(), 6))
            + _chunk(b"IEND", b""))
