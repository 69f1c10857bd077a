"""The port's PNG reader and writer (webp_tpu_torch/utils/png.py) against
Pillow, which the reference CLI reads PNG with: read_png must return
np.array(im.convert("RGBA" if "A" in im.getbands() else "RGB")) for
every PNG the specification allows. The files are built here, sample by
sample (struct + zlib, the filters and Adam7 written out in numpy), so
that every colour type, bit depth, filter type and interlace pass is
exercised on purpose."""

import io
import struct
import zlib

import numpy as np
import pytest
from PIL import Image

from webp_tpu_torch.utils import png

DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16),
          6: (8, 16)}
CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
         (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))


def chunk(tag, payload):
    return (struct.pack(">I", len(payload)) + tag + payload
            + struct.pack(">I", zlib.crc32(tag + payload)))


def pack_rows(px, depth):
    """Samples [h, w, n] -> scanline bytes [h, rowbytes], MSB first."""
    h = px.shape[0]
    s = px.reshape(h, -1).astype(np.uint32)
    if depth == 16:
        return s.astype(">u2").view(np.uint8).reshape(h, -1)
    if depth == 8:
        return s.astype(np.uint8)
    per = 8 // depth
    pad = (-s.shape[1]) % per
    s = np.pad(s, ((0, 0), (0, pad))).reshape(h, -1, per)
    shifts = np.arange(8 - depth, -1, -depth)
    return (s << shifts).sum(-1).astype(np.uint8)


def paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = np.abs(p - a), np.abs(p - b), np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def filter_rows(rows, bpp, types):
    """Filters scanlines [h, rowbytes] with filter types[y] on row y."""
    out = []
    prev = np.zeros(rows.shape[1], np.int32)
    for y, cur in enumerate(rows.astype(np.int32)):
        left = np.concatenate([np.zeros(bpp, np.int32), cur[:-bpp]])
        upleft = np.concatenate([np.zeros(bpp, np.int32), prev[:-bpp]])
        # A type past 4 (an invalid file) is written unfiltered.
        pred = {1: left, 2: prev, 3: (left + prev) >> 1,
                4: paeth(left, prev, upleft)}.get(types[y], 0)
        out.append(bytes([types[y]]) + ((cur - pred) & 0xFF)
                   .astype(np.uint8).tobytes())
        prev = cur
    return b"".join(out)


def make_png(px, ctype, depth, interlace=0, filters=None, idat_parts=1,
             extra=b"", palette=None):
    h, w, n = px.shape
    bpp = max(1, n * depth // 8)
    passes = ADAM7 if interlace else ((0, 0, 1, 1),)
    raw = b""
    for x0, y0, dx, dy in passes:
        sub = px[y0::dy, x0::dx]
        if sub.size == 0:
            continue
        types = [filters if isinstance(filters, int) else
                 (y % 5 if filters is None else filters[y])
                 for y in range(sub.shape[0])]
        raw += filter_rows(pack_rows(sub, depth), bpp, types)
    z = zlib.compress(raw, 9)
    cut = np.linspace(0, len(z), idat_parts + 1).astype(int)
    idat = b"".join(chunk(b"IDAT", z[a:b]) for a, b in zip(cut, cut[1:]))
    plte = b"" if palette is None else chunk(b"PLTE", palette.tobytes())
    return (png.SIGNATURE + chunk(b"IHDR", struct.pack(
        ">IIBBBBB", w, h, depth, ctype, 0, 0, interlace)) + plte + extra
        + idat + chunk(b"IEND", b""))


def pillow(data):
    im = Image.open(io.BytesIO(data))
    return np.array(im.convert("RGBA" if "A" in im.getbands() else "RGB"))


def samples(rng, h, w, ctype, depth, n_palette=None):
    hi = (n_palette if ctype == 3 and n_palette else 1 << depth)
    return rng.integers(0, hi, (h, w, CHANNELS[ctype])).astype(np.uint16)


def palette(rng, n=256):
    return rng.integers(0, 256, (n, 3)).astype(np.uint8)


def check(data):
    got = png.read_png(data)
    want = pillow(data)
    assert got.dtype == np.uint8 and got.shape == want.shape
    np.testing.assert_array_equal(got, want)
    return got


COMBOS = [(c, d) for c in DEPTHS for d in DEPTHS[c]]


@pytest.mark.parametrize("interlace", [0, 1])
@pytest.mark.parametrize("ctype,depth", COMBOS)
def test_every_colour_type_and_depth_equals_pillow(ctype, depth, interlace):
    """Each colour type at each bit depth, non-interlaced and Adam7,
    rows filtered with types 0-4 in turn: Pillow's convert array."""
    rng = np.random.default_rng(ctype * 100 + depth * 2 + interlace)
    px = samples(rng, 11, 13, ctype, depth, 1 << min(depth, 8))
    pal = palette(rng, 1 << min(depth, 8)) if ctype == 3 else None
    got = check(make_png(px, ctype, depth, interlace, palette=pal))
    assert got.shape == (11, 13, 4 if ctype in (4, 6) else 3)


@pytest.mark.parametrize("ftype", range(5))
@pytest.mark.parametrize("ctype,depth", [(2, 8), (6, 16), (0, 2), (4, 8),
                                         (3, 4)])
def test_each_filter_type_on_every_row(ftype, ctype, depth):
    rng = np.random.default_rng(ftype)
    px = samples(rng, 9, 17, ctype, depth)
    pal = palette(rng) if ctype == 3 else None
    check(make_png(px, ctype, depth, filters=ftype, palette=pal))


@pytest.mark.parametrize("h,w", [(1, 1), (1, 9), (9, 1), (3, 5), (8, 8),
                                 (17, 10)])
def test_adam7_small_and_odd_sizes(h, w):
    """Sizes at which some Adam7 passes are empty (no filter bytes)."""
    rng = np.random.default_rng(h * 31 + w)
    for ctype, depth in ((2, 8), (0, 1), (6, 16)):
        px = samples(rng, h, w, ctype, depth)
        check(make_png(px, ctype, depth, interlace=1))


def test_split_idat_and_ancillary_chunks_are_skipped():
    rng = np.random.default_rng(5)
    px = samples(rng, 20, 30, 6, 8)
    extra = (chunk(b"gAMA", struct.pack(">I", 45455))
             + chunk(b"tEXt", b"Comment\0made in a test")
             + chunk(b"prVt", b"private ancillary"))
    data = make_png(px, 6, 8, idat_parts=7, extra=extra)
    got = check(data)
    np.testing.assert_array_equal(got, px.astype(np.uint8))


def test_trns_is_dropped_as_pillow_drops_it():
    """tRNS on palette, gray (8 and 16 bits) and RGB files: Pillow opens
    them without an A band, so the reader returns RGB."""
    rng = np.random.default_rng(6)
    cases = [(3, 8, chunk(b"tRNS", bytes([0, 128, 255]))),
             (0, 8, chunk(b"tRNS", struct.pack(">H", 7))),
             (0, 16, chunk(b"tRNS", struct.pack(">H", 300))),
             (2, 8, chunk(b"tRNS", struct.pack(">HHH", 1, 2, 3)))]
    for ctype, depth, trns in cases:
        px = samples(rng, 6, 9, ctype, depth)
        pal = palette(rng) if ctype == 3 else None
        data = make_png(px, ctype, depth, palette=pal)
        i = data.index(b"IDAT") - 4
        data = data[:i] + trns + data[i:]
        assert Image.open(io.BytesIO(data)).info.get("transparency") \
            is not None
        assert check(data).shape == (6, 9, 3)


def test_16_bit_gray_clips_at_255():
    """Pillow opens 16-bit gray as I;16 and converts it to RGB clipped at
    255, not scaled."""
    v = np.array([[0, 1, 255, 256, 1000, 65535]], np.uint16)[..., None]
    got = check(make_png(v, 0, 16))
    np.testing.assert_array_equal(got[0, :, 0], [0, 1, 255, 255, 255, 255])


def test_palette_index_past_plte_is_black():
    pal = np.array([[10, 20, 30], [40, 50, 60]], np.uint8)
    px = np.array([[0, 1, 2, 200]], np.uint16)[..., None]
    got = check(make_png(px, 3, 8, palette=pal))
    np.testing.assert_array_equal(got[0], [[10, 20, 30], [40, 50, 60],
                                           [0, 0, 0], [0, 0, 0]])


def _bad(data, match):
    with pytest.raises(ValueError, match=match):
        png.read_png(data)


def test_unreadable_files_raise_value_error():
    rng = np.random.default_rng(8)
    px = samples(rng, 5, 6, 2, 8)
    good = make_png(px, 2, 8)
    i = good.index(b"IDAT")
    _bad(good[:i + 6] + bytes([good[i + 6] ^ 1]) + good[i + 7:], "CRC")
    _bad(b"\x89PNX" + good[4:], "signature")
    _bad(good[:-12], "no IEND")
    _bad(good[:40], "truncated")
    _bad(make_png(px, 2, 8, filters=[0, 1, 5, 0, 0]), "filter type 5")
    _bad(make_png(samples(rng, 5, 6, 3, 8), 3, 8), "PLTE")
    ihdr = struct.pack(">IIBBBBB", 6, 5, 16, 3, 0, 0, 0)
    _bad(png.SIGNATURE + chunk(b"IHDR", ihdr) + good[33:], "bit depth 16")
    short = zlib.compress(b"\0" * 10)
    _bad(png.SIGNATURE + good[8:33] + chunk(b"IDAT", short)
         + chunk(b"IEND", b""), "truncated image data")
    _bad(png.SIGNATURE + good[8:33] + chunk(b"IDAT", b"not zlib")
         + chunk(b"IEND", b""), "bad image data")
    _bad(good[:33] + chunk(b"CrIt", b"x") + good[33:], "critical chunk")


@pytest.mark.parametrize("shape", [(1, 1, 3), (48, 64, 3), (37, 53, 4),
                                   (7, 1, 4)])
def test_writer_pixels_read_back_by_pillow(shape):
    rng = np.random.default_rng(shape[0])
    a = rng.integers(0, 256, shape).astype(np.uint8)
    data = png.write_png(a)
    im = Image.open(io.BytesIO(data))
    assert im.mode == ("RGB" if shape[2] == 3 else "RGBA")
    np.testing.assert_array_equal(np.array(im), a)
    np.testing.assert_array_equal(png.read_png(data), a)


def test_writer_rejects_what_it_cannot_write():
    for a in (np.zeros((4, 4), np.uint8), np.zeros((4, 4, 2), np.uint8),
              np.zeros((4, 4, 3), np.uint16), np.zeros((0, 4, 3), np.uint8)):
        with pytest.raises(ValueError):
            png.write_png(a)


def test_pillow_written_files_and_apng_detection():
    """Files Pillow writes (its own filter choices, optimize, Adam7 where
    it interlaces) read back exactly; an APNG is told apart by its acTL
    chunk."""
    rng = np.random.default_rng(9)
    a = rng.integers(0, 256, (33, 45, 4)).astype(np.uint8)
    for mode in ("RGB", "RGBA", "L", "LA", "P", "1", "I;16"):
        im = Image.fromarray(a, "RGBA").convert(mode)
        buf = io.BytesIO()
        im.save(buf, format="PNG", optimize=True)
        check(buf.getvalue())
        assert not png.is_apng(buf.getvalue())
    buf = io.BytesIO()
    frames = [Image.fromarray(a[..., :3]), Image.fromarray(255 - a[..., :3])]
    frames[0].save(buf, format="PNG", save_all=True,
                   append_images=frames[1:])
    assert png.is_apng(buf.getvalue())
