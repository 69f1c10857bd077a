"""An independent VP8L (WebP lossless) decoder, written from RFC 9649
("WebP Image Format", section 3: "Specification for WebP Lossless
Bitstream") in plain Python and numpy, for the benchmark's check. It
shares no code with the measured package's decoders.

It reads the whole format: the four transforms (predictor, color,
subtract-green, color indexing with pixel bundling), the color cache,
LZ77 backward references with the distance map, and the meta prefix
codes of the entropy image. Where the RFC leaves a choice to the decoder
it follows libwebp's: a prefix code with one used symbol takes zero bits,
predictor modes 14 and 15 predict black, a palette index past the table
gives transparent black. What the RFC does not allow raises VP8LError:
a truncated stream, a wrong signature or version, a transform used
twice, an incomplete or over-subscribed prefix code, an empty one, a
cache size out of range, a back reference before the first pixel or past
the last.

The pixel loop and the predictor inverse are plain Python loops (about
8 s together for a 1920x1080 photo-like image on one core); the color,
subtract-green and color-indexing inverses are numpy.
"""

from __future__ import annotations

import numpy as np


class VP8LError(ValueError):
    """A stream this decoder refuses."""


SIGNATURE = 0x2F
NUM_LITERAL = 256
NUM_LENGTH_PREFIX = 24
NUM_DISTANCE_PREFIX = 40
# RFC 9649 3.7.2.1.2: the order in which code length code lengths come.
CODE_LENGTH_ORDER = (17, 18, 0, 1, 2, 3, 4, 5, 16, 6, 7, 8, 9, 10, 11, 12,
                     13, 14, 15)
# RFC 9649 4.2.2: distance codes 1..120 as (xi, yi), distance xi + yi *
# image width (at least 1).
DISTANCE_MAP = (
    (0, 1), (1, 0), (1, 1), (-1, 1), (0, 2), (2, 0), (1, 2),
    (-1, 2), (2, 1), (-2, 1), (2, 2), (-2, 2), (0, 3), (3, 0),
    (1, 3), (-1, 3), (3, 1), (-3, 1), (2, 3), (-2, 3), (3, 2),
    (-3, 2), (0, 4), (4, 0), (1, 4), (-1, 4), (4, 1), (-4, 1),
    (3, 3), (-3, 3), (2, 4), (-2, 4), (4, 2), (-4, 2), (0, 5),
    (3, 4), (-3, 4), (4, 3), (-4, 3), (5, 0), (1, 5), (-1, 5),
    (5, 1), (-5, 1), (2, 5), (-2, 5), (5, 2), (-5, 2), (4, 4),
    (-4, 4), (3, 5), (-3, 5), (5, 3), (-5, 3), (0, 6), (6, 0),
    (1, 6), (-1, 6), (6, 1), (-6, 1), (2, 6), (-2, 6), (6, 2),
    (-6, 2), (4, 5), (-4, 5), (5, 4), (-5, 4), (3, 6), (-3, 6),
    (6, 3), (-6, 3), (0, 7), (7, 0), (1, 7), (-1, 7), (5, 5),
    (-5, 5), (7, 1), (-7, 1), (4, 6), (-4, 6), (6, 4), (-6, 4),
    (2, 7), (-2, 7), (7, 2), (-7, 2), (3, 7), (-3, 7), (7, 3),
    (-7, 3), (5, 6), (-5, 6), (6, 5), (-6, 5), (8, 0), (4, 7),
    (-4, 7), (7, 4), (-7, 4), (8, 1), (8, 2), (6, 6), (-6, 6),
    (8, 3), (5, 7), (-5, 7), (7, 5), (-7, 5), (8, 4), (6, 7),
    (-6, 7), (7, 6), (-7, 6), (8, 5), (7, 7), (-7, 7), (8, 6),
    (8, 7))
PREDICTOR, COLOR, SUBTRACT_GREEN, COLOR_INDEXING = range(4)


def _div_round_up(num: int, bits: int) -> int:
    return (num + (1 << bits) - 1) >> bits


class _Reader:
    """LSB-first bits of a byte string. Reads past the end raise; the
    pixel loop peeks at the bytes itself and checks `pos` after."""

    def __init__(self, data: bytes):
        self.data = bytes(data) + bytes(8)
        self.nbits = len(data) * 8
        self.pos = 0

    def read(self, n: int) -> int:
        if n == 0:
            return 0
        p = self.pos
        v = int.from_bytes(self.data[p >> 3:(p >> 3) + 8], "little")
        self.pos = p + n
        self.check()
        return (v >> (p & 7)) & ((1 << n) - 1)

    def check(self) -> None:
        if self.pos > self.nbits:
            raise VP8LError("truncated VP8L stream")


# -- prefix codes (RFC 9649 3.7.2) ------------------------------------------

class _Code:
    """A canonical prefix code as a lookup table over the next `bits` bits
    of the stream (LSB first): each entry is symbol << 4 | code length."""

    __slots__ = ("table", "mask")

    def __init__(self, lengths):
        used = [(s, n) for s, n in enumerate(lengths) if n]
        if not used:
            raise VP8LError("a prefix code with no symbol")
        if len(used) == 1:              # one symbol: zero bits
            self.table, self.mask = [used[0][0] << 4], 0
            return
        top = max(n for _, n in used)
        count = [0] * (top + 1)
        for _, n in used:
            count[n] += 1
        if sum(count[n] << (top - n) for n in range(1, top + 1)) \
                != 1 << top:
            raise VP8LError("an incomplete or over-subscribed prefix code")
        first = [0] * (top + 1)
        code = 0
        for n in range(1, top + 1):
            code = (code + count[n - 1]) << 1
            first[n] = code
        table = [0] * (1 << top)
        for s, n in used:               # symbols in increasing order
            c = first[n]
            first[n] += 1
            rev = int(format(c, f"0{n}b")[::-1], 2)
            table[rev::1 << n] = [(s << 4) | n] * (1 << (top - n))
        self.table, self.mask = table, (1 << top) - 1

    def read(self, br: _Reader) -> int:
        p = br.pos
        v = int.from_bytes(br.data[p >> 3:(p >> 3) + 8], "little") \
            >> (p & 7)
        e = self.table[v & self.mask]
        br.pos = p + (e & 15)
        br.check()
        return e >> 4


def _read_code(br: _Reader, alphabet: int) -> _Code:
    lengths = [0] * alphabet
    if br.read(1):                      # simple code: one or two symbols
        n_symbols = br.read(1) + 1
        symbols = [br.read(8 if br.read(1) else 1)]
        if n_symbols == 2:
            symbols.append(br.read(8))
        for s in symbols:
            if s >= alphabet:
                raise VP8LError("a simple code's symbol is out of range")
            lengths[s] = 1
        return _Code(lengths)
    n_lengths = br.read(4) + 4
    cl_lengths = [0] * len(CODE_LENGTH_ORDER)
    for i in range(n_lengths):
        cl_lengths[CODE_LENGTH_ORDER[i]] = br.read(3)
    cl_code = _Code(cl_lengths)
    if br.read(1):
        max_symbol = 2 + br.read(2 + 2 * br.read(3))
        if max_symbol > alphabet:
            raise VP8LError("max_symbol is larger than the alphabet")
    else:
        max_symbol = alphabet
    s, prev = 0, 8
    while s < alphabet and max_symbol > 0:
        max_symbol -= 1
        c = cl_code.read(br)
        if c < 16:
            lengths[s] = c
            s += 1
            if c:
                prev = c
            continue
        if c == 16:
            repeat, value = 3 + br.read(2), prev
        elif c == 17:
            repeat, value = 3 + br.read(3), 0
        else:
            repeat, value = 11 + br.read(7), 0
        if s + repeat > alphabet:
            raise VP8LError("code lengths run past the alphabet")
        lengths[s:s + repeat] = [value] * repeat
        s += repeat
    return _Code(lengths)


def _read_group(br: _Reader, cache_bits: int) -> tuple:
    green = NUM_LITERAL + NUM_LENGTH_PREFIX + (
        (1 << cache_bits) if cache_bits else 0)
    codes = [_read_code(br, n) for n in (green, NUM_LITERAL, NUM_LITERAL,
                                         NUM_LITERAL, NUM_DISTANCE_PREFIX)]
    return tuple(x for c in codes for x in (c.table, c.mask))


# -- entropy-coded images (RFC 9649 3.6 and 3.7) --------------------------

def _prefix_value(br: _Reader, code: int) -> int:
    """A length or distance from its prefix code and extra bits."""
    if code < 4:
        return code + 1
    extra = (code - 2) >> 1
    return ((2 + (code & 1)) << extra) + br.read(extra) + 1


def _decode_image(br: _Reader, w: int, h: int, main: bool) -> list:
    """The w * h ARGB pixels of an entropy-coded image (main: the
    spatially coded main image, which may have meta prefix codes)."""
    cache_bits = 0
    if br.read(1):
        cache_bits = br.read(4)
        if not 1 <= cache_bits <= 11:
            raise VP8LError(f"color cache bits {cache_bits}")
    meta, meta_bits, meta_w = None, 0, 0
    if main and br.read(1):
        meta_bits = br.read(3) + 2
        meta_w = _div_round_up(w, meta_bits)
        entropy = _decode_image(br, meta_w, _div_round_up(h, meta_bits),
                                False)
        meta = [(p >> 8) & 0xFFFF for p in entropy]
    n_groups = max(meta) + 1 if meta else 1
    groups = [_read_group(br, cache_bits) for _ in range(n_groups)]
    return _decode_pixels(br, w, h, groups, meta, meta_bits, meta_w,
                          cache_bits)


def _decode_pixels(br, w, h, groups, meta, meta_bits, meta_w, cache_bits):
    n = w * h
    out = [0] * n
    data = br.data
    cache = [0] * (1 << cache_bits) if cache_bits else None
    shift = 32 - cache_bits
    tg = mg = tr = mr = tb = mb = ta = ma = td = md = None
    i = x = y = 0
    switch = 0                  # the pixel at which the group may change
    while i < n:
        if i >= switch:
            if meta is None:
                gi, switch = 0, n
            else:
                tx = x >> meta_bits
                gi = meta[(y >> meta_bits) * meta_w + tx]
                switch = i + min((tx + 1) << meta_bits, w) - x
            tg, mg, tr, mr, tb, mb, ta, ma, td, md = groups[gi]
        p = br.pos
        e = tg[(int.from_bytes(data[p >> 3:(p >> 3) + 8], "little")
                >> (p & 7)) & mg]
        p += e & 15
        s = e >> 4
        if s < NUM_LITERAL:
            q = p >> 3
            v = int.from_bytes(data[q:q + 8], "little") >> (p & 7)
            e = tr[v & mr]
            red = e >> 4
            p += e & 15
            q = p >> 3
            v = int.from_bytes(data[q:q + 8], "little") >> (p & 7)
            e = tb[v & mb]
            blue = e >> 4
            p += e & 15
            q = p >> 3
            v = int.from_bytes(data[q:q + 8], "little") >> (p & 7)
            e = ta[v & ma]
            br.pos = p + (e & 15)
            px = ((e >> 4) << 24) | (red << 16) | (s << 8) | blue
            out[i] = px
            if cache is not None:
                cache[((px * 0x1E35A7BD) & 0xFFFFFFFF) >> shift] = px
            i += 1
            x += 1
            if x == w:
                x = 0
                y += 1
                br.check()
            continue
        br.pos = p
        if s < NUM_LITERAL + NUM_LENGTH_PREFIX:
            length = _prefix_value(br, s - NUM_LITERAL)
            p = br.pos
            e = td[(int.from_bytes(data[p >> 3:(p >> 3) + 8], "little")
                    >> (p & 7)) & md]
            br.pos = p + (e & 15)
            code = _prefix_value(br, e >> 4)
            if code > 120:
                dist = code - 120
            else:
                xi, yi = DISTANCE_MAP[code - 1]
                dist = max(1, xi + yi * w)
            br.check()
            if dist > i or i + length > n:
                raise VP8LError("a back reference outside the image")
            src = i - dist
            if dist >= length:
                out[i:i + length] = out[src:src + length]
            else:
                run = out[src:i]
                out[i:i + length] = (run * (length // dist + 1))[:length]
            if cache is not None:
                for px in out[i:i + length]:
                    cache[((px * 0x1E35A7BD) & 0xFFFFFFFF) >> shift] = px
            i += length
            y, x = divmod(i, w)
            switch = i if meta is not None else switch
        else:
            if cache is None:
                raise VP8LError("a color cache symbol without a cache")
            out[i] = cache[s - NUM_LITERAL - NUM_LENGTH_PREFIX]
            i += 1
            x += 1
            if x == w:
                x = 0
                y += 1
                br.check()
    br.check()
    return out


# -- transforms (RFC 9649 4) -----------------------------------------------

def _add(a: int, b: int) -> int:
    return ((((a & 0xFF00FF00) + (b & 0xFF00FF00)) & 0xFF00FF00)
            | (((a & 0x00FF00FF) + (b & 0x00FF00FF)) & 0x00FF00FF))


def _avg2(a: int, b: int) -> int:
    return (((a ^ b) & 0xFEFEFEFE) >> 1) + (a & b)


def _select(left: int, top: int, top_left: int) -> int:
    p_left = p_top = 0
    for s in (0, 8, 16, 24):
        tl = (top_left >> s) & 0xFF
        p_left += abs(((top >> s) & 0xFF) - tl)
        p_top += abs(((left >> s) & 0xFF) - tl)
    return left if p_left < p_top else top


def _clamp_add_subtract_full(a: int, b: int, c: int) -> int:
    out = 0
    for s in (0, 8, 16, 24):
        v = ((a >> s) & 0xFF) + ((b >> s) & 0xFF) - ((c >> s) & 0xFF)
        out |= (0 if v < 0 else 255 if v > 255 else v) << s
    return out


def _clamp_add_subtract_half(a: int, b: int) -> int:
    out = 0
    for s in (0, 8, 16, 24):
        ca, cb = (a >> s) & 0xFF, (b >> s) & 0xFF
        d = ca - cb
        v = ca + (d >> 1 if d >= 0 else -((-d) >> 1))
        out |= (0 if v < 0 else 255 if v > 255 else v) << s
    return out


def _prediction(mode: int, left: int, top: int, top_left: int,
                top_right: int) -> int:
    if mode == 1:
        return left
    if mode == 2:
        return top
    if mode == 3:
        return top_right
    if mode == 4:
        return top_left
    if mode == 5:
        return _avg2(_avg2(left, top_right), top)
    if mode == 6:
        return _avg2(left, top_left)
    if mode == 7:
        return _avg2(left, top)
    if mode == 8:
        return _avg2(top_left, top)
    if mode == 9:
        return _avg2(top, top_right)
    if mode == 10:
        return _avg2(_avg2(left, top_left), _avg2(top, top_right))
    if mode == 11:
        return _select(left, top, top_left)
    if mode == 12:
        return _clamp_add_subtract_full(left, top, top_left)
    if mode == 13:
        return _clamp_add_subtract_half(_avg2(left, top), top_left)
    return 0xFF000000                   # 0, and 14 and 15 as libwebp


def _predictor_inverse(px: list, w: int, h: int, bits: int,
                       tiles: list) -> list:
    """In place on the residuals (a list of w * h packed ints). The top
    row predicts from the left (its first pixel from black), the left
    column from the top; the rest by the tile's mode, with the top-right
    of the last column the first pixel of the current row."""
    px[0] = _add(px[0], 0xFF000000)
    for i in range(1, w):
        px[i] = _add(px[i], px[i - 1])
    tiles_w = _div_round_up(w, bits)
    for y in range(1, h):
        row = y * w
        px[row] = _add(px[row], px[row - w])
        modes = tiles[(y >> bits) * tiles_w:(y >> bits) * tiles_w + tiles_w]
        for tx, t in enumerate(modes):
            mode = (t >> 8) & 0xF
            lo = row + max(1, tx << bits)
            hi = row + min(w, (tx + 1) << bits)
            if mode == 1:               # the commonest: a running sum
                left = px[lo - 1]
                for i in range(lo, hi):
                    left = px[i] = _add(px[i], left)
                continue
            if mode == 2:
                for i in range(lo, hi):
                    px[i] = _add(px[i], px[i - w])
                continue
            for i in range(lo, hi):
                px[i] = _add(px[i], _prediction(
                    mode, px[i - 1], px[i - w], px[i - w - 1],
                    px[i - w + 1]))
    return px


def _signed8(v: np.ndarray) -> np.ndarray:
    return (v & 0xFF).astype(np.int32) - ((v & 0x80).astype(np.int32) << 1)


def _color_inverse(px: np.ndarray, w: int, h: int, bits: int,
                   tiles: np.ndarray) -> np.ndarray:
    """RFC 9649 4.2: red += delta(green_to_red, green); blue +=
    delta(green_to_blue, green) + delta(red_to_blue, the new red), each
    delta (t * c) >> 5 of signed bytes."""
    tiles_w = _div_round_up(w, bits)
    ty = np.arange(h)[:, None] >> bits
    tx = np.arange(w)[None, :] >> bits
    t = tiles.reshape(-1)[(ty * tiles_w + tx).reshape(-1)].astype(np.int64)
    g2r, g2b, r2b = _signed8(t), _signed8(t >> 8), _signed8(t >> 16)
    p = px.astype(np.int64)
    green = _signed8(p >> 8)
    red = ((p >> 16) + ((g2r * green) >> 5)) & 0xFF
    blue = (p + ((g2b * green) >> 5)) & 0xFF
    blue = (blue + ((r2b * _signed8(red)) >> 5)) & 0xFF
    return ((p & 0xFF00FF00) | (red << 16) | blue).astype(np.uint32)


def _add_green_inverse(px: np.ndarray) -> np.ndarray:
    p = px.astype(np.int64)
    green = (p >> 8) & 0xFF
    red = ((p >> 16) + green) & 0xFF
    blue = (p + green) & 0xFF
    return ((p & 0xFF00FF00) | (red << 16) | blue).astype(np.uint32)


def _color_indexing_inverse(px: np.ndarray, w: int, h: int,
                            width_bits: int,
                            palette: np.ndarray) -> np.ndarray:
    """The packed image [h, ceil(w / 2^width_bits)] of indices in green
    (several to a pixel, the first in the lowest bits) -> [h, w] colors;
    an index past the table is transparent black."""
    per = 1 << width_bits
    nbits = 8 >> width_bits
    packed = ((px.reshape(h, -1) >> 8) & 0xFF).astype(np.int64)
    xs = np.arange(w)
    idx = (packed[:, xs >> width_bits] >> ((xs & (per - 1)) * nbits)) \
        & ((1 << nbits) - 1)
    table = np.zeros(256, np.uint32)
    table[:len(palette)] = palette[:256]
    return table[idx].reshape(-1)


# -- the frame ---------------------------------------------------------------

def decode_argb(payload: bytes):
    """A VP8L payload (the VP8L chunk's data) -> (ARGB uint32 [h, w],
    alpha_is_used)."""
    br = _Reader(payload)
    if len(payload) < 5 or br.read(8) != SIGNATURE:
        raise VP8LError("no VP8L signature")
    w = br.read(14) + 1
    h = br.read(14) + 1
    alpha_is_used = bool(br.read(1))
    if br.read(3) != 0:
        raise VP8LError("VP8L version is not 0")
    transforms = []
    xsize = w
    while br.read(1):
        kind = br.read(2)
        if any(t[0] == kind for t in transforms):
            raise VP8LError(f"transform {kind} used twice")
        if kind in (PREDICTOR, COLOR):
            bits = br.read(3) + 2
            data = _decode_image(br, _div_round_up(xsize, bits),
                                 _div_round_up(h, bits), False)
            transforms.append((kind, xsize, bits, data))
        elif kind == SUBTRACT_GREEN:
            transforms.append((kind, xsize, 0, None))
        else:
            size = br.read(8) + 1
            pal = _decode_image(br, size, 1, False)
            for k in range(1, size):
                pal[k] = _add(pal[k], pal[k - 1])
            width_bits = 3 if size <= 2 else 2 if size <= 4 else \
                1 if size <= 16 else 0
            transforms.append((kind, xsize, width_bits,
                               np.array(pal, np.uint32)))
            xsize = _div_round_up(xsize, width_bits)
    px = _decode_image(br, xsize, h, True)
    for kind, width, bits, data in reversed(transforms):
        if kind == PREDICTOR:
            px = _predictor_inverse(np.asarray(px, np.uint32).tolist(),
                                    width, h, bits, data)
        elif kind == COLOR:
            px = _color_inverse(np.asarray(px, np.uint32), width, h, bits,
                                np.asarray(data, np.uint32))
        elif kind == SUBTRACT_GREEN:
            px = _add_green_inverse(np.asarray(px, np.uint32))
        else:
            px = _color_indexing_inverse(np.asarray(px, np.uint32), width,
                                         h, bits, data)
    return np.asarray(px, np.uint32).reshape(h, w), alpha_is_used


def vp8l_payload(data: bytes) -> bytes:
    """The VP8L chunk of a simple lossless WebP file: RIFF, WEBP, one
    VP8L chunk and nothing after it; anything else raises."""
    data = bytes(data)
    if len(data) < 21 or data[:4] != b"RIFF" or data[8:12] != b"WEBP":
        raise VP8LError("not a RIFF WEBP file")
    if int.from_bytes(data[4:8], "little") != len(data) - 8:
        raise VP8LError("the RIFF size is not the file's")
    if data[12:16] != b"VP8L":
        raise VP8LError(f"the frame is {data[12:16]!r}, not one VP8L chunk")
    n = int.from_bytes(data[16:20], "little")
    if 20 + n + (n & 1) != len(data):
        raise VP8LError("the VP8L chunk is not the file's one chunk")
    return data[20:20 + n]


def decode_rgb(data: bytes) -> np.ndarray:
    """A simple lossless WebP file -> RGB uint8 [h, w, 3]."""
    argb, _ = decode_argb(vp8l_payload(data))
    b = argb.view(np.uint8).reshape(argb.shape + (4,))
    return np.ascontiguousarray(b[..., 2::-1])
