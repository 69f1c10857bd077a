"""VP8L lossless decoder.

Host entropy decode (Huffman + LZ77 + color cache) producing an ARGB pixel
grid, followed by the inverse transform stack. decode_vp8l runs the native
decoder (native/src/vp8l_dec.cc, built at first use; a failed build
raises). VP8LDecoder is the numpy decoder with the same validation: the
ALPH path decodes its headerless streams with it (lossy/alpha.py), and the
tests hold the native decoder against it. Its inverse transforms are
lossless/transforms.py's (the predictor inverse's left-dependent modes are
a serial chain per row); PyTorch versions of the parallel ones are in
ops/lossless.py. There is no device VP8L decode.

Behavioral parity with the reference's internal/lossless/
{decode.go,decode_image.go,decode_transform.go}.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

from ..bitio.lossless import LosslessBitReader
from ..container.riff import WebPError
from . import huffman as hf
from .huffman import HuffmanTable

VP8L_MAGIC = 0x2F
MAX_CACHE_BITS = 11
NUM_LITERAL_CODES = 256
NUM_LENGTH_CODES = 24
ARGB_BLACK = 0xFF000000

# Transform types (WebP lossless spec §3).
PREDICTOR_TRANSFORM = 0
CROSS_COLOR_TRANSFORM = 1
SUBTRACT_GREEN_TRANSFORM = 2
COLOR_INDEXING_TRANSFORM = 3

CODE_TO_PLANE_CODES = 120


def _make_code_to_plane() -> list[tuple[int, int]]:
    """Derives the spec's 120-entry distance-to-plane neighborhood map.

    The table is the (dx, dy) offsets with dy in 0..7, dx in -7..8 (dy>0 or
    dx>0), ordered by squared distance, then |dx|, positive dx first.
    (Equivalent to the constant table in the WebP lossless spec §5.2.2.)
    """
    cands = []
    for dy in range(0, 8):
        for dx in range(-7, 9):
            if dy == 0 and dx <= 0:
                continue
            cands.append((dx, dy))
    cands.sort(key=lambda p: (p[0] ** 2 + p[1] ** 2, abs(p[0]), p[0] < 0))
    return cands[:CODE_TO_PLANE_CODES]


CODE_TO_PLANE = _make_code_to_plane()


def sub_sample_size(size: int, bits: int) -> int:
    return (size + (1 << bits) - 1) >> bits


def plane_code_to_distance(xsize: int, plane_code: int) -> int:
    if plane_code > CODE_TO_PLANE_CODES:
        return plane_code - CODE_TO_PLANE_CODES
    dx, dy = CODE_TO_PLANE[plane_code - 1]
    dist = dy * xsize + dx
    return dist if dist >= 1 else 1


def get_copy_distance(symbol: int, br: LosslessBitReader) -> int:
    if symbol < 4:
        return symbol + 1
    extra = (symbol - 2) >> 1
    offset = (2 + (symbol & 1)) << extra
    return offset + br.read_bits(extra) + 1


@dataclass
class Transform:
    type: int
    xsize: int
    ysize: int
    bits: int = 0
    data: Optional[np.ndarray] = None  # uint32 tile/palette data


@dataclass
class HTreeGroup:
    trees: List[HuffmanTable] = field(default_factory=list)  # G, R, B, A, D


class BitstreamError(WebPError):
    """Malformed/truncated VP8L bitstream (a WebPError: decode() raises
    only WebPError subclasses on bad input)."""


class VP8LDecoder:
    """Decodes one VP8L bitstream into an ARGB uint32 [h, w] array."""

    def __init__(self, data: bytes):
        if len(data) < 5 or data[0] != VP8L_MAGIC:
            raise BitstreamError("webp: bad VP8L signature")
        self.br = LosslessBitReader(data[1:])
        self.width = self.br.read_bits(14) + 1
        self.height = self.br.read_bits(14) + 1
        self.has_alpha = self.br.read_bits(1) != 0
        if self.br.read_bits(3) != 0:
            raise BitstreamError("webp: bad VP8L version")
        self.transforms: List[Transform] = []
        self._transforms_seen = 0
        self._recursion = 0
        # Per-stream (reset for sub-images):
        self._groups: List[HTreeGroup] = []
        self._huffman_image: Optional[np.ndarray] = None
        self._huffman_bits = 0
        self._huffman_xsize = 0
        self._cache_bits = 0

    # -- top level -------------------------------------------------------
    def decode(self) -> np.ndarray:
        """Returns the decoded image as uint32 ARGB [height, width]."""
        w, h = self.width, self.height
        tw = self._decode_image_stream_header(w, h, is_level0=True)
        data = self._decode_image_data(tw, h)
        argb = self._apply_inverse_transforms(data, tw, h)
        return argb.reshape(h, w)

    # -- stream header ----------------------------------------------------
    def _decode_image_stream_header(self, xsize: int, ysize: int, is_level0: bool) -> int:
        tw, th = xsize, ysize
        if is_level0:
            while self.br.read_bits(1) == 1:
                tw = self._read_transform(tw, th)
        cache_bits = 0
        if self.br.read_bits(1) == 1:
            cache_bits = self.br.read_bits(4)
            if not (1 <= cache_bits <= MAX_CACHE_BITS):
                raise BitstreamError("webp: bad color cache bits")
        self._read_huffman_codes(tw, th, cache_bits, is_level0)
        self._cache_bits = cache_bits
        return tw

    def _read_transform(self, xsize: int, ysize: int) -> int:
        ttype = self.br.read_bits(2)
        if self._transforms_seen & (1 << ttype):
            raise BitstreamError("webp: duplicate transform")
        self._transforms_seen |= 1 << ttype
        t = Transform(ttype, xsize, ysize)
        if ttype in (PREDICTOR_TRANSFORM, CROSS_COLOR_TRANSFORM):
            t.bits = 2 + self.br.read_bits(3)
            sw = sub_sample_size(xsize, t.bits)
            sh = sub_sample_size(ysize, t.bits)
            t.data = self._decode_sub_image(sw, sh)
        elif ttype == COLOR_INDEXING_TRANSFORM:
            num_colors = self.br.read_bits(8) + 1
            if num_colors > 16:
                t.bits = 0
            elif num_colors > 4:
                t.bits = 1
            elif num_colors > 2:
                t.bits = 2
            else:
                t.bits = 3
            xsize = sub_sample_size(xsize, t.bits)
            pal = self._decode_sub_image(num_colors, 1)
            # Palette entries are delta-coded per byte channel.
            acc = np.cumsum(
                pal.view(np.uint8).reshape(-1, 4).astype(np.uint32), axis=0, dtype=np.uint32
            ) & 0xFF
            t.data = np.ascontiguousarray(acc.astype(np.uint8)).view(np.uint32).reshape(-1)
        # SUBTRACT_GREEN has no payload.
        self.transforms.append(t)
        return xsize

    def _decode_sub_image(self, xsize: int, ysize: int) -> np.ndarray:
        self._recursion += 1
        if self._recursion > 2:
            raise BitstreamError("webp: transform recursion too deep")
        saved = (self._groups, self._huffman_image, self._huffman_bits,
                 self._huffman_xsize, self._cache_bits)
        self._huffman_image = None
        self._huffman_bits = 0
        tw = self._decode_image_stream_header(xsize, ysize, is_level0=False)
        assert tw == xsize
        data = self._decode_image_data(xsize, ysize)
        (self._groups, self._huffman_image, self._huffman_bits,
         self._huffman_xsize, self._cache_bits) = saved
        self._recursion -= 1
        return data

    def _read_huffman_codes(self, xsize: int, ysize: int, cache_bits: int,
                            allow_recursion: bool) -> None:
        num_groups = 1
        if allow_recursion and self.br.read_bits(1) == 1:
            bits = 2 + self.br.read_bits(3)
            sw = sub_sample_size(xsize, bits)
            sh = sub_sample_size(ysize, bits)
            img = self._decode_sub_image(sw, sh)
            meta = ((img >> 8) & 0xFFFF).astype(np.int32)
            num_groups = int(meta.max()) + 1
            self._huffman_image = meta
            self._huffman_bits = bits
            self._huffman_xsize = sw
        else:
            self._huffman_image = None
            self._huffman_bits = 0
            self._huffman_xsize = 0
        groups: List[HTreeGroup] = []
        for _ in range(num_groups):
            g = HTreeGroup()
            for i in range(5):
                n = hf.alphabet_size(i, cache_bits if i == 0 else 0)
                g.trees.append(self._read_huffman_code(n))
            groups.append(g)
        self._groups = groups

    def _read_huffman_code(self, alphabet_size: int) -> HuffmanTable:
        br = self.br
        simple = br.read_bits(1)
        code_lengths = [0] * alphabet_size
        if simple == 1:
            num_symbols = br.read_bits(1) + 1
            first_8bit = br.read_bits(1)
            sym0 = br.read_bits(8 if first_8bit else 1)
            if sym0 >= alphabet_size:
                raise BitstreamError("webp: bad simple huffman symbol")
            code_lengths[sym0] = 1
            if num_symbols == 2:
                sym1 = br.read_bits(8)
                if sym1 >= alphabet_size:
                    raise BitstreamError("webp: bad simple huffman symbol")
                code_lengths[sym1] = 1
            try:
                return hf.build_huffman_table(code_lengths)
            except ValueError as e:
                raise BitstreamError(str(e)) from None
        # Code-lengths are themselves huffman coded.
        num_codes = br.read_bits(4) + 4
        if num_codes > hf.CODE_LENGTH_CODES:
            raise BitstreamError("webp: bad code length count")
        cl_lengths = [0] * hf.CODE_LENGTH_CODES
        for i in range(num_codes):
            cl_lengths[hf.CODE_LENGTH_CODE_ORDER[i]] = br.read_bits(3)
        try:
            cl_table = hf.build_huffman_table(cl_lengths)
        except ValueError as e:
            raise BitstreamError(str(e)) from None
        lengths = self._read_code_lengths(cl_table, alphabet_size)
        try:
            return hf.build_huffman_table(lengths)
        except ValueError as e:
            raise BitstreamError(str(e)) from None

    def _read_code_lengths(self, cl_table: HuffmanTable, num_symbols: int) -> List[int]:
        br = self.br
        lengths = [0] * num_symbols
        prev_len = 8  # default code length
        max_symbol = num_symbols
        if br.read_bits(1) == 1:  # use length
            length_nbits = 2 + 2 * br.read_bits(3)
            max_symbol = 2 + br.read_bits(length_nbits)
            if max_symbol > num_symbols:
                raise BitstreamError("webp: bad max symbol")
        symbol = 0
        remaining = max_symbol
        while symbol < num_symbols:
            if remaining == 0:
                break
            remaining -= 1
            code_len = cl_table.read_symbol(br)
            if code_len < hf.CODE_LENGTH_LITERALS:
                lengths[symbol] = code_len
                symbol += 1
                if code_len != 0:
                    prev_len = code_len
            else:
                slot = code_len - hf.CODE_LENGTH_LITERALS
                extra = hf.CODE_LENGTH_EXTRA_BITS[slot]
                repeat = br.read_bits(extra) + hf.CODE_LENGTH_REPEAT_OFFSETS[slot]
                if symbol + repeat > num_symbols:
                    raise BitstreamError("webp: code length repeat overflow")
                fill = prev_len if code_len == hf.CODE_LENGTH_REPEAT_CODE else 0
                for _ in range(repeat):
                    lengths[symbol] = fill
                    symbol += 1
        if self.br.is_end_of_stream():
            raise BitstreamError("webp: truncated code lengths")
        return lengths

    # -- pixel data --------------------------------------------------------
    def _decode_image_data(self, width: int, height: int) -> np.ndarray:
        """The serial LZ77 + Huffman + color-cache loop."""
        br = self.br
        n = width * height
        data = np.zeros(n, dtype=np.uint32)
        cache_bits = self._cache_bits
        cache_size = 1 << cache_bits if cache_bits else 0
        cache = [0] * cache_size
        cache_shift = 32 - cache_bits if cache_bits else 0
        len_code_limit = NUM_LITERAL_CODES + NUM_LENGTH_CODES
        cache_limit = len_code_limit + cache_size

        meta = self._huffman_image
        hbits = self._huffman_bits
        hxsize = self._huffman_xsize
        mask = (1 << hbits) - 1 if hbits else ~0

        groups = self._groups
        group = groups[0]

        pos = 0
        col = 0
        row = 0
        while pos < n:
            if hbits and (col & mask) == 0:
                idx = int(meta[(row >> hbits) * hxsize + (col >> hbits)])
                group = groups[idx] if idx < len(groups) else groups[0]
            g = group.trees[0].read_symbol(br)
            if g < NUM_LITERAL_CODES:
                red = group.trees[1].read_symbol(br)
                blue = group.trees[2].read_symbol(br)
                alpha = group.trees[3].read_symbol(br)
                px = (alpha << 24) | (red << 16) | (g << 8) | blue
                data[pos] = px
                if cache_bits:
                    cache[(0x1E35A7BD * px & 0xFFFFFFFF) >> cache_shift] = px
                pos += 1
                col += 1
                if col >= width:
                    col = 0
                    row += 1
            elif g < len_code_limit:
                length = get_copy_distance(g - NUM_LITERAL_CODES, br)
                dsym = group.trees[4].read_symbol(br)
                dist = plane_code_to_distance(width, get_copy_distance(dsym, br))
                if dist > pos or length > n - pos:
                    raise BitstreamError("webp: bad backward reference")
                if cache_bits:
                    for _ in range(length):
                        px = int(data[pos - dist])
                        data[pos] = px
                        cache[(0x1E35A7BD * px & 0xFFFFFFFF) >> cache_shift] = px
                        pos += 1
                else:
                    if dist >= length:
                        data[pos : pos + length] = data[pos - dist : pos - dist + length]
                        pos += length
                    else:
                        for _ in range(length):
                            data[pos] = data[pos - dist]
                            pos += 1
                col = pos % width
                row = pos // width
                # A copy can land mid-tile in a different meta-huffman tile;
                # the loop-top refetch only fires at tile boundaries.
                if hbits and (col & mask) != 0 and pos < n:
                    idx = int(meta[(row >> hbits) * hxsize + (col >> hbits)])
                    group = groups[idx] if idx < len(groups) else groups[0]
            elif g < cache_limit:
                px = cache[g - len_code_limit]
                data[pos] = px
                pos += 1
                col += 1
                if col >= width:
                    col = 0
                    row += 1
            else:
                raise BitstreamError("webp: bad green symbol")
            if br.eos:
                raise BitstreamError("webp: truncated VP8L stream")
        return data

    # -- inverse transforms --------------------------------------------------
    def _apply_inverse_transforms(self, data: np.ndarray, tw: int, h: int) -> np.ndarray:
        from . import transforms as tf

        cur = data
        cur_w = tw
        for t in reversed(self.transforms):
            if t.type == SUBTRACT_GREEN_TRANSFORM:
                cur = tf.add_green_inverse(cur)
            elif t.type == PREDICTOR_TRANSFORM:
                cur = tf.predictor_inverse(cur.reshape(h, cur_w), t.bits, t.data).reshape(-1)
            elif t.type == CROSS_COLOR_TRANSFORM:
                cur = tf.color_space_inverse(cur.reshape(h, cur_w), t.bits, t.data).reshape(-1)
            elif t.type == COLOR_INDEXING_TRANSFORM:
                cur = tf.color_index_inverse(
                    cur.reshape(h, cur_w), t.bits, t.data, t.xsize
                ).reshape(-1)
                cur_w = t.xsize
        return cur


def decode_vp8l(data: bytes) -> tuple[np.ndarray, bool]:
    """Decodes a VP8L payload → (ARGB uint32 [h,w], has_alpha_hint), by
    the native decoder (a failed build raises; BitstreamError on a
    malformed or truncated stream)."""
    from ..native.api import vp8l_decode

    return vp8l_decode(data)


def argb_to_rgba(argb: np.ndarray) -> np.ndarray:
    """uint32 ARGB [h,w] → uint8 RGBA [h,w,4]."""
    if (np.little_endian and argb.dtype.byteorder in ("<", "=")
            and argb.flags.c_contiguous):
        # Little-endian u32 0xAARRGGBB is bytes [B,G,R,A] in memory: one
        # byte-shuffle pass instead of four shift+cast passes.
        h, w = argb.shape
        return argb.view(np.uint8).reshape(h, w, 4)[..., [2, 1, 0, 3]]
    a = (argb >> 24).astype(np.uint8)
    r = (argb >> 16).astype(np.uint8)
    g = (argb >> 8).astype(np.uint8)
    b = argb.astype(np.uint8)
    return np.stack([r, g, b, a], axis=-1)
