"""The VP8L encoder's top level, transforms and palette: a copy of the
measured package's lossless/encode.py at the commit that added this
reference, with its plain numpy predictor search in place of the native
and device searches (the package's tests hold the three equal), the
entropy coder and the cross-color search called in this reference's own
build (native.py), and nothing of the numpy entropy coder or the tracer.

Pipeline: palette (at most 16 colours: the palette alone), else
subtract-green, the per-tile predictor, the cross-color search (quality
>= 50, method >= 2, kept where its estimated gain passes 1024 bits), and
an exact coded-size choice among transform configurations, by image
size: up to 2^16 pixels, several tile sizes with and without
subtract-green, cross-color and the raw image; up to 2^18, tiles of 16
(and 8 at method >= 5) and the raw image; above, one configuration per
tile size.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from . import native
from .bitio import LosslessBitWriter

MAX_PALETTE_SIZE = 256


def sub_sample_size(size: int, bits: int) -> int:
    return (size + (1 << bits) - 1) >> bits


def _avg2(a, b):
    """Per-channel (a + b) // 2 on packed uint32 ARGB."""
    a = np.uint32(a) if np.isscalar(a) else a
    b = np.uint32(b) if np.isscalar(b) else b
    return (((a ^ b) & np.uint32(0xFEFEFEFE)) >> np.uint32(1)) + (a & b)


def _encode_entropy_coded_image(bw: LosslessBitWriter, argb: np.ndarray,
                                xsize: int, quality: int,
                                is_level0: bool = False,
                                method: int = 4) -> None:
    """color-cache bit + (level0: meta-huffman bit) + trees + LZ77 data,
    by the entropy coder."""
    buf, nbits = native.encode_entropy_image(argb, xsize, quality,
                                             is_level0, method)
    bw.append_bits_buffer(buf, nbits)


def _sub_pixels(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Per-channel (a - b) mod 256 on packed uint32 (borrow-safe: biased per
    16-bit lane so borrows never cross channels, like libwebp VP8LSubPixels)."""
    with np.errstate(over="ignore"):
        ag = (np.uint32(0x00FF00FF) + (a & np.uint32(0xFF00FF00))
              - (b & np.uint32(0xFF00FF00))) & np.uint32(0xFF00FF00)
        rb = (np.uint32(0xFF00FF00) + (a & np.uint32(0x00FF00FF))
              - (b & np.uint32(0x00FF00FF))) & np.uint32(0x00FF00FF)
        return ag | rb


def subtract_green(argb: np.ndarray) -> np.ndarray:
    """Wrapping byte-plane subtraction on a u8 view of the u32 pixels
    (little-endian: B,G,R,A) — no u32 temporaries."""
    v = np.ascontiguousarray(argb)
    b8 = v.view(np.uint8).reshape(v.shape + (4,)).copy()
    g = b8[..., 1]
    b8[..., 0] -= g
    b8[..., 2] -= g
    return b8.view(np.uint32).reshape(v.shape)


def _predict_all(img: np.ndarray, mode: int) -> np.ndarray:
    """Predicted value for every pixel under `mode` (interior rule only;
    the caller fixes up row 0 / col 0 which always use L/T/black)."""
    h, w = img.shape
    L = np.zeros_like(img)
    T = np.zeros_like(img)
    TL = np.zeros_like(img)
    TR = np.zeros_like(img)
    L[:, 1:] = img[:, :-1]
    T[1:, :] = img[:-1, :]
    TL[1:, 1:] = img[:-1, :-1]
    TR[1:, :-1] = img[:-1, 1:]
    TR[1:, -1] = img[1:, 0]  # spec: TR at last column = current row pixel 0
    av2 = _avg2
    if mode == 0:
        return np.full_like(img, 0xFF000000)
    if mode == 1:
        return L
    if mode == 2:
        return T
    if mode == 3:
        return TR
    if mode == 4:
        return TL
    if mode == 5:
        return av2(av2(L, TR), T)
    if mode == 6:
        return av2(L, TL)
    if mode == 7:
        return av2(L, T)
    if mode == 8:
        return av2(TL, T)
    if mode == 9:
        return av2(T, TR)
    if mode == 10:
        return av2(av2(L, TL), av2(T, TR))
    if mode == 11:
        return _select_vec(T, L, TL)
    if mode == 12:
        return _clamp_add_sub_full_vec(L, T, TL)
    if mode == 13:
        return _clamp_add_sub_half_vec(L, T, TL)
    raise ValueError(mode)


def _channels_i32(px):
    return [((px >> np.uint32(s)) & np.uint32(0xFF)).astype(np.int32)
            for s in (0, 8, 16, 24)]


def _select_vec(t, l, tl):
    pa = np.zeros(t.shape, dtype=np.int32)
    for (tc, lc, tlc) in zip(_channels_i32(t), _channels_i32(l), _channels_i32(tl)):
        pa += np.abs(lc - tlc) - np.abs(tc - tlc)
    return np.where(pa <= 0, t, l)


def _clamp_add_sub_full_vec(l, t, tl):
    out = np.zeros(l.shape, dtype=np.uint32)
    for s in (0, 8, 16, 24):
        v = (((l >> np.uint32(s)) & np.uint32(0xFF)).astype(np.int32)
             + ((t >> np.uint32(s)) & np.uint32(0xFF)).astype(np.int32)
             - ((tl >> np.uint32(s)) & np.uint32(0xFF)).astype(np.int32))
        out |= np.clip(v, 0, 255).astype(np.uint32) << np.uint32(s)
    return out


def _clamp_add_sub_half_vec(l, t, tl):
    avg = _avg2(l, t)
    out = np.zeros(l.shape, dtype=np.uint32)
    for s in (0, 8, 16, 24):
        va = ((avg >> np.uint32(s)) & np.uint32(0xFF)).astype(np.int32)
        vc = ((tl >> np.uint32(s)) & np.uint32(0xFF)).astype(np.int32)
        d = va - vc
        v = va + np.sign(d) * (np.abs(d) // 2)
        out |= np.clip(v, 0, 255).astype(np.uint32) << np.uint32(s)
    return out


_COST_LUT = np.minimum(np.arange(256), 256 - np.arange(256)).astype(np.uint16)
_COST_LUT[0] = 0


def _tile_image(tile_modes: np.ndarray) -> np.ndarray:
    return (np.uint32(0xFF000000)
            | (tile_modes.astype(np.uint32) << np.uint32(8))).reshape(-1)


def _predictor_transform_numpy(img: np.ndarray, bits: int):
    """The numpy predictor search: per-tile best of 14 predictors by the
    cost proxy sum(min(byte, 256 - byte)), ties to the lower mode, then
    the row-0 / column-0 edge rules. Returns (residuals, tile_image)."""
    h, w = img.shape
    tx, ty = sub_sample_size(w, bits), sub_sample_size(h, bits)
    tile = 1 << bits
    hp, wp = ty * tile, tx * tile
    residuals = np.empty((14, h, w), dtype=np.uint32)
    cost_tiles = np.empty((14, ty, tx), dtype=np.int64)
    pad = np.zeros((hp, wp), dtype=np.uint16)
    for m in range(14):
        res = _sub_pixels(img, _predict_all(img, m))
        residuals[m] = res
        b = res.view(np.uint8).reshape(h, w, 4)
        c = _COST_LUT[b].sum(axis=2, dtype=np.uint16)  # <= 4*128
        pad[:h, :w] = c
        if wp > w:
            pad[:h, w:] = 0
        if hp > h:
            pad[h:] = 0
        cost_tiles[m] = pad.reshape(ty, tile, tx, tile).sum(
            axis=(1, 3), dtype=np.int64)
    tile_modes = cost_tiles.argmin(axis=0).astype(np.int32)  # [ty, tx]
    mode_map = np.repeat(np.repeat(tile_modes, tile, 0), tile, 1)[:h, :w]
    out = np.take_along_axis(
        residuals, mode_map[None].astype(np.intp), axis=0)[0]
    # Edge rules: row 0 uses L (except pixel 0: black), col 0 uses T.
    out[0, 0] = _sub_pixels(img[0:1, 0:1], np.uint32(0xFF000000))[0, 0]
    if w > 1:
        out[0, 1:] = _sub_pixels(img[0:1, 1:], img[0:1, :-1])
    if h > 1:
        out[1:, 0] = _sub_pixels(img[1:, 0], img[:-1, 0])
    return out, _tile_image(tile_modes)


def build_palette(argb_flat: np.ndarray) -> Optional[np.ndarray]:
    colors = np.unique(argb_flat)
    if len(colors) > MAX_PALETTE_SIZE:
        return None
    return colors  # sorted ascending (uint32) — deterministic valid order


def apply_palette(argb: np.ndarray, palette: np.ndarray) -> np.ndarray:
    """Maps pixels to indices stored in the green channel, with bundling."""
    h, w = argb.shape
    idx = np.searchsorted(palette, argb.reshape(-1)).reshape(h, w).astype(np.uint32)
    n = len(palette)
    if n > 16:
        xbits = 0
    elif n > 4:
        xbits = 1
    elif n > 2:
        xbits = 2
    else:
        xbits = 3
    if xbits == 0:
        packed = idx
    else:
        ppb = 1 << xbits  # pixels per byte
        bpp = 8 >> xbits  # bits per pixel
        pw = sub_sample_size(w, xbits)
        pad_w = pw * ppb
        padded = np.zeros((h, pad_w), dtype=np.uint32)
        padded[:, :w] = idx
        packed = np.zeros((h, pw), dtype=np.uint32)
        for i in range(ppb):
            packed |= padded[:, i::ppb] << np.uint32(i * bpp)
    return (np.uint32(0xFF000000) | (packed << np.uint32(8))), xbits


def rgba_to_argb(a: np.ndarray) -> np.ndarray:
    """uint8 [h,w,3|4] -> packed uint32 ARGB [h,w].

    Byte-plane writes into a u32 view (little-endian: B,G,R,A) — ~6x
    cheaper than the shift-or formulation's four u32 upcasts."""
    h, w = a.shape[:2]
    out = np.empty((h, w, 4), np.uint8)
    out[..., 0] = a[..., 2]
    out[..., 1] = a[..., 1]
    out[..., 2] = a[..., 0]
    if a.shape[2] == 4:
        out[..., 3] = a[..., 3]
    else:
        out[..., 3] = 255
    return out.view(np.uint32).reshape(h, w)


def prepare(img: np.ndarray, exact: bool = False,
            near_lossless: int = 100) -> np.ndarray:
    """The packed ARGB pixels an RGB(A) uint8 image is coded as: after the
    transparent cleanup (unless exact) and near-lossless (below 100)."""
    argb = rgba_to_argb(np.asarray(img))
    if not exact:
        # Transparent-area cleanup (reference encode.go:944
        # cleanupTransparentAreaLossless / libwebp
        # WebPReplaceTransparentPixels): zero the RGB of fully-transparent
        # pixels so LZ77 sees long runs of 0x00000000.
        argb = np.where((argb >> np.uint32(24)) == 0, np.uint32(0), argb)
    if near_lossless < 100:
        from .near_lossless import apply_near_lossless

        argb = apply_near_lossless(argb, near_lossless)
    return argb


def encode_vp8l_argb(argb: np.ndarray, quality: int = 75, method: int = 4,
                     with_header: bool = True,
                     alpha_hint: bool = False) -> bytes:
    """Encodes a packed ARGB uint32 [h, w] image; optionally headerless
    (as ALPH payloads are)."""
    h, w = argb.shape

    bw = LosslessBitWriter()
    if with_header:
        bw.write_bits(0x2F, 8)
        bw.write_bits(w - 1, 14)
        bw.write_bits(h - 1, 14)
        bw.write_bits(1 if alpha_hint else 0, 1)
        bw.write_bits(0, 3)  # version

    flat = argb.reshape(-1)
    palette = build_palette(flat) if method > 0 else None

    def _palette_body() -> tuple[bytes, int]:
        packed, xbits = apply_palette(argb, palette)
        b2 = LosslessBitWriter()
        # Transform: color indexing.
        b2.write_bits(1, 1)  # transform present
        b2.write_bits(3, 2)  # COLOR_INDEXING
        b2.write_bits(len(palette) - 1, 8)
        # Palette stored delta-coded as a 1-high image.
        pal = palette.astype(np.uint32)
        deltas = pal.copy()
        deltas[1:] = _sub_pixels(pal[1:], pal[:-1])
        _encode_entropy_coded_image(b2, deltas, len(palette), quality,
                                    method=method)
        b2.write_bits(0, 1)  # no more transforms
        _encode_entropy_coded_image(b2, packed.reshape(-1),
                                    packed.shape[1], quality, is_level0=True,
                                    method=method)
        return b2.finish(), b2.bit_position()

    use_palette = palette is not None and len(palette) <= 256
    # A large palette can lose badly to the spatial transforms (a smooth
    # gradient has hundreds of colors yet near-zero predictor residuals;
    # libwebp's AnalyzeEntropy picks spatial there, encode_analysis.go).
    # Palettes this small always win — skip the spatial encode.
    if use_palette and len(palette) <= 16:
        body, nbits = _palette_body()
        bw.append_bits_buffer(body, nbits)
        return bw.finish()

    sg = subtract_green(argb)

    def _cross_color(residuals, bits):
        # Cross-color only at quality >= 50 (reference encode.go:277
        # useCrossColor): below that the multiplier search costs more
        # than it saves — notably the ALPH path encodes at q = 8*effort.
        if quality >= 50 and method >= 2:
            return native.cross_color(residuals, bits)
        return None

    def _body(use_pred: bool, bits: int = 4, pred=None,
              cc=None, use_sg: bool = True) -> tuple[bytes, int]:
        """Encodes one transform-config candidate (optional subtract-
        green; predictor at the given tile granularity + optional
        cross-color) into its own bit buffer so configs can be compared
        by exact coded size. pred/cc: precomputed transform outputs
        (shared between the with- and without-cross-color variants)."""
        b2 = LosslessBitWriter()
        if use_sg:
            b2.write_bits(1, 1)
            b2.write_bits(2, 2)  # SUBTRACT_GREEN
        cur = sg if use_sg else argb
        if use_pred:
            b2.write_bits(1, 1)
            b2.write_bits(0, 2)  # PREDICTOR
            b2.write_bits(bits - 2, 3)
            residuals, tile_img = (pred if pred is not None else
                                   _predictor_transform_numpy(cur, bits))
            _encode_entropy_coded_image(
                b2, tile_img, sub_sample_size(w, bits), quality,
                method=method)
            if cc is not None:
                residuals, cc_tiles, _ = cc
                b2.write_bits(1, 1)
                b2.write_bits(1, 2)  # CROSS_COLOR
                b2.write_bits(bits - 2, 3)
                _encode_entropy_coded_image(
                    b2, cc_tiles.reshape(-1), sub_sample_size(w, bits),
                    quality, method=method)
            cur = residuals
        b2.write_bits(0, 1)  # no more transforms
        _encode_entropy_coded_image(b2, cur.reshape(-1), w, quality,
                                    is_level0=True, method=method)
        nbits = b2.bit_position()
        return b2.finish(), nbits

    def _pred_cands(bits, use_sg=True):
        """With- and without-cross-color candidates sharing one
        predictor pass (cross-color included only when its gain
        estimate clears the reference threshold)."""
        pred = _predictor_transform_numpy(sg if use_sg else argb, bits)
        cc = _cross_color(pred[0], bits)
        out = []
        if cc is not None and cc[2] > 1024.0:
            out.append(_body(True, bits, pred, cc, use_sg))
        out.append(_body(True, bits, pred, None, use_sg))
        return out

    # Transform-config search: the predictor helps photographs but hurts
    # graphics whose raw pixels LZ77-compress directly, the best tile
    # granularity is content-dependent, and the cross-color gain estimate
    # can overshoot its own tile-image cost (libwebp decides all three
    # via AnalyzeEntropy heuristics, encode.go:274; an exact size
    # comparison is both simpler and never wrong). Small images pay the
    # multi-encode; large images keep the single spatial config the
    # reference always picks for them.
    if h * w <= (1 << 16) and quality >= 50 and method >= 4:
        # Single-tile granularity: one predictor for the whole image wins
        # on smooth content (a gradient's constant residual costs ~0 bits
        # with a one-symbol histogram, and the tile image vanishes).
        b1 = max(3, min(9, int(max(w, h) - 1).bit_length()))
        bits_set = sorted({3, 4, 5, b1})
        cands = [c for b in bits_set for c in _pred_cands(b)]
        # No-subtract-green variants: SG hurts channels that are already
        # one-direction predictable (it mixes G's gradient into R/B).
        cands += [c for b in {4, b1} for c in _pred_cands(b, use_sg=False)]
        cands.append(_body(False))
    elif h * w <= (1 << 18) and quality >= 50 and method >= 4:
        # method >= 5 widens the tile-granularity search: finer predictor
        # tiles (bits=3) often win on photographic content — the exact
        # analog of libwebp spending its method budget on transform
        # search (reference encode.go:274 picks bits by heuristic; an
        # exact coded-size comparison is never wrong). Note _pred_cands
        # also tries the without-cross-color variant when the gain
        # estimate clears the threshold, so method 4 pays one extra
        # entropy encode here too (size can only improve).
        bits_set = (3, 4) if method >= 5 else (4,)
        cands = [c for b in bits_set for c in _pred_cands(b)]
        cands.append(_body(False))
    else:
        bits_set = (3, 4) if (method >= 5 and quality >= 50) else (4,)
        cands = []
        for b in bits_set:
            pred = _predictor_transform_numpy(sg, b)
            cc = _cross_color(pred[0], b)
            cands.append(_body(True, b, pred,
                               cc if cc is not None and cc[2] > 1024.0
                               else None))
    if use_palette:
        cands.append(_palette_body())
    best = min(cands, key=lambda c: c[1])
    bw.append_bits_buffer(best[0], best[1])

    return bw.finish()
