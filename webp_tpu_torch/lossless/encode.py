"""VP8L lossless encoder.

Pipeline (parity with the reference's internal/lossless/encode.go):
analyze (palette vs photo) -> transforms (palette / subtract-green +
per-tile predictor + cross-color) -> LZ77 backward references ->
histograms -> canonical Huffman codes -> bitstream emission, with an
exact coded-size search over transform configurations.

Where each part runs:
  * the per-tile predictor search: `search`, an argument of encode_vp8l,
    encode_vp8l_argb and predictor_transform. HOST ("host") runs the
    native C++ predictor (native/src/vp8l_predictor.cc); a torch device
    runs ops/lossless.py predictor_search there (the card, or the same
    PyTorch code on the CPU). Both give the same residuals and modes;
  * subtract-green, the palette and near-lossless: numpy on the host;
  * the cross-color search, LZ77, the colour cache, the meta-Huffman
    clustering and the bit emission: the native C++ entropy coder
    (native/src/vp8l_enc.cc), built at first use; a failed build raises.

The numpy predictor (_predictor_transform_numpy) and the numpy entropy
coder (encode_entropy_image_numpy) are the plain versions the tests hold
the native code against; no entry point reaches them.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

import numpy as np

from ..bitio.lossless import LosslessBitWriter
from . import transforms as tf
from .decode import CODE_TO_PLANE, sub_sample_size
from .huffman import NUM_LENGTH_CODES, NUM_LITERAL_CODES, NUM_DISTANCE_CODES
from .huffman_enc import HuffmanCode, write_huffman_code

MAX_PALETTE_SIZE = 256
WINDOW_SIZE = (1 << 20) - 120
MAX_LENGTH = 4096
HASH_BITS = 18
HASH_SIZE = 1 << HASH_BITS


# ---------------------------------------------------------------------------
# Prefix coding (inverse of decode.get_copy_distance).
# ---------------------------------------------------------------------------

def prefix_encode(value: int) -> Tuple[int, int, int]:
    """value (>=1) -> (code, n_extra_bits, extra_value)."""
    x = value - 1
    if x < 4:
        return x, 0, 0
    h = x.bit_length() - 1
    b = (x >> (h - 1)) & 1
    code = 2 * h + b
    return code, h - 1, x & ((1 << (h - 1)) - 1)


def _plane_code_map(xsize: int) -> dict:
    m = {}
    for i, (dx, dy) in enumerate(CODE_TO_PLANE):
        d = dy * xsize + dx
        if d >= 1 and d not in m:
            m[d] = i + 1
    return m


# ---------------------------------------------------------------------------
# Tokens.
# ---------------------------------------------------------------------------

TOK_LITERAL = 0
TOK_COPY = 1
TOK_CACHE = 2


# ---------------------------------------------------------------------------
# LZ77 hash-chain backward references (greedy).
# ---------------------------------------------------------------------------

def _hash2(a: np.ndarray) -> np.ndarray:
    """Hash of pixel pairs (argb[i], argb[i+1]) -> HASH_BITS."""
    lo = a[:-1].astype(np.uint64)
    hi = a[1:].astype(np.uint64)
    key = (hi << np.uint64(32)) | lo
    key = (key * np.uint64(0x9E3779B185EBCA87)) & np.uint64(0xFFFFFFFFFFFFFFFF)
    return (key >> np.uint64(64 - HASH_BITS)).astype(np.int64)


def backward_references(argb: np.ndarray, xsize: int, quality: int) -> list:
    """Greedy LZ77 over the pixel stream. Returns token list."""
    n = len(argb)
    tokens = []
    if n == 0:
        return tokens
    max_chain = 8 if quality < 25 else (32 if quality < 50 else
                                        (128 if quality < 75 else 512))
    hashes = _hash2(argb) if n > 1 else np.zeros(0, dtype=np.int64)
    head = np.full(HASH_SIZE, -1, dtype=np.int64)
    prev = np.full(n, -1, dtype=np.int64)
    a = argb
    pos = 0
    while pos < n:
        best_len = 0
        best_dist = 0
        if pos + 1 < n:
            h = int(hashes[pos])
            cand = int(head[h])
            chain = 0
            min_pos = max(0, pos - WINDOW_SIZE)
            limit = min(n - pos, MAX_LENGTH)
            while cand >= min_pos and chain < max_chain:
                if best_len >= limit:
                    break
                # quick check at best_len position
                if best_len == 0 or (pos + best_len < n
                                     and a[cand + best_len] == a[pos + best_len]):
                    length = 0
                    while length < limit and a[cand + length] == a[pos + length]:
                        length += 1
                    if length > best_len:
                        best_len = length
                        best_dist = pos - cand
                cand = int(prev[cand])
                chain += 1
            # Also try distance == xsize (pixel above) explicitly.
            if pos >= xsize:
                cand = pos - xsize
                length = 0
                limit2 = min(n - pos, MAX_LENGTH)
                while length < limit2 and a[cand + length] == a[pos + length]:
                    length += 1
                if length > best_len or (length == best_len and length > 0
                                         and best_dist != xsize):
                    if length >= max(best_len, 1):
                        if length > best_len or xsize < best_dist:
                            best_len = length
                            best_dist = xsize
        if best_len >= 3:
            tokens.append((TOK_COPY, best_len, best_dist))
            end = min(pos + best_len, n - 1)
            for p in range(pos, end):
                h = int(hashes[p])
                prev[p] = head[h]
                head[h] = p
            pos += best_len
        else:
            tokens.append((TOK_LITERAL, int(a[pos]), 0))
            if pos + 1 < n:
                h = int(hashes[pos])
                prev[pos] = head[h]
                head[h] = pos
            pos += 1
    return tokens


# ---------------------------------------------------------------------------
# Histogram + emission.
# ---------------------------------------------------------------------------

def _histogram(tokens: list, xsize: int, cache_bits: int):
    pmap = _plane_code_map(xsize)
    green = np.zeros(NUM_LITERAL_CODES + NUM_LENGTH_CODES + (1 << cache_bits if cache_bits else 0), dtype=np.int64)
    red = np.zeros(256, dtype=np.int64)
    blue = np.zeros(256, dtype=np.int64)
    alpha = np.zeros(256, dtype=np.int64)
    dist = np.zeros(NUM_DISTANCE_CODES, dtype=np.int64)
    for kind, v, d in tokens:
        if kind == TOK_LITERAL:
            green[(v >> 8) & 0xFF] += 1
            red[(v >> 16) & 0xFF] += 1
            blue[v & 0xFF] += 1
            alpha[(v >> 24) & 0xFF] += 1
        elif kind == TOK_COPY:
            code, _, _ = prefix_encode(v)
            green[NUM_LITERAL_CODES + code] += 1
            dcode = pmap.get(d, d + 120)
            dc, _, _ = prefix_encode(dcode)
            dist[dc] += 1
        else:
            green[NUM_LITERAL_CODES + NUM_LENGTH_CODES + v] += 1
    return [green, red, blue, alpha, dist]


def _emit_tokens(bw: LosslessBitWriter, tokens: list, codes: List[HuffmanCode],
                 xsize: int) -> None:
    pmap = _plane_code_map(xsize)
    g, r, b, a, d = codes
    for kind, v, dd in tokens:
        if kind == TOK_LITERAL:
            g.write_symbol(bw, (v >> 8) & 0xFF)
            r.write_symbol(bw, (v >> 16) & 0xFF)
            b.write_symbol(bw, v & 0xFF)
            a.write_symbol(bw, (v >> 24) & 0xFF)
        elif kind == TOK_COPY:
            code, nbits, extra = prefix_encode(v)
            g.write_symbol(bw, NUM_LITERAL_CODES + code)
            if nbits:
                bw.write_bits(extra, nbits)
            dcode = pmap.get(dd, dd + 120)
            dc, dnbits, dextra = prefix_encode(dcode)
            d.write_symbol(bw, dc)
            if dnbits:
                bw.write_bits(dextra, dnbits)
        else:
            g.write_symbol(bw, NUM_LITERAL_CODES + NUM_LENGTH_CODES + v)


def _apply_color_cache(tokens: list, argb: np.ndarray, cache_bits: int) -> list:
    """Replays a token stream through a color cache, converting literals
    that hit into cache references (libwebp BackwardRefsWithLocalCache)."""
    if cache_bits == 0:
        return tokens
    shift = 32 - cache_bits
    cache = [-1] * (1 << cache_bits)
    out = []
    pos = 0
    a = argb
    for kind, v, d in tokens:
        if kind == TOK_LITERAL:
            key = (0x1E35A7BD * v & 0xFFFFFFFF) >> shift
            if cache[key] == v:
                out.append((TOK_CACHE, key, 0))
            else:
                cache[key] = v
                out.append((kind, v, d))
            pos += 1
        else:  # copy: insert every copied pixel
            for p in range(pos, pos + v):
                px = int(a[p])
                cache[(0x1E35A7BD * px & 0xFFFFFFFF) >> shift] = px
            pos += v
            out.append((kind, v, d))
    return out


def _histo_cost_bits(hists) -> float:
    """Shannon-entropy cost estimate of a histogram set (in bits)."""
    total_bits = 0.0
    for h in hists:
        n = int(h.sum())
        if n == 0:
            continue
        nz = h[h > 0].astype(np.float64)
        total_bits += float((nz * (np.log2(n) - np.log2(nz))).sum())
        total_bits += 40 + 5 * (h > 0).sum()  # rough tree transmission cost
    return total_bits


def _encode_entropy_coded_image(bw: LosslessBitWriter, argb: np.ndarray,
                                xsize: int, quality: int,
                                is_level0: bool = False,
                                method: int = 4) -> None:
    """color-cache bit + (level0: meta-huffman bit) + trees + LZ77 data,
    by the native entropy coder."""
    from ..native.api import vp8l_encode_entropy_image

    buf, nbits = vp8l_encode_entropy_image(argb, xsize, quality, is_level0,
                                           method)
    bw.append_bits_buffer(buf, nbits)


def encode_entropy_image_numpy(bw: LosslessBitWriter, argb: np.ndarray,
                               xsize: int, quality: int,
                               is_level0: bool = False) -> None:
    """The numpy entropy coder (greedy LZ77, colour-cache search, one
    Huffman group): a plain version for the tests, which decode its
    streams; the native coder's streams are smaller and differ."""
    base_tokens = backward_references(argb, xsize, quality)
    # Color-cache search: replay the token stream per candidate size and
    # keep the entropy-cheapest (encode_backward.go cache-size search analog).
    best = (None, _histo_cost_bits(_histogram(base_tokens, xsize, 0)),
            base_tokens, 0)
    if is_level0 and len(argb) >= 512 and quality >= 25:
        for cb in (6, 8, 10):
            toks = _apply_color_cache(base_tokens, argb, cb)
            cost = _histo_cost_bits(_histogram(toks, xsize, cb))
            if cost < best[1]:
                best = (None, cost, toks, cb)
    _, _, tokens, cache_bits = best
    hists = _histogram(tokens, xsize, cache_bits)
    codes = [HuffmanCode.from_counts(h) for h in hists]
    if cache_bits:
        bw.write_bits(1, 1)
        bw.write_bits(cache_bits, 4)
    else:
        bw.write_bits(0, 1)
    if is_level0:
        bw.write_bits(0, 1)  # single huffman group (no entropy image)
    for c in codes:
        write_huffman_code(bw, c.desc_lengths)
    _emit_tokens(bw, tokens, codes, xsize)


# ---------------------------------------------------------------------------
# Transforms (encoder side).
# ---------------------------------------------------------------------------

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
    av2 = tf._avg2
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
    avg = tf._avg2(l, t)
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


HOST = "host"


def _tile_image(tile_modes: np.ndarray) -> np.ndarray:
    return (np.uint32(0xFF000000)
            | (tile_modes.astype(np.uint32) << np.uint32(8))).reshape(-1)


def predictor_transform(img: np.ndarray, bits: int, quality: int,
                        search=HOST):
    """Chooses per-tile predictors (entropy proxy: sum of |residual byte|
    distances from 0/256 wraparound) and returns (residuals, tile_image).
    search: HOST for the native C++ predictor, else the torch device on
    which ops/lossless.py predictor_search runs; the same output."""
    if search == HOST:
        from ..native.api import vp8l_predictor_transform

        out, tile_modes = vp8l_predictor_transform(img, bits)
        return out, _tile_image(tile_modes)
    import torch

    from ..ops.lossless import predictor_search

    dev = torch.device(search)
    t = torch.from_numpy(np.ascontiguousarray(img).view(np.int32))
    out, modes = predictor_search(t.to(dev), bits)
    return out.cpu().numpy().astype(np.uint32), _tile_image(modes.cpu().numpy())


def _predictor_transform_numpy(img: np.ndarray, bits: int):
    """The numpy predictor search: a plain version for the tests (the
    native predictor and predictor_search equal it)."""
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


# ---------------------------------------------------------------------------
# Palette.
# ---------------------------------------------------------------------------

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


# ---------------------------------------------------------------------------
# Top level.
# ---------------------------------------------------------------------------

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


def encode_vp8l(img: np.ndarray, quality: int = 75, method: int = 4,
                exact: bool = False, near_lossless: int = 100,
                search=HOST) -> bytes:
    """Encodes an RGB(A) uint8 array to a VP8L payload. search: where the
    predictor search runs (HOST: native C++; else a torch device)."""
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
    has_alpha = bool(((argb >> np.uint32(24)) != 255).any())
    return encode_vp8l_argb(argb, quality=quality, method=method,
                            with_header=True, alpha_hint=has_alpha,
                            search=search)


def encode_vp8l_argb(argb: np.ndarray, quality: int = 75, method: int = 4,
                     with_header: bool = True, alpha_hint: bool = False,
                     search=HOST) -> bytes:
    """Encodes a packed ARGB uint32 [h, w] image; optionally headerless
    (as required for ALPH payloads). search: as in encode_vp8l."""
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
            from ..native.api import vp8l_cross_color

            return vp8l_cross_color(residuals, bits)
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
                                   predictor_transform(cur, bits, quality,
                                                       search))
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
        pred = predictor_transform(sg if use_sg else argb, bits, quality,
                                   search)
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
            pred = predictor_transform(sg, b, quality, search)
            cc = _cross_color(pred[0], b)
            cands.append(_body(True, b, pred,
                               cc if cc is not None and cc[2] > 1024.0
                               else None))
    if use_palette:
        cands.append(_palette_body())
    best = min(cands, key=lambda c: c[1])
    bw.append_bits_buffer(best[0], best[1])

    return bw.finish()
