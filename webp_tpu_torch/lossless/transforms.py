"""VP8L inverse transforms (host/numpy vectorized).

PyTorch versions of the row-parallel transforms live in
webp_tpu_torch/ops/lossless.py; these numpy versions are the exact-integer
reference of the numpy VP8LDecoder (the ALPH path) and of the tests.

Parity with the reference's internal/lossless/decode_transform.go.
"""

from __future__ import annotations

import numpy as np


def _avg2(a: np.ndarray | int, b: np.ndarray | int):
    """Per-channel (a+b)//2 on packed uint32 ARGB."""
    a = np.uint32(a) if np.isscalar(a) else a
    b = np.uint32(b) if np.isscalar(b) else b
    return (((a ^ b) & np.uint32(0xFEFEFEFE)) >> np.uint32(1)) + (a & b)


def _add_pixels(a, b):
    """Per-channel mod-256 addition on packed uint32 (wrap is intended)."""
    with np.errstate(over="ignore"):
        lo = ((a & np.uint32(0x00FF00FF)) + (b & np.uint32(0x00FF00FF))) & np.uint32(0x00FF00FF)
        hi = ((a & np.uint32(0xFF00FF00)) + (b & np.uint32(0xFF00FF00))) & np.uint32(0xFF00FF00)
        return lo | hi


def _channels(px: np.ndarray):
    return (
        (px >> np.uint32(24)).astype(np.int32),
        ((px >> np.uint32(16)) & np.uint32(0xFF)).astype(np.int32),
        ((px >> np.uint32(8)) & np.uint32(0xFF)).astype(np.int32),
        (px & np.uint32(0xFF)).astype(np.int32),
    )


def _pack(a, r, g, b):
    return (
        (a.astype(np.uint32) << np.uint32(24))
        | (r.astype(np.uint32) << np.uint32(16))
        | (g.astype(np.uint32) << np.uint32(8))
        | b.astype(np.uint32)
    )


def _select(t: int, l: int, tl: int) -> int:
    pa_minus_pb = 0
    for shift in (0, 8, 16, 24):
        ac = ((t >> shift) & 0xFF) - ((tl >> shift) & 0xFF)
        bc = ((l >> shift) & 0xFF) - ((tl >> shift) & 0xFF)
        pa_minus_pb += abs(bc) - abs(ac)
    return t if pa_minus_pb <= 0 else l


def _clamp_add_sub_full(l: int, t: int, tl: int) -> int:
    out = 0
    for shift in (0, 8, 16, 24):
        v = ((l >> shift) & 0xFF) + ((t >> shift) & 0xFF) - ((tl >> shift) & 0xFF)
        v = 0 if v < 0 else (255 if v > 255 else v)
        out |= v << shift
    return out


def _clamp_add_sub_half(l: int, t: int, tl: int) -> int:
    avg = int(_avg2(np.uint32(l), np.uint32(t)))
    out = 0
    for shift in (0, 8, 16, 24):
        va = (avg >> shift) & 0xFF
        vc = (tl >> shift) & 0xFF
        d = va - vc
        v = va + (abs(d) // 2) * (1 if d >= 0 else -1)  # trunc toward zero
        v = 0 if v < 0 else (255 if v > 255 else v)
        out |= v << shift
    return out


def sub_sample_size(size: int, bits: int) -> int:
    return (size + (1 << bits) - 1) >> bits


def add_green_inverse(argb: np.ndarray) -> np.ndarray:
    """r += g; b += g (mod 256). Fully vectorized."""
    g = (argb >> np.uint32(8)) & np.uint32(0xFF)
    r = (((argb >> np.uint32(16)) & np.uint32(0xFF)) + g) & np.uint32(0xFF)
    b = ((argb & np.uint32(0xFF)) + g) & np.uint32(0xFF)
    return (argb & np.uint32(0xFF00FF00)) | (r << np.uint32(16)) | b


def color_space_inverse(argb: np.ndarray, bits: int, tiles: np.ndarray) -> np.ndarray:
    """Inverse cross-color transform; fully vectorized via per-pixel multiplier maps."""
    h, w = argb.shape
    tx = sub_sample_size(w, bits)
    tgrid = tiles.reshape(-1, tx)[: sub_sample_size(h, bits), :]
    # Expand per-tile multipliers to per-pixel.
    row_idx = np.arange(h) >> bits
    col_idx = np.arange(w) >> bits
    tmap = tgrid[np.ix_(row_idx, col_idx)]
    g2r = tmap.astype(np.uint8).astype(np.int8).astype(np.int32)
    g2b = (tmap >> np.uint32(8)).astype(np.uint8).astype(np.int8).astype(np.int32)
    r2b = (tmap >> np.uint32(16)).astype(np.uint8).astype(np.int8).astype(np.int32)

    green_s = ((argb >> np.uint32(8)) & np.uint32(0xFF)).astype(np.uint8).astype(np.int8).astype(np.int32)
    red = ((argb >> np.uint32(16)) & np.uint32(0xFF)).astype(np.int32)
    blue = (argb & np.uint32(0xFF)).astype(np.int32)

    red = (red + ((g2r * green_s) >> 5)) & 0xFF
    blue = blue + ((g2b * green_s) >> 5)
    red_s = red.astype(np.uint8).astype(np.int8).astype(np.int32)
    blue = (blue + ((r2b * red_s) >> 5)) & 0xFF
    return (
        (argb & np.uint32(0xFF00FF00))
        | (red.astype(np.uint32) << np.uint32(16))
        | blue.astype(np.uint32)
    )


def color_index_inverse(packed: np.ndarray, bits: int, palette: np.ndarray,
                        out_width: int) -> np.ndarray:
    """Inverse color-indexing: palette lookup with optional pixel unbundling."""
    h, w = packed.shape
    idx_all = ((packed >> np.uint32(8)) & np.uint32(0xFF)).astype(np.int64)
    if bits == 0:
        safe = np.where(idx_all < len(palette), idx_all, 0)
        out = np.where(idx_all < len(palette), palette[safe], np.uint32(0))
        return out
    pixels_per_byte = 1 << bits
    bits_per_pixel = 8 >> bits
    mask = (1 << bits_per_pixel) - 1
    # Unbundle: each packed green byte holds `pixels_per_byte` indices, LSB first.
    shifts = (np.arange(pixels_per_byte) * bits_per_pixel).astype(np.int64)
    expanded = (idx_all[:, :, None] >> shifts[None, None, :]) & mask
    expanded = expanded.reshape(h, w * pixels_per_byte)[:, :out_width]
    safe = np.where(expanded < len(palette), expanded, 0)
    return np.where(expanded < len(palette), palette[safe], np.uint32(0)).astype(np.uint32)


_L_DEPENDENT = {1, 5, 6, 7, 10, 11, 12, 13}


def predictor_inverse(residual: np.ndarray, bits: int, tiles: np.ndarray) -> np.ndarray:
    """Inverse spatial-predictor transform. Sequential by nature (prediction
    from decoded neighbors); vectorized where the row's tile mode has no
    left-dependency, scalar otherwise."""
    h, w = residual.shape
    out = np.zeros_like(residual)
    tx = sub_sample_size(w, bits)
    modes = ((tiles.reshape(-1, tx) >> np.uint32(8)) & np.uint32(0xF)).astype(np.int32)

    # Row 0: pixel 0 = black predictor; rest = left (prefix sum).
    out[0, 0] = _add_pixels(residual[0, 0], np.uint32(0xFF000000))
    if w > 1:
        _cum_left(out[0], residual[0], 1, w)

    tile_w = 1 << bits
    for y in range(1, h):
        mrow = modes[y >> bits]
        top = out[y - 1]
        cur_res = residual[y]
        cur = out[y]
        cur[0] = _add_pixels(cur_res[0], top[0])  # first pixel: T predictor
        x = 1
        while x < w:
            mode = int(mrow[x >> bits])
            x_end = min((x & ~(tile_w - 1)) + tile_w, w)
            seg = slice(x, x_end)
            if mode == 0:
                cur[seg] = _add_pixels(cur_res[seg], np.uint32(0xFF000000))
            elif mode == 2:
                cur[seg] = _add_pixels(cur_res[seg], top[seg])
            elif mode == 3:
                e = min(x_end, w - 1)
                cur[x:e] = _add_pixels(cur_res[x:e], top[x + 1 : e + 1])
                if e < x_end:  # last column: TR wraps to current row pixel 0
                    cur[e] = _add_pixels(cur_res[e], cur[0])
            elif mode == 4:
                cur[seg] = _add_pixels(cur_res[seg], top[x - 1 : x_end - 1])
            elif mode == 8:
                cur[seg] = _add_pixels(cur_res[seg], _avg2(top[x - 1 : x_end - 1], top[seg]))
            elif mode == 9:
                e = min(x_end, w - 1)
                cur[x:e] = _add_pixels(cur_res[x:e], _avg2(top[x:e], top[x + 1 : e + 1]))
                if e < x_end:
                    cur[e] = _add_pixels(cur_res[e], _avg2(top[e], cur[0]))
            elif mode == 1:
                # Left: per-channel mod-256 prefix sum.
                _cum_left(cur, cur_res, x, x_end)
            else:
                _pixel_loop(mode, cur, cur_res, top, x, x_end, w)
            x = x_end
    return out


def _cum_left(cur: np.ndarray, res: np.ndarray, x0: int, x1: int) -> None:
    seg = res[x0:x1]
    b = seg.view(np.uint8).reshape(-1, 4).astype(np.uint32)
    prev = np.frombuffer(cur[x0 - 1 : x0].tobytes(), dtype=np.uint8).astype(np.uint32)
    acc = (np.cumsum(b, axis=0, dtype=np.uint32) + prev[None, :]) & 0xFF
    cur[x0:x1] = np.ascontiguousarray(acc.astype(np.uint8)).view(np.uint32).reshape(-1)


def _pixel_loop(mode: int, cur, res, top, x0: int, x1: int, w: int) -> None:
    """Scalar fallback for left-dependent averaging/select/clamp modes."""
    for x in range(x0, x1):
        l = int(cur[x - 1])
        t = int(top[x])
        tl = int(top[x - 1])
        tr = int(top[x + 1]) if x + 1 < w else int(cur[0])
        if mode == 5:
            pred = int(_avg2(_avg2(np.uint32(l), np.uint32(tr)), np.uint32(t)))
        elif mode == 6:
            pred = int(_avg2(np.uint32(l), np.uint32(tl)))
        elif mode == 7:
            pred = int(_avg2(np.uint32(l), np.uint32(t)))
        elif mode == 10:
            pred = int(_avg2(_avg2(np.uint32(l), np.uint32(tl)), _avg2(np.uint32(t), np.uint32(tr))))
        elif mode == 11:
            pred = _select(t, l, tl)
        elif mode == 12:
            pred = _clamp_add_sub_full(l, t, tl)
        elif mode == 13:
            pred = _clamp_add_sub_half(l, t, tl)
        else:
            pred = 0xFF000000
        cur[x] = _add_pixels(res[x], np.uint32(pred))
