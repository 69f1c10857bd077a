"""The tile- and row-parallel VP8L transforms in PyTorch: subtract-green
both directions, cross-color inverse and forward application, palette
expansion, and the encoder's per-tile predictor search. Exact-integer
mirrors of lossless/transforms.py (the numpy oracle) and of the native
predictor (native/src/vp8l_predictor.cc).

Packed ARGB pixels travel as int64 tensors holding the uint32 value
(0 <= v < 2**32): PyTorch has no uint32 arithmetic, and int64 keeps
every shift and mask exact. Channels are int32. Every function runs on
the tensors' device, the card or the CPU alike; none is a hand-written
kernel (the reference's counterparts are jnp, not Pallas).

Reference behavior: internal/dsp/lossless_dsp.go (AddGreenToBlueAndRed,
SubtractGreen, TransformColor{,Inverse}), decode_transform.go:456
(colorSpaceInverseTransform). The predictor inverse stays a host
transform: its left-dependent modes make each output pixel a function of
the previous one along the row.
"""

from __future__ import annotations

import torch

_U32 = 0xFFFFFFFF


def _sub_sample_size(size: int, bits: int) -> int:
    return (size + (1 << bits) - 1) >> bits


def _u32(argb: torch.Tensor) -> torch.Tensor:
    """The packed pixels as int64 in [0, 2**32) (an int32 bit view of
    uint32 data is read back unsigned)."""
    return argb.to(torch.int64) & _U32


def add_green_inverse(argb: torch.Tensor) -> torch.Tensor:
    """r += g; b += g (mod 256): [h, w] packed ARGB."""
    a = _u32(argb)
    g = (a >> 8) & 0xFF
    r = (((a >> 16) & 0xFF) + g) & 0xFF
    b = ((a & 0xFF) + g) & 0xFF
    return (a & 0xFF00FF00) | (r << 16) | b


def subtract_green(argb: torch.Tensor) -> torch.Tensor:
    """Forward transform: r -= g; b -= g (mod 256)."""
    a = _u32(argb)
    g = (a >> 8) & 0xFF
    r = (((a >> 16) & 0xFF) - g) & 0xFF
    b = ((a & 0xFF) - g) & 0xFF
    return (a & 0xFF00FF00) | (r << 16) | b


def _signed8(v: torch.Tensor) -> torch.Tensor:
    """Low byte as an int8-style signed value."""
    v = v & 0xFF
    return v - ((v >> 7) << 8)


def _tile_map(tiles: torch.Tensor, h: int, w: int, bits: int):
    grid = tiles.reshape(_sub_sample_size(h, bits), _sub_sample_size(w, bits))
    t = 1 << bits
    return grid.repeat_interleave(t, 0).repeat_interleave(t, 1)[:h, :w]


def _cross_terms(a: torch.Tensor, tiles: torch.Tensor, bits: int):
    h, w = a.shape
    tmap = _tile_map(_u32(tiles), h, w, bits)
    return _signed8(tmap), _signed8(tmap >> 8), _signed8(tmap >> 16)


def color_space_inverse(argb: torch.Tensor, bits: int,
                        tiles: torch.Tensor) -> torch.Tensor:
    """Inverse cross-color: per-tile (g2r, g2b, r2b) multipliers applied
    per pixel (decode_transform.go:456)."""
    a = _u32(argb)
    g2r, g2b, r2b = _cross_terms(a, tiles, bits)
    gs = _signed8(a >> 8)
    red = (((a >> 16) & 0xFF) + ((g2r * gs) >> 5)) & 0xFF
    blue = (a & 0xFF) + ((g2b * gs) >> 5)
    blue = (blue + ((r2b * _signed8(red)) >> 5)) & 0xFF
    return (a & 0xFF00FF00) | (red << 16) | blue


def color_space_forward(argb: torch.Tensor, bits: int,
                        tiles: torch.Tensor) -> torch.Tensor:
    """Forward cross-color with given per-tile multipliers (the transform
    the encoder's per-tile search emits, encode_predictor.go:715)."""
    a = _u32(argb)
    g2r, g2b, r2b = _cross_terms(a, tiles, bits)
    gs = _signed8(a >> 8)
    red = (((a >> 16) & 0xFF) - ((g2r * gs) >> 5)) & 0xFF
    blue = ((a & 0xFF) - ((g2b * gs) >> 5)
            - ((r2b * _signed8(a >> 16)) >> 5)) & 0xFF
    return (a & 0xFF00FF00) | (red << 16) | blue


def color_index_inverse(packed: torch.Tensor, bits: int,
                        palette: torch.Tensor, out_width: int):
    """Palette lookup with pixel unbundling: packed [h, w] whose green
    bytes hold indices; palette [n] packed ARGB. Indices past the palette
    give 0."""
    h, w = packed.shape
    idx = (_u32(packed) >> 8) & 0xFF
    pal = _u32(palette)
    n = pal.shape[0]
    if bits:
        per, bpp = 1 << bits, 8 >> bits
        shifts = torch.arange(per, device=idx.device) * bpp
        idx = ((idx[:, :, None] >> shifts) & ((1 << bpp) - 1))
        idx = idx.reshape(h, w * per)[:, :out_width]
    ok = idx < n
    return torch.where(ok, pal[torch.where(ok, idx, 0)], 0)


# ---------------------------------------------------------------------------
# The encoder's per-tile predictor search.
#
# Exact mirror of native/src/vp8l_predictor.cc vp8l_predictor_transform
# (reference encode_predictor.go ResidualImage): interior-rule neighbours
# (missing = 0, TR at the last column = the current row's pixel 0), cost
# proxy sum(min(byte, 256-byte)) per tile per mode, ties to the lowest
# mode, then the row-0/col-0 edge overwrite. The forward search predicts
# from the original pixels, so all h*w*14 predictions are independent.
# ---------------------------------------------------------------------------

def _channels(a: torch.Tensor) -> torch.Tensor:
    """Packed [h, w] -> int32 [4, h, w] (a, r, g, b)."""
    return torch.stack([(a >> s) & 0xFF for s in (24, 16, 8, 0)]).to(
        torch.int32)


def _neighbors(ch: torch.Tensor):
    """Interior-rule L/T/TL/TR of planar channels [4, h, w]: missing
    neighbours read 0; TR at the last column is the current row's pixel
    0, and row 0 has no above."""
    L = torch.zeros_like(ch)
    L[:, :, 1:] = ch[:, :, :-1]
    T = torch.zeros_like(ch)
    T[:, 1:] = ch[:, :-1]
    TL = torch.zeros_like(ch)
    TL[:, :, 1:] = T[:, :, :-1]
    TR = torch.zeros_like(ch)
    TR[:, 1:, :-1] = ch[:, :-1, 1:]
    TR[:, 1:, -1] = ch[:, 1:, 0]
    return L, T, TL, TR


def _avg2(a, b):
    return (a + b) >> 1


def _predict_mode(m: int, L, T, TL, TR):
    """Predicted channels [4, h, w] for mode m (int32, exact)."""
    if m == 0:
        p = torch.zeros_like(L)
        p[0] = 255
        return p
    if m == 1:
        return L
    if m == 2:
        return T
    if m == 3:
        return TR
    if m == 4:
        return TL
    if m == 5:
        return _avg2(_avg2(L, TR), T)
    if m == 6:
        return _avg2(L, TL)
    if m == 7:
        return _avg2(L, T)
    if m == 8:
        return _avg2(TL, T)
    if m == 9:
        return _avg2(T, TR)
    if m == 10:
        return _avg2(_avg2(L, TL), _avg2(T, TR))
    if m == 11:
        # Select: per pixel, the sum over channels of |L-TL| - |T-TL|.
        pa = ((L - TL).abs() - (T - TL).abs()).sum(0)
        return torch.where(pa <= 0, T, L)
    if m == 12:
        return (L + T - TL).clamp(0, 255)
    # 13: ClampAddSubHalf, the delta halved toward zero.
    avg = _avg2(L, T)
    d = avg - TL
    return (avg + torch.sign(d) * (d.abs() >> 1)).clamp(0, 255)


def predictor_search(argb: torch.Tensor, bits: int):
    """Per-tile best-of-14 predictor search and residual emission.

    argb: packed [h, w] (after subtract-green). Returns (residuals int64
    [h, w] packed, tile_modes int32 [ty, tx]), equal to the native
    vp8l_predictor_transform's."""
    h, w = argb.shape
    tile = 1 << bits
    ty, tx = _sub_sample_size(h, bits), _sub_sample_size(w, bits)
    ch = _channels(_u32(argb))
    L, T, TL, TR = _neighbors(ch)
    cost_pad = torch.zeros((ty * tile, tx * tile), dtype=torch.int32,
                           device=ch.device)
    best_cost = best_res = modes = None
    for m in range(14):
        res = (ch - _predict_mode(m, L, T, TL, TR)) & 0xFF
        # The cost of a byte: min(b, 256 - b), so byte 0 costs 0.
        cost_pad[:h, :w] = torch.minimum(res, 256 - res).sum(0)
        cost = cost_pad.reshape(ty, tile, tx, tile).sum((1, 3))
        if m == 0:
            best_cost, best_res = cost, res
            modes = torch.zeros((ty, tx), dtype=torch.int32,
                                device=ch.device)
            continue
        better = cost < best_cost              # ties keep the lower mode
        best_cost = torch.where(better, cost, best_cost)
        modes = torch.where(better, m, modes)
        px = better.repeat_interleave(tile, 0).repeat_interleave(
            tile, 1)[:h, :w]
        best_res = torch.where(px, res, best_res)
    sel = best_res.clone()
    # Edge rules, after the selection as on the host: (0, 0) predicts
    # black, row 0 uses L, column 0 uses T.
    sel[:, 0, :] = (ch[:, 0, :] - L[:, 0, :]) & 0xFF
    sel[:, :, 0] = (ch[:, :, 0] - T[:, :, 0]) & 0xFF
    black = torch.tensor([255, 0, 0, 0], dtype=torch.int32, device=ch.device)
    sel[:, 0, 0] = (ch[:, 0, 0] - black) & 0xFF
    s = sel.to(torch.int64)
    return (s[0] << 24) | (s[1] << 16) | (s[2] << 8) | s[3], modes
