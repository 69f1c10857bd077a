"""Fixed-point image rescaler: the incremental row rescaler of libwebp's
rescaler.c (and of the Go reference's internal/dsp/rescale.go, except
where noted): 32-bit fixed-point (RESCALER_RFIX) box-filter shrink and
linear expand, row-by-row import/export with fractional carry.

The port's own copy of webp_tpu/utils/rescaler.py, numpy host code with
the same arithmetic, so the same outputs. This is a utility API (the
codecs never resample); the per-row loops are vectorized across x where
the stepping has a closed form and kept as faithful scalar walks
elsewhere.
"""

from __future__ import annotations

import numpy as np

RFIX = 32
ONE = 1 << RFIX
_ROUNDER = 1 << (RFIX - 1)


def _mult_fix(x, y):
    return (int(x) * int(y) + _ROUNDER) >> RFIX


def _frac(x: int, y: int) -> int:
    return 0 if y == 0 else (x << RFIX) // y


class Rescaler:
    """Incremental one-channel rescaler (RescalerInit, rescale.go:63)."""

    def __init__(self, src_w: int, src_h: int, dst_w: int, dst_h: int):
        self.src_w, self.src_h = src_w, src_h
        self.dst_w, self.dst_h = dst_w, dst_h
        self.x_expand = dst_w > src_w
        self.y_expand = dst_h > src_h
        self.frow = np.zeros(dst_w, np.int64)
        self.irow = np.zeros(dst_w, np.int64)
        # Expand mode steps by (n-1) so endpoints map to endpoints
        # (libwebp rescaler_utils.c; the reference Go port omits the -1
        # adjustment and its expand path mis-normalizes — ours follows
        # libwebp, which is also what its own tests never covered).
        self.x_add = max(src_w - 1, 1) if self.x_expand else src_w
        self.x_sub = max(dst_w - 1, 1) if self.x_expand else dst_w
        self.y_add = max(src_h - 1, 1) if self.y_expand else src_h
        self.y_sub = max(dst_h - 1, 1) if self.y_expand else dst_h
        self.y_accum = self.y_sub if self.y_expand else self.y_add
        self.fx_scale = _frac(1, self.x_sub) if not self.x_expand else 0
        # Horizontal magnitude carried by FRow: x_add (expand interp)
        # or x_sub (shrink box sum).
        # FRow carries a horizontal magnitude of x_add in both modes
        # (expand: right*x_add + (left-right)*accum; shrink: the box sum
        # of ~x_add/x_sub pixels times x_sub).
        hor = self.x_add
        # y-expand: normalizes the horizontal magnitude out of FRow;
        # y-shrink: the fractional-row split factor (1 / y_sub).
        self.fy_scale = _frac(1, hor) if self.y_expand else _frac(1, self.y_sub)
        self.fxy_scale = 0
        if not self.y_expand and hor > 0 and self.y_add > 0:
            ratio = (dst_h << RFIX) // (hor * self.y_add)
            self.fxy_scale = ratio if ratio < (1 << 32) else 0
        self.src_y = 0
        self.dst_y = 0

    # -- import --------------------------------------------------------
    def import_row(self, src: np.ndarray) -> None:
        if self.x_expand:
            self._import_expand(src)
        else:
            self._import_shrink(src)
        if not self.y_expand:
            self.irow += self.frow
        self.src_y += 1
        self.y_accum -= self.y_sub

    def _import_expand(self, src: np.ndarray) -> None:
        w, dw = self.src_w, self.dst_w
        s = src.astype(np.int64)
        # Closed form of the accumulator walk: before emitting output x,
        # accum has been decremented x times by x_sub (wrapping by +x_add
        # with x_in++ on underflow).
        t = np.arange(dw, dtype=np.int64) * self.x_sub
        x_in = t // self.x_add          # number of wraps before output x
        accum = self.x_add - (t - x_in * self.x_add)
        left = s[np.minimum(x_in, w - 1)]
        right = s[np.minimum(x_in + 1, w - 1)]
        self.frow = right * self.x_add + (left - right) * accum

    def _import_shrink(self, src: np.ndarray) -> None:
        # Faithful scalar walk (rescalerImportRowShrink): the fractional
        # carry between output pixels has no clean closed form.
        x_in = 0
        total = 0
        accum = 0
        base = 0
        out = np.empty(self.dst_w, np.int64)
        for x_out in range(self.dst_w):
            accum += self.x_add
            while accum > 0:
                accum -= self.x_sub
                if x_in < self.src_w:
                    base = int(src[x_in])
                total += base
                x_in += 1
            frac = base * (-accum)
            out[x_out] = total * self.x_sub - frac
            total = _mult_fix(frac, self.fx_scale)
        self.frow = out

    # -- export --------------------------------------------------------
    def has_dst_row(self) -> bool:
        return self.y_accum <= 0

    def export_row(self):
        if self.y_accum > 0:
            return None
        if self.y_expand:
            dst = self._export_expand()
        else:
            dst = self._export_shrink()
        self.y_accum += self.y_add
        self.dst_y += 1
        return dst

    def _export_expand(self) -> np.ndarray:
        if self.y_accum == 0:
            v = (self.frow * self.fy_scale + _ROUNDER) >> RFIX
        else:
            b = _frac(-self.y_accum, self.y_sub)
            a = ONE - b
            i = a * self.frow + b * self.irow
            j = (i + _ROUNDER) >> RFIX
            v = (j * self.fy_scale + _ROUNDER) >> RFIX
        self.irow = self.frow.copy()
        return np.clip(v, 0, 255).astype(np.uint8)

    def _export_shrink(self) -> np.ndarray:
        yscale = self.fy_scale * (-self.y_accum)
        if yscale:
            frac = (self.frow * yscale) >> RFIX
            v = ((self.irow - frac) * self.fxy_scale + _ROUNDER) >> RFIX
            self.irow = frac
        else:
            v = (self.irow * self.fxy_scale + _ROUNDER) >> RFIX
            self.irow = np.zeros_like(self.irow)
        return np.clip(v, 0, 255).astype(np.uint8)


def rescale_plane(src: np.ndarray, dst_w: int, dst_h: int) -> np.ndarray:
    """Rescales a uint8 [h, w] plane to [dst_h, dst_w] with the canonical
    incremental loop: import each source row, export every ready
    destination row (rescale.go's intended usage)."""
    src_h, src_w = src.shape
    if (dst_w, dst_h) == (src_w, src_h):
        return src.copy()
    r = Rescaler(src_w, src_h, dst_w, dst_h)
    out = np.empty((dst_h, dst_w), np.uint8)
    dst_y = 0
    for y in range(src_h):
        r.import_row(src[y])
        while dst_y < dst_h:
            row = r.export_row()
            if row is None:
                break
            out[dst_y] = row
            dst_y += 1
    while dst_y < dst_h:  # bottom remainder (rounding tail)
        r.y_accum = 0
        out[dst_y] = r.export_row()
        dst_y += 1
    return out


def rescale_rgba(img: np.ndarray, dst_w: int, dst_h: int) -> np.ndarray:
    """Per-channel rescale of uint8 [h, w, c]."""
    return np.stack([rescale_plane(img[..., c], dst_w, dst_h)
                     for c in range(img.shape[2])], axis=-1)
