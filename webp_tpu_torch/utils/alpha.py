"""Alpha-plane processing utilities: premultiply / unpremultiply and
alpha extraction/dispatch.

Parity with the reference's alpha processing kernels
(internal/dsp/alpha_proc.go: MultARGBRow :28, DispatchAlpha :140,
ExtractAlpha/ExtractGreen :221): exact 8-bit fixed-point rounding
(((x + 128) * 257) >> 16 == round(x / 255) for all x <= 255*255),
vectorized numpy.
"""

from __future__ import annotations

import numpy as np

def _div255_round(x: np.ndarray) -> np.ndarray:
    """Exact round(x / 255) for 0 <= x <= 255*255: ((x + 128) * 257) >> 16."""
    return ((x + 128) * 257) >> 16


def premultiply(rgba: np.ndarray, inverse: bool = False) -> np.ndarray:
    """(Un)premultiplies RGB by alpha in place-semantics (returns a copy).

    rgba: uint8 [..., 4]. inverse=True undoes a premultiply (values are
    clamped; fully transparent pixels stay unchanged).
    """
    out = rgba.copy()
    a = rgba[..., 3].astype(np.uint32)
    if not inverse:
        for c in range(3):
            v = rgba[..., c].astype(np.uint32)
            out[..., c] = _div255_round(v * a).astype(np.uint8)
        return out
    safe = np.maximum(a, 1)
    for c in range(3):
        v = rgba[..., c].astype(np.uint32)
        r = (v * 255 + safe // 2) // safe
        out[..., c] = np.where(a == 0, rgba[..., c],
                               np.minimum(r, 255)).astype(np.uint8)
    return out


def extract_alpha(rgba: np.ndarray) -> tuple[np.ndarray, bool]:
    """Returns (alpha plane u8 [h, w], has_non_opaque) — ExtractAlpha."""
    a = np.ascontiguousarray(rgba[..., 3])
    return a, bool((a != 255).any())


def dispatch_alpha(rgb: np.ndarray, alpha: np.ndarray) -> np.ndarray:
    """Interleaves an alpha plane back into RGBA — DispatchAlpha."""
    h, w = alpha.shape
    out = np.empty((h, w, 4), np.uint8)
    out[..., :3] = rgb[..., :3]
    out[..., 3] = alpha
    return out


def extract_green(argb: np.ndarray) -> np.ndarray:
    """Packed uint32 ARGB -> green-channel plane u8 — ExtractGreen (the
    alpha codec stores the plane in VP8L's green channel)."""
    return ((argb >> np.uint32(8)) & np.uint32(0xFF)).astype(np.uint8)


def _smooth_rect(out: np.ndarray, alpha: np.ndarray,
                 y0: int, y1: int, x0: int, x1: int) -> None:
    """Replaces RGB of transparent pixels in the rect with the average of
    the rect's opaque pixels (smoothenBlock, reference encode.go:896)."""
    op = alpha[y0:y1, x0:x1] != 0
    n = int(op.sum())
    if n == 0 or n == op.size:
        return
    rgb = out[y0:y1, x0:x1, :3].astype(np.int32)
    avg = (rgb * op[..., None]).sum(axis=(0, 1)) // n
    out[y0:y1, x0:x1, :3] = np.where(op[..., None], rgb,
                                     avg[None, None]).astype(np.uint8)


def cleanup_transparent_lossy(rgba: np.ndarray) -> np.ndarray:
    """8x8-block cleanup of RGB under zero alpha before lossy encode
    (reference encode.go:788 cleanupTransparentAreaLossy): transparent
    pixels in mixed blocks take the block's opaque average; fully
    transparent blocks are flattened to a value carried across the run
    (the run's first block's top-left pixel), killing DCT energy that the
    eye can't see. Returns a new array; input must be uint8 [h, w, 4]."""
    alpha = rgba[..., 3]
    if not (alpha == 0).any():
        return rgba
    out = rgba.copy()
    h, w = alpha.shape
    B = 8
    nby, nbx = h // B, w // B
    if nby and nbx:
        # Block views ([nby, nbx, B, B, ...]) so only blocks that contain
        # transparent pixels are materialized — the all-opaque majority
        # costs one uint8 per-block count and nothing else.
        rgbv = out[:nby * B, :nbx * B, :3].reshape(
            nby, B, nbx, B, 3).transpose(0, 2, 1, 3, 4)
        op = (alpha[:nby * B, :nbx * B].reshape(nby, B, nbx, B)
              .transpose(0, 2, 1, 3) != 0)
        cnt = op.sum(axis=(2, 3), dtype=np.int32)              # [nby, nbx]
        ft = cnt == 0
        mixed_blk = (cnt > 0) & (cnt < B * B)
        if mixed_blk.any():
            ys, xs = np.nonzero(mixed_blk)
            blk = rgbv[ys, xs]                                 # [K, B, B, 3]
            opb = op[ys, xs]                                   # [K, B, B]
            # uint8 * bool stays uint8; widen only in the reduction.
            sums = (blk * opb[..., None]).sum(axis=(1, 2), dtype=np.int32)
            avg = (sums // cnt[ys, xs, None]).astype(np.uint8)
            ti = np.nonzero(~opb)
            blk[ti] = avg[ti[0]]
            rgbv[ys, xs] = blk
        if ft.any():
            # Fully-transparent runs flatten to the run-start block's
            # original top-left pixel (the "carry" in the reference).
            idx = np.broadcast_to(np.arange(nbx)[None, :], ft.shape)
            is_start = ft.copy()
            is_start[:, 1:] &= ~ft[:, :-1]
            run_start = np.maximum.accumulate(
                np.where(is_start, idx, -1), axis=1)
            tl = rgba[:nby * B:B, :nbx * B:B, :3]              # originals
            carry = np.take_along_axis(
                tl, np.maximum(run_start, 0)[..., None], axis=1)
            ys, xs = np.nonzero(ft)
            rgbv[ys, xs] = carry[ys, xs][:, None, None, :]
    # Edge remainders get smoothing only (no flatten/carry), as in the
    # reference.
    if w % B:
        for by in range(nby):
            _smooth_rect(out, alpha, by * B, (by + 1) * B, nbx * B, w)
    if h % B:
        for bx in range(nbx):
            _smooth_rect(out, alpha, nby * B, h, bx * B, (bx + 1) * B)
        if w % B:
            _smooth_rect(out, alpha, nby * B, h, nbx * B, w)
    return out
