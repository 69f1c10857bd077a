"""ALPH alpha-plane encoder.

Parity with the reference's internal/lossy/alpha.go EncodeAlpha: 1-byte
header (method, filter, preprocessing), optional prediction filter, raw or
headerless-VP8L payload (alpha values in the green channel), best-filter
search by output size.
"""

from __future__ import annotations

import numpy as np

from ..container.riff import WebPError

FILTER_NONE, FILTER_HORIZONTAL, FILTER_VERTICAL, FILTER_GRADIENT = range(4)


def _filter_horizontal(a: np.ndarray) -> np.ndarray:
    out = a.astype(np.int16)
    out[:, 1:] = a[:, 1:].astype(np.int16) - a[:, :-1]
    out[1:, 0] = a[1:, 0].astype(np.int16) - a[:-1, 0]
    return (out & 0xFF).astype(np.uint8)


def _filter_vertical(a: np.ndarray) -> np.ndarray:
    out = a.astype(np.int16)
    out[0, 1:] = a[0, 1:].astype(np.int16) - a[0, :-1]
    out[1:, :] = a[1:, :].astype(np.int16) - a[:-1, :]
    return (out & 0xFF).astype(np.uint8)


def _filter_gradient(a: np.ndarray) -> np.ndarray:
    h, w = a.shape
    out = a.astype(np.int16).copy()
    out[0, 1:] = a[0, 1:].astype(np.int16) - a[0, :-1]
    if h > 1:
        ai = a.astype(np.int32)
        left = np.empty((h - 1, w), dtype=np.int32)
        left[:, 1:] = ai[1:, :-1]
        left[:, 0] = ai[:-1, 0]  # first col: left = top
        top = ai[:-1, :]
        top_left = np.empty((h - 1, w), dtype=np.int32)
        top_left[:, 1:] = ai[:-1, :-1]
        top_left[:, 0] = ai[:-1, 0]
        pred = np.clip(left + top - top_left, 0, 255)
        out[1:, :] = ai[1:, :] - pred
    return (out & 0xFF).astype(np.uint8)


FILTERS = {
    FILTER_NONE: lambda a: a,
    FILTER_HORIZONTAL: _filter_horizontal,
    FILTER_VERTICAL: _filter_vertical,
    FILTER_GRADIENT: _filter_gradient,
}


def quantize_levels(alpha: np.ndarray, num_levels: int) -> np.ndarray:
    """Quantizes the alpha plane to at most num_levels distinct values by a
    1-D k-means over the 256-symbol histogram (reference alpha.go:591
    quantizeLevels / libwebp QuantizeLevels). Returns a new array."""
    if num_levels < 2 or num_levels > 256 or alpha.size == 0:
        return alpha
    freq = np.bincount(alpha.reshape(-1), minlength=256).astype(np.float64)
    present = np.nonzero(freq)[0]
    if present.size <= num_levels:
        return alpha
    min_s, max_s = int(present[0]), int(present[-1])

    inv_q = min_s + (max_s - min_s) * np.arange(num_levels) / (num_levels - 1)
    q_level = np.zeros(256, dtype=np.int32)
    n_px = float(alpha.size)
    last_err = 1e38
    syms = np.arange(min_s, max_s + 1)
    fsy = freq[min_s:max_s + 1]
    for _ in range(6):
        # Assign each symbol to the slot whose midpoint boundary it falls in
        # (the reference walks slots in order; boundaries are midpoints of
        # consecutive centroids, ties to the lower slot via strict >).
        bounds = (inv_q[:-1] + inv_q[1:])  # 2*s > bounds[k] => slot > k
        slot = (2.0 * syms[:, None] > bounds[None, :]).sum(axis=1)
        q_level[min_s:max_s + 1] = slot
        if num_levels > 2:
            q_sum = np.bincount(slot, weights=syms * fsy,
                                minlength=num_levels)
            q_cnt = np.bincount(slot, weights=fsy, minlength=num_levels)
            inner = slice(1, num_levels - 1)
            upd = q_cnt[inner] > 0
            new_inner = np.where(upd, q_sum[inner] / np.maximum(q_cnt[inner],
                                                                1e-30),
                                 inv_q[inner])
            inv_q = inv_q.copy()
            inv_q[inner] = new_inner
        e = syms - inv_q[slot]
        err = float((fsy * e * e).sum())
        if last_err - err < 1e-4 * n_px:
            break
        last_err = err
    remap = np.arange(256, dtype=np.float64)
    remap[min_s:max_s + 1] = inv_q[q_level[min_s:max_s + 1]]
    remap = np.floor(remap + 0.5).astype(np.uint8)
    return remap[alpha]


def _alpha_levels_for_quality(quality: int) -> int:
    """Quality->levels map from the reference (alpha.go:612-618):
    [0,70] -> [2,16]; (70,100] -> (16,256]."""
    if quality <= 70:
        return 2 + quality // 5
    return 16 + (quality - 70) * 8


def _estimate_best_filter(a: np.ndarray) -> int:
    """Cheap best-filter estimate (reference alpha.go:321
    estimateBestFilter / libwebp WebPEstimateBestFilter): on a 2x-
    subsampled grid, bin |pred residual| >> 4 per filter as presence
    flags; the filter whose occupied bins have the smallest index sum
    wins. The NONE filter scores against a running row mean."""
    h, w = a.shape
    if h < 4 or w < 4:
        return FILTER_GRADIENT
    ai = a.astype(np.int32)
    cur = ai[2:h - 1:2, 2:w - 1:2]
    left = ai[2:h - 1:2, 1:w - 2:2]
    up = ai[1:h - 2:2, 2:w - 1:2]
    upleft = ai[1:h - 2:2, 1:w - 2:2]
    grad = np.clip(left + up - upleft, 0, 255)
    # Row-mean recurrence (mean' = (3*mean + cur + 2) >> 4ths): serial in
    # x, vectorized over rows; ~w/2 tiny vector steps.
    mean = ai[2:h - 1:2, 0].copy()
    d0 = np.empty_like(cur)
    for k in range(cur.shape[1]):
        d0[:, k] = np.abs(cur[:, k] - mean)
        mean = (3 * mean + cur[:, k] + 2) >> 2
    diffs = [d0 >> 4, np.abs(cur - left) >> 4, np.abs(cur - up) >> 4,
             np.abs(cur - grad) >> 4]
    order = [FILTER_NONE, FILTER_HORIZONTAL, FILTER_VERTICAL,
             FILTER_GRADIENT]
    best_f, best_score = FILTER_NONE, 1 << 30
    for f, d in zip(order, diffs):
        present = np.bincount(d.reshape(-1), minlength=16)[:16] > 0
        score = int(np.arange(16)[present].sum())
        if score < best_score:
            best_score, best_f = score, f
    return best_f


def encode_alpha(alpha: np.ndarray, quality: int = 100, method: int = 1,
                 filtering: int = 1, effort: int = 4) -> bytes:
    """Encodes a uint8 [h, w] alpha plane into an ALPH chunk payload."""
    alpha = np.asarray(alpha, dtype=np.uint8)
    h, w = alpha.shape
    quality = max(0, min(100, quality))
    if quality < 100:
        alpha = quantize_levels(alpha, _alpha_levels_for_quality(quality))
    if method == 0:
        header = 0  # no compression, no filter
        return bytes([header]) + alpha.tobytes()

    from ..lossless.encode import encode_vp8l_argb

    # Pick filters to try (reference alpha.go:271 getFilterMap):
    # 0=none only; 1=fast (estimate the best candidate, adding NONE at
    # effort > 3 or for many-color planes); 2=best (all four).
    if filtering == 0:
        candidates = [FILTER_NONE]
    elif filtering == 1:
        num_colors = int(np.unique(alpha).size)
        if num_colors <= 16:  # kMinColorsForFilterNone
            best_f = FILTER_NONE
        else:
            best_f = _estimate_best_filter(alpha)
        candidates = [best_f]
        if (effort > 3 or num_colors > 192) and best_f != FILTER_NONE:
            candidates.append(FILTER_NONE)
    else:
        candidates = [FILTER_NONE, FILTER_HORIZONTAL, FILTER_VERTICAL,
                      FILTER_GRADIENT]

    # VP8L effort for the alpha plane (reference alpha.go:488-497): full
    # quality only at effort 6 with no level reduction; otherwise the
    # cheap q = 8*effort search (the plane is a single channel — deep
    # LZ77/cost-model passes buy little and cost a full-image encode).
    if quality >= 100 and effort == 6:
        vq = 100
    else:
        vq = min(100, 8 * effort)
    best = None
    for f in candidates:
        filtered = FILTERS[f](alpha)
        argb = (np.uint32(0xFF000000)
                | (filtered.astype(np.uint32) << np.uint32(8)))
        payload = encode_vp8l_argb(argb, quality=vq,
                                   method=max(1, effort), with_header=False)
        header = 1 | (f << 2)  # lossless compression | filter
        blob = bytes([header]) + payload
        if best is None or len(blob) < len(best):
            best = blob
    # Raw fallback if compression doesn't help.
    if len(best) > 1 + w * h:
        return bytes([0]) + alpha.tobytes()
    return best
