"""VP8 DSP reference implementations (numpy, exact integer).

This is the host fallback and the conformance oracle for the Pallas/JAX
device kernels in webp_tpu_torch.ops (the same role the pure-Go functions play
for the SIMD paths in the reference, dsp/dsp.go:86-123).

All math matches RFC 6386: inverse/forward 4x4 DCT (¶14.3), WHT (¶14.3),
intra predictors (¶11.2-11.4, ¶12.2-12.3), loop filters (¶15).
"""

from __future__ import annotations

import numpy as np

C1 = 20091  # cos(pi/8)*sqrt(2) in Q16, minus 1.0
C2 = 35468  # sin(pi/8)*sqrt(2) in Q16


# ---------------------------------------------------------------------------
# Transforms (batched over leading axes).
# ---------------------------------------------------------------------------

def _mul1(a):
    return ((a * C1) >> 16) + a


def _mul2(a):
    return (a * C2) >> 16


def idct4x4_add(coeffs: np.ndarray, pred: np.ndarray) -> np.ndarray:
    """Batched inverse DCT + predictor add + clamp.

    coeffs: int32 [..., 4, 4] (row-major frequency layout, already dequantized)
    pred:   uint8/int  [..., 4, 4]
    returns uint8 [..., 4, 4]
    """
    c = coeffs.astype(np.int64)
    i0, i1, i2, i3 = c[..., 0, :], c[..., 1, :], c[..., 2, :], c[..., 3, :]
    a = i0 + i2
    b = i0 - i2
    cc = _mul2(i1) - _mul1(i3)
    d = _mul1(i1) + _mul2(i3)
    t0, t1, t2, t3 = a + d, b + cc, b - cc, a - d  # rows of tmp
    # Horizontal pass per row of tmp: operate along the last axis.
    tmp = np.stack([t0, t1, t2, t3], axis=-2)  # [..., 4(row), 4(col)]
    dc = tmp[..., 0] + 4
    a = dc + tmp[..., 2]
    b = dc - tmp[..., 2]
    cc = _mul2(tmp[..., 1]) - _mul1(tmp[..., 3])
    d = _mul1(tmp[..., 1]) + _mul2(tmp[..., 3])
    out = np.stack([a + d, b + cc, b - cc, a - d], axis=-1) >> 3
    res = pred.astype(np.int64) + out
    return np.clip(res, 0, 255).astype(np.uint8)


def idct4x4(coeffs: np.ndarray) -> np.ndarray:
    """Batched inverse DCT returning int32 residuals (no pred/clamp)."""
    c = coeffs.astype(np.int64)
    i0, i1, i2, i3 = c[..., 0, :], c[..., 1, :], c[..., 2, :], c[..., 3, :]
    a = i0 + i2
    b = i0 - i2
    cc = _mul2(i1) - _mul1(i3)
    d = _mul1(i1) + _mul2(i3)
    tmp = np.stack([a + d, b + cc, b - cc, a - d], axis=-2)
    dc = tmp[..., 0] + 4
    a = dc + tmp[..., 2]
    b = dc - tmp[..., 2]
    cc = _mul2(tmp[..., 1]) - _mul1(tmp[..., 3])
    d = _mul1(tmp[..., 1]) + _mul2(tmp[..., 3])
    out = np.stack([a + d, b + cc, b - cc, a - d], axis=-1) >> 3
    return out.astype(np.int32)


def wht4x4(coeffs: np.ndarray) -> np.ndarray:
    """Batched inverse WHT: [..., 4, 4] int -> [..., 4, 4] int32 DC values
    (result [i, j] is the DC for the (i, j) luma sub-block)."""
    c = coeffs.astype(np.int64)
    i0, i1, i2, i3 = c[..., 0, :], c[..., 1, :], c[..., 2, :], c[..., 3, :]
    a0 = i0 + i3
    a1 = i1 + i2
    a2 = i1 - i2
    a3 = i0 - i3
    tmp = np.stack([a0 + a1, a3 + a2, a0 - a1, a3 - a2], axis=-2)
    dc = tmp[..., 0] + 3
    a0 = dc + tmp[..., 3]
    a1 = tmp[..., 1] + tmp[..., 2]
    a2 = tmp[..., 1] - tmp[..., 2]
    a3 = dc - tmp[..., 3]
    out = np.stack([a0 + a1, a3 + a2, a0 - a1, a3 - a2], axis=-1) >> 3
    return out.astype(np.int32)


def fdct4x4(src: np.ndarray, ref: np.ndarray) -> np.ndarray:
    """Batched forward DCT of (src - ref): uint8 [..., 4, 4] -> int32 [..., 4, 4].

    Matches the reference fTransform (dsp/transforms.go:371) integer math.
    """
    d = src.astype(np.int64) - ref.astype(np.int64)  # [..., 4(row), 4(col)]
    # Horizontal pass (within each pixel row).
    d0, d1, d2, d3 = d[..., 0], d[..., 1], d[..., 2], d[..., 3]
    a0 = d0 + d3
    a1 = d1 + d2
    a2 = d1 - d2
    a3 = d0 - d3
    t0 = (a0 + a1) * 8
    t1 = (a2 * 2217 + a3 * 5352 + 1812) >> 9
    t2 = (a0 - a1) * 8
    t3 = (a3 * 2217 - a2 * 5352 + 937) >> 9
    tmp = np.stack([t0, t1, t2, t3], axis=-1)  # [..., 4(row), 4(freq)]
    # Vertical pass (within each frequency column).
    m0, m1, m2, m3 = tmp[..., 0, :], tmp[..., 1, :], tmp[..., 2, :], tmp[..., 3, :]
    a0 = m0 + m3
    a1 = m1 + m2
    a2 = m1 - m2
    a3 = m0 - m3
    o0 = (a0 + a1 + 7) >> 4
    o2 = (a0 - a1 + 7) >> 4
    o1 = ((a2 * 2217 + a3 * 5352 + 12000) >> 16) + (a3 != 0).astype(np.int64)
    o3 = (a3 * 2217 - a2 * 5352 + 51000) >> 16
    return np.stack([o0, o1, o2, o3], axis=-2).astype(np.int32)


def fwht4x4(dcs: np.ndarray) -> np.ndarray:
    """Batched forward WHT over the 16 luma sub-block DCs [..., 4, 4] int
    (matches fTransformWHT, transforms.go:500)."""
    d = dcs.astype(np.int64)
    # First pass: within each row, over columns.
    c0, c1, c2, c3 = d[..., 0], d[..., 1], d[..., 2], d[..., 3]
    a0 = c0 + c2
    a1 = c1 + c3
    a2 = c1 - c3
    a3 = c0 - c2
    tmp = np.stack([a0 + a1, a3 + a2, a3 - a2, a0 - a1], axis=-1)  # [..., row, 4]
    # Second pass: within each column, over rows.
    r0, r1, r2, r3 = tmp[..., 0, :], tmp[..., 1, :], tmp[..., 2, :], tmp[..., 3, :]
    a0 = r0 + r2
    a1 = r1 + r3
    a2 = r1 - r3
    a3 = r0 - r2
    out = np.stack([a0 + a1, a3 + a2, a3 - a2, a0 - a1], axis=-2) >> 1
    return out.astype(np.int32)


# ---------------------------------------------------------------------------
# Intra prediction. Work buffers are 2D numpy int32 views with a 1-px halo:
# buf[-1, :] = top row, buf[:, -1] = left column (callers pass plain arrays
# `top` (with topleft at index 0) and `left`).
# ---------------------------------------------------------------------------

# Mode numbering (libwebp order): DC=0, TM=1, V=2, H=3; DC border variants.
DC_PRED, TM_PRED, V_PRED, H_PRED = 0, 1, 2, 3
B_DC, B_TM, B_VE, B_HE, B_RD, B_VR, B_LD, B_VL, B_HD, B_HU = range(10)
B_PRED = 10
DC_NO_TOP, DC_NO_LEFT, DC_NO_TOPLEFT = 4, 5, 6


def pred_block(mode: int, size: int, top: np.ndarray, left: np.ndarray,
               topleft: int) -> np.ndarray:
    """Whole-block predictor for 16x16 luma / 8x8 chroma.

    top/left are int arrays of length `size`; topleft is a scalar.
    mode includes the DC border variants (4, 5, 6).
    """
    if mode == DC_PRED:
        dc = (int(top.sum()) + int(left.sum()) + size) >> int(np.log2(size * 2))
        return np.full((size, size), dc, dtype=np.int32)
    if mode == DC_NO_TOP:
        dc = (int(left.sum()) + (size >> 1)) >> int(np.log2(size))
        return np.full((size, size), dc, dtype=np.int32)
    if mode == DC_NO_LEFT:
        dc = (int(top.sum()) + (size >> 1)) >> int(np.log2(size))
        return np.full((size, size), dc, dtype=np.int32)
    if mode == DC_NO_TOPLEFT:
        return np.full((size, size), 0x80, dtype=np.int32)
    if mode == V_PRED:
        return np.broadcast_to(top[None, :], (size, size)).astype(np.int32)
    if mode == H_PRED:
        return np.broadcast_to(left[:, None], (size, size)).astype(np.int32)
    if mode == TM_PRED:
        p = left[:, None].astype(np.int32) + top[None, :].astype(np.int32) - topleft
        return np.clip(p, 0, 255)
    raise ValueError(f"bad whole-block mode {mode}")


def _avg3(a, b, c):
    return (a + 2 * b + c + 2) >> 2


def _avg2(a, b):
    return (a + b + 1) >> 1


def pred_luma4(mode: int, top: np.ndarray, left: np.ndarray, topleft: int,
               topright: np.ndarray) -> np.ndarray:
    """4x4 intra predictor (RFC 6386 ¶12.3; formulas match libwebp dec.c).

    top/left: 4 ints; topright: 4 ints (pixels at x=4..7 of the row above).
    """
    t0, t1, t2, t3 = (int(v) for v in top[:4])
    l0, l1, l2, l3 = (int(v) for v in left[:4])
    tl = int(topleft)
    t4, t5, t6, t7 = (int(v) for v in topright[:4])
    a2, a3 = _avg2, _avg3
    o = np.zeros((4, 4), dtype=np.int32)
    if mode == B_DC:
        o[:] = (t0 + t1 + t2 + t3 + l0 + l1 + l2 + l3 + 4) >> 3
    elif mode == B_TM:
        l = np.array([l0, l1, l2, l3], dtype=np.int32)
        t = np.array([t0, t1, t2, t3], dtype=np.int32)
        o[:] = np.clip(l[:, None] + t[None, :] - tl, 0, 255)
    elif mode == B_VE:
        vals = [a3(tl, t0, t1), a3(t0, t1, t2), a3(t1, t2, t3), a3(t2, t3, t4)]
        o[:] = np.array(vals, dtype=np.int32)[None, :]
    elif mode == B_HE:
        vals = [a3(tl, l0, l1), a3(l0, l1, l2), a3(l1, l2, l3), a3(l2, l3, l3)]
        o[:] = np.array(vals, dtype=np.int32)[:, None]
    elif mode == B_RD:
        o[3, 0] = a3(l3, l2, l1)
        o[2, 0] = o[3, 1] = a3(l2, l1, l0)
        o[1, 0] = o[2, 1] = o[3, 2] = a3(l1, l0, tl)
        o[0, 0] = o[1, 1] = o[2, 2] = o[3, 3] = a3(l0, tl, t0)
        o[0, 1] = o[1, 2] = o[2, 3] = a3(tl, t0, t1)
        o[0, 2] = o[1, 3] = a3(t0, t1, t2)
        o[0, 3] = a3(t1, t2, t3)
    elif mode == B_VR:
        o[0, 0] = o[2, 1] = a2(tl, t0)
        o[0, 1] = o[2, 2] = a2(t0, t1)
        o[0, 2] = o[2, 3] = a2(t1, t2)
        o[0, 3] = a2(t2, t3)
        o[1, 0] = o[3, 1] = a3(l0, tl, t0)
        o[1, 1] = o[3, 2] = a3(tl, t0, t1)
        o[1, 2] = o[3, 3] = a3(t0, t1, t2)
        o[1, 3] = a3(t1, t2, t3)
        o[2, 0] = a3(l1, l0, tl)
        o[3, 0] = a3(l2, l1, l0)
    elif mode == B_LD:
        o[0, 0] = a3(t0, t1, t2)
        o[0, 1] = o[1, 0] = a3(t1, t2, t3)
        o[0, 2] = o[1, 1] = o[2, 0] = a3(t2, t3, t4)
        o[0, 3] = o[1, 2] = o[2, 1] = o[3, 0] = a3(t3, t4, t5)
        o[1, 3] = o[2, 2] = o[3, 1] = a3(t4, t5, t6)
        o[2, 3] = o[3, 2] = a3(t5, t6, t7)
        o[3, 3] = a3(t6, t7, t7)
    elif mode == B_VL:
        o[0, 0] = a2(t0, t1)
        o[0, 1] = o[2, 0] = a2(t1, t2)
        o[0, 2] = o[2, 1] = a2(t2, t3)
        o[0, 3] = o[2, 2] = a2(t3, t4)
        o[1, 0] = a3(t0, t1, t2)
        o[1, 1] = o[3, 0] = a3(t1, t2, t3)
        o[1, 2] = o[3, 1] = a3(t2, t3, t4)
        o[1, 3] = o[3, 2] = a3(t3, t4, t5)
        o[2, 3] = a3(t4, t5, t6)
        o[3, 3] = a3(t5, t6, t7)
    elif mode == B_HD:
        o[0, 0] = a2(tl, l0)
        o[0, 1] = a3(l0, tl, t0)
        o[0, 2] = a3(tl, t0, t1)
        o[0, 3] = a3(t0, t1, t2)
        o[1, 0] = a2(l0, l1)
        o[1, 1] = a3(tl, l0, l1)
        o[1, 2] = o[0, 0]
        o[1, 3] = o[0, 1]
        o[2, 0] = a2(l1, l2)
        o[2, 1] = a3(l0, l1, l2)
        o[2, 2] = o[1, 0]
        o[2, 3] = o[1, 1]
        o[3, 0] = a2(l2, l3)
        o[3, 1] = a3(l1, l2, l3)
        o[3, 2] = o[2, 0]
        o[3, 3] = o[2, 1]
    elif mode == B_HU:
        o[0, 0] = a2(l0, l1)
        o[0, 1] = a3(l0, l1, l2)
        o[0, 2] = a2(l1, l2)
        o[0, 3] = a3(l1, l2, l3)
        o[1, 0] = o[0, 2]
        o[1, 1] = o[0, 3]
        o[1, 2] = a2(l2, l3)
        o[1, 3] = a3(l2, l3, l3)
        o[2, 0] = o[1, 2]
        o[2, 1] = o[1, 3]
        o[2, 2] = l3
        o[2, 3] = l3
        o[3, :] = l3
    else:
        raise ValueError(f"bad 4x4 mode {mode}")
    return o


# ---------------------------------------------------------------------------
# Loop filter (RFC 6386 ¶15), vectorized along the edge.
# Edges are described by gathering 8 parallel sample vectors p3..q3.
# ---------------------------------------------------------------------------

def _sclip1(v):
    return np.clip(v, -128, 127)


def _sclip2(v):
    return np.clip(v, -16, 15)


def _clip255(v):
    return np.clip(v, 0, 255)


def _needs_filter(p1, p0, q0, q1, thresh):
    return 4 * np.abs(p0 - q0) + np.abs(p1 - q1) <= thresh


def _needs_filter2(p, thresh, ithresh):
    p3, p2, p1, p0, q0, q1, q2, q3 = p
    ok = _needs_filter(p1, p0, q0, q1, thresh)
    ok &= np.abs(p3 - p2) <= ithresh
    ok &= np.abs(p2 - p1) <= ithresh
    ok &= np.abs(p1 - p0) <= ithresh
    ok &= np.abs(q3 - q2) <= ithresh
    ok &= np.abs(q2 - q1) <= ithresh
    ok &= np.abs(q1 - q0) <= ithresh
    return ok


def _hev(p1, p0, q0, q1, t):
    return (np.abs(p1 - p0) > t) | (np.abs(q1 - q0) > t)


def _do_filter2(p1, p0, q0, q1):
    a = 3 * (q0 - p0) + _sclip1(p1 - q1)
    a1 = _sclip2((a + 4) >> 3)
    a2 = _sclip2((a + 3) >> 3)
    return _clip255(p0 + a2), _clip255(q0 - a1)


def _do_filter4(p1, p0, q0, q1):
    a = 3 * (q0 - p0)
    a1 = _sclip2((a + 4) >> 3)
    a2 = _sclip2((a + 3) >> 3)
    a3 = (a1 + 1) >> 1
    return (_clip255(p1 + a3), _clip255(p0 + a2),
            _clip255(q0 - a1), _clip255(q1 - a3))


def _do_filter6(p2, p1, p0, q0, q1, q2):
    a = _sclip1(3 * (q0 - p0) + _sclip1(p1 - q1))
    a1 = (27 * a + 63) >> 7
    a2 = (18 * a + 63) >> 7
    a3 = (9 * a + 63) >> 7
    return (_clip255(p2 + a3), _clip255(p1 + a2), _clip255(p0 + a1),
            _clip255(q0 - a1), _clip255(q1 - a2), _clip255(q2 - a3))


def _gather8(plane, horiz_edge, pos, start, n):
    """Returns list of 8 int32 vectors p3..q3 across the edge."""
    if horiz_edge:  # edge between row pos-1 and pos; vectors along columns
        return [plane[pos + d, start:start + n].astype(np.int32) for d in range(-4, 4)]
    return [plane[start:start + n, pos + d].astype(np.int32) for d in range(-4, 4)]


def _scatter(plane, horiz_edge, pos, start, n, offsets, vecs, mask):
    for d, v in zip(offsets, vecs):
        if horiz_edge:
            tgt = plane[pos + d, start:start + n]
        else:
            tgt = plane[start:start + n, pos + d]
        tgt[...] = np.where(mask, v, tgt).astype(plane.dtype)


def filter_edge_simple(plane, horiz_edge, pos, start, n, limit):
    """Simple 2-tap filter across one edge (luma only)."""
    thresh2 = 2 * limit + 1
    p = _gather8(plane, horiz_edge, pos, start, n)
    p1, p0, q0, q1 = p[2], p[3], p[4], p[5]
    mask = _needs_filter(p1, p0, q0, q1, thresh2)
    np0, nq0 = _do_filter2(p1, p0, q0, q1)
    _scatter(plane, horiz_edge, pos, start, n, (-1, 0), (np0, nq0), mask)


def filter_edge_complex(plane, horiz_edge, pos, start, n, limit, ilevel, hev_t,
                        inner: bool):
    """Normal (complex) filter: FilterLoop26 (MB edge) / FilterLoop24 (inner)."""
    thresh2 = 2 * limit + 1
    p = _gather8(plane, horiz_edge, pos, start, n)
    p3, p2, p1, p0, q0, q1, q2, q3 = p
    mask = _needs_filter2(p, thresh2, ilevel)
    hv = _hev(p1, p0, q0, q1, hev_t)
    # hev path: doFilter2.
    f2p0, f2q0 = _do_filter2(p1, p0, q0, q1)
    if inner:
        f4 = _do_filter4(p1, p0, q0, q1)
        np1 = np.where(hv, p1, f4[0])
        np0 = np.where(hv, f2p0, f4[1])
        nq0 = np.where(hv, f2q0, f4[2])
        nq1 = np.where(hv, q1, f4[3])
        _scatter(plane, horiz_edge, pos, start, n, (-2, -1, 0, 1),
                 (np1, np0, nq0, nq1), mask)
    else:
        f6 = _do_filter6(p2, p1, p0, q0, q1, q2)
        np2 = np.where(hv, p2, f6[0])
        np1 = np.where(hv, p1, f6[1])
        np0 = np.where(hv, f2p0, f6[2])
        nq0 = np.where(hv, f2q0, f6[3])
        nq1 = np.where(hv, q1, f6[4])
        nq2 = np.where(hv, q2, f6[5])
        _scatter(plane, horiz_edge, pos, start, n, (-3, -2, -1, 0, 1, 2),
                 (np2, np1, np0, nq0, nq1, nq2), mask)
