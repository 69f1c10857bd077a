"""An independent VP8 key-frame decoder, written from RFC 6386 with
libwebp's conventions (src/dec/vp8_dec.c, tree_dec.c, frame_dec.c and
dsp/dec.c, upsampling.c, yuv.h) where the RFC leaves a choice: the
127/129 edge fills, the skip rule of the inner loop-filter edges, the
fancy chroma upsampler and the 14-bit YUV to RGB conversion.

It shares no code with the measured package or with the frozen encoder
copy beside it (vp8ref/); it reads only the RFC's constant tables from
vp8ref/lossy/tables.py (numbers, no code). The benchmark's CPU tests hold
it pixel for pixel against libwebp through Pillow.

decode_frame(vp8) -> Frame: the header, the per-macroblock modes and the
reconstruction before and after the loop filter, on the macroblock grid.
to_rgb(frame) -> uint8 [h, w, 3]: fancy upsampling and conversion.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .vp8ref.lossy import tables as T

# libwebp's mode numbers: 16x16 and chroma DC, TM, V, H share the 4x4
# numbers of B_DC, B_TM, B_VE, B_HE.
DC, TM, VE, HE, RD, VR, LD, VL, HD, HU = range(10)

_NORM = [0] + [7 - r.bit_length() + 1 for r in range(1, 128)]
_ZIGZAG = [int(z) for z in T.ZIGZAG]
_BANDS = [int(b) for b in T.BANDS]
_CAT = [tuple(c) for c in T.CAT3456]
_BMODE_TREE = [int(v) for v in T.YMODES_INTRA4_TREE]
_BMODE_PROBA = T.BMODE_PROBA.tolist()


class BoolReader:
    """The boolean entropy decoder of RFC 6386 section 7. `val` holds the
    unread bits; the 8-bit window sits `bits` bits above its bottom.
    Past the end of its bytes it reads zeros."""

    __slots__ = ("buf", "pos", "end", "val", "bits", "rng")

    def __init__(self, buf: bytes, start: int, end: int):
        self.buf, self.pos, self.end = buf, start, min(end, len(buf))
        self.val, self.bits, self.rng = 0, -8, 255

    def _load(self):
        take = self.buf[self.pos:min(self.pos + 4, self.end)]
        self.pos += 4
        n = len(take)
        self.val = (self.val << 32) | (int.from_bytes(take, "big")
                                       << (8 * (4 - n)))
        self.bits += 32

    def bit(self, prob: int) -> int:
        split = 1 + (((self.rng - 1) * prob) >> 8)
        if self.bits < 0:
            self._load()
        big = split << self.bits
        if self.val >= big:
            self.val -= big
            r = self.rng - split
            b = 1
        else:
            r = split
            b = 0
        if r < 128:
            s = _NORM[r]
            r <<= s
            self.bits -= s
        self.rng = r
        return b

    def literal(self, n: int) -> int:
        v = 0
        for _ in range(n):
            v = (v << 1) | self.bit(128)
        return v

    def signed(self, n: int) -> int:
        v = self.literal(n)
        return -v if self.bit(128) else v

    def optional_signed(self, n: int) -> int:
        return self.signed(n) if self.bit(128) else 0


@dataclass
class Frame:
    width: int
    height: int
    mb_w: int
    mb_h: int
    filter_type: int            # 0 none, 1 simple, 2 normal
    is_i4: np.ndarray           # bool [mb_h, mb_w]
    ymode: np.ndarray           # [mb_h, mb_w] 16x16 mode (I16 MBs)
    bmodes: np.ndarray          # [mb_h, mb_w, 16] 4x4 modes (I4 MBs)
    uvmode: np.ndarray          # [mb_h, mb_w]
    segment: np.ndarray         # [mb_h, mb_w]
    skip: np.ndarray            # [mb_h, mb_w] the bitstream's skip flag
    y: np.ndarray = None        # uint8 planes on the MB grid, filtered
    u: np.ndarray = None
    v: np.ndarray = None
    y_unfiltered: np.ndarray = None
    u_unfiltered: np.ndarray = None
    v_unfiltered: np.ndarray = None


def vp8_payload(data: bytes) -> bytes:
    """The VP8 chunk of a simple lossy file (RIFF, WEBP, one VP8 chunk);
    raises on anything else."""
    if len(data) < 20 or data[:4] != b"RIFF" or data[8:12] != b"WEBP" \
            or data[12:16] != b"VP8 ":
        raise ValueError("not a simple lossy WebP file")
    size = int.from_bytes(data[16:20], "little")
    if 20 + size > len(data):
        raise ValueError("VP8 chunk runs past the file")
    return data[20:20 + size]


class _Header:
    pass


def _parse_header(vp8: bytes):
    """Frame tag, key-frame header and partition 0's frame header ->
    (header, the partition-0 reader positioned at the first MB's modes)."""
    if len(vp8) < 10:
        raise ValueError("VP8 frame too short")
    tag = vp8[0] | (vp8[1] << 8) | (vp8[2] << 16)
    if tag & 1:
        raise ValueError("not a key frame")
    if (tag >> 1) & 7 > 3:
        raise ValueError("unknown VP8 profile")
    part0 = tag >> 5
    if vp8[3:6] != b"\x9d\x01\x2a":
        raise ValueError("bad VP8 start code")
    h = _Header()
    h.width = (vp8[6] | (vp8[7] << 8)) & 0x3FFF
    h.height = (vp8[8] | (vp8[9] << 8)) & 0x3FFF
    h.mb_w, h.mb_h = (h.width + 15) >> 4, (h.height + 15) >> 4
    if 10 + part0 > len(vp8):
        raise ValueError("partition 0 runs past the frame")
    br = BoolReader(vp8, 10, 10 + part0)
    br.bit(128)                                   # colour space
    br.bit(128)                                   # clamping type
    h.use_segment = br.bit(128)
    h.update_map = 0
    h.absolute = 0
    h.seg_quant = [0] * 4
    h.seg_filter = [0] * 4
    h.seg_probs = [255] * 3
    if h.use_segment:
        h.update_map = br.bit(128)
        if br.bit(128):                           # segment data
            h.absolute = br.bit(128)
            h.seg_quant = [br.optional_signed(7) for _ in range(4)]
            h.seg_filter = [br.optional_signed(6) for _ in range(4)]
        if h.update_map:
            h.seg_probs = [br.literal(8) if br.bit(128) else 255
                           for _ in range(3)]
    h.simple = br.bit(128)
    h.level = br.literal(6)
    h.sharpness = br.literal(3)
    h.use_lf_delta = br.bit(128)
    h.ref_lf_delta = [0] * 4
    h.mode_lf_delta = [0] * 4
    if h.use_lf_delta and br.bit(128):
        for i in range(4):
            if br.bit(128):
                h.ref_lf_delta[i] = br.signed(6)
        for i in range(4):
            if br.bit(128):
                h.mode_lf_delta[i] = br.signed(6)
    h.filter_type = 0 if h.level == 0 else (1 if h.simple else 2)
    h.num_parts = 1 << br.literal(2)
    base_q = br.literal(7)
    dq = [br.optional_signed(4) for _ in range(5)]
    h.quant = _dequant_tables(h, base_q, dq)
    br.bit(128)                                   # refresh entropy probs
    probs = T.COEFFS_PROBA0.tolist()
    upd = T.COEFFS_UPDATE_PROBA.tolist()
    for t in range(4):
        for b in range(8):
            for c in range(3):
                for p in range(11):
                    if br.bit(upd[t][b][c][p]):
                        probs[t][b][c][p] = br.literal(8)
    h.probs = probs
    h.use_skip = br.bit(128)
    h.skip_p = br.literal(8) if h.use_skip else 0
    # The token partitions: their sizes follow partition 0.
    at = 10 + part0
    sizes_at = at
    at += 3 * (h.num_parts - 1)
    if at > len(vp8):
        raise ValueError("partition sizes run past the frame")
    h.parts = []
    for p in range(h.num_parts):
        if p < h.num_parts - 1:
            o = sizes_at + 3 * p
            size = vp8[o] | (vp8[o + 1] << 8) | (vp8[o + 2] << 16)
        else:
            size = len(vp8) - at
        if at + size > len(vp8):
            raise ValueError("token partition runs past the frame")
        h.parts.append((at, at + size))
        at += size
    return h, br


def _dequant_tables(h, base_q: int, dq: list) -> list:
    """Per segment ((y1 dc, ac), (y2 dc, ac), (uv dc, ac)), libwebp's
    VP8ParseQuant."""
    def clip(v, m):
        return 0 if v < 0 else (m if v > m else v)

    dc_t, ac_t = T.DC_TABLE.tolist(), T.AC_TABLE.tolist()
    out = []
    for s in range(4):
        if h.use_segment:
            q = h.seg_quant[s] + (0 if h.absolute else base_q)
        else:
            q = base_q
        y2ac = (ac_t[clip(q + dq[2], 127)] * 101581) >> 16
        out.append(((dc_t[clip(q + dq[0], 127)], ac_t[clip(q, 127)]),
                    (dc_t[clip(q + dq[1], 127)] * 2, max(y2ac, 8)),
                    (dc_t[clip(q + dq[3], 117)], ac_t[clip(q + dq[4], 127)])))
    return out


def _parse_modes(h, br: BoolReader):
    """Every macroblock's segment, skip flag and intra modes (partition 0,
    after the frame header)."""
    mb_w, mb_h = h.mb_w, h.mb_h
    is_i4 = np.zeros((mb_h, mb_w), bool)
    ymode = np.zeros((mb_h, mb_w), np.int32)
    bmodes = np.zeros((mb_h, mb_w, 16), np.int32)
    uvmode = np.zeros((mb_h, mb_w), np.int32)
    segment = np.zeros((mb_h, mb_w), np.int32)
    skip = np.zeros((mb_h, mb_w), bool)
    top = [DC] * (4 * mb_w)
    sp = h.seg_probs
    for y in range(mb_h):
        left = [DC] * 4
        for x in range(mb_w):
            if h.update_map:
                segment[y, x] = (2 + br.bit(sp[2])) if br.bit(sp[0]) \
                    else br.bit(sp[1])
            if h.use_skip:
                skip[y, x] = br.bit(h.skip_p)
            if not br.bit(145):
                is_i4[y, x] = True
                for r in range(4):
                    m = left[r]
                    for c in range(4):
                        p = _BMODE_PROBA[top[4 * x + c]][m]
                        i = _BMODE_TREE[br.bit(p[0])]
                        while i > 0:
                            i = _BMODE_TREE[2 * i + br.bit(p[i])]
                        m = -i
                        top[4 * x + c] = m
                        bmodes[y, x, 4 * r + c] = m
                    left[r] = m
            else:
                if br.bit(156):
                    m = TM if br.bit(128) else HE
                else:
                    m = VE if br.bit(163) else DC
                ymode[y, x] = m
                top[4 * x:4 * x + 4] = [m] * 4
                left = [m] * 4
            if not br.bit(142):
                uvmode[y, x] = DC
            elif not br.bit(114):
                uvmode[y, x] = VE
            else:
                uvmode[y, x] = TM if br.bit(183) else HE
    return is_i4, ymode, bmodes, uvmode, segment, skip


def parse(vp8: bytes) -> Frame:
    """The header and the modes, without tokens or pixels."""
    h, br = _parse_header(vp8)
    is_i4, ymode, bmodes, uvmode, segment, skip = _parse_modes(h, br)
    f = Frame(h.width, h.height, h.mb_w, h.mb_h, h.filter_type, is_i4,
              ymode, bmodes, uvmode, segment, skip)
    f._h = h
    return f


def _coeffs(br: BoolReader, probs, ctx: int, n: int, dq, out: list,
            base: int) -> int:
    """One block's tokens (RFC 6386 section 13): the dequantised
    coefficients into out[base + raster index]; returns the position
    after the last nonzero one (n where the block ends at once)."""
    bit = br.bit
    p = probs[_BANDS[n]][ctx]
    while n < 16:
        if not bit(p[0]):
            return n                              # end of block
        while not bit(p[1]):                      # a zero
            n += 1
            if n == 16:
                return 16
            p = probs[_BANDS[n]][0]
        if not bit(p[2]):
            v = 1
            nxt = 1
        else:
            if not bit(p[3]):
                v = 2 if not bit(p[4]) else 3 + bit(p[5])
            elif not bit(p[6]):
                if not bit(p[7]):
                    v = 5 + bit(159)
                else:
                    v = 7 + 2 * bit(165)
                    v += bit(145)
            else:
                b1 = bit(p[8])
                cat = 2 * b1 + bit(p[9 + b1])
                v = 0
                for q in _CAT[cat]:
                    v = v + v + bit(q)
                v += 3 + (8 << cat)
            nxt = 2
        if bit(128):
            v = -v
        out[base + _ZIGZAG[n]] = v * dq[1 if n > 0 else 0]
        n += 1
        if n < 16:
            p = probs[_BANDS[n]][nxt]
    return 16


def _parse_tokens(vp8: bytes, f: Frame):
    """Every macroblock's dequantised coefficients, [n_mb, 25, 16] in
    raster order (blocks 0-15 Y, 16-19 U, 20-23 V, 24 Y2), and whether it
    holds any nonzero coefficient after the Y2 transform (libwebp's rule
    for the inner loop-filter edges)."""
    h = f._h
    mb_w, mb_h = f.mb_w, f.mb_h
    coeff = [0] * (mb_w * mb_h * 400)
    nonzero = np.zeros((mb_h, mb_w), bool)
    probs = h.probs
    p_i16, p_y2, p_uv, p_i4 = probs[0], probs[1], probs[2], probs[3]
    # Above contexts per MB column: 4 Y, 2 U, 2 V flags and the Y2 flag.
    t_y = [0] * (4 * mb_w)
    t_u = [0] * (2 * mb_w)
    t_v = [0] * (2 * mb_w)
    t_dc = [0] * mb_w
    readers = [BoolReader(vp8, s, e) for s, e in h.parts]
    for my in range(mb_h):
        br = readers[my & (h.num_parts - 1)]
        l_y, l_u, l_v, l_dc = [0] * 4, [0] * 2, [0] * 2, 0
        for mx in range(mb_w):
            base = (my * mb_w + mx) * 400
            i4 = bool(f.is_i4[my, mx])
            if f.skip[my, mx]:
                t_y[4 * mx:4 * mx + 4] = [0] * 4
                t_u[2 * mx:2 * mx + 2] = [0] * 2
                t_v[2 * mx:2 * mx + 2] = [0] * 2
                l_y, l_u, l_v = [0] * 4, [0] * 2, [0] * 2
                if not i4:
                    t_dc[mx] = l_dc = 0
                continue
            q = h.quant[int(f.segment[my, mx])]
            nzc = False
            if not i4:
                nz = _coeffs(br, p_y2, t_dc[mx] + l_dc, 0, q[1], coeff,
                             base + 384)
                t_dc[mx] = l_dc = int(nz > 0)
                first, py = 1, p_i16
                # The Y2 transform feeds the DCs of the 16 Y blocks.
                dcs = _iwht(coeff[base + 384:base + 400])
                for k in range(16):
                    coeff[base + 16 * k] = dcs[k]
                nzc = any(dcs)
            else:
                first, py = 0, p_i4
            for r in range(4):
                lf = l_y[r]
                for c in range(4):
                    o = base + 16 * (4 * r + c)
                    nz = _coeffs(br, py, lf + t_y[4 * mx + c], first, q[0],
                                 coeff, o)
                    lf = int(nz > first)
                    t_y[4 * mx + c] = lf
                    nzc = nzc or nz > 1 or coeff[o] != 0
                l_y[r] = lf
            for plane, (tt, ll) in enumerate(((t_u, l_u), (t_v, l_v))):
                for r in range(2):
                    lf = ll[r]
                    for c in range(2):
                        o = base + 256 + 64 * plane + 16 * (2 * r + c)
                        nz = _coeffs(br, p_uv, lf + tt[2 * mx + c], 0, q[2],
                                     coeff, o)
                        lf = int(nz > 0)
                        tt[2 * mx + c] = lf
                        nzc = nzc or nz > 1 or coeff[o] != 0
                    ll[r] = lf
            nonzero[my, mx] = nzc
    return np.array(coeff, np.int32).reshape(mb_h * mb_w, 25, 16), nonzero


def _iwht(c: list) -> list:
    """The inverse Walsh-Hadamard transform of the Y2 block (raster
    order) -> the 16 Y blocks' DC coefficients."""
    tmp = [0] * 16
    for i in range(4):
        a0 = c[i] + c[12 + i]
        a1 = c[4 + i] + c[8 + i]
        a2 = c[4 + i] - c[8 + i]
        a3 = c[i] - c[12 + i]
        tmp[i], tmp[8 + i] = a0 + a1, a0 - a1
        tmp[4 + i], tmp[12 + i] = a3 + a2, a3 - a2
    out = [0] * 16
    for i in range(4):
        dc = tmp[4 * i] + 3
        a0 = dc + tmp[4 * i + 3]
        a1 = tmp[4 * i + 1] + tmp[4 * i + 2]
        a2 = tmp[4 * i + 1] - tmp[4 * i + 2]
        a3 = dc - tmp[4 * i + 3]
        out[4 * i] = (a0 + a1) >> 3
        out[4 * i + 1] = (a3 + a2) >> 3
        out[4 * i + 2] = (a0 - a1) >> 3
        out[4 * i + 3] = (a3 - a2) >> 3
    return out


def _idct(c: np.ndarray) -> np.ndarray:
    """The inverse DCT of RFC 6386 section 14.3 over [..., 16] raster
    blocks -> the residual [..., 4, 4] added to the prediction."""
    c = c.astype(np.int64).reshape(c.shape[:-1] + (4, 4))

    def mul1(a):
        return ((a * 20091) >> 16) + a

    def mul2(a):
        return (a * 35468) >> 16

    # Vertical pass over the columns.
    i0, i1, i2, i3 = c[..., 0, :], c[..., 1, :], c[..., 2, :], c[..., 3, :]
    a, b = i0 + i2, i0 - i2
    cc, d = mul2(i1) - mul1(i3), mul1(i1) + mul2(i3)
    t = np.stack([a + d, b + cc, b - cc, a - d], axis=-2)   # [..., row, col]
    # Horizontal pass over the rows.
    j0, j1, j2, j3 = t[..., 0] + 4, t[..., 1], t[..., 2], t[..., 3]
    a, b = j0 + j2, j0 - j2
    cc, d = mul2(j1) - mul1(j3), mul1(j1) + mul2(j3)
    return (np.stack([a + d, b + cc, b - cc, a - d], axis=-1) >> 3).astype(
        np.int32)


def _avg3(a, b, c):
    return (a + 2 * b + c + 2) >> 2


def _avg2(a, b):
    return (a + b + 1) >> 1


def _pred4(m: int, top: list, left: list, tl: int) -> list:
    """A 4x4 prediction, rows of 4, from the 8 pixels above (4 and 4
    above-right), the 4 to the left and the corner."""
    A, B, C, D, E, F, G, H = top
    I, J, K, L = left
    X = tl
    if m == DC:
        v = (A + B + C + D + I + J + K + L + 4) >> 3
        return [[v] * 4 for _ in range(4)]
    if m == TM:
        return [[min(255, max(0, lv + t - X)) for t in (A, B, C, D)]
                for lv in (I, J, K, L)]
    if m == VE:
        row = [_avg3(X, A, B), _avg3(A, B, C), _avg3(B, C, D), _avg3(C, D, E)]
        return [row[:] for _ in range(4)]
    if m == HE:
        return [[v] * 4 for v in (_avg3(X, I, J), _avg3(I, J, K),
                                  _avg3(J, K, L), _avg3(K, L, L))]
    o = [[0] * 4 for _ in range(4)]
    if m == RD:
        e = [L, K, J, I, X, A, B, C, D]
        for r in range(4):
            for c in range(4):
                k = 4 - r + c
                o[r][c] = _avg3(e[k - 1], e[k], e[k + 1])
    elif m == LD:
        t = [A, B, C, D, E, F, G, H, H]
        for r in range(4):
            for c in range(4):
                k = r + c
                o[r][c] = _avg3(t[k], t[k + 1], t[k + 2])
    elif m == VR:
        o[0] = [_avg2(X, A), _avg2(A, B), _avg2(B, C), _avg2(C, D)]
        o[1] = [_avg3(I, X, A), _avg3(X, A, B), _avg3(A, B, C),
                _avg3(B, C, D)]
        o[2] = [_avg3(J, I, X), o[0][0], o[0][1], o[0][2]]
        o[3] = [_avg3(K, J, I), o[1][0], o[1][1], o[1][2]]
    elif m == VL:
        o[0] = [_avg2(A, B), _avg2(B, C), _avg2(C, D), _avg2(D, E)]
        o[1] = [_avg3(A, B, C), _avg3(B, C, D), _avg3(C, D, E),
                _avg3(D, E, F)]
        o[2] = [o[0][1], o[0][2], o[0][3], _avg3(E, F, G)]
        o[3] = [o[1][1], o[1][2], o[1][3], _avg3(F, G, H)]
    elif m == HD:
        o[0] = [_avg2(I, X), _avg3(I, X, A), _avg3(X, A, B), _avg3(A, B, C)]
        o[1] = [_avg2(J, I), _avg3(J, I, X), o[0][0], o[0][1]]
        o[2] = [_avg2(K, J), _avg3(K, J, I), o[1][0], o[1][1]]
        o[3] = [_avg2(L, K), _avg3(L, K, J), o[2][0], o[2][1]]
    elif m == HU:
        o[0] = [_avg2(I, J), _avg3(I, J, K), _avg2(J, K), _avg3(J, K, L)]
        o[1] = [o[0][2], o[0][3], _avg2(K, L), _avg3(K, L, L)]
        o[2] = [o[1][2], o[1][3], L, L]
        o[3] = [L, L, L, L]
    else:
        raise ValueError(f"4x4 mode {m}")
    return o


def _pred_block(m: int, n: int, top, left, tl: int, has_top: bool,
                has_left: bool) -> np.ndarray:
    """A 16x16 (n=16) or 8x8 (n=8) prediction: DC, TM, V or H."""
    shift = 4 if n == 16 else 3
    if m == DC:
        if has_top and has_left:
            v = (int(top.sum()) + int(left.sum()) + n) >> (shift + 1)
        elif has_top:
            v = (int(top.sum()) + n // 2) >> shift
        elif has_left:
            v = (int(left.sum()) + n // 2) >> shift
        else:
            v = 128
        return np.full((n, n), v, np.int32)
    if m == TM:
        return np.clip(left[:, None] + top[None, :] - tl, 0, 255)
    if m == VE:
        return np.broadcast_to(top[None, :], (n, n))
    if m == HE:
        return np.broadcast_to(left[:, None], (n, n))
    raise ValueError(f"block mode {m}")


def _edges(plane: np.ndarray, y0: int, x0: int, n: int, mb_x: int,
           mb_y: int):
    """The row above, the column to the left and the corner of an n x n
    block at (y0, x0) of an unfiltered plane, with libwebp's fills: 127
    above the first MB row (the corner too), 129 left of the first MB
    column (the corner too below the first row)."""
    if mb_y > 0:
        top = plane[y0 - 1, x0:x0 + n].astype(np.int32)
    else:
        top = np.full(n, 127, np.int32)
    if mb_x > 0:
        left = plane[y0:y0 + n, x0 - 1].astype(np.int32)
    else:
        left = np.full(n, 129, np.int32)
    if mb_y == 0:
        tl = 127
    elif mb_x == 0:
        tl = 129
    else:
        tl = int(plane[y0 - 1, x0 - 1])
    return top, left, tl


def _reconstruct(f: Frame, coeff: np.ndarray):
    """Prediction plus residual, macroblock by macroblock in raster order
    -> unfiltered Y, U, V planes on the MB grid (uint8)."""
    mb_w, mb_h = f.mb_w, f.mb_h
    res = _idct(coeff[:, :24]).reshape(mb_h, mb_w, 24, 4, 4)
    Y = np.zeros((16 * mb_h, 16 * mb_w), np.int32)
    U = np.zeros((8 * mb_h, 8 * mb_w), np.int32)
    V = np.zeros((8 * mb_h, 8 * mb_w), np.int32)
    for my in range(mb_h):
        for mx in range(mb_w):
            r = res[my, mx]
            y0, x0 = 16 * my, 16 * mx
            ry = r[:16].reshape(4, 4, 4, 4).transpose(0, 2, 1, 3).reshape(16, 16)
            if f.is_i4[my, mx]:
                _reconstruct_i4(Y, y0, x0, mx, my, mb_w, f.bmodes[my, mx], ry)
            else:
                top, left, tl = _edges(Y, y0, x0, 16, mx, my)
                p = _pred_block(int(f.ymode[my, mx]), 16, top, left, tl,
                                my > 0, mx > 0)
                Y[y0:y0 + 16, x0:x0 + 16] = np.clip(p + ry, 0, 255)
            m = int(f.uvmode[my, mx])
            for plane, blocks in ((U, r[16:20]), (V, r[20:24])):
                rc = blocks.reshape(2, 2, 4, 4).transpose(0, 2, 1, 3).reshape(8, 8)
                top, left, tl = _edges(plane, 8 * my, 8 * mx, 8, mx, my)
                p = _pred_block(m, 8, top, left, tl, my > 0, mx > 0)
                plane[8 * my:8 * my + 8, 8 * mx:8 * mx + 8] = np.clip(
                    p + rc, 0, 255)
    return Y.astype(np.uint8), U.astype(np.uint8), V.astype(np.uint8)


def _reconstruct_i4(Y, y0, x0, mx, my, mb_w, modes, ry):
    """An I4 macroblock: 16 subblocks in raster order, each predicted from
    the pixels reconstructed before it. Above-right of the rightmost
    subblock column is always the MB above-right's bottom row (the above
    MB's last pixel repeated in the last MB column; 127 in the first MB
    row)."""
    # b: rows 0..16, cols 0..20: row 0 the pixels above (col 0 the corner,
    # 17..20 above-right), col 0 the pixels to the left.
    b = [[0] * 21 for _ in range(17)]
    if my > 0:
        b[0][1:17] = Y[y0 - 1, x0:x0 + 16].tolist()
        if mx < mb_w - 1:
            b[0][17:21] = Y[y0 - 1, x0 + 16:x0 + 20].tolist()
        else:
            b[0][17:21] = [int(Y[y0 - 1, x0 + 15])] * 4
        b[0][0] = int(Y[y0 - 1, x0 - 1]) if mx > 0 else 129
    else:
        b[0] = [127] * 21
    if mx > 0:
        col = Y[y0:y0 + 16, x0 - 1].tolist()
    else:
        col = [129] * 16
    for i in range(16):
        b[i + 1][0] = col[i]
    for i in (4, 8, 12):
        b[i][17:21] = b[0][17:21]
    rl = ry.tolist()
    for k in range(16):
        r, c = k >> 2, k & 3
        ys, xs = 4 * r, 4 * c
        top = b[ys][xs + 1:xs + 9]
        left = [b[ys + 1 + i][xs] for i in range(4)]
        p = _pred4(int(modes[k]), top, left, b[ys][xs])
        for i in range(4):
            row = b[ys + 1 + i]
            rr = rl[ys + i]
            for j in range(4):
                v = p[i][j] + rr[xs + j]
                row[xs + 1 + j] = 0 if v < 0 else (255 if v > 255 else v)
    Y[y0:y0 + 16, x0:x0 + 16] = np.array([row[1:17] for row in b[1:]],
                                         np.int32)


# --- the loop filter (RFC 6386 section 15, libwebp dsp/dec.c) ---------------

def _filter_params(f: Frame, nonzero: np.ndarray):
    """Per MB (limit, interior limit, hev threshold, inner edges) with
    limit 0 where the MB is not filtered."""
    h = f._h
    out = np.zeros((f.mb_h, f.mb_w, 4), np.int32)
    for my in range(f.mb_h):
        for mx in range(f.mb_w):
            s = int(f.segment[my, mx])
            i4 = bool(f.is_i4[my, mx])
            if h.use_segment:
                level = h.seg_filter[s] + (0 if h.absolute else h.level)
            else:
                level = h.level
            if h.use_lf_delta:
                level += h.ref_lf_delta[0]
                if i4:
                    level += h.mode_lf_delta[0]
            level = min(63, max(0, level))
            inner = int(i4 or bool(nonzero[my, mx]))
            if level == 0:
                out[my, mx] = (0, 0, 0, inner)
                continue
            ilevel = level
            if h.sharpness > 0:
                ilevel >>= 2 if h.sharpness > 4 else 1
                ilevel = min(ilevel, 9 - h.sharpness)
            ilevel = max(ilevel, 1)
            hev = 2 if level >= 40 else (1 if level >= 15 else 0)
            out[my, mx] = (2 * level + ilevel, ilevel, hev, inner)
    return out


def _sclip1(v):
    return np.clip(v, -128, 127)


def _sclip2(v):
    return np.clip(v, -16, 15)


def _clip1(v):
    return np.clip(v, 0, 255)


def _filter_lines(P: np.ndarray, thresh, ilevel, hev_t,
                  mb_edge: bool) -> np.ndarray:
    """The normal filter across one edge: P [lines, 8] int32 holds
    p3 p2 p1 p0 q0 q1 q2 q3 of each line, thresh, ilevel and hev_t one
    value per line; returns the filtered lines."""
    p3, p2, p1, p0, q0, q1, q2, q3 = P.T
    need = ((4 * np.abs(p0 - q0) + np.abs(p1 - q1)) <= 2 * thresh + 1) \
        & (np.maximum.reduce([np.abs(p3 - p2), np.abs(p2 - p1),
                              np.abs(p1 - p0), np.abs(q3 - q2),
                              np.abs(q2 - q1), np.abs(q1 - q0)]) <= ilevel)
    hev = np.maximum(np.abs(p1 - p0), np.abs(q1 - q0)) > hev_t
    out = P.copy()
    # hev lines: the 2-tap filter (DoFilter2).
    a = 3 * (q0 - p0) + _sclip1(p1 - q1)
    a1 = _sclip2((a + 4) >> 3)
    a2 = _sclip2((a + 3) >> 3)
    f2 = need & hev
    out[f2, 3] = _clip1(p0 + a2)[f2]
    out[f2, 4] = _clip1(q0 - a1)[f2]
    rest = need & ~hev
    if mb_edge:
        # DoFilter6.
        a = _sclip1(a)
        w1 = (27 * a + 63) >> 7
        w2 = (18 * a + 63) >> 7
        w3 = (9 * a + 63) >> 7
        out[rest, 1] = _clip1(p2 + w3)[rest]
        out[rest, 2] = _clip1(p1 + w2)[rest]
        out[rest, 3] = _clip1(p0 + w1)[rest]
        out[rest, 4] = _clip1(q0 - w1)[rest]
        out[rest, 5] = _clip1(q1 - w2)[rest]
        out[rest, 6] = _clip1(q2 - w3)[rest]
    else:
        # DoFilter4.
        a = 3 * (q0 - p0)
        a1 = _sclip2((a + 4) >> 3)
        a2 = _sclip2((a + 3) >> 3)
        a3 = (a1 + 1) >> 1
        out[rest, 2] = _clip1(p1 + a3)[rest]
        out[rest, 3] = _clip1(p0 + a2)[rest]
        out[rest, 4] = _clip1(q0 - a1)[rest]
        out[rest, 5] = _clip1(q1 - a3)[rest]
    return out


def _simple_lines(P: np.ndarray, thresh, ilevel, hev_t,
                  mb_edge: bool) -> np.ndarray:
    """The simple filter across one edge, on the same [lines, 8] layout
    (only p1 p0 q0 q1 are read and p0 q0 written)."""
    p1, p0, q0, q1 = P[:, 2], P[:, 3], P[:, 4], P[:, 5]
    need = (4 * np.abs(p0 - q0) + np.abs(p1 - q1)) <= 2 * thresh + 1
    out = P.copy()
    a = 3 * (q0 - p0) + _sclip1(p1 - q1)
    out[need, 3] = _clip1(p0 + _sclip2((a + 3) >> 3))[need]
    out[need, 4] = _clip1(q0 - _sclip2((a + 4) >> 3))[need]
    return out


# One macroblock's edges in filter order: (direction, offset, which MBs,
# MB edge): the left MB edge, the inner vertical edges, the top MB edge,
# the inner horizontal edges. Chroma has one inner edge each way (4).
_STEPS = (("v", 0, "left", True), ("v", 4, "inner", False),
          ("v", 8, "inner", False), ("v", 12, "inner", False),
          ("h", 0, "top", True), ("h", 4, "inner", False),
          ("h", 8, "inner", False), ("h", 12, "inner", False))
_TAPS = np.arange(-4, 4)


def _loop_filter(f: Frame, planes: list, params: np.ndarray) -> None:
    """The loop filter, in place on int32 planes. Its order is raster
    order over macroblocks (each MB: _STEPS). An MB's filters read and
    write only pixels within 4 of its own, so the MBs of one wave
    x + 2y = t touch disjoint pixels, and every MB that overlaps them and
    comes earlier in raster order lies on an earlier wave: the waves, in
    order, each applied at once, give the raster order's result."""
    if f.filter_type == 1:
        planes = planes[:1]                       # the simple filter: luma
        lines = _simple_lines
    else:
        lines = _filter_lines
    flat = np.concatenate([p.ravel() for p in planes])
    offs = np.cumsum([0] + [p.size for p in planes])[:-1]
    scales = (16, 8, 8)
    yy = np.arange(f.mb_h)
    for t in range(f.mb_w + 2 * (f.mb_h - 1)):
        xx = t - 2 * yy
        ok = (xx >= 0) & (xx < f.mb_w)
        ys, xs = yy[ok], xx[ok]
        prm = params[ys, xs]
        on = prm[:, 0] > 0
        ys, xs, prm = ys[on], xs[on], prm[on]
        if not len(ys):
            continue
        which = {"left": xs > 0, "top": ys > 0, "inner": prm[:, 3] > 0}
        for d, k, who, mb_edge in _STEPS:
            sel = which[who]
            if not sel.any():
                continue
            idx, per = [], []
            for p, plane in enumerate(planes):
                n = scales[p]
                if k >= n:
                    continue
                stride = plane.shape[1]
                r0 = ys[sel] * n
                c0 = xs[sel] * n
                ln = np.arange(n)
                if d == "v":
                    rows = (r0[:, None] + ln)[:, :, None]
                    cols = (c0 + k)[:, None, None] + _TAPS
                else:
                    rows = (r0 + k)[:, None, None] + _TAPS
                    cols = (c0[:, None] + ln)[:, :, None]
                idx.append((offs[p] + rows * stride + cols).reshape(-1, 8))
                per.append(np.repeat(prm[sel], n, axis=0))
            idx = np.concatenate(idx)
            per = np.concatenate(per)
            limit = per[:, 0] + (4 if mb_edge else 0)
            flat[idx] = lines(flat[idx], limit, per[:, 1], per[:, 2],
                              mb_edge)
    for p, plane in enumerate(planes):
        plane[...] = flat[offs[p]:offs[p] + plane.size].reshape(plane.shape)


def decode_frame(vp8: bytes, loop_filter: bool = True) -> Frame:
    """Parses and reconstructs a key frame. loop_filter=False leaves the
    loop filter out (the decode cell's control)."""
    f = parse(vp8)
    coeff, nonzero = _parse_tokens(vp8, f)
    Y, U, V = _reconstruct(f, coeff)
    f.y_unfiltered, f.u_unfiltered, f.v_unfiltered = Y, U, V
    if f.filter_type and loop_filter:
        planes = [p.astype(np.int32) for p in (Y, U, V)]
        _loop_filter(f, planes, _filter_params(f, nonzero))
        f.y, f.u, f.v = (p.astype(np.uint8) for p in planes)
    else:
        f.y, f.u, f.v = Y, U, V
    return f


# --- output: fancy upsampling and YUV -> RGB (libwebp) ----------------------

def _upsample(c: np.ndarray, h: int, w: int) -> np.ndarray:
    """libwebp's fancy upsampler: chroma [ceil(h/2), ceil(w/2)] -> [h, w],
    each output pixel (9 near + 3 + 3 + 1 far) / 16 in its two-step
    rounding, the first and the last (even) row and column from one
    chroma row or column."""
    c = c.astype(np.int32)
    hc, wc = c.shape
    j = np.arange(h)
    k = (j + 1) >> 1
    near = np.where(j & 1, k - 1, k)
    far = np.where(j & 1, np.minimum(k, hc - 1), k - 1)
    far[0] = 0
    N, F = c[near], c[far]                     # [h, wc]
    out = np.empty((h, w), np.int32)
    out[:, 0] = (3 * N[:, 0] + F[:, 0] + 2) >> 2
    last_pair = (w - 1) >> 1
    if last_pair >= 1:
        x = np.arange(1, last_pair + 1)
        nn, nf = N[:, x - 1], N[:, x]
        fn, ff = F[:, x - 1], F[:, x]
        out[:, 2 * x - 1] = (((nn + 3 * nf + 3 * fn + ff + 8) >> 3) + nn) >> 1
        out[:, 2 * x] = (((nf + 3 * nn + 3 * ff + fn + 8) >> 3) + nf) >> 1
    if not w & 1:
        out[:, w - 1] = (3 * N[:, wc - 1] + F[:, wc - 1] + 2) >> 2
    return out


def _yuv_to_rgb(y, u, v) -> np.ndarray:
    """libwebp's VP8YUVToR/G/B (yuv.h), 14-bit fixed point."""
    def mult_hi(a, k):
        return (a * k) >> 8

    def clip8(a):
        return np.where((a & ~16383) == 0, a >> 6,
                        np.where(a < 0, 0, 255))

    yy = mult_hi(y, 19077)
    r = clip8(yy + mult_hi(v, 26149) - 14234)
    g = clip8(yy - mult_hi(u, 6419) - mult_hi(v, 13320) + 8708)
    b = clip8(yy + mult_hi(u, 33050) - 17685)
    return np.stack([r, g, b], axis=-1).astype(np.uint8)


def to_rgb(f: Frame) -> np.ndarray:
    """uint8 [height, width, 3], as libwebp's RGB output."""
    h, w = f.height, f.width
    y = f.y[:h, :w].astype(np.int32)
    hc, wc = (h + 1) >> 1, (w + 1) >> 1
    u = _upsample(f.u[:hc, :wc], h, w)
    v = _upsample(f.v[:hc, :wc], h, w)
    return _yuv_to_rgb(y, u, v)


def decode_rgb(data: bytes, loop_filter: bool = True) -> np.ndarray:
    """RGB uint8 [h, w, 3] of a simple lossy WebP file."""
    return to_rgb(decode_frame(vp8_payload(data), loop_filter))
