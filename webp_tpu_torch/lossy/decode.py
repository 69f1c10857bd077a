"""VP8 (lossy) keyframe decoder.

Host entropy decode (boolean coder: headers, modes, DCT tokens) producing
batched coefficient arrays, then reconstruction (intra predict + IDCT),
loop filter, and fancy upsampling. Reconstruction/filter/upsample have exact
numpy versions here; the device versions (PyTorch) live in
webp_tpu_torch.ops and are validated against these.

Behavioral parity with the reference's internal/lossy/{decode.go,
decode_frame.go,decode_mb.go,decode_tree.go,decode_quant.go}.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

from ..bitio.bool import BoolReader
from ..container.riff import WebPError
from . import dsp
from . import tables as T


class VP8Error(WebPError):
    pass


@dataclass
class SegmentHeader:
    use_segment: bool = False
    update_map: bool = False
    absolute_delta: bool = True
    quantizer: list = field(default_factory=lambda: [0] * 4)
    filter_strength: list = field(default_factory=lambda: [0] * 4)


@dataclass
class FilterHeader:
    simple: bool = False
    level: int = 0
    sharpness: int = 0
    use_lf_delta: bool = False
    ref_lf_delta: list = field(default_factory=lambda: [0] * 4)
    mode_lf_delta: list = field(default_factory=lambda: [0] * 4)


@dataclass
class QuantMatrix:
    y1_dc: int = 0
    y1_ac: int = 0
    y2_dc: int = 0
    y2_ac: int = 0
    uv_dc: int = 0
    uv_ac: int = 0


@dataclass
class FilterInfo:
    limit: int = 0
    ilevel: int = 0
    hev_thresh: int = 0
    inner: bool = False


def _read_optional_signed(br: BoolReader, nbits: int) -> int:
    return br.get_signed_value(nbits) if br.get_bit(0x80) else 0


class VP8Decoder:
    """Decodes one VP8 keyframe bitstream to Y/U/V planes."""

    def __init__(self, data: bytes):
        self.data = data
        self._parse_headers()

    # ------------------------------------------------------------------
    def _parse_headers(self) -> None:
        data = self.data
        if len(data) < 10:
            raise VP8Error("vp8: truncated header")
        bits = data[0] | data[1] << 8 | data[2] << 16
        if bits & 1:
            raise VP8Error("vp8: not a keyframe")
        self.profile = (bits >> 1) & 7
        if self.profile > 3:
            raise VP8Error("vp8: bad profile")
        if not ((bits >> 4) & 1):
            raise VP8Error("vp8: frame not displayable")
        part0_len = bits >> 5
        if data[3] != 0x9D or data[4] != 0x01 or data[5] != 0x2A:
            raise VP8Error("vp8: bad signature")
        self.width = (data[6] | data[7] << 8) & 0x3FFF
        self.height = (data[8] | data[9] << 8) & 0x3FFF
        if self.width == 0 or self.height == 0:
            raise VP8Error("vp8: zero dimensions")
        self.mb_w = (self.width + 15) >> 4
        self.mb_h = (self.height + 15) >> 4

        buf = data[10:]
        if part0_len > len(buf):
            raise VP8Error("vp8: bad partition 0 length")
        br = BoolReader(buf[:part0_len])
        self.br = br
        token_buf = buf[part0_len:]

        self.colorspace = br.get_bit(0x80)
        self.clamp_type = br.get_bit(0x80)

        # Segment header (¶9.3).
        seg = SegmentHeader()
        self.seg_hdr = seg
        self.segment_probs = [255, 255, 255]
        seg.use_segment = br.get_bit(0x80) != 0
        if seg.use_segment:
            seg.update_map = br.get_bit(0x80) != 0
            if br.get_bit(0x80):  # update data
                seg.absolute_delta = br.get_bit(0x80) != 0
                for s in range(4):
                    seg.quantizer[s] = _read_optional_signed(br, 7)
                for s in range(4):
                    seg.filter_strength[s] = _read_optional_signed(br, 6)
            if seg.update_map:
                for s in range(3):
                    if br.get_bit(0x80):
                        self.segment_probs[s] = br.get_value(8)

        # Filter header (¶9.4).
        fh = FilterHeader()
        self.filter_hdr = fh
        fh.simple = br.get_bit(0x80) != 0
        fh.level = br.get_value(6)
        fh.sharpness = br.get_value(3)
        fh.use_lf_delta = br.get_bit(0x80) != 0
        if fh.use_lf_delta:
            if br.get_bit(0x80):  # update deltas
                for i in range(4):
                    if br.get_bit(0x80):
                        fh.ref_lf_delta[i] = br.get_signed_value(6)
                for i in range(4):
                    if br.get_bit(0x80):
                        fh.mode_lf_delta[i] = br.get_signed_value(6)
        self.filter_type = 0 if fh.level == 0 else (1 if fh.simple else 2)

        # Token partitions (¶9.5).
        num_parts = 1 << br.get_value(2)
        last = num_parts - 1
        if len(token_buf) < 3 * last:
            raise VP8Error("vp8: truncated partition sizes")
        self.parts: List[BoolReader] = []
        start = 3 * last
        off = 0
        for p in range(last):
            psize = token_buf[p * 3] | token_buf[p * 3 + 1] << 8 | token_buf[p * 3 + 2] << 16
            if start + off + psize > len(token_buf):
                raise VP8Error("vp8: partition overflow")
            self.parts.append(BoolReader(token_buf[start + off : start + off + psize]))
            off += psize
        self.parts.append(BoolReader(token_buf[start + off :]))
        self.num_parts = num_parts

        # Quantizer (¶9.6).
        base_q = br.get_value(7)
        dq_y1_dc = _read_optional_signed(br, 4)
        dq_y2_dc = _read_optional_signed(br, 4)
        dq_y2_ac = _read_optional_signed(br, 4)
        dq_uv_dc = _read_optional_signed(br, 4)
        dq_uv_ac = _read_optional_signed(br, 4)
        self.dqm: List[QuantMatrix] = []
        for s in range(4):
            if seg.use_segment:
                q = seg.quantizer[s]
                if not seg.absolute_delta:
                    q += base_q
            else:
                q = base_q
            clip = lambda v, m: max(0, min(m, v))
            m = QuantMatrix()
            m.y1_dc = int(T.DC_TABLE[clip(q + dq_y1_dc, 127)])
            m.y1_ac = int(T.AC_TABLE[clip(q, 127)])
            m.y2_dc = int(T.DC_TABLE[clip(q + dq_y2_dc, 127)]) * 2
            m.y2_ac = max(8, (int(T.AC_TABLE[clip(q + dq_y2_ac, 127)]) * 101581) >> 16)
            m.uv_dc = int(T.DC_TABLE[clip(q + dq_uv_dc, 117)])
            m.uv_ac = int(T.AC_TABLE[clip(q + dq_uv_ac, 127)])
            self.dqm.append(m)

        br.get_bit(0x80)  # update_proba flag (ignored for keyframes)

        # Coefficient probabilities (¶13).
        proba = T.COEFFS_PROBA0.copy()
        upd = T.COEFFS_UPDATE_PROBA
        for t in range(4):
            for b in range(8):
                for c in range(3):
                    for p in range(11):
                        if br.get_bit(int(upd[t, b, c, p])):
                            proba[t, b, c, p] = br.get_value(8)
        self.proba = proba
        self.use_skip_proba = br.get_bit(0x80) != 0
        self.skip_p = br.get_value(8) if self.use_skip_proba else 0

    # ------------------------------------------------------------------
    def _parse_intra_modes(self) -> None:
        """Parses per-MB segment/skip/mode records from partition 0."""
        br = self.br
        mb_w, mb_h = self.mb_w, self.mb_h
        self.segment = np.zeros((mb_h, mb_w), dtype=np.uint8)
        self.skip = np.zeros((mb_h, mb_w), dtype=bool)
        self.is_i4 = np.zeros((mb_h, mb_w), dtype=bool)
        self.imodes = np.zeros((mb_h, mb_w, 16), dtype=np.uint8)
        self.uvmode = np.zeros((mb_h, mb_w), dtype=np.uint8)

        tree = T.YMODES_INTRA4_TREE
        bprob = T.BMODE_PROBA
        sp = self.segment_probs
        top = np.zeros((mb_w, 4), dtype=np.uint8)  # B_DC = 0
        for mb_y in range(mb_h):
            left = np.zeros(4, dtype=np.uint8)
            for mb_x in range(mb_w):
                if self.seg_hdr.update_map:
                    if not br.get_bit(sp[0]):
                        seg = br.get_bit(sp[1])
                    else:
                        seg = 2 + br.get_bit(sp[2])
                    self.segment[mb_y, mb_x] = seg
                if self.use_skip_proba:
                    self.skip[mb_y, mb_x] = br.get_bit(self.skip_p) != 0
                if not br.get_bit(145):
                    # 4x4 modes.
                    self.is_i4[mb_y, mb_x] = True
                    for y in range(4):
                        ymode = left[y]
                        for x in range(4):
                            prob = bprob[top[mb_x, x], ymode]
                            i = tree[br.get_bit(int(prob[0]))]
                            while i > 0:
                                i = tree[2 * i + br.get_bit(int(prob[i]))]
                            ymode = -i
                            top[mb_x, x] = ymode
                            self.imodes[mb_y, mb_x, y * 4 + x] = ymode
                        left[y] = ymode
                else:
                    if br.get_bit(156):
                        ymode = dsp.TM_PRED if br.get_bit(128) else dsp.H_PRED
                    else:
                        ymode = dsp.V_PRED if br.get_bit(163) else dsp.DC_PRED
                    self.imodes[mb_y, mb_x, 0] = ymode
                    top[mb_x, :] = ymode
                    left[:] = ymode
                # UV mode.
                if not br.get_bit(142):
                    uv = dsp.DC_PRED
                elif not br.get_bit(114):
                    uv = dsp.V_PRED
                else:
                    uv = dsp.TM_PRED if br.get_bit(183) else dsp.H_PRED
                self.uvmode[mb_y, mb_x] = uv

    # ------------------------------------------------------------------
    def _get_coeffs(self, br: BoolReader, ptype: int, ctx: int, dq0: int,
                    dq1: int, n: int, out: np.ndarray) -> int:
        """Token-decodes one 4x4 block (dequantized, into natural order)."""
        proba = self.proba
        bands = T.BANDS
        zigzag = T.ZIGZAG
        p = proba[ptype, bands[n], ctx]
        while n < 16:
            if not br.get_bit(int(p[0])):
                return n
            while not br.get_bit(int(p[1])):
                n += 1
                if n == 16:
                    return 16
                p = proba[ptype, bands[n], 0]
            if not br.get_bit(int(p[2])):
                v = 1
                next_ctx = 1
            else:
                if not br.get_bit(int(p[3])):
                    if not br.get_bit(int(p[4])):
                        v = 2
                    else:
                        v = 3 + br.get_bit(int(p[5]))
                else:
                    if not br.get_bit(int(p[6])):
                        if not br.get_bit(int(p[7])):
                            v = 5 + br.get_bit(159)
                        else:
                            v = 7 + 2 * br.get_bit(165)
                            v += br.get_bit(145)
                    else:
                        bit1 = br.get_bit(int(p[8]))
                        bit0 = br.get_bit(int(p[9 + bit1]))
                        cat = 2 * bit1 + bit0
                        v = 0
                        for tp in T.CAT3456[cat]:
                            v = v + v + br.get_bit(tp)
                        v += 3 + (8 << cat)
                next_ctx = 2
            dq = dq0 if n == 0 else dq1
            sv = br.get_sign_applied(v)
            out[zigzag[n]] = sv * dq
            n += 1
            if n == 16:
                return 16
            p = proba[ptype, bands[n], next_ctx]
        return 16

    # ------------------------------------------------------------------
    def decode_coefficients(self) -> None:
        """Parses all residual tokens into self.coeffs [mbH, mbW, 24, 16]."""
        mb_w, mb_h = self.mb_w, self.mb_h
        self.coeffs = np.zeros((mb_h, mb_w, 24, 16), dtype=np.int32)
        self.nonzero_y = np.zeros((mb_h, mb_w), dtype=np.uint32)
        self.nonzero_uv = np.zeros((mb_h, mb_w), dtype=np.uint32)

        # nz contexts: per-MB-column top context, per-row left context.
        top_nz = np.zeros(mb_w, dtype=np.uint32)
        top_nz_dc = np.zeros(mb_w, dtype=np.uint8)
        buf = np.zeros(16, dtype=np.int32)
        dc_buf = np.zeros(16, dtype=np.int32)

        for mb_y in range(mb_h):
            br = self.parts[mb_y & (self.num_parts - 1)]
            left_nz = 0
            left_nz_dc = 0
            for mb_x in range(mb_w):
                if self.use_skip_proba and self.skip[mb_y, mb_x]:
                    left_nz = 0
                    top_nz[mb_x] = 0
                    if not self.is_i4[mb_y, mb_x]:
                        left_nz_dc = 0
                        top_nz_dc[mb_x] = 0
                    continue
                q = self.dqm[self.segment[mb_y, mb_x] & 3]
                dst = self.coeffs[mb_y, mb_x]
                nonzero_y = 0
                nonzero_uv = 0

                if not self.is_i4[mb_y, mb_x]:
                    # Y2 DC block (type 1).
                    dc_buf[:] = 0
                    ctx = int(top_nz_dc[mb_x]) + left_nz_dc
                    nz = self._get_coeffs(br, 1, ctx, q.y2_dc, q.y2_ac, 0, dc_buf)
                    nz_dc = 1 if nz > 0 else 0
                    top_nz_dc[mb_x] = nz_dc
                    left_nz_dc = nz_dc
                    # Inverse WHT scatters DCs into the 16 luma blocks.
                    dcs = dsp.wht4x4(dc_buf.reshape(4, 4))
                    dst[:16, 0] = dcs.reshape(16)
                    first = 1
                    ptype = 0
                else:
                    first = 0
                    ptype = 3

                # Luma AC.
                tnz = int(top_nz[mb_x]) & 0x0F
                lnz = left_nz & 0x0F
                for y in range(4):
                    l = lnz & 1
                    nz_coeffs = 0
                    for x in range(4):
                        bi = y * 4 + x
                        ctx = l + (tnz & 1)
                        buf[:] = dst[bi]
                        nz = self._get_coeffs(br, ptype, ctx, q.y1_dc, q.y1_ac,
                                              first, buf)
                        dst[bi] = buf
                        l = 1 if nz > first else 0
                        tnz = (tnz >> 1) | (l << 7)
                        dc_nz = 1 if buf[0] != 0 else 0
                        nz_coeffs = self._nz_code(nz_coeffs, nz, dc_nz)
                    tnz >>= 4
                    lnz = (lnz >> 1) | (l << 7)
                    nonzero_y = ((nonzero_y << 8) | nz_coeffs) & 0xFFFFFFFF
                out_tnz = tnz
                out_lnz = lnz >> 4

                # Chroma.
                for ch in (0, 2):
                    nz_coeffs = 0
                    tnz = int(top_nz[mb_x]) >> (4 + ch)
                    lnz = left_nz >> (4 + ch)
                    for y in range(2):
                        l = lnz & 1
                        for x in range(2):
                            bi = 16 + ch * 2 + y * 2 + x
                            ctx = l + (tnz & 1)
                            buf[:] = 0
                            nz = self._get_coeffs(br, 2, ctx, q.uv_dc, q.uv_ac,
                                                  0, buf)
                            dst[bi] = buf
                            l = 1 if nz > 0 else 0
                            tnz = (tnz >> 1) | (l << 3)
                            dc_nz = 1 if buf[0] != 0 else 0
                            nz_coeffs = self._nz_code(nz_coeffs, nz, dc_nz)
                        tnz >>= 2
                        lnz = (lnz >> 1) | (l << 5)
                    nonzero_uv |= nz_coeffs << (4 * ch)
                    out_tnz |= ((tnz << 4) << ch) & 0xFFFFFFFF
                    out_lnz |= (lnz & 0xF0) << ch

                top_nz[mb_x] = out_tnz
                left_nz = out_lnz
                self.nonzero_y[mb_y, mb_x] = nonzero_y
                self.nonzero_uv[mb_y, mb_x] = nonzero_uv
                if br.eof:
                    raise VP8Error("vp8: premature EOF in tokens")

    @staticmethod
    def _nz_code(nz_coeffs: int, nz: int, dc_nz: int) -> int:
        nz_coeffs <<= 2
        nz_coeffs |= 3 if nz > 3 else (2 if nz > 1 else dc_nz)
        return nz_coeffs

    # ------------------------------------------------------------------
    def reconstruct(self) -> None:
        """Intra-predict + IDCT-add every macroblock (numpy reference path)."""
        mb_w, mb_h = self.mb_w, self.mb_h
        Y = np.zeros((mb_h * 16, mb_w * 16), dtype=np.uint8)
        U = np.zeros((mb_h * 8, mb_w * 8), dtype=np.uint8)
        V = np.zeros((mb_h * 8, mb_w * 8), dtype=np.uint8)

        # Batched inverse DCT of every block (device-friendly: one shot).
        residuals = dsp.idct4x4(self.coeffs.reshape(mb_h, mb_w, 24, 4, 4))

        for mb_y in range(mb_h):
            for mb_x in range(mb_w):
                self._reconstruct_mb(Y, U, V, residuals, mb_x, mb_y)

        self.Y, self.U, self.V = Y, U, V

    def _mb_halo(self, plane: np.ndarray, x0: int, y0: int, size: int,
                 mb_x: int, mb_y: int, tr_count: int) -> np.ndarray:
        """Builds the (size+1, size+1+tr_count) halo buffer B:
        B[0,0]=topleft, B[0,1:]=top(+topright), B[1:,0]=left."""
        B = np.zeros((size + 1, size + 1 + tr_count), dtype=np.int32)
        if mb_y == 0:
            B[0, :] = 127
        else:
            B[0, 1 : size + 1] = plane[y0 - 1, x0 : x0 + size]
            B[0, 0] = plane[y0 - 1, x0 - 1] if mb_x > 0 else 129
            if tr_count:
                if mb_x >= self.mb_w - 1:
                    B[0, size + 1 :] = plane[y0 - 1, x0 + size - 1]
                else:
                    B[0, size + 1 :] = plane[y0 - 1, x0 + size : x0 + size + tr_count]
        if mb_x == 0:
            B[1:, 0] = 129
        else:
            B[1 : size + 1, 0] = plane[y0 : y0 + size, x0 - 1]
        return B

    def _reconstruct_mb(self, Y, U, V, residuals, mb_x: int, mb_y: int) -> None:
        y0, x0 = mb_y * 16, mb_x * 16
        res = residuals[mb_y, mb_x]
        B = self._mb_halo(Y, x0, y0, 16, mb_x, mb_y, 4)

        if self.is_i4[mb_y, mb_x]:
            modes = self.imodes[mb_y, mb_x]
            mb_tr = B[0, 17:21].copy()
            for n in range(16):
                r, c = n >> 2, n & 3
                top = B[r * 4, 1 + c * 4 : 5 + c * 4]
                left = B[1 + r * 4 : 5 + r * 4, c * 4]
                topleft = B[r * 4, c * 4]
                if c < 3:
                    tr = B[r * 4, 5 + c * 4 : 9 + c * 4]
                else:
                    tr = mb_tr
                pred = dsp.pred_luma4(int(modes[n]), top, left, int(topleft), tr)
                out = np.clip(pred + res[n], 0, 255)
                B[1 + r * 4 : 5 + r * 4, 1 + c * 4 : 5 + c * 4] = out
        else:
            mode = self._check_mode(mb_x, mb_y, int(self.imodes[mb_y, mb_x, 0]))
            pred = dsp.pred_block(mode, 16, B[0, 1:17], B[1:17, 0], int(B[0, 0]))
            out = np.clip(pred + res[:16].reshape(4, 4, 4, 4).transpose(0, 2, 1, 3).reshape(16, 16), 0, 255)
            B[1:17, 1:17] = out

        Y[y0 : y0 + 16, x0 : x0 + 16] = B[1:17, 1:17]

        # Chroma.
        uv_mode = self._check_mode(mb_x, mb_y, int(self.uvmode[mb_y, mb_x]))
        yc0, xc0 = mb_y * 8, mb_x * 8
        for plane, base in ((U, 16), (V, 20)):
            Bc = self._mb_halo(plane, xc0, yc0, 8, mb_x, mb_y, 0)
            pred = dsp.pred_block(uv_mode, 8, Bc[0, 1:9], Bc[1:9, 0], int(Bc[0, 0]))
            r = res[base : base + 4].reshape(2, 2, 4, 4).transpose(0, 2, 1, 3).reshape(8, 8)
            plane[yc0 : yc0 + 8, xc0 : xc0 + 8] = np.clip(pred + r, 0, 255)

    @staticmethod
    def _check_mode(mb_x: int, mb_y: int, mode: int) -> int:
        if mode == dsp.DC_PRED:
            if mb_x == 0:
                return dsp.DC_NO_TOPLEFT if mb_y == 0 else dsp.DC_NO_LEFT
            return dsp.DC_NO_TOP if mb_y == 0 else dsp.DC_PRED
        return mode

    # ------------------------------------------------------------------
    def _filter_strengths(self) -> list:
        """Per-segment, per-i4 filter params (decode_frame.go:220)."""
        fh = self.filter_hdr
        out = [[FilterInfo(), FilterInfo()] for _ in range(4)]
        for s in range(4):
            if self.seg_hdr.use_segment:
                base = self.seg_hdr.filter_strength[s]
                if not self.seg_hdr.absolute_delta:
                    base += fh.level
            else:
                base = fh.level
            for i4 in (0, 1):
                fi = out[s][i4]
                level = base
                if fh.use_lf_delta:
                    level += fh.ref_lf_delta[0]
                    if i4:
                        level += fh.mode_lf_delta[0]
                level = max(0, min(63, level))
                if level > 0:
                    ilevel = level
                    if fh.sharpness > 0:
                        ilevel >>= 2 if fh.sharpness > 4 else 1
                        ilevel = min(ilevel, 9 - fh.sharpness)
                    ilevel = max(1, ilevel)
                    fi.ilevel = ilevel
                    fi.limit = 2 * level + ilevel
                    fi.hev_thresh = 2 if level >= 40 else (1 if level >= 15 else 0)
                else:
                    fi.limit = 0
                fi.inner = i4 == 1
        return out

    def loop_filter(self) -> None:
        if self.filter_type == 0:
            return
        fstr = self._filter_strengths()
        Y, U, V = self.Y, self.U, self.V
        mb_w, mb_h = self.mb_w, self.mb_h
        for mb_y in range(mb_h):
            for mb_x in range(mb_w):
                seg = int(self.segment[mb_y, mb_x]) & 3
                i4 = bool(self.is_i4[mb_y, mb_x])
                fi = fstr[seg][1 if i4 else 0]
                # The inner-edge filter flag uses "MB actually has non-zero
                # coefficients" (libwebp: skip = ParseResiduals(...) return),
                # not just the bitstream skip flag.
                has_coeffs = bool(self.nonzero_y[mb_y, mb_x]
                                  | self.nonzero_uv[mb_y, mb_x])
                inner = fi.inner or has_coeffs
                limit = fi.limit
                if limit == 0:
                    continue
                x0, y0 = mb_x * 16, mb_y * 16
                xc0, yc0 = mb_x * 8, mb_y * 8
                if self.filter_type == 1:  # simple, luma only
                    if mb_x > 0:
                        dsp.filter_edge_simple(Y, False, x0, y0, 16, limit + 4)
                    if inner:
                        for k in (4, 8, 12):
                            dsp.filter_edge_simple(Y, False, x0 + k, y0, 16, limit)
                    if mb_y > 0:
                        dsp.filter_edge_simple(Y, True, y0, x0, 16, limit + 4)
                    if inner:
                        for k in (4, 8, 12):
                            dsp.filter_edge_simple(Y, True, y0 + k, x0, 16, limit)
                else:  # complex
                    il, hev = fi.ilevel, fi.hev_thresh
                    if mb_x > 0:
                        dsp.filter_edge_complex(Y, False, x0, y0, 16, limit + 4, il, hev, False)
                        dsp.filter_edge_complex(U, False, xc0, yc0, 8, limit + 4, il, hev, False)
                        dsp.filter_edge_complex(V, False, xc0, yc0, 8, limit + 4, il, hev, False)
                    if inner:
                        for k in (4, 8, 12):
                            dsp.filter_edge_complex(Y, False, x0 + k, y0, 16, limit, il, hev, True)
                        dsp.filter_edge_complex(U, False, xc0 + 4, yc0, 8, limit, il, hev, True)
                        dsp.filter_edge_complex(V, False, xc0 + 4, yc0, 8, limit, il, hev, True)
                    if mb_y > 0:
                        dsp.filter_edge_complex(Y, True, y0, x0, 16, limit + 4, il, hev, False)
                        dsp.filter_edge_complex(U, True, yc0, xc0, 8, limit + 4, il, hev, False)
                        dsp.filter_edge_complex(V, True, yc0, xc0, 8, limit + 4, il, hev, False)
                    if inner:
                        for k in (4, 8, 12):
                            dsp.filter_edge_complex(Y, True, y0 + k, x0, 16, limit, il, hev, True)
                        dsp.filter_edge_complex(U, True, yc0 + 4, xc0, 8, limit, il, hev, True)
                        dsp.filter_edge_complex(V, True, yc0 + 4, xc0, 8, limit, il, hev, True)

    # ------------------------------------------------------------------
    def decode(self) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Runs the full pipeline; returns cropped (Y, U, V) planes."""
        self._parse_intra_modes()
        self.decode_coefficients()
        self.reconstruct()
        self.loop_filter()
        w, h = self.width, self.height
        cw, ch = (w + 1) >> 1, (h + 1) >> 1
        return (self.Y[:h, :w], self.U[:ch, :cw], self.V[:ch, :cw])


def decode_vp8_yuv(data: bytes):
    """VP8 keyframe -> cropped (Y, U, V) uint8 planes, by the native
    decoder (built at first use; a failed build raises)."""
    from ..native import api as native

    (Y, U, V), (w, h) = native.vp8_decode(data)
    cw, ch = (w + 1) >> 1, (h + 1) >> 1
    return Y[:h, :w], U[:ch, :cw], V[:ch, :cw]


def decode_vp8_rgba(data: bytes, alpha_data: Optional[bytes] = None) -> np.ndarray:
    """Full VP8 decode to RGBA uint8 [h, w, 4], by the native decoder and
    its fancy upsampler; the alpha plane from an ALPH payload
    (lossy/alpha.py decode_alpha), else 255."""
    from ..native import api as native

    y, u, v = decode_vp8_yuv(data)
    rgba = native.native_upsample_rgba(y, u, v, 4)
    if alpha_data is not None:
        from .alpha import decode_alpha

        h, w = y.shape
        rgba[..., 3] = decode_alpha(alpha_data, w, h)
    return rgba
