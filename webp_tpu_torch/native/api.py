"""ctypes bindings for the port's three native libraries.

The encoder side (get()): a frame's tokens and partition 0, one call
each (lossy/frame.py), the closed-loop MB encode and the analysis
alphas (lossy/encode.py, the host backend and the escape-overflow
fallback), the RGB -> YUV 4:2:0 importer and an elementwise powf;
sources native/src/vp8_enc.cc, vp8_enc_loop.cc, yuv_import.cc,
powf_array.cc and bitio.h. Each call into it through a
wrapper here adds 1 to trace.NATIVE["calls"]; each releases the GIL
while it runs, so a pool thread retakes it once a call.

The decoder side (get_dec()): the VP8 keyframe decoder (vp8_decode), its
parse-only half for the device decode (vp8_parse), the loop filter's
SIMD self-test, the fancy-upsampling YUV 4:2:0 -> RGB(A) converter and
the VP8L decoder (vp8l_decode); sources native/src/vp8_dec.cc,
upsample.cc, vp8l_dec.cc and bitio.h.

The lossless encoder side (get_vp8l()): the VP8L entropy-image coder
(vp8l_encode_entropy_image), the per-tile predictor search
(vp8l_predictor_transform) and the cross-color search
(vp8l_cross_color); sources native/src/vp8l_enc.cc and
vp8l_predictor.cc.

All three are compiled with g++ at first use (webp_tpu_torch/_build.py); a
failed build raises.
"""

from __future__ import annotations

import ctypes as ct
import functools

import numpy as np

from .. import _build, trace


def _setup(lib):
    lib.vp8_write_partition0.argtypes = (
        [ct.c_int, ct.c_void_p] + [ct.c_int] * 7 + [ct.c_void_p] * 3
        + [ct.c_int] * 2 + [ct.c_void_p] * 7 + [ct.c_int] * 2
        + [ct.c_void_p, ct.c_long])
    lib.vp8_write_partition0.restype = ct.c_long
    lib.vp8_code_frame.argtypes = (
        [ct.c_void_p] * 4 + [ct.c_int] + [ct.c_void_p] * 3 + [ct.c_int] * 4
        + [ct.c_void_p] * 6 + [ct.c_long])
    lib.vp8_code_frame.restype = ct.c_long
    lib.vp8_encode_mbs.argtypes = [ct.c_void_p] * 3 + [ct.c_int] * 2 + \
        [ct.c_void_p] * 8 + [ct.c_int, ct.c_int, ct.c_int64] + \
        [ct.c_void_p] * 9
    lib.vp8_encode_mbs.restype = None
    lib.vp8_compute_alphas.argtypes = [ct.c_void_p] * 3 + [ct.c_int] * 2 + \
        [ct.c_void_p] * 2
    lib.vp8_compute_alphas.restype = None
    lib.yuv_import.argtypes = [
        ct.c_void_p, ct.c_int, ct.c_int,
        ct.c_void_p, ct.c_void_p, ct.c_void_p,
    ]
    lib.yuv_import.restype = None
    lib.powf_array.argtypes = [ct.c_void_p, ct.c_float, ct.c_void_p,
                               ct.c_long]
    lib.powf_array.restype = None
    return lib


_lib = None


def get():
    """The encoder-side library, built from native/src at first use into
    the package's _build/ directory (never the JAX package's prebuilt
    libwebptpu.so)."""
    global _lib
    if _lib is None:
        _lib = _setup(_build.load("webp_enc"))
    return _lib


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ct.c_void_p)


def _u8(a) -> np.ndarray:
    return np.ascontiguousarray(a, dtype=np.uint8)


@functools.lru_cache(maxsize=None)
def _enc_tables():
    """The spec tables partition 0 reads (lossy/tables.py): COEFFS_PROBA0,
    COEFFS_UPDATE_PROBA, BMODE_PROBA as uint8, YMODES_INTRA4_TREE as int8."""
    from ..lossy import tables as T

    return (_u8(T.COEFFS_PROBA0), _u8(T.COEFFS_UPDATE_PROBA),
            _u8(T.BMODE_PROBA),
            np.ascontiguousarray(T.YMODES_INTRA4_TREE, dtype=np.int8))


def _part0_cap(n_mb: int) -> int:
    """The first try's output buffer for partition 0: the header's
    at most ~2.2 KB and a few bytes an MB, with room to spare."""
    return 4096 + 32 * n_mb


def write_partition0(num_segments: int, seg_quant, seg_fstrength,
                     seg_probas, filter_simple: bool, filter_level: int,
                     filter_sharpness: int, log2_parts: int, base_q: int,
                     dq_uv_dc: int, dq_uv_ac: int, proba: np.ndarray,
                     use_skip: bool, skip_prob: int, imodes: np.ndarray,
                     is_i4: np.ndarray, uvmode: np.ndarray, skip: np.ndarray,
                     seg_map, mb_w: int, mb_h: int) -> bytes:
    """All of partition 0 (vp8_write_partition0 in native/src/vp8_enc.cc)
    in one native call: the frame header, the coefficient-probability
    updates of proba [4, 8, 3, 11] against COEFFS_PROBA0 and the MB modes
    (imodes [n_mb, 16], is_i4 / uvmode / skip [n_mb]; seg_map [n_mb] is
    read only when num_segments > 1, and may be None otherwise). A buffer
    too small for the first try is retried once at the size the call
    reports; the bytes are never truncated."""
    lib = get()
    p0, upd, bmode, tree = _enc_tables()
    hdr = np.array([*seg_quant, *seg_fstrength, *seg_probas], np.int32)
    pr = _u8(proba)
    im, i4, uv, sk = _u8(imodes), _u8(is_i4), _u8(uvmode), _u8(skip)
    seg = _u8(seg_map) if num_segments > 1 else None
    n_mb = mb_w * mb_h
    per_mb = [a.size for a in (i4, uv, sk, seg) if a is not None]
    if (hdr.size != 11 or pr.size != p0.size or im.size != 16 * n_mb
            or any(n != n_mb for n in per_mb)):
        raise ValueError("write_partition0: field sizes do not match "
                         f"{mb_w}x{mb_h} macroblocks")
    cap = _part0_cap(n_mb)
    for _ in range(2):
        out = np.empty(cap, dtype=np.uint8)
        trace.count(trace.NATIVE, "calls")
        n = lib.vp8_write_partition0(
            int(num_segments), _ptr(hdr), int(bool(filter_simple)),
            int(filter_level), int(filter_sharpness), int(log2_parts),
            int(base_q), int(dq_uv_dc), int(dq_uv_ac), _ptr(pr), _ptr(p0),
            _ptr(upd), int(bool(use_skip)), int(skip_prob), _ptr(im),
            _ptr(i4), _ptr(uv), _ptr(sk),
            None if seg is None else _ptr(seg), _ptr(bmode), _ptr(tree),
            int(mb_w), int(mb_h), _ptr(out), cap)
        if n >= 0:
            return out[:n].tobytes()
        cap = -n
    raise RuntimeError("native partition 0: the retry's buffer was short")


@functools.lru_cache(maxsize=None)
def _proba_tables():
    """The tables the coefficient probabilities are chosen by:
    COEFFS_PROBA0 and COEFFS_UPDATE_PROBA as uint8, ENTROPY_COST as
    int32 (lossy/cost.py bit_cost)."""
    from ..lossy import cost as C

    p0, upd = _enc_tables()[:2]
    return p0, upd, np.ascontiguousarray(C.ENTROPY_COST, dtype=np.int32)


def _tokens_cap(n_mb: int) -> int:
    """The first try's output buffer for a frame's token partitions: about
    a nibble a coefficient, the packed levels' own size."""
    return 4096 + 192 * n_mb


def code_frame(is_i4, skip, mb_w: int, mb_h: int, use_skip: bool,
               num_parts: int, levels=None, y2_levels=None, packed=None):
    """One frame's coefficient tokens in one native call (vp8_code_frame
    in native/src/vp8_enc.cc): the branch statistics, the coefficient
    probabilities chosen from them and every token partition (MB row r
    in partition r mod num_parts), from y2_levels [n_mb, 16] and the
    levels: dense, levels [n_mb, 24, 16] (read as int32), or the device's
    packed fields, packed = (packed u8 [n_mb, 24, 8], esc_idx i32 [K],
    esc_val i16 [K, 16], esc_cnt) (y2_levels read as int16), decoded MB
    by MB: no dense array is made. A buffer too small for the first try
    (_tokens_cap) is retried once at the size the call reports.
    Returns (the probabilities u8 [4, 8, 3, 11], the partitions' bytes).
    Raises ValueError on fields of another size or an escape list out of
    order, out of range or longer than its blocks."""
    lib = get()
    p0, upd, ec = _proba_tables()
    n_mb = mb_w * mb_h
    i4, sk = _u8(is_i4), _u8(skip)
    if packed is None:
        lv = np.ascontiguousarray(levels, dtype=np.int32)
        y2 = np.ascontiguousarray(y2_levels, dtype=np.int32)
        src = (_ptr(lv), None, None, None, 0)
        ok = lv.size == 384 * n_mb
    else:
        pk, idx, val, cnt = packed
        pk = _u8(pk)
        idx = np.ascontiguousarray(idx, dtype=np.int32)
        val = np.ascontiguousarray(val, dtype=np.int16)
        y2 = np.ascontiguousarray(y2_levels, dtype=np.int16)
        cnt = int(cnt)
        if not 0 <= cnt <= min(idx.size, val.size // 16):
            raise ValueError(f"code_frame: {cnt} escaped blocks, room for "
                             f"{min(idx.size, val.size // 16)}")
        src = (None, _ptr(pk), _ptr(idx), _ptr(val), cnt)
        ok = pk.size == 192 * n_mb
    if (not ok or y2.size != 16 * n_mb or i4.size != n_mb
            or sk.size != n_mb or num_parts not in (1, 2, 4, 8)):
        raise ValueError("code_frame: field sizes do not match "
                         f"{mb_w}x{mb_h} macroblocks and {num_parts} "
                         "partitions")
    proba = np.empty((4, 8, 3, 11), dtype=np.uint8)
    sizes = np.empty(num_parts, dtype=np.int64)
    cap = _tokens_cap(n_mb)
    for _ in range(2):
        out = np.empty(cap, dtype=np.uint8)
        trace.count(trace.NATIVE, "calls")
        n = lib.vp8_code_frame(
            *src, _ptr(y2), _ptr(i4), _ptr(sk), int(mb_w), int(mb_h),
            int(bool(use_skip)), int(num_parts), _ptr(p0), _ptr(upd),
            _ptr(ec), _ptr(proba), _ptr(sizes), _ptr(out), cap)
        if n == -1:
            raise ValueError("code_frame: the escape list is out of order "
                             "or out of range")
        if n >= 0:
            parts, o = [], 0
            for size in sizes.tolist():
                parts.append(out[o:o + size].tobytes())
                o += size
            return proba, parts
        cap = -n
    raise RuntimeError("native token coding: the retry's buffer was short")


def vp8_encode_mbs(srcY, srcU, srcV, mb_w, mb_h, seg_map, quant, lambdas,
                   proba, cost_tables, method, i4_blocks, i4_header_cap):
    """Native closed-loop MB encode (mode RD + quant + reconstruction),
    bit-exact vs the JAX package's Python loop. Returns dict of per-MB
    outputs + reconstructed planes."""
    from ..lossy import cost as C

    lib = get()
    n_mb = mb_w * mb_h
    srcY = np.ascontiguousarray(srcY, dtype=np.uint8)
    srcU = np.ascontiguousarray(srcU, dtype=np.uint8)
    srcV = np.ascontiguousarray(srcV, dtype=np.uint8)
    seg = np.ascontiguousarray(seg_map, dtype=np.uint8).reshape(-1)
    quant = np.ascontiguousarray(quant, dtype=np.int64)
    lam = np.ascontiguousarray(lambdas, dtype=np.int64)
    pr = np.ascontiguousarray(proba, dtype=np.uint8)
    ctab = np.ascontiguousarray(cost_tables, dtype=np.int32)
    ec = np.ascontiguousarray(C.ENTROPY_COST, dtype=np.int32)
    lf = np.ascontiguousarray(C.LEVEL_FIXED_COSTS, dtype=np.int32)
    fc4 = np.ascontiguousarray(C.FIXED_COSTS_I4, dtype=np.int32)
    levels = np.zeros((n_mb, 24, 16), dtype=np.int32)
    y2 = np.zeros((n_mb, 16), dtype=np.int32)
    is_i4 = np.zeros(n_mb, dtype=np.uint8)
    imodes = np.zeros((n_mb, 16), dtype=np.uint8)
    uvmode = np.zeros(n_mb, dtype=np.uint8)
    skip = np.zeros(n_mb, dtype=np.uint8)
    recY = np.zeros_like(srcY)
    recU = np.zeros_like(srcU)
    recV = np.zeros_like(srcV)
    trace.count(trace.NATIVE, "calls")
    lib.vp8_encode_mbs(
        _ptr(srcY), _ptr(srcU), _ptr(srcV), mb_w, mb_h, _ptr(seg),
        _ptr(quant), _ptr(lam), _ptr(pr), _ptr(ctab), _ptr(ec), _ptr(lf),
        _ptr(fc4), int(method), int(bool(i4_blocks)), int(i4_header_cap),
        _ptr(levels), _ptr(y2), _ptr(is_i4), _ptr(imodes), _ptr(uvmode),
        _ptr(skip), _ptr(recY), _ptr(recU), _ptr(recV))
    return {"levels": levels, "y2_levels": y2, "is_i4": is_i4,
            "imodes": imodes, "uvmode": uvmode, "skip": skip,
            "recY": recY, "recU": recU, "recV": recV}


def vp8_compute_alphas(Y, U, V, mb_w, mb_h):
    """Native analysis-pass alphas -> (mixed [n_mb] i32, global_uv int),
    bit-exact vs the JAX package's numpy compute_alphas."""
    lib = get()
    Y = np.ascontiguousarray(Y, dtype=np.uint8)
    U = np.ascontiguousarray(U, dtype=np.uint8)
    V = np.ascontiguousarray(V, dtype=np.uint8)
    mixed = np.zeros(mb_w * mb_h, dtype=np.int32)
    guv = np.zeros(1, dtype=np.int32)
    trace.count(trace.NATIVE, "calls")
    lib.vp8_compute_alphas(_ptr(Y), _ptr(U), _ptr(V), mb_w, mb_h,
                           _ptr(mixed), _ptr(guv))
    return mixed, int(guv[0])


def native_yuv_import(rgb: np.ndarray):
    """RGB [h, w, 3] u8 -> (Y, U, V) u8 planes padded to MB multiples by
    border replication (native/src/yuv_import.cc; the reference's
    rgb_to_yuv420 without dithering). Releases the GIL while it runs."""
    lib = get()
    h, w = rgb.shape[:2]
    mbw, mbh = (w + 15) >> 4, (h + 15) >> 4
    rgb = np.ascontiguousarray(rgb[..., :3], dtype=np.uint8)
    Y = np.empty((mbh * 16, mbw * 16), dtype=np.uint8)
    U = np.empty((mbh * 8, mbw * 8), dtype=np.uint8)
    V = np.empty((mbh * 8, mbw * 8), dtype=np.uint8)
    trace.count(trace.NATIVE, "calls")
    lib.yuv_import(_ptr(rgb), h, w, _ptr(Y), _ptr(U), _ptr(V))
    return Y, U, V


def powf_array(x: np.ndarray, e: float) -> np.ndarray:
    """The C library's powf(x, e) over a float32 array (native/src/
    powf_array.cc): bit for bit the reference's float32 pow on the CPU."""
    lib = get()
    x = np.ascontiguousarray(x, dtype=np.float32)
    y = np.empty_like(x)
    trace.count(trace.NATIVE, "calls")
    lib.powf_array(_ptr(x), float(np.float32(e)), _ptr(y), x.size)
    return y


# --- Decoder side -----------------------------------------------------------


def _setup_dec(lib):
    tabs = [ct.c_void_p] * 6
    lib.vp8_decode.argtypes = [ct.c_void_p, ct.c_long] + tabs + \
        [ct.c_void_p] * 4
    lib.vp8_decode.restype = ct.c_int
    lib.vp8_parse.argtypes = [ct.c_void_p, ct.c_long] + tabs + \
        [ct.c_void_p] * 6
    lib.vp8_parse.restype = ct.c_int
    lib.vp8_filter_selftest.argtypes = [ct.c_int]
    lib.vp8_filter_selftest.restype = ct.c_int
    lib.yuv420_to_rgb_fancy.argtypes = [
        ct.c_void_p, ct.c_int, ct.c_void_p, ct.c_void_p, ct.c_int,
        ct.c_int, ct.c_int, ct.c_void_p, ct.c_int,
    ]
    lib.yuv420_to_rgb_fancy.restype = None
    lib.vp8l_decode.argtypes = [
        ct.c_void_p, ct.c_long, ct.c_void_p, ct.c_long,
        ct.POINTER(ct.c_int), ct.POINTER(ct.c_int), ct.POINTER(ct.c_int),
    ]
    lib.vp8l_decode.restype = ct.c_int
    return lib


_dec = None


def get_dec():
    """The decoder-side library, built from native/src at first use."""
    global _dec
    if _dec is None:
        _dec = _setup_dec(_build.load("webp_dec"))
    return _dec


def _dec_tables():
    """The spec tables the native decoder reads, in its argument order."""
    from ..lossy import tables as T

    return (np.ascontiguousarray(T.COEFFS_PROBA0, dtype=np.uint8),
            np.ascontiguousarray(T.COEFFS_UPDATE_PROBA, dtype=np.uint8),
            np.ascontiguousarray(T.DC_TABLE, dtype=np.int32),
            np.ascontiguousarray(T.AC_TABLE, dtype=np.int32),
            np.ascontiguousarray(T.BMODE_PROBA, dtype=np.uint8),
            np.ascontiguousarray(T.YMODES_INTRA4_TREE, dtype=np.int8))


def _dec_error(rc: int, what: str):
    from ..lossy.decode import VP8Error

    return VP8Error(f"vp8: native {what} failed" if rc == -1
                    else "vp8: premature EOF in tokens")


def vp8_decode(data: bytes):
    """Native VP8 keyframe decode -> ((Y, U, V) MB-padded planes, (w, h)).
    Raises VP8Error on a bad header or truncated tokens."""
    from ..container.parser import parse_vp8_dimensions

    lib = get_dec()
    w, h = parse_vp8_dimensions(data)
    mbw, mbh = (w + 15) >> 4, (h + 15) >> 4
    Y = np.zeros((mbh * 16, mbw * 16), dtype=np.uint8)
    U = np.zeros((mbh * 8, mbw * 8), dtype=np.uint8)
    V = np.zeros((mbh * 8, mbw * 8), dtype=np.uint8)
    dims = np.zeros(4, dtype=np.int32)
    buf = np.frombuffer(data, dtype=np.uint8)
    tabs = _dec_tables()
    rc = lib.vp8_decode(_ptr(buf), len(data), *map(_ptr, tabs), _ptr(Y),
                        _ptr(U), _ptr(V), _ptr(dims))
    if rc != 0:
        raise _dec_error(rc, "decode")
    return (Y, U, V), (w, h)


def vp8_parse(data: bytes) -> dict:
    """Parse-only native decode for the device reconstruction: headers
    and the token pass, exporting dequantized coefficients and per-MB
    info: dict(coeffs i16 [n_mb, 24, 16], bnz u8 [n_mb, 24],
    is_i4/uvmode/segment/has_nz u8 [n_mb], imodes u8 [n_mb, 16],
    finfo i32 [1 + 32] (the filter type, then per segment and I4 flag:
    limit, ilevel, hev threshold, inner), dims (mb_w, mb_h, w, h)).
    Raises VP8Error on a bad header or truncated tokens."""
    from ..container.parser import parse_vp8_dimensions

    lib = get_dec()
    w, h = parse_vp8_dimensions(data)
    mbw, mbh = (w + 15) >> 4, (h + 15) >> 4
    nmb = mbw * mbh
    coeffs = np.zeros((nmb, 24, 16), dtype=np.int16)
    bnz = np.zeros((nmb, 24), dtype=np.uint8)
    info = np.zeros((nmb, 4), dtype=np.uint8)
    imodes = np.zeros((nmb, 16), dtype=np.uint8)
    finfo = np.zeros(1 + 4 * 2 * 4, dtype=np.int32)
    dims = np.zeros(4, dtype=np.int32)
    buf = np.frombuffer(data, dtype=np.uint8)
    tabs = _dec_tables()
    rc = lib.vp8_parse(_ptr(buf), len(data), *map(_ptr, tabs),
                       _ptr(coeffs), _ptr(bnz), _ptr(info), _ptr(imodes),
                       _ptr(finfo), _ptr(dims))
    if rc != 0:
        raise _dec_error(rc, "parse")
    return {"coeffs": coeffs, "bnz": bnz, "is_i4": info[:, 0],
            "uvmode": info[:, 1], "segment": info[:, 2],
            "has_nz": info[:, 3], "imodes": imodes, "finfo": finfo,
            "dims": tuple(int(d) for d in dims)}


def vp8_filter_selftest(seed: int = 0) -> int:
    """The native loop filter's SIMD edge filters against its scalar ones
    on pseudo-random planes: 0 when bit-exact (or when the library was
    built without the SIMD filters), else the 1-based failing case."""
    return int(get_dec().vp8_filter_selftest(int(seed)))


def native_upsample_rgba(y: np.ndarray, u: np.ndarray, v: np.ndarray,
                         nch: int = 4) -> np.ndarray:
    """Fancy-upsampled YUV 4:2:0 -> RGB(A) u8 [h, w, nch] (alpha 255).
    Accepts row-strided plane views (crops of MB-padded planes)."""
    lib = get_dec()
    h, w = y.shape
    if u.strides != v.strides or u.strides[1] != 1 or y.strides[1] != 1:
        raise ValueError("native_upsample_rgba: planes need unit column "
                         "strides, U and V the same row stride")
    out = np.empty((h, w, nch), dtype=np.uint8)
    lib.yuv420_to_rgb_fancy(_ptr(y), y.strides[0], _ptr(u), _ptr(v),
                            u.strides[0], w, h, _ptr(out), nch)
    return out


def vp8l_decode(payload: bytes):
    """Native VP8L decode -> (argb u32 [h, w], has_alpha). Raises
    BitstreamError on a malformed or truncated stream (the numpy
    VP8LDecoder's validation)."""
    from ..lossless.decode import BitstreamError

    lib = get_dec()
    if len(payload) < 5 or payload[0] != 0x2F:
        raise BitstreamError("webp: bad VP8L signature")
    # The dimensions live in the first 4 bytes after the signature.
    bits = int.from_bytes(payload[1:5], "little")
    w = (bits & 0x3FFF) + 1
    h = ((bits >> 14) & 0x3FFF) + 1
    buf = np.frombuffer(payload, dtype=np.uint8)
    out = np.empty(w * h, dtype=np.uint32)
    ow, oh, oa = ct.c_int(), ct.c_int(), ct.c_int()
    rc = lib.vp8l_decode(_ptr(buf), len(payload), _ptr(out), out.size,
                         ct.byref(ow), ct.byref(oh), ct.byref(oa))
    if rc == -3:
        raise BitstreamError("webp: truncated VP8L stream")
    if rc != 0:
        raise BitstreamError("webp: malformed VP8L stream")
    return out.reshape(h, w), bool(oa.value)


# --- Lossless encoder side --------------------------------------------------


def _setup_vp8l(lib):
    lib.vp8l_encode_entropy_image.argtypes = [
        ct.c_void_p, ct.c_long, ct.c_int, ct.c_int, ct.c_int, ct.c_int,
        ct.c_void_p, ct.c_long,
    ]
    lib.vp8l_encode_entropy_image.restype = ct.c_long
    lib.vp8l_predictor_transform.argtypes = [
        ct.c_void_p, ct.c_long, ct.c_long, ct.c_int, ct.c_void_p,
        ct.c_void_p,
    ]
    lib.vp8l_predictor_transform.restype = None
    lib.vp8l_cross_color.argtypes = [
        ct.c_void_p, ct.c_long, ct.c_long, ct.c_int, ct.c_void_p,
        ct.c_void_p,
    ]
    lib.vp8l_cross_color.restype = ct.c_double
    return lib


_vp8l = None


def get_vp8l():
    """The lossless encoder's library, built from native/src at first
    use."""
    global _vp8l
    if _vp8l is None:
        _vp8l = _setup_vp8l(_build.load("vp8l_enc"))
    return _vp8l


def vp8l_encode_entropy_image(argb: np.ndarray, xsize: int, quality: int,
                              is_level0: bool, method: int = 4):
    """One entropy-coded image stream (colour-cache bit, the meta-Huffman
    bit and entropy image at level 0, the trees and the LZ77 tokens) ->
    (bytes, nbits), bit 0 the LSB of the first byte."""
    lib = get_vp8l()
    a = np.ascontiguousarray(argb, dtype=np.uint32)
    cap = a.size * 6 + (1 << 16)
    out = np.empty(cap, dtype=np.uint8)
    bits = lib.vp8l_encode_entropy_image(_ptr(a), a.size, xsize,
                                         int(quality), int(method),
                                         int(is_level0), _ptr(out), cap)
    if bits < 0:
        raise RuntimeError("native VP8L entropy coder: output overflow")
    return out[: (bits + 7) // 8].tobytes(), int(bits)


def vp8l_predictor_transform(img: np.ndarray, bits: int):
    """Per-tile best-of-14 predictor search -> (residuals u32 [h, w],
    tile_modes i32 [ty, tx])."""
    lib = get_vp8l()
    h, w = img.shape
    img = np.ascontiguousarray(img, dtype=np.uint32)
    ty, tx = (h + (1 << bits) - 1) >> bits, (w + (1 << bits) - 1) >> bits
    out = np.empty((h, w), dtype=np.uint32)
    modes = np.empty((ty, tx), dtype=np.int32)
    lib.vp8l_predictor_transform(_ptr(img), h, w, bits, _ptr(out),
                                 _ptr(modes))
    return out, modes


def vp8l_cross_color(img: np.ndarray, bits: int):
    """Cross-color search and application -> (out u32 [h, w], tiles u32
    [ty, tx], the estimated gain in bits)."""
    lib = get_vp8l()
    h, w = img.shape
    img = np.ascontiguousarray(img, dtype=np.uint32)
    ty, tx = (h + (1 << bits) - 1) >> bits, (w + (1 << bits) - 1) >> bits
    out = np.empty((h, w), dtype=np.uint32)
    tiles = np.empty((ty, tx), dtype=np.uint32)
    gain = lib.vp8l_cross_color(_ptr(img), h, w, bits, _ptr(out),
                                _ptr(tiles))
    return out, tiles, float(gain)
