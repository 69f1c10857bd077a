"""ctypes bindings for the port's two native libraries.

The encoder side (get()): the boolean writer, token emission,
statistics, the closed-loop MB encode (the escape-overflow fallback and
the host backend), the analysis alphas, the RGB -> YUV 4:2:0 importer
and an elementwise powf; sources native/src/vp8_enc.cc, vp8_enc_loop.cc,
yuv_import.cc, powf_array.cc and bitio.h.

The decoder side (get_dec()): the VP8 keyframe decoder (vp8_decode), its
parse-only half for the device decode (vp8_parse), the loop filter's
SIMD self-test and the fancy-upsampling YUV 4:2:0 -> RGB(A) converter;
sources native/src/vp8_dec.cc, upsample.cc and bitio.h.

Both are compiled with g++ at first use (webp_tpu_torch/_build.py); a
failed build raises.
"""

from __future__ import annotations

import ctypes as ct

import numpy as np

from .. import _build


def _setup(lib):
    lib.bw_new.restype = ct.c_void_p
    lib.bw_free.argtypes = [ct.c_void_p]
    lib.bw_put_bit.argtypes = [ct.c_void_p, ct.c_int, ct.c_int]
    lib.bw_put_bits.argtypes = [ct.c_void_p, ct.c_uint32, ct.c_int]
    lib.bw_put_signed_bits.argtypes = [ct.c_void_p, ct.c_int, ct.c_int]
    lib.bw_size.argtypes = [ct.c_void_p]
    lib.bw_size.restype = ct.c_long
    lib.bw_finish.argtypes = [ct.c_void_p, ct.c_void_p, ct.c_long]
    lib.bw_finish.restype = ct.c_long
    lib.bw_write_mb_modes.argtypes = [
        ct.c_void_p, ct.c_void_p, ct.c_void_p, ct.c_void_p, ct.c_void_p,
        ct.c_int, ct.c_int, ct.c_void_p, ct.c_void_p, ct.c_int, ct.c_int,
    ]
    if hasattr(lib, "bw_write_mb_modes_seg"):
        lib.bw_write_mb_modes_seg.argtypes = [
            ct.c_void_p, ct.c_void_p, ct.c_void_p, ct.c_void_p, ct.c_void_p,
            ct.c_int, ct.c_int, ct.c_void_p, ct.c_void_p, ct.c_int, ct.c_int,
            ct.c_void_p, ct.c_void_p, ct.c_int,
        ]
    lib.vp8_emit_tokens.argtypes = [
        ct.c_void_p, ct.c_void_p, ct.c_void_p, ct.c_void_p, ct.c_void_p,
        ct.c_int, ct.c_int, ct.c_int, ct.c_int, ct.c_int, ct.c_void_p,
        ct.c_long,
    ]
    lib.vp8_emit_tokens.restype = ct.c_long
    lib.vp8_record_stats.argtypes = [
        ct.c_void_p, ct.c_void_p, ct.c_void_p, ct.c_void_p,
        ct.c_int, ct.c_int, ct.c_int, ct.c_void_p,
    ]
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


def available() -> bool:
    return get() is not None


class NativeBoolWriter:
    """Drop-in replacement for bitio.bool.BoolWriter backed by C++."""

    def __init__(self):
        self._lib = get()
        self._h = self._lib.bw_new()

    def put_bit(self, prob: int, bit: int) -> int:
        self._lib.bw_put_bit(self._h, prob, 1 if bit else 0)
        return bit

    def put_bits(self, value: int, nbits: int) -> None:
        self._lib.bw_put_bits(self._h, value, nbits)

    def put_signed_bits(self, value: int, nbits: int) -> None:
        self._lib.bw_put_signed_bits(self._h, value, nbits)

    def num_bytes(self) -> int:
        return int(self._lib.bw_size(self._h))

    def write_mb_modes(self, imodes, is_i4, uvmode, skip, use_skip, skip_prob,
                       bmode_prob, tree, mb_w, mb_h, seg_map=None,
                       seg_probas=None, num_segments=1) -> None:
        if num_segments > 1:
            self._lib.bw_write_mb_modes_seg(
                self._h,
                _ptr(imodes), _ptr(is_i4), _ptr(uvmode), _ptr(skip),
                int(use_skip), int(skip_prob), _ptr(bmode_prob), _ptr(tree),
                mb_w, mb_h, _ptr(seg_map), _ptr(seg_probas),
                int(num_segments))
            return
        self._lib.bw_write_mb_modes(
            self._h,
            _ptr(imodes), _ptr(is_i4), _ptr(uvmode), _ptr(skip),
            int(use_skip), int(skip_prob), _ptr(bmode_prob), _ptr(tree),
            mb_w, mb_h)

    def finish(self) -> bytes:
        cap = self.num_bytes() + 64
        out = np.zeros(cap, dtype=np.uint8)
        n = self._lib.bw_finish(self._h, _ptr(out), cap)
        assert n >= 0
        data = bytes(out[:n].tobytes())
        self._lib.bw_free(self._h)
        self._h = None
        return data


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ct.c_void_p)


def emit_tokens(levels: np.ndarray, y2_levels: np.ndarray, is_i4: np.ndarray,
                skip: np.ndarray, proba: np.ndarray, mb_w: int, mb_h: int,
                use_skip: bool, part_idx: int, num_parts: int) -> bytes:
    lib = get()
    levels = np.ascontiguousarray(levels, dtype=np.int32)
    y2 = np.ascontiguousarray(y2_levels, dtype=np.int32)
    i4 = np.ascontiguousarray(is_i4, dtype=np.uint8)
    sk = np.ascontiguousarray(skip, dtype=np.uint8)
    pr = np.ascontiguousarray(proba, dtype=np.uint8)
    cap = levels.size * 4 + 65536
    out = np.zeros(cap, dtype=np.uint8)
    n = lib.vp8_emit_tokens(_ptr(levels), _ptr(y2), _ptr(i4), _ptr(sk),
                            _ptr(pr), mb_w, mb_h, int(use_skip), part_idx,
                            num_parts, _ptr(out), cap)
    if n < 0:
        raise RuntimeError("native token emission overflow")
    return bytes(out[:n].tobytes())


def record_stats(levels, y2_levels, is_i4, skip, mb_w, mb_h,
                 use_skip) -> np.ndarray:
    lib = get()
    levels = np.ascontiguousarray(levels, dtype=np.int32)
    y2 = np.ascontiguousarray(y2_levels, dtype=np.int32)
    i4 = np.ascontiguousarray(is_i4, dtype=np.uint8)
    sk = np.ascontiguousarray(skip, dtype=np.uint8)
    stats = np.zeros((4, 8, 3, 11, 2), dtype=np.int64)
    lib.vp8_record_stats(_ptr(levels), _ptr(y2), _ptr(i4), _ptr(sk),
                         mb_w, mb_h, int(use_skip), _ptr(stats))
    return stats


def vp8_encode_mbs(srcY, srcU, srcV, mb_w, mb_h, seg_map, quant, lambdas,
                   proba, cost_tables, method, i4_blocks, i4_header_cap):
    """Native closed-loop MB encode (mode RD + quant + reconstruction),
    bit-exact vs lossy/encode.py's Python loop. Returns dict of per-MB
    outputs + reconstructed planes, or None when unavailable."""
    lib = get()
    if lib is None or not hasattr(lib, "vp8_encode_mbs"):
        return None
    if not getattr(lib, "_enc_loop_ready", False):
        lib.vp8_encode_mbs.argtypes = [ct.c_void_p] * 3 + [ct.c_int] * 2 + \
            [ct.c_void_p] * 8 + [ct.c_int, ct.c_int, ct.c_int64] + \
            [ct.c_void_p] * 9
        lib._enc_loop_ready = True
    from ..lossy import cost as C

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
    bit-exact vs lossy/analysis.py compute_alphas. None if unavailable."""
    lib = get()
    if lib is None or not hasattr(lib, "vp8_compute_alphas"):
        return None
    if not getattr(lib, "_alphas_ready", False):
        lib.vp8_compute_alphas.argtypes = [ct.c_void_p] * 3 + \
            [ct.c_int] * 2 + [ct.c_void_p] * 2
        lib._alphas_ready = True
    Y = np.ascontiguousarray(Y, dtype=np.uint8)
    U = np.ascontiguousarray(U, dtype=np.uint8)
    V = np.ascontiguousarray(V, dtype=np.uint8)
    mixed = np.zeros(mb_w * mb_h, dtype=np.int32)
    guv = np.zeros(1, dtype=np.int32)
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
    lib.yuv_import(_ptr(rgb), h, w, _ptr(Y), _ptr(U), _ptr(V))
    return Y, U, V


def powf_array(x: np.ndarray, e: float) -> np.ndarray:
    """The C library's powf(x, e) over a float32 array (native/src/
    powf_array.cc): bit for bit the reference's float32 pow on the CPU."""
    lib = get()
    x = np.ascontiguousarray(x, dtype=np.float32)
    y = np.empty_like(x)
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
