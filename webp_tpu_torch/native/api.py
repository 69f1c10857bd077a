"""ctypes bindings for the encoder-side native library: the boolean
writer, token emission, statistics, the closed-loop MB encode (the
escape-overflow fallback) and the analysis alphas.

Sources: native/src/vp8_enc.cc, vp8_enc_loop.cc and bitio.h. The library
is compiled with g++ at first use (webp_tpu_torch/_build.py).
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
