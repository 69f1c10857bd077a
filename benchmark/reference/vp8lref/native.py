"""The reference's own build of the lossless encoder's C++ (vp8l_enc.cc:
the LZ77, colour cache, Huffman codes and emission; vp8l_cross_color.cc:
the cross-color search) and its ctypes interface.

The library is built with g++ at first use into _build/ beside this file
(listed in .gitignore), with the measured package's g++ flags, named by
a hash of the sources, the flags and the CPU's feature flags (-march=
native code may not run on another CPU). A file lock serializes the
reference's worker processes; the compiler writes a temporary file that
os.replace moves into place. A failed build raises.
"""

from __future__ import annotations

import ctypes as ct
import fcntl
import hashlib
import os
import subprocess
import threading

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(HERE, "_build")
SOURCES = ("vp8l_enc.cc", "vp8l_cross_color.cc")
# The measured package's g++ flags (its _build.py GXX_FLAGS).
GXX_FLAGS = ["-O3", "-march=native", "-shared", "-fPIC", "-std=c++17"]

_lib = None
_mutex = threading.Lock()


def _cpu_flags() -> bytes:
    try:
        with open("/proc/cpuinfo", "rb") as f:
            for line in f:
                if line.startswith(b"flags"):
                    return line
    except OSError:
        pass
    return b""


def lib_path() -> str:
    h = hashlib.sha256(" ".join(GXX_FLAGS).encode())
    h.update(_cpu_flags())
    for name in SOURCES:
        with open(os.path.join(HERE, name), "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"libvp8lref-{h.hexdigest()[:16]}.so")


def build() -> str:
    """The library's path, built first if it is not there."""
    path = lib_path()
    if os.path.exists(path):
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    with open(path + ".lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)
        if os.path.exists(path):        # another process built it
            return path
        tmp = f"{path}.{os.getpid()}.tmp"
        cmd = ["g++"] + GXX_FLAGS + ["-o", tmp] + [
            os.path.join(HERE, s) for s in SOURCES]
        try:
            proc = subprocess.run(cmd, stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
            if proc.returncode != 0:
                raise RuntimeError(f"the reference's g++ build failed "
                                   f"(exit {proc.returncode}):\n"
                                   f"{proc.stdout}")
            os.replace(tmp, path)
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
    return path


def get():
    """The loaded library (built at first use)."""
    global _lib
    with _mutex:
        if _lib is None:
            lib = ct.CDLL(build())
            lib.vp8l_encode_entropy_image.argtypes = [
                ct.c_void_p, ct.c_long, ct.c_int, ct.c_int, ct.c_int,
                ct.c_int, ct.c_void_p, ct.c_long]
            lib.vp8l_encode_entropy_image.restype = ct.c_long
            lib.vp8l_cross_color.argtypes = [
                ct.c_void_p, ct.c_long, ct.c_long, ct.c_int, ct.c_void_p,
                ct.c_void_p]
            lib.vp8l_cross_color.restype = ct.c_double
            _lib = lib
        return _lib


def _ptr(a: np.ndarray):
    return a.ctypes.data_as(ct.c_void_p)


def encode_entropy_image(argb: np.ndarray, xsize: int, quality: int,
                         is_level0: bool, method: int):
    """One entropy-coded image stream -> (bytes, nbits), bit 0 the LSB of
    the first byte."""
    lib = get()
    a = np.ascontiguousarray(argb, dtype=np.uint32)
    cap = a.size * 6 + (1 << 16)
    out = np.empty(cap, dtype=np.uint8)
    bits = lib.vp8l_encode_entropy_image(_ptr(a), a.size, xsize,
                                         int(quality), int(method),
                                         int(is_level0), _ptr(out), cap)
    if bits < 0:
        raise RuntimeError("the reference's entropy coder: output overflow")
    return out[: (bits + 7) // 8].tobytes(), int(bits)


def cross_color(img: np.ndarray, bits: int):
    """The cross-color search and its application -> (out u32 [h, w],
    tiles u32 [ty, tx], the estimated gain in bits)."""
    lib = get()
    h, w = img.shape
    img = np.ascontiguousarray(img, dtype=np.uint32)
    ty, tx = (h + (1 << bits) - 1) >> bits, (w + (1 << bits) - 1) >> bits
    out = np.empty((h, w), dtype=np.uint32)
    tiles = np.empty((ty, tx), dtype=np.uint32)
    gain = lib.vp8l_cross_color(_ptr(img), h, w, bits, _ptr(out),
                                _ptr(tiles))
    return out, tiles, float(gain)
