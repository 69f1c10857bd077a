"""Builds the port's shared libraries at first use.

Two kinds of library, both with a plain C interface loaded by ctypes:

  * the host entropy coder (native/src, g++), used on every encode;
  * the Hopper kernels (csrc/*.cu, nvcc for sm_90a), used when a kernel
    wrapper receives CUDA tensors.

Each library is named by a hash of its sources and flags and lands in
`_build/` beside this file (listed in .gitignore). Builds are safe under
concurrency — several test workers or threads may ask for the same
library at once: a per-library file lock serializes them, the compiler
writes a temporary file, and os.replace moves it into place.
"""

from __future__ import annotations

import ctypes
import fcntl
import hashlib
import os
import shutil
import subprocess
import threading
import time

HERE = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(HERE, "_build")

# The card the kernels are built for: H100 (Hopper, sm_90a). -fmad=false
# keeps every float multiply-add uncontracted unless the source asks for
# __fmaf_rn explicitly (the kernels match the reference's rounding op by
# op; see csrc/common.cuh).
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-shared", "-Xcompiler", "-fPIC"]
GXX_FLAGS = ["-O3", "-march=native", "-shared", "-fPIC", "-std=c++17"]

# name -> (compiler, sources relative to the package, headers it includes)
LIBS = {
    "webp_enc": ("g++", ["native/src/vp8_enc.cc",
                         "native/src/vp8_enc_loop.cc"],
                 ["native/src/bitio.h"]),
    "p1_alpha": ("nvcc", ["csrc/p1_alpha.cu"], ["csrc/common.cuh"]),
    "p1_mode": ("nvcc", ["csrc/p1_mode.cu"], ["csrc/common.cuh"]),
    "i4_search": ("nvcc", ["csrc/i4_search.cu"], ["csrc/common.cuh"]),
}
KERNEL_LIBS = ("p1_alpha", "p1_mode", "i4_search")

_loaded: dict = {}
_mutex = threading.Lock()


def nvcc_path() -> str:
    cand = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(cand):
        return cand
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found: the CUDA kernels are built on "
                           "a machine with the CUDA toolkit")
    return found


def _command(name: str, out: str) -> list:
    compiler, sources, _ = LIBS[name]
    srcs = [os.path.join(HERE, s) for s in sources]
    if compiler == "nvcc":
        return [nvcc_path()] + NVCC_FLAGS + ["-o", out] + srcs
    return ["g++"] + GXX_FLAGS + ["-o", out] + srcs


def _cpu_flags() -> bytes:
    """The host CPU's feature flags: -march=native code built on one
    machine may not run on another, so they are part of the g++ key."""
    try:
        with open("/proc/cpuinfo", "rb") as f:
            for line in f:
                if line.startswith(b"flags"):
                    return line
    except OSError:
        pass
    return b""


def lib_path(name: str) -> str:
    compiler, sources, headers = LIBS[name]
    h = hashlib.sha256()
    flags = NVCC_FLAGS if compiler == "nvcc" else GXX_FLAGS
    h.update(" ".join(flags).encode())
    if compiler == "g++":
        h.update(_cpu_flags())
    for rel in sources + headers:
        with open(os.path.join(HERE, rel), "rb") as f:
            h.update(f.read())
    return os.path.join(BUILD_DIR, f"lib{name}-{h.hexdigest()[:16]}.so")


def build(names) -> dict:
    """Builds every library in `names` that is not built yet, one
    compiler process per library, all started together. Returns
    {name: seconds spent building it (0.0 if it was already built)}."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    spent = {name: 0.0 for name in names}
    pending, errors = [], []
    try:
        for name in names:
            path = lib_path(name)
            if os.path.exists(path):
                continue
            tmp = f"{path}.{os.getpid()}.{threading.get_ident()}.tmp"
            cmd = _command(name, tmp)
            lock = open(path + ".lock", "w")
            fcntl.flock(lock, fcntl.LOCK_EX)
            if os.path.exists(path):        # another process built it
                lock.close()
                continue
            try:
                proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True)
            except OSError:
                lock.close()
                raise
            pending.append((name, path, tmp, lock, time.perf_counter(), proc))
        for name, path, tmp, lock, t0, proc in pending:
            log, _ = proc.communicate()
            spent[name] = time.perf_counter() - t0
            if proc.returncode == 0:
                os.replace(tmp, path)
            else:
                errors.append(f"{name}: exit {proc.returncode}\n{log}")
    finally:
        for _, _, tmp, lock, _, proc in pending:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
            if os.path.exists(tmp):
                os.remove(tmp)
            lock.close()                    # closing releases the lock
    if errors:
        raise RuntimeError("build failed:\n" + "\n".join(errors))
    return spent


def load(name: str) -> ctypes.CDLL:
    """The library `name`, built first if needed (thread-safe)."""
    with _mutex:
        lib = _loaded.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(lib_path(name))
            _loaded[name] = lib
        return lib
