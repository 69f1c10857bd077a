"""Builds the port's shared libraries at first use.

Two kinds of library, both with a plain C interface loaded by ctypes:

  * the host entropy coder, YUV importer and the C library's powf over
    an array (native/src, g++), used on every lossy encode; the host VP8
    decoder with its token parse and fancy upsampler and the VP8L decoder
    (native/src, g++), used on every decode; and the VP8L encoder's
    entropy coder, predictor and cross-color searches (native/src, g++),
    used on every lossless encode and ALPH plane;
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
import re
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
# -Xptxas -v prints each kernel's registers, shared memory and spills; the
# log is kept beside the library (ptxas_facts reads it).
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-fmad=false", "-Xptxas", "-v", "-shared", "-Xcompiler",
              "-fPIC"]
GXX_FLAGS = ["-O3", "-march=native", "-shared", "-fPIC", "-std=c++17"]

# name -> (compiler, sources relative to the package, headers it includes)
LIBS = {
    "webp_enc": ("g++", ["native/src/vp8_enc.cc",
                         "native/src/vp8_enc_loop.cc",
                         "native/src/yuv_import.cc",
                         "native/src/powf_array.cc"],
                 ["native/src/bitio.h"]),
    "webp_dec": ("g++", ["native/src/vp8_dec.cc",
                         "native/src/upsample.cc",
                         "native/src/vp8l_dec.cc"],
                 ["native/src/bitio.h"]),
    "vp8l_enc": ("g++", ["native/src/vp8l_enc.cc",
                         "native/src/vp8l_predictor.cc"], []),
    "p1_alpha": ("nvcc", ["csrc/p1_alpha.cu"], ["csrc/common.cuh"]),
    "p1_mode": ("nvcc", ["csrc/p1_mode.cu"], ["csrc/common.cuh"]),
    "i4_search": ("nvcc", ["csrc/i4_search.cu"], ["csrc/common.cuh"]),
    "p2_wavefront": ("nvcc", ["csrc/p2_wavefront.cu"], ["csrc/common.cuh"]),
}
KERNEL_LIBS = ("p1_alpha", "p1_mode", "i4_search", "p2_wavefront")

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
                with open(path + ".log", "w") as f:
                    f.write(log)
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


def ptxas_facts(name: str) -> list:
    """What ptxas reported for each kernel of the built library `name`:
    [{"entry", "registers", "smem", "stack", "spill_stores",
    "spill_loads"}] (bytes; smem is the static shared memory, a kernel's
    dynamic shared memory is set at launch)."""
    with open(lib_path(name) + ".log") as f:
        log = f.read()
    facts, cur = [], None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '([^']+)'", line)
        if m:
            cur = {"entry": m.group(1), "registers": 0, "smem": 0,
                   "stack": 0, "spill_stores": 0, "spill_loads": 0}
            facts.append(cur)
        elif cur is not None:
            for key, pat in (("stack", r"(\d+) bytes stack frame"),
                             ("spill_stores", r"(\d+) bytes spill stores"),
                             ("spill_loads", r"(\d+) bytes spill loads"),
                             ("registers", r"Used (\d+) registers"),
                             ("smem", r"(\d+) bytes smem")):
                m = re.search(pat, line)
                if m:
                    cur[key] = int(m.group(1))
    return facts


def load(name: str) -> ctypes.CDLL:
    """The library `name`, built first if needed (thread-safe)."""
    with _mutex:
        lib = _loaded.get(name)
        if lib is None:
            build([name])
            lib = ctypes.CDLL(lib_path(name))
            _loaded[name] = lib
        return lib
