"""Launch plumbing shared by the port's hand-written CUDA kernels.

Each kernel lives in csrc/<name>.cu behind a plain C function
`<name>_launch(...)` that returns cudaGetLastError(); the library is built
by nvcc at first use (_build.py) and called through ctypes on PyTorch's
current stream. A kernel wrapper (ops/p1_kernels.py, ops/i4_kernel.py)
checks its tensors with `check`, takes its plain PyTorch version only when
`on_cpu` says the tensors lie on the CPU, and otherwise calls `launch`,
which raises on a refused launch and counts it in LAUNCHES.
"""

from __future__ import annotations

import ctypes

import torch

from .. import _build

# Launches per kernel since the last reset (a plain count, read by
# chip_smoke.py to show that the main path went through every kernel).
LAUNCHES = {name: 0 for name in _build.KERNEL_LIBS}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def check(what: str, t: torch.Tensor, dtype, shape) -> None:
    """Raises unless t has `dtype`, is contiguous and matches `shape`
    (None entries match any size)."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{what}: expected a tensor, got {type(t).__name__}")
    if t.dtype != dtype:
        raise TypeError(f"{what}: dtype {t.dtype}, expected {dtype}")
    if t.dim() != len(shape) or any(
            s is not None and s != d for s, d in zip(shape, t.shape)):
        raise ValueError(f"{what}: shape {tuple(t.shape)}, expected {shape}")
    if not t.is_contiguous():
        raise ValueError(f"{what}: not contiguous")


def on_cpu(*tensors) -> bool:
    """True when every tensor lies on the CPU (the plain version runs),
    False when all lie on one CUDA device (the kernel runs). Raises on
    mixed or other devices."""
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise ValueError(f"tensors on several devices: {sorted(map(str, devs))}")
    dev = devs.pop()
    if dev.type == "cpu":
        return True
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    return False


_P, _I = ctypes.c_void_p, ctypes.c_int

# The C signature of each `<name>_launch` before its trailing stream
# argument: pointers for tensors, ints for sizes and flags.
SIGNATURES = {
    "p1_alpha": (_P, _I, _P, _P),
    "p1_mode": (_P, _P, _P, _P, _P, _I, _I, _I, _P, _P, _P),
    "i4_search": (_P, _P, _P, _P, _I, _I, _I, _P, _P),
}
_fns: dict = {}


def _launcher(name: str):
    fn = _fns.get(name)
    if fn is None:
        fn = getattr(_build.load(name), f"{name}_launch")
        fn.argtypes = list(SIGNATURES[name]) + [_P]
        fn.restype = ctypes.c_int
        _fns[name] = fn
    return fn


def launch(name: str, *args) -> None:
    """Calls `<name>_launch(*args, stream)` from the kernel library
    `name` on the current stream of the first tensor's device; raises if
    the launch was refused."""
    if len(args) != len(SIGNATURES[name]):
        raise TypeError(f"{name}: {len(args)} arguments, expected "
                        f"{len(SIGNATURES[name])}")
    dev = next(a.device for a in args if isinstance(a, torch.Tensor))
    fn = _launcher(name)
    stream = torch.cuda.current_stream(dev).cuda_stream
    with torch.cuda.device(dev):
        err = fn(*[a.data_ptr() if isinstance(a, torch.Tensor) else int(a)
                   for a in args], stream)
    if err != 0:
        raise RuntimeError(f"{name}: kernel launch failed with CUDA error "
                           f"{err}")
    LAUNCHES[name] += 1
