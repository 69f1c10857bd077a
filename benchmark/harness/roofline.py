"""Operations, bytes and the least time of the measured package's four
hand-written kernels, at a batch's shapes.

The counts are those of the repository's card smoke script
(chip_smoke.py: _ops_*, bound_ms and phase 4's byte counts), copied here
so that later changes to the program cannot move the yardstick. Bytes
count each input once in and each output once out; the input sizes are
the kernels' argument tensors as the program passes them, recorded at
small sizes on the CPU and written as formulas in the batch's shapes.

Peaks of one NVIDIA H100 SXM: HBM at 3.35 TB/s (NVIDIA's data sheet) and
an INT32 rate of 64 lanes x 132 SMs x 1.98 GHz, derived from the
architecture (no data sheet quotes it). These kernels do integer work,
so their operation bound is the INT32 rate. Hopper's three-input add,
three-input logic op and integer multiply-add retire up to two counted
operations per instruction, so the operation bound is an estimate a kernel
can approach closely, not a wall.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 64 * 132 * 1.98e9

# Integer operations per unit of work: a 4x4 forward DCT 160, inverse DCT
# 144, 4x4 WHT 80, the weighted Hadamard texture measure 112, quantize +
# dequantize + error + rate walk 20 per coefficient, reconstruct and
# clamp 48 per block.
_FDCT, _IDCT, _WHT, _HAD, _QC, _REC = 160, 144, 80, 112, 20, 48

# The profiler's kernel names (kernel_name of the demangled names) of each
# hand-written kernel; kernel 4 is the wavefront and its escape-list pass.
KERNEL_NAMES = {
    "p1_alpha": ("p1_alpha_kernel",),
    "p1_mode": ("p1_mode_kernel",),
    "i4_search": ("i4_search_kernel",),
    "p2_wavefront": ("p2_wavefront_kernel", "p2_escape_kernel"),
}


def kernel_name(name: str) -> str:
    """A profiler kernel name without its arguments and namespaces:
    "(anonymous namespace)::p1_mode_kernel(unsigned char const*, ...)" is
    "p1_mode_kernel"."""
    base = name.replace("(anonymous namespace)::", "").split("(", 1)[0]
    return base.rsplit("::", 1)[-1].strip()


def kernel_of(name: str):
    """The hand-written kernel a profiler kernel name belongs to, or None."""
    base = kernel_name(name)
    for kernel, names in KERNEL_NAMES.items():
        if base in names:
            return kernel
    return None


def ops_alpha_per_mb() -> int:
    # 24 blocks: pixel sum 16, DC removal 16, FDCT, 16 histogram updates
    # of 4 ops; two 32-bin scans of 3 ops.
    return 24 * (16 + 16 + _FDCT + 16 * 4) + 2 * 32 * 3


def ops_mode_per_mb(use_td: bool) -> int:
    blk = 16 + 16 + _FDCT + 15 * _QC            # predict, residual, DCT, quant
    td = _IDCT + _REC + _HAD + 3                 # TDisto per block
    i16 = 16 * blk + (_WHT + 16 * _QC + _WHT) + 16 * 3 + 64 + 5
    if use_td:
        i16 += 16 * td
    uv = 8 * (16 + 16 + _FDCT + 16 * _QC) + 10
    return 4 * i16 + 4 * uv + (16 * _HAD if use_td else 0)


def ops_i4_per_sb(use_td: bool) -> int:
    per_mode = 16 + 16 + _FDCT + 16 * _QC + 5
    if use_td:
        per_mode += _IDCT + _REC + _HAD + 3
    return 10 * per_mode + 110 + (_HAD if use_td else 0)


def ops_p2(n_i16: int, n_i4: int, n_mb: int) -> int:
    """Phase 2, counting each MB's chosen luma pipeline only (the kernel
    runs just that one): per 4x4 block predict 16, residual 16, the DCT
    pair, quantize + dequantize, reconstruct, pack; an I16 MB adds its
    contour sums, the WHT pair and the y2 quantization, an I4 subblock its
    contour's smoothed strips; chroma is 8 blocks and its contour sums
    for every MB."""
    blk = 16 + 16 + _FDCT + 16 * 12 + _IDCT + _REC + 16 * 4
    i16 = 16 * blk + 32 + 2 * _WHT + 16 * 12
    i4 = 16 * (blk + 110)
    return n_i16 * i16 + n_i4 * i4 + n_mb * (8 * blk + 32)


# The rate-constant table every search kernel reads (978 int32).
_RC_BYTES = 978 * 4


def kernel_work(kernel: str, B: int, w16: int, h16: int, use_td: bool,
                n_i4: int = 0):
    """(bytes, operations) of one launch of `kernel` on a batch of B
    images of w16 x h16 macroblocks. n_i4: the batch's I4 macroblocks
    (kernel 4 only)."""
    L = B * w16 * h16
    if kernel == "p1_alpha":
        return 384 * L + 8 * L, ops_alpha_per_mb() * L
    if kernel == "p1_mode":
        n_in = (384 + 70) * L + B * (48 * 16 * 4 + 16 * 4) + _RC_BYTES
        return n_in + 12 * L, ops_mode_per_mb(use_td) * L
    if kernel == "i4_search":
        n_sb = 16 * L
        n_in = 32 * n_sb + B * (16 * 16 * 4 + 12 * 4) + _RC_BYTES
        return n_in + 8 * n_sb, ops_i4_per_sb(use_td) * n_sb
    if kernel == "p2_wavefront":
        pixels = B * (16 * w16) * (16 * h16)
        n_in = pixels * 3 // 2 + 23 * L + B * 48 * 16 * 4
        # Out: nibbles 24 x 8, int16 levels 24 x 16, y2 16 x 2, bitmap 4
        # and skip 1 bytes per MB.
        n_out = L * (24 * 8 + 24 * 16 * 2 + 16 * 2 + 4 + 1)
        return n_in + n_out, ops_p2(L - n_i4, n_i4, L)
    raise ValueError(f"unknown kernel {kernel!r}")


def bound_s(n_bytes: float, n_ops: float):
    """(least seconds, "bytes" or "operations": whichever binds)."""
    t_bytes = n_bytes / HBM_BYTES_PER_S
    t_ops = n_ops / INT32_OPS_PER_S
    return (t_bytes, "bytes") if t_bytes > t_ops else (t_ops, "operations")
