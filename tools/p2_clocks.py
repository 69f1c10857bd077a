"""Where a step of the phase-2 wavefront kernel goes, in SM clock cycles.

    python3 tools/p2_clocks.py

Needs one CUDA card. Copies webp_tpu_torch into _probe/p2_clocks/ with
csrc/p2_wavefront.cu instrumented: lane 0 of every warp working on image
0 stamps clock() when it leaves the step barrier, when its MB starts,
after the MB's contour fill, after its pipeline (the I4 walk, the I16 or
the chroma rounds), when the MB ends and when it reaches the barrier, and
notes the MB's kind. It builds the copy, runs the kernel on random modes
(tests/test_torch_cuda.py p2_inputs, a fifth of the MBs I4) at 1536x1024
for B = 16 and B = 1, and on a one-MB-row frame (1536x16, all I4 or all
I16, so one MB runs per step), and prints per MB kind the median cycles
of fill, pipeline and tail, and per step the median over steps of the
slowest warp's gap (barrier exit to MB start), MB, tail (MB end to
barrier) and barrier wait. The stamps cost a few instructions each, so the
instrumented kernel runs slightly slower than the real one.
"""

from __future__ import annotations

import ctypes
import os
import shutil
import subprocess
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
COPY = os.path.join(ROOT, "_probe", "p2_clocks")
STEPS_MAX = 256
REC = 8             # stamps per (rank, warp, step)

REC_AT = ("k.rec = (k.img == 0 && t < 256) ? g_clk + (((int)cluster"
          ".block_rank() * 16 + (int)(threadIdx.x >> 5)) * 256 + t) * 8 : "
          "nullptr;\n")

# (text of csrc/p2_wavefront.cu, its instrumented replacement)
PATCHES = [
    ("namespace {\n",
     "namespace {\n__device__ unsigned g_clk[8 * 16 * 256 * 8];\n"
     "#define CLK(i) do { if (k.rec && k.lane == 0) "
     "k.rec[i] = (unsigned)clock(); } while (0)\n"),
    ("  size_t m;                     // raster MB index over the batch\n",
     "  size_t m;\n  unsigned* rec;\n"),
    ("      if constexpr (kChroma) chroma_mb(a, k, cur);\n"
     "      else luma_mb(a, k, cur);\n    }\n    cluster.sync();\n",
     "      " + REC_AT + "      CLK(1);\n"
     "      if constexpr (kChroma) chroma_mb(a, k, cur);\n"
     "      else luma_mb(a, k, cur);\n      CLK(4);\n    }\n"
     "    " + REC_AT + "    CLK(5);\n    cluster.sync();\n    CLK(0);\n"),
    ("  int16_t* lvb = reinterpret_cast<int16_t*>(k.slot + S_LV);\n"
     "  bool y2nz",
     "  CLK(2);\n  if (k.rec && lane == 0) k.rec[6] = in.i4 ? 1 : 0;\n"
     "  int16_t* lvb = reinterpret_cast<int16_t*>(k.slot + S_LV);\n"
     "  bool y2nz"),
    ("  unsigned f = 0;\n  if (lane < 16)\n",
     "  CLK(3);\n  unsigned f = 0;\n  if (lane < 16)\n"),
    ("  // The contour sums, a plane side per 8 lanes",
     "  CLK(2);\n  if (k.rec && lane == 0) k.rec[6] = 2;\n"
     "  // The contour sums, a plane side per 8 lanes"),
    ("  unsigned f = 0;\n  if (lane < 8)\n",
     "  CLK(3);\n  unsigned f = 0;\n  if (lane < 8)\n"),
]

READER = """
extern "C" int p2_clk_read(void* dst) {
  return (int)cudaMemcpyFromSymbol(dst, g_clk, sizeof(g_clk));
}
extern "C" int p2_clk_clear() {
  static unsigned z[8 * 16 * 256 * 8];
  return (int)cudaMemcpyToSymbol(g_clk, z, sizeof(z));
}
"""


def instrumented_copy():
    shutil.rmtree(COPY, ignore_errors=True)
    shutil.copytree(os.path.join(ROOT, "webp_tpu_torch"),
                    os.path.join(COPY, "webp_tpu_torch"),
                    ignore=shutil.ignore_patterns("_build", "__pycache__"))
    path = os.path.join(COPY, "webp_tpu_torch", "csrc", "p2_wavefront.cu")
    src = open(path).read()
    for old, new in PATCHES:
        if src.count(old) != 1:
            raise SystemExit(f"p2_wavefront.cu does not hold exactly one "
                             f"{old!r}: update tools/p2_clocks.py")
        src = src.replace(old, new)
    open(path, "w").write(src + READER)


def breakdown(lib, P2K, args, W, H, B):
    import torch
    P2K.wavefront(*args, 1024.0, 1024)
    torch.cuda.synchronize()
    if lib.p2_clk_clear() != 0:
        raise RuntimeError("p2_clk_clear failed")
    P2K.wavefront(*args, 1024.0, 1024)
    torch.cuda.synchronize()
    buf = np.zeros(8 * 16 * STEPS_MAX * REC, np.uint32)
    if lib.p2_clk_read(buf.ctypes.data_as(ctypes.c_void_p)) != 0:
        raise RuntimeError("p2_clk_read failed")
    steps = W // 16 + H // 16 - 1
    C = P2K.cluster_size(B, H // 16, P2K.sm_count(torch.device("cuda")))
    r = buf.reshape(8, 16, STEPS_MAX, REC).astype(np.int64)[:C, :, :steps]

    def d(i, j):
        return (r[..., j] - r[..., i]) % (1 << 32)

    active, kind = r[..., 4] != 0, r[..., 6]
    luma_warp = (np.arange(16) % 2 == 0)[None, :, None]
    lines = []
    for name, kv in (("I16", 0), ("I4", 1), ("chroma", 2)):
        m = active & (kind == kv) & (luma_warp if kv < 2 else ~luma_warp)
        if m.any():
            lines.append(
                f"  {name} MB: {int(m.sum())} MBs, median {np.median(d(1, 4)[m]):.0f} "
                f"cycles (p90 {np.percentile(d(1, 4)[m], 90):.0f}): fill "
                f"{np.median(d(1, 2)[m]):.0f}, pipeline "
                f"{np.median(d(2, 3)[m]):.0f}, tail {np.median(d(3, 4)[m]):.0f}")
    rows = []
    for t in range(1, steps):
        act = active[:, :, t]
        if not act.any():
            continue
        end = np.where(act, (r[:, :, t, 4] - r[:, :, t - 1, 0]) % (1 << 32), -1)
        x = r[np.unravel_index(np.argmax(end), end.shape)]
        rows.append([(x[t, 1] - x[t - 1, 0]) % (1 << 32),
                     (x[t, 4] - x[t, 1]) % (1 << 32),
                     (x[t, 5] - x[t, 4]) % (1 << 32),
                     (x[t, 0] - x[t, 5]) % (1 << 32), x[t, 6]])
    s = np.array(rows)
    lines.append(
        f"  per step, the warp that ends last (median over {len(s)} steps): "
        f"gap {np.median(s[:, 0]):.0f}, MB {np.median(s[:, 1]):.0f}, tail "
        f"{np.median(s[:, 2]):.0f}, barrier {np.median(s[:, 3]):.0f} "
        f"cycles; its MB is I16 / I4 / chroma in "
        f"{[int((s[:, 4] == k).sum()) for k in (0, 1, 2)]} steps")
    return lines


def main():
    import torch
    if not torch.cuda.is_available():
        print("p2_clocks: no CUDA device is available", file=sys.stderr)
        return 2
    instrumented_copy()
    sys.path.insert(0, COPY)
    sys.path.insert(0, os.path.join(ROOT, "tests"))
    from webp_tpu_torch import _build
    from webp_tpu_torch.ops import p2_kernel as P2K
    from test_torch_cuda import p2_args, p2_inputs
    assert P2K.__file__.startswith(COPY), P2K.__file__
    _build.build(["p2_wavefront"])
    lib = _build.load("p2_wavefront")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    print(card)
    for (W, H, B, split) in ((1536, 1024, 16, None), (1536, 1024, 1, None),
                             (1536, 16, 1, "i4"), (1536, 16, 1, "i16")):
        d = p2_inputs(B, W, H, W + H + B)
        if split is None:
            d["is_i4"] = np.random.default_rng(0).random(d["is_i4"].shape) < 0.2
        else:
            d["is_i4"][:] = split == "i4"
        print(f"{W}x{H} B={B} {split or 'a fifth I4'}:")
        print("\n".join(breakdown(lib, P2K, p2_args(d, "cuda"), W, H, B)),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
