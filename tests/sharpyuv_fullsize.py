"""The port's sharp YUV against the reference's at full size, on the CPU.

    JAX_PLATFORMS=cpu python tests/sharpyuv_fullsize.py [--w 1536 --h 1024]

Prints, per image, the samples of Y, U and V where
webp_tpu_torch.ops.sharpyuv.sharp_yuv420 differs from the reference's
jitted webp_tpu.ops.sharpyuv.sharp_yuv420, and the largest difference.
It also prints, per refinement iteration, the whole-image sum of |diff_y|
that the early exit compares, taken in float64 (as the port takes it)
and in float32, the exit decision each gives, and the smallest relative
distance of the sum from the two values it is compared with (the
threshold and the previous iteration's sum): where that distance is far
above float32's rounding of a sum of this many terms, the order and width
of the sum cannot change the decision.

The images: a smooth gradient (the content on which a one-ulp `pow`
difference flips a sample) and two of chip_smoke.py's photo-like images.
Not a test: the reference's program at this size is too slow to compile
for the tier-1 run."""

import argparse
import os
import sys

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import jax  # noqa: E402

from chip_smoke import synth_images  # noqa: E402
from webp_tpu.ops import sharpyuv as SY_ref  # noqa: E402
from webp_tpu_torch.ops import sharpyuv as SY  # noqa: E402


def smooth(h, w):
    y, x = np.mgrid[0:h, 0:w]
    img = np.stack([x * 255 // (w - 1), y * 255 // (h - 1),
                    (x + y) * 255 // (w + h - 2)], -1)
    return img.astype(np.uint8)


def exit_sums(rgb):
    """The port's refinement loop (SY.sharp_yuv420's, one image) with its
    |diff_y| sum in float64 and float32 at each iteration: a list of
    (f64 sum, f32 sum, decision by f64, decision by f32, margin)."""
    h, w = rgb.shape[1:3]
    rgb10 = rgb.to(torch.float32) * 4.0
    best_y = SY._gray(rgb10[..., 0], rgb10[..., 1], rgb10[..., 2])
    w_target = SY._w_unscaled(rgb10)
    target_uv = SY._update_chroma(rgb10)
    best_uv = target_uv
    thr = 3.0 * w * h
    out, prev64, prev32, done = [], None, None, False
    for it in range(SY.NUM_ITERATIONS):
        if done:
            break
        rec = SY._interpolate(best_y, best_uv)
        diff_y = SY._fma(w_target, SY.MAX_Y,
                         -(SY._w_unscaled(rec) * SY.MAX_Y))
        best_y = torch.clamp(best_y + diff_y, 0.0, SY.MAX_Y)
        best_uv = best_uv + (target_uv - SY._update_chroma(rec))
        s64 = float(diff_y.abs().sum(dtype=torch.float64))
        s32 = float(diff_y.abs().sum(dtype=torch.float32))
        if it > 0:
            d64 = s64 < thr or s64 > prev64
            d32 = s32 < thr or s32 > prev32
            margin = min(abs(s64 - thr) / thr, abs(s64 - prev64) / prev64)
            out.append((it, s64, s32, d64, d32, margin))
            done = d64
        prev64, prev32 = s64, s32
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--w", type=int, default=1536)
    ap.add_argument("--h", type=int, default=1024)
    ap.add_argument("--seed", type=int, default=0)
    a = ap.parse_args()
    imgs = {"smooth": smooth(a.h, a.w)}
    for i, img in enumerate(synth_images(np.random.default_rng(a.seed), 2,
                                         a.h, a.w)):
        imgs[f"photo{i}"] = img
    ref_fn = jax.jit(SY_ref.sharp_yuv420)
    total = 0
    for name, img in imgs.items():
        got = SY.sharp_yuv420(torch.as_tensor(img[None]))
        ref = ref_fn(img)
        parts = []
        for plane, g, r in zip("YUV", got, ref):
            d = np.abs(g[0].numpy().astype(np.int32)
                       - np.asarray(r).astype(np.int32))
            n = int((d != 0).sum())
            total += n
            parts.append(f"{plane} {n} of {d.size} (max {int(d.max())})")
        print(f"{name} {a.w}x{a.h}: differing samples " + ", ".join(parts),
              flush=True)
        for it, s64, s32, d64, d32, m in exit_sums(torch.as_tensor(img[None])):
            print(f"  iteration {it}: |diff_y| sum {s64!r} (float64), "
                  f"{s32!r} (float32); exit {d64} / {d32}; relative "
                  f"margin {m:.3e}", flush=True)
    print(f"total differing samples: {total}")


if __name__ == "__main__":
    main()
