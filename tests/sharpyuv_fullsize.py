"""The port's sharp YUV against the reference's at full size, on the CPU.

    JAX_PLATFORMS=cpu python tests/sharpyuv_fullsize.py [--w 1536 --h 1024]
        [--more]

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
difference flips a sample) and two of chip_smoke.py's photo-like images;
with --more also seven on which the refinement behaves differently:
uniform noise (two iterations), saturated noise, one-pixel red/blue and
two-pixel red/green checkerboards, sparse dots on two backgrounds and a
mosaic of saturated and mid-grey noise (three iterations each).
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
    y_rec = best_y
    for it in range(SY.NUM_ITERATIONS):
        if done:
            break
        rec = SY._interpolate(y_rec, best_uv)
        w_rec = SY._w_unscaled(rec)
        diff_y = SY._fma(-w_rec, SY.MAX_Y, w_target * SY.MAX_Y)
        new_y = torch.clamp(best_y + diff_y, 0.0, SY.MAX_Y)
        if it == 0:
            diff_y = SY._fma(w_target, SY.MAX_Y, -(w_rec * SY.MAX_Y))
            y_rec = torch.clamp(best_y + diff_y, 0.0, SY.MAX_Y)
        best_y = new_y
        if it > 0:
            y_rec = best_y
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


def more_images(h, w, seed):
    """Seven images on which the refinement runs two or three iterations
    (see the module docstring)."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]

    def pick(cond, a, b):
        return np.where(cond[..., None], a, b)

    dots = (x % 4 == 0) & (y % 4 == 0)
    imgs = {
        "noise": rng.integers(0, 256, (h, w, 3)),
        "saturated_noise": rng.integers(0, 2, (h, w, 3)) * 255,
        "checker_rb": pick((x + y) % 2 == 1, [255, 0, 0], [0, 0, 255]),
        "checker_rg2": pick((x // 2 + y // 2) % 2 == 1, [255, 0, 0],
                            [0, 255, 0]),
        "dots": pick(dots, [255, 255, 0], [0, 0, 80]),
        "dots_noisy": pick(dots, [255, 230, 0], [0, 20, 140])
        + rng.integers(0, 30, (h, w, 3)),
        "mosaic": pick((x // 7 + y // 5) % 3 == 0,
                       rng.integers(0, 2, (h, w, 3)) * 255,
                       rng.integers(60, 200, (h, w, 3))),
    }
    return {k: np.clip(v, 0, 255).astype(np.uint8) for k, v in imgs.items()}


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--w", type=int, default=1536)
    ap.add_argument("--h", type=int, default=1024)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--more", action="store_true")
    a = ap.parse_args()
    imgs = {"smooth": smooth(a.h, a.w)}
    for i, img in enumerate(synth_images(np.random.default_rng(a.seed), 2,
                                         a.h, a.w)):
        imgs[f"photo{i}"] = img
    if a.more:
        imgs.update(more_images(a.h, a.w, a.seed))
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
    return total


if __name__ == "__main__":
    main()
