"""Drives the PyTorch/CUDA port (webp_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each of which raises on failure (the script then exits nonzero):

  1. The card's name and power limit (nvidia-smi) and torch's device name.
  2. Builds the three CUDA kernels (nvcc, sm_90a) and the host entropy
     coder (g++) from the checkout's sources, all compilers at once.
  3. The main path, counted: webp_tpu_torch.encode_batch on B=16 synthetic
     1536x1024 images (made from --seed), with every kernel's launch count
     set to 0 just before and read just after; each kernel must have run.
     Every output must carry a RIFF/WEBP/VP8 header of the right size.
  4. Each kernel at the main path's shapes (its inputs recorded during the
     counted run) against its plain PyTorch version on the same card
     tensors: decisions and alphas exact, f32 scores within rtol 3e-7.
     Median kernel time (CUDA events), plain-version time and the bound.
  5. Throughput: end to end (numpy images in, WebP bytes out) and
     device-compute only (.rgbp_blob with the planes resident), and the
     device time per stage.
  6. On-card parity: small images encoded with device="cpu" (the plain
     versions) and device="cuda" must give byte-identical files,
     including a q99 noise image that takes the escape-overflow fallback.

The line before the last is a JSON object {"kernels": [...]} with each
kernel's route, source, the TPU kernel it replaces, launches, error,
times and bound; the last line is {"ok": true, "device": {...}}.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)

W, H, B = 1536, 1024, 16
QUALITY = 75
SCORE_RTOL = 3e-7

# H100 SXM peaks (NVIDIA data sheet): HBM bandwidth, and the INT32 rate of
# 64 INT32 lanes per SM x 132 SMs at the 1980 MHz boost clock. These
# kernels do integer work, so their operation bound is the INT32 rate.
HBM_BYTES_PER_S = 3.35e12
INT32_OPS_PER_S = 64 * 132 * 1.98e9

# Integer operations of the algorithm per unit of work (adds, multiplies,
# shifts, compares, selects, table reads), counted from the kernels'
# arithmetic: a 4x4 forward DCT 160, inverse DCT 144, 4x4 WHT 80, the
# weighted Hadamard texture measure 112, quantize + dequantize + error +
# rate walk 20 per coefficient, reconstruct-and-clamp 48 per block.
# Hopper's three-input add, three-input logic op and integer
# multiply-add each retire up to two counted operations in one issue, so
# this bound is an estimate a kernel can approach closely, not a wall.
_FDCT, _IDCT, _WHT, _HAD, _QC, _REC = 160, 144, 80, 112, 20, 48


def _ops_alpha_per_mb():
    # 24 blocks: pixel sum 16, DC removal 16, FDCT, 16 histogram updates
    # of 4 ops; two 32-bin scans of 3 ops.
    return 24 * (16 + 16 + _FDCT + 16 * 4) + 2 * 32 * 3


def _ops_mode_per_mb(use_td):
    blk = 16 + 16 + _FDCT + 15 * _QC            # predict, residual, DCT, quant
    td = _IDCT + _REC + _HAD + 3                 # TDisto per block
    i16 = 16 * blk + (_WHT + 16 * _QC + _WHT) + 16 * 3 + 64 + 5
    if use_td:
        i16 += 16 * td
    uv = 8 * (16 + 16 + _FDCT + 16 * _QC) + 10
    return 4 * i16 + 4 * uv + (16 * _HAD if use_td else 0)


def _ops_i4_per_sb(use_td):
    per_mode = 16 + 16 + _FDCT + 16 * _QC + 5
    if use_td:
        per_mode += _IDCT + _REC + _HAD + 3
    return 10 * per_mode + 110 + (_HAD if use_td else 0)


def bound_ms(n_bytes, n_ops):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / INT32_OPS_PER_S * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes > t_ops else "operations")


def card_info():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip()
    return out.splitlines()[0].strip()


def synth_images(rng, n, h, w):
    """Photo-like test content: smooth gradients and blobs, a textured
    region, hard edges and thin stripes."""
    y = np.linspace(0.0, 1.0, h, dtype=np.float32)[:, None]
    x = np.linspace(0.0, 1.0, w, dtype=np.float32)[None, :]
    out = np.empty((n, h, w, 3), np.uint8)
    for i in range(n):
        f = rng.uniform(1.0, 4.0, 3).astype(np.float32)
        ph = rng.uniform(0.0, 6.28, 3).astype(np.float32)
        img = np.empty((h, w, 3), np.float32)
        for c in range(3):
            img[..., c] = 128 + 90 * np.sin(f[c] * 3.1 * x + ph[c]) \
                * np.cos(f[(c + 1) % 3] * 2.3 * y + ph[(c + 2) % 3])
        cy, cx = rng.uniform(0.2, 0.8, 2)
        blob = np.exp(-((x - cx) ** 2 + (y - cy) ** 2) * 20.0)
        img += blob[..., None] * rng.uniform(-80, 80, 3).astype(np.float32)
        th, tw = h // 3, w // 3
        ty, tx = rng.integers(0, h - th), rng.integers(0, w - tw)
        img[ty:ty + th, tx:tx + tw] += rng.normal(
            0, 18, (th, tw, 3)).astype(np.float32)
        ey = rng.integers(h // 4, 3 * h // 4)
        img[ey:, : w // 5] = rng.uniform(0, 255, 3)
        sw = min(64, w // 4)
        sx = rng.integers(0, w - sw)
        img[:, sx:sx + sw:4] = 255.0
        out[i] = np.clip(img + 0.5, 0, 255).astype(np.uint8)
    return out


def check_webp(data: bytes, w: int, h: int):
    if not (len(data) > 30 and data[:4] == b"RIFF" and data[8:12] == b"WEBP"
            and data[12:16] == b"VP8 "):
        raise AssertionError("output is not a RIFF/WEBP/VP8 file")
    if int.from_bytes(data[4:8], "little") != len(data) - 8:
        raise AssertionError("RIFF size field disagrees with the file")
    frame = data[20:]
    if frame[3:6] != b"\x9d\x01\x2a":
        raise AssertionError("VP8 start code missing")
    fw = int.from_bytes(frame[6:8], "little") & 0x3FFF
    fh = int.from_bytes(frame[8:10], "little") & 0x3FFF
    if (fw, fh) != (w, h):
        raise AssertionError(f"VP8 frame is {fw}x{fh}, expected {w}x{h}")


def time_ms(fn, reps):
    """Median milliseconds of fn() over `reps` runs, CUDA events."""
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def wall_s(fn, reps):
    """Median host seconds of fn() over `reps` runs, each ending in a
    torch.cuda.synchronize()."""
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


def once(fn):
    """(fn(), host seconds) for one run ending in torch.cuda.synchronize()."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def hold(name, kernel, plain, args, replaces, launches, n_bytes, n_ops):
    """Runs a kernel wrapper and its plain version on the same card
    tensors: integer outputs (modes, alphas) must be equal, float outputs
    (scores) within SCORE_RTOL. Times both and returns the kernel's
    record; "mismatches" counts the outputs that disagree."""
    got, ref = kernel(*args), plain(*args)
    mismatches = sum(
        not torch.allclose(g, r, rtol=SCORE_RTOL, atol=0)
        if g.is_floating_point() else not torch.equal(g, r)
        for g, r in zip(got, ref))
    err = max(float((g.double() - r.double()).abs().max())
              for g, r in zip(got, ref))
    ms = time_ms(lambda: kernel(*args), 20)
    plain_ms = time_ms(lambda: plain(*args), 3)
    bd, by = bound_ms(n_bytes, n_ops)
    print(f"kernel {name}: {launches[name]} launch(es) on the main path; "
          f"{'exact' if not mismatches else 'DISAGREES'} (max abs err "
          f"{err}); {ms:.3f} ms, plain {plain_ms:.3f} ms, bound {bd:.3f} ms "
          f"by {by}", flush=True)
    return dict(name=name, route="cuda",
                source=f"webp_tpu_torch/csrc/{name}.cu", replaces=replaces,
                launches=launches[name], max_abs_err=err, ms=ms,
                plain_ms=plain_ms, bound_ms=bd, bound_by=by, library_ms=None,
                mismatches=mismatches)


class Recorder:
    """Wraps a kernel wrapper so that the main path's call records its
    (card) inputs; the kernel and its plain version are then held against
    each other on exactly those tensors."""

    def __init__(self, module, name):
        self.module, self.name = module, name
        self.orig = getattr(module, name)
        self.calls = []

    def __enter__(self):
        def rec(*args):
            self.calls.append(args)
            return self.orig(*args)
        setattr(self.module, self.name, rec)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.orig)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    import webp_tpu_torch
    from webp_tpu_torch import _build
    from webp_tpu_torch.lossy import device_encode as DE
    from webp_tpu_torch.ops import cuda as KC
    from webp_tpu_torch.ops import fastpath as FP
    from webp_tpu_torch.ops import i4_kernel as I4K
    from webp_tpu_torch.ops import p1_kernels as P1K
    from webp_tpu_torch.ops import yuv as YUV

    dev = torch.device("cuda")
    # 1. The card.
    name = torch.cuda.get_device_name(0)
    print(card_info(), flush=True)
    print(f"torch device: {name}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}", flush=True)

    # 2. Build every library of the path, all compilers at once.
    t0 = time.perf_counter()
    spent = _build.build(["webp_enc"] + list(_build.KERNEL_LIBS))
    print(f"build: {time.perf_counter() - t0:.1f} s wall; per library "
          + ", ".join(f"{k} {v:.1f} s" for k, v in spent.items()), flush=True)

    rng = np.random.default_rng(args.seed)
    imgs = synth_images(rng, B, H, W)

    # 3. The main path, counted; the kernels' card inputs are recorded.
    with Recorder(P1K, "alphas") as r_alpha, \
            Recorder(P1K, "mode_search") as r_mode, \
            Recorder(I4K, "i4_scores") as r_i4:
        DE.FALLBACKS["images"] = 0
        KC.reset_launches()
        t0 = time.perf_counter()
        files = webp_tpu_torch.encode_batch(list(imgs), QUALITY)
        first_s = time.perf_counter() - t0
        launches = dict(KC.LAUNCHES)
    fallbacks = DE.FALLBACKS["images"]
    print(f"main path: encode_batch B={B} {W}x{H} q{QUALITY} first call "
          f"{first_s:.2f} s; launches {launches}; escape-overflow "
          f"fallbacks {fallbacks}", flush=True)
    for k, n in launches.items():
        if n <= 0:
            raise AssertionError(f"kernel {k} did not run on the main path")
    if len(files) != B:
        raise AssertionError(f"{len(files)} files for {B} images")
    for f in files:
        check_webp(f, W, H)
    print(f"main path: {B} valid WebP files, "
          f"{sum(map(len, files)) / B / 1024:.1f} KiB mean", flush=True)

    # 4. Each kernel against its plain version at the main path's shapes.
    n_mb = (W // 16) * (H // 16)
    L, n_sb = B * n_mb, B * 16 * n_mb
    a_args = r_alpha.calls[0]
    m_args = r_mode.calls[0]
    i_args = r_i4.calls[0]

    def in_bytes(args):
        return sum(a.numel() * a.element_size() for a in args
                   if isinstance(a, torch.Tensor))

    kernels = [
        hold("p1_alpha", P1K.alphas, P1K.alphas_plain, a_args,
             "webp_tpu/ops/pallas_p1.py:500", launches,
             in_bytes(a_args) + 8 * L, _ops_alpha_per_mb() * L),
        hold("p1_mode", P1K.mode_search, P1K.mode_search_plain, m_args,
             "webp_tpu/ops/pallas_p1.py:173", launches,
             in_bytes(m_args) + 12 * L, _ops_mode_per_mb(m_args[-1]) * L),
        hold("i4_search", I4K.i4_scores, I4K.i4_scores_plain, i_args,
             "webp_tpu/ops/pallas_i4.py:72", launches,
             in_bytes(i_args) + 8 * n_sb, _ops_i4_per_sb(i_args[-1]) * n_sb),
    ]
    bad = [k["name"] for k in kernels if k.pop("mismatches")]
    if bad:
        raise AssertionError(f"kernels disagree with their plain versions: "
                             f"{bad}")

    # 5. Throughput and where the device time goes.
    px = B * W * H
    e2e = wall_s(lambda: webp_tpu_torch.encode_batch(list(imgs), QUALITY), 2)
    fn = FP.fast_encode_fn(W // 16, H // 16, QUALITY, 4, 50)
    planes = torch.as_tensor(np.ascontiguousarray(
        imgs.transpose(0, 3, 1, 2))).to(dev)
    dev_s = wall_s(lambda: fn.rgbp_blob(planes), 2)
    print(f"throughput: end to end {px / e2e / 1e6:.2f} Mpx/s "
          f"({e2e:.3f} s per batch); device compute only (rgbp_blob, "
          f"input resident) {px / dev_s / 1e6:.2f} Mpx/s ({dev_s:.3f} s)",
          flush=True)
    stage = {}
    yuv, stage["yuv"] = once(lambda: YUV.rgb_planes_to_yuv420(
        planes[:, 0], planes[:, 1], planes[:, 2]))
    p1, stage["phase0_1_i4"] = once(lambda: fn.part1_batched(*yuv))
    p2, stage["phase2_loop"] = once(lambda: fn.phase2(*yuv, p1))
    _, stage["pack_blob"] = once(lambda: FP._blobify(fn.pack(*p2, p1)))
    steps = W // 16 + H // 16 - 1
    print("device stages (s): " + ", ".join(
        f"{k} {v:.4f}" for k, v in stage.items())
        + f"; phase-2 steps {steps}, {stage['phase2_loop'] / steps * 1e3:.2f}"
        " ms per step", flush=True)

    # 6. On-card parity with the plain versions, small images.
    rng_s = np.random.default_rng(args.seed + 1)
    for (w, h, q) in ((64, 48, 75), (72, 40, 75)):
        small = list(synth_images(rng_s, 2, h, w))
        on_cpu = webp_tpu_torch.encode_batch(small, q, device="cpu")
        on_card = webp_tpu_torch.encode_batch(small, q, device="cuda")
        if on_cpu != on_card:
            raise AssertionError(f"{w}x{h}: card and CPU files differ")
        for f in on_card:
            check_webp(f, w, h)
    noise = [np.random.default_rng(args.seed + 2).integers(
        0, 256, (96, 128, 3), np.uint8)]
    DE.FALLBACKS["images"] = 0
    on_card = webp_tpu_torch.encode_batch(noise, 99, device="cuda")
    if DE.FALLBACKS["images"] != 1:
        raise AssertionError("q99 noise did not take the host fallback")
    if on_card != webp_tpu_torch.encode_batch(noise, 99, device="cpu"):
        raise AssertionError("q99 noise: card and CPU files differ")
    print("parity: card == CPU plain versions, byte for byte, on 64x48, "
          "72x40 and the q99 escape-overflow image", flush=True)

    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
