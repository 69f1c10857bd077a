"""Drives the PyTorch/CUDA port (webp_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each of which raises on failure (the script then exits nonzero):

  1. The card's name and power limit (nvidia-smi) and torch's device name.
  2. Builds the four CUDA kernels (nvcc, sm_90a) and the host libraries
     (entropy coder and YUV importer; the VP8 and VP8L decoders and the
     upsampler; the VP8L encoder's coder and searches; g++) from the
     checkout's sources, all compilers at once, and prints each
     kernel's registers, shared memory and spills as ptxas reported them.
  3. The main path, counted: webp_tpu_torch.encode_batch on B=16 synthetic
     1536x1024 images (made from --seed), with every kernel's launch count
     set to 0 just before and read just after; each kernel must have run
     exactly once (one batch). Every output must carry a RIFF/WEBP/VP8
     header of the right size.
  4. Each kernel at the main path's shapes (its inputs recorded during the
     counted run) against its plain PyTorch version on the same card
     tensors: decisions, alphas and every phase-2 output exact, f32 scores
     within rtol 3e-7. Median kernel time (CUDA events), plain-version time
     (one run of the phase-2 step loop, which takes seconds) and the bound
     with its basis; the phase-2 kernel's cluster size, block count and
     time per anti-diagonal step, and its time on the first image alone
     (one cluster on an otherwise idle card: the chain of steps).
  5. Throughput: end to end (numpy images in, WebP bytes out) and
     device-compute only (.rgbp_blob with the planes resident), encode_batch
     split into its device round trip and its host tail, the device time
     per stage and the phase-2 kernel's time per anti-diagonal step.
  6. On-card parity: small images encoded with device="cpu" (the plain
     versions) and device="cuda" must give byte-identical files, on 64x48,
     72x40, a one-MB column (16x64), a one-MB row (64x16), the stream with
     host YUV (its launches counted: each kernel once per batch), and a
     q99 noise image that takes the escape-overflow fallback.
  7. The pipelined stream: encode_lossy_stream over 32 images at 1536x1024
     in batches of 16, its Mpx/s beside encode_batch's on the same images
     (three runs each, alternating), its files equal to encode_batch's,
     and the launches of its first run counted: each kernel once per
     batch.
  8. The single-image entry webp_tpu_torch.encode: one 1536x1024 image at
     the defaults (wall time, its device program, launches: each kernel
     once); on 64x48, 72x40 and 32x16 (fewer than 4 MBs, unsegmented)
     card files equal CPU files with method 2 (I4 off), segments=1, the
     text and icon presets, preprocessing=2 (dithered import) and
     ICC/EXIF/XMP metadata, with the launches each configuration implies
     (no p1_alpha unsegmented, no i4_search with I4 off, p2_wavefront
     once); and kernels 2, 3 and 4 against their plain versions on the
     full-width inputs of encode() with I4 off and unsegmented.
  9. The quality modes. One 1536x1024 encode() at method 5 (the skew-2
     closed loop with the trellis) and one at method 6 (plus the in-loop
     I4/UV search), each counted: kernels 1-3 once, kernel 4 never (phase
     2 is the planar step loop, its steps replayed from a CUDA graph); wall
     and device-program seconds, phase 2's steps and ms per step (and, at
     method 6, the step loop without the graph), kernels 1-3 against their
     plain versions on the path's inputs (kernel 3 with the skew-1 ban
     lifted). Sharp YUV at the main path's configuration (encode_batch,
     B=16, sharp_yuv=True, counted): the sharp import's time beside the
     plain import's, the batch's time, and one full-size image's card
     planes against the CPU's (within one level, on at most one sample in
     10^4: the card's powf is not the C library's). Card files against CPU
     files on 64x48 and 72x40 at methods 5 and 6 (equal) and with sharp
     YUV (equal where the planes are).
 10. Decoding. 1536x1024 bitstreams from encode() on the card (the
     defaults, method 6, the simple filter, no filter) decoded by
     decode_rgba on the card (the host's token parse, then the skew-2 step
     loop of reconstruction and loop filter replayed from a CUDA graph,
     and the upsampling) equal the native decoder's pixels, with every
     kernel's launch count 0 while decoding (the decode runs none of the
     four); ms per image on both backends, the step loop's ms per step
     with the graph and once without it; the pipelined decode stream over
     32 images against 32 single decodes; card == CPU decodes at 64x48,
     72x40 and 33x17 on every filter branch; encode() with autofilter,
     target_size and target_psnr at full width (card == CPU at 64x48) and
     with backend="host" (host time).
 11. Lossless and alpha (lossless()). A 1536x1024 RGBA image (soft
     alpha edges, transparent areas, a noisy region) through encode() at
     the defaults on the card: kernels 1-4 once each, the ALPH plane
     encoded on a host thread beside them (wall seconds, ALPH bytes and
     seconds); decode_rgba on both backends: the source's alpha, equal
     RGB. encode(img, lossless=True, exact=True) on the card (its
     predictor search there) and with backend="host" (the native
     predictor) on the photo-like RGBA image and on one with a large
     noise area, whose trees include lone-symbol code-length codes
     (counted): equal files that decode to the source, wall seconds,
     the native VP8L decode's ms, no kernel launched. predictor_search on
     the card against the native predictor at bits 3, 4 and 5 (equal;
     card ms against host ms); the other ops/lossless.py functions card
     against CPU; card files against CPU files at 64x48, 72x40 and 33x17
     (lossless, lossy with alpha, near_lossless=60).

Kernel times ("ms") are the card's own (runs queued behind a sleep, CUDA
events); each kernel's time per call from an idle card, which also
counts the host's launch ("call_ms", the method of the kernel times
recorded before the queued timing), is printed and recorded beside it.

The line before the last is a JSON object {"kernels": [...]} with each
kernel's route, source, the TPU kernel it replaces, launches on the main
path and in the stream (stream_launches) and, for kernel 3, at methods
5 and 6 (quality_launches, with its card and plain times there), its
launches in phase 11 (lossless_launches: the alpha encode, the lossless
encodes, the decodes), error, times and bound; the last line is
{"ok": true, "device": {...}}.
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
CARD = torch.device("cuda")
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
# rate walk 20 per coefficient (12 without the rate walk and error),
# reconstruct-and-clamp 48 per block, nibble and level pack 4 per
# coefficient.
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


def _ops_p2(n_i16, n_i4, n_mb):
    """Phase 2, counting the chosen luma pipeline of each MB only (the
    kernel runs just that one): per 4x4 block predict 16, residual 16, the
    DCT pair, quantize + dequantize, reconstruct, pack; an I16 MB adds its
    contour sums, the WHT pair and the y2 quantization, an I4 subblock its
    contour's smoothed strips (110, as _ops_i4_per_sb); chroma is 8 blocks
    and its contour sums for every MB."""
    blk = 16 + 16 + _FDCT + 16 * 12 + _IDCT + _REC + 16 * 4
    i16 = 16 * blk + 32 + 2 * _WHT + 16 * 12
    i4 = 16 * (blk + 110)
    return n_i16 * i16 + n_i4 * i4 + n_mb * (8 * blk + 32)


def bound_ms(n_bytes, n_ops):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / INT32_OPS_PER_S * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes > t_ops else "operations")


def check_per_batch(launches, n_batches, what):
    """Every kernel of the path must have launched once per batch."""
    if set(launches.values()) != {n_batches}:
        raise AssertionError(f"{what}: launches {launches}, expected "
                             f"{n_batches} of each (one per batch)")
    print(f"{what}: launches {launches}, one per batch of {n_batches}",
          flush=True)


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


def alpha_edge_inputs(rng, L):
    """Segment-alpha inputs u8 [384, L]: random rows, a flat MB in lane 0
    and, where L > 1, a checkerboard MB in lane 1."""
    src = rng.integers(0, 256, (384, L)).astype(np.uint8)
    src[:, 0] = 77
    if L > 1:
        r, c = np.mgrid[0:4, 0:4]
        src[:, 1] = np.tile((((r + c) % 2) * 255).reshape(16), 24)
    return src


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


# Cycles of torch.cuda._sleep queued ahead of timed runs (~10 ms at the
# H100's clock): the host enqueues every run while the card sleeps.
SLEEP_CYCLES = 20_000_000


def time_ms(fn, reps, queued=True):
    """Median milliseconds of fn() over `reps` runs, CUDA events around
    each run. queued: the runs are enqueued behind a sleep on the card, so
    that each pair of events reads the card's time for fn's work alone;
    otherwise each run starts from an idle card and the host's time to
    launch fn's work counts too (the method of the earlier PRs' kernel
    times, and the one for the plain versions, whose host launches are
    their cost)."""
    torch.cuda.synchronize()
    ev = [(torch.cuda.Event(enable_timing=True),
           torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    if queued:
        torch.cuda._sleep(SLEEP_CYCLES)
    for a, b in ev:
        a.record()
        fn()
        b.record()
        if not queued:
            b.synchronize()
    torch.cuda.synchronize()
    return statistics.median(a.elapsed_time(b) for a, b in ev)


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


def _outputs(x):
    return list(x.values()) if isinstance(x, dict) else list(x)


def hold(name, kernel, plain, args, replaces, launches, n_bytes, n_ops,
         plain_reps=3, where="the main path"):
    """Runs a kernel wrapper and its plain version on the same card
    tensors: integer outputs (modes, alphas, levels) must be equal, float
    outputs (scores) within SCORE_RTOL. Times both and returns the
    kernel's record; "mismatches" counts the outputs that disagree."""
    got, ref = _outputs(kernel(*args)), _outputs(plain(*args))
    mismatches = sum(
        not torch.allclose(g, r, rtol=SCORE_RTOL, atol=0)
        if g.is_floating_point() else not torch.equal(g, r)
        for g, r in zip(got, ref))
    err = max(float((g.double() - r.double()).abs().max())
              for g, r in zip(got, ref))
    ms = time_ms(lambda: kernel(*args), 20)
    call_ms = time_ms(lambda: kernel(*args), 20, queued=False)
    plain_ms = time_ms(lambda: plain(*args), plain_reps, queued=False)
    bd, by = bound_ms(n_bytes, n_ops)
    print(f"kernel {name}: {launches[name]} launch(es) on {where}; "
          f"{'exact' if not mismatches else 'DISAGREES'} (max abs err "
          f"{err}); {ms:.4f} ms on the card (runs queued), {call_ms:.4f} ms "
          f"per call from an idle card (host launch included), plain "
          f"{plain_ms:.3f} ms, bound {bd:.4f} ms by {by} ({n_bytes} bytes, "
          f"{n_ops} integer operations)", flush=True)
    return dict(name=name, route="cuda",
                source=f"webp_tpu_torch/csrc/{name}.cu", replaces=replaces,
                launches=launches[name], max_abs_err=err, ms=ms,
                call_ms=call_ms, plain_ms=plain_ms, bound_ms=bd, bound_by=by, library_ms=None,
                mismatches=mismatches)


def hold_exact(name, kernel, plain, args):
    """Kernel against its plain version on the same card tensors (outputs
    equal, scores within SCORE_RTOL; raises otherwise); returns the
    kernel's time on the card in ms."""
    got, ref = _outputs(kernel(*args)), _outputs(plain(*args))
    for g, r in zip(got, ref):
        if not (torch.allclose(g, r, rtol=SCORE_RTOL, atol=0)
                if g.is_floating_point() else torch.equal(g, r)):
            raise AssertionError(f"{name} disagrees with its plain version")
    return time_ms(lambda: kernel(*args), 10)


def single_image(seed, card, hold):
    """Phase 8: encode() at full width (time and launches), card files
    against CPU files on small images in the unsegmented, I4-off, preset,
    dithered and metadata configurations (launches counted per
    configuration), and kernels 2-4 against their plain versions on the
    full-width unsegmented and I4-off inputs."""
    import webp_tpu_torch
    from webp_tpu_torch.ops import cuda as KC
    from webp_tpu_torch.ops import fastpath as FP
    from webp_tpu_torch.ops import i4_kernel as I4K
    from webp_tpu_torch.ops import p1_kernels as P1K
    from webp_tpu_torch.ops import p2_kernel as P2K

    rng = np.random.default_rng(seed + 4)
    img = synth_images(rng, 1, H, W)[0]
    KC.reset_launches()
    data = webp_tpu_torch.encode(img)
    launches = dict(KC.LAUNCHES)
    check_per_batch(launches, 1, f"encode() {W}x{H} defaults")
    check_webp(data, W, H)
    e2e = wall_s(lambda: webp_tpu_torch.encode(img), 3)
    fn = FP.fast_encode_fn(W // 16, H // 16, QUALITY, 4, 50, True)
    x = torch.as_tensor(img[None]).cuda()
    dev_s = wall_s(lambda: fn.rgb_blob(x), 3)
    print(f"single image: encode() {W}x{H} at the defaults (method 4, 4 "
          f"segments, SNS 50) {e2e:.4f} s wall (median of 3), "
          f"{W * H / e2e / 1e6:.2f} Mpx/s; its device program (rgb_blob, "
          f"B=1, input resident) {dev_s:.4f} s; {len(data)} bytes; "
          f"launches {launches}; {card}", flush=True)

    # Card files against CPU files; launches per configuration.
    configs = {"method 2": dict(method=2), "segments=1": dict(segments=1),
               "preset text": webp_tpu_torch.options_for_preset("text"),
               "preset icon": webp_tpu_torch.options_for_preset("icon"),
               "preprocessing=2": dict(preprocessing=2),
               "ICC/EXIF/XMP": dict(iccp=b"icc", exif=b"Exif\0\0II*\0",
                                    xmp=b"<x:xmpmeta/>")}
    for (w, h) in ((64, 48), (72, 40), (32, 16)):
        small = synth_images(rng, 1, h, w)[0]
        n_mb = ((w + 15) // 16) * ((h + 15) // 16)
        for label, opts in configs.items():
            o = opts if isinstance(opts, webp_tpu_torch.EncoderOptions) \
                else webp_tpu_torch.EncoderOptions(**opts)
            want = {"p1_alpha": int(o.segments > 1 and n_mb >= 4),
                    "p1_mode": 1, "i4_search": int(o.method >= 3),
                    "p2_wavefront": 1}
            KC.reset_launches()
            on_card = webp_tpu_torch.encode(small, options=o)
            if dict(KC.LAUNCHES) != want:
                raise AssertionError(f"{w}x{h} {label}: launches "
                                     f"{dict(KC.LAUNCHES)}, expected {want}")
            if on_card != webp_tpu_torch.encode(small, device="cpu",
                                                options=o):
                raise AssertionError(f"{w}x{h} {label}: card and CPU "
                                     f"files differ")
    print("single image: card == CPU files, byte for byte, on 64x48, "
          "72x40 and 32x16 with " + ", ".join(configs) + "; launches as "
          "configured (no p1_alpha unsegmented, no i4_search with I4 off, "
          "p2_wavefront once per encode)", flush=True)

    # Kernels 2-4 on the full-width inputs of the new configurations.
    for label, opts in (("I4 off (method 2)", dict(method=2)),
                        ("unsegmented (segments=1)", dict(segments=1))):
        with Recorder(P1K, "mode_search") as r_mode, \
                Recorder(I4K, "i4_scores") as r_i4, \
                Recorder(P2K, "phase2_pack") as r_p2:
            webp_tpu_torch.encode(img, **opts)
        times = {"p1_mode": hold("p1_mode", P1K.mode_search,
                                 P1K.mode_search_plain, r_mode.calls[0])}
        if r_i4.calls:
            times["i4_search"] = hold("i4_search", I4K.i4_scores,
                                      I4K.i4_scores_plain, r_i4.calls[0])
        p_args = r_p2.calls[0]
        zero = {k: not bool(p_args[i].any())
                for k, i in (("is_i4", 5), ("seg_map", 7))}
        if not zero["is_i4" if "method" in opts else "seg_map"]:
            raise AssertionError(f"{label}: kernel 4's input is not zero")
        times["p2_wavefront"] = hold("p2_wavefront", P2K.phase2_pack,
                                     P2K.phase2_pack_plain, p_args)
        print(f"single image {W}x{H}, {label}: exact against the plain "
              f"versions (is_i4 all zero: {zero['is_i4']}, seg_map all "
              f"zero: {zero['seg_map']}); ms on the card (B=1): " + ", ".join(
                  f"{k} {v:.4f}" for k, v in times.items()) + f"; {card}",
              flush=True)


def quality_modes(seed, card, hold, imgs):
    """Phase 9: methods 5 and 6 at full width, sharp YUV at the main
    path's configuration (imgs: its B images), and card files against CPU
    files at the new settings. Returns kernel 3's record at method 5 and
    the launches of each kernel at methods 5 and 6."""
    import webp_tpu_torch
    from webp_tpu_torch.lossy import device_encode as DE
    from webp_tpu_torch.ops import cuda as KC
    from webp_tpu_torch.ops import fastpath as FP
    from webp_tpu_torch.ops import i4_kernel as I4K
    from webp_tpu_torch.ops import p1_kernels as P1K
    from webp_tpu_torch.ops import planar as PL
    from webp_tpu_torch.ops import sharpyuv as SY
    from webp_tpu_torch.ops import yuv as YUV

    rng = np.random.default_rng(seed + 9)
    img = synth_images(rng, 1, H, W)[0]
    x = torch.as_tensor(img[None]).cuda()
    steps = W // 16 + 2 * (H // 16 - 1)
    want = {"p1_alpha": 1, "p1_mode": 1, "i4_search": 1, "p2_wavefront": 0}
    quality, rec3 = {}, None
    for method in (5, 6):
        with Recorder(P1K, "alphas") as r_a, \
                Recorder(P1K, "mode_search") as r_m, \
                Recorder(I4K, "i4_scores") as r_i4:
            KC.reset_launches()
            data, first_s = once(lambda: webp_tpu_torch.encode(
                img, method=method))
            launches = dict(KC.LAUNCHES)
        if launches != want:
            raise AssertionError(f"method {method}: launches {launches}, "
                                 f"expected {want}")
        quality[f"method{method}"] = launches
        check_webp(data, W, H)
        e2e = wall_s(lambda: webp_tpu_torch.encode(img, method=method), 1)
        fn = FP.fast_encode_fn(W // 16, H // 16, QUALITY, 4, 50, True, sk=2,
                               trellis=True, i4_mode_search=method >= 6)
        dev_s = wall_s(lambda: fn.rgb_blob(x), 1)
        yuv = fn.to_yuv(x)
        p1 = fn.part1_batched(*yuv)
        _, p2_s = once(lambda: fn.phase2(*yuv, p1))
        eager = ""
        if method == 6:
            # The same step loop without the graph, on the same inputs.
            seen = []
            orig = PL.phase2_planar

            def rec(*a, **k):
                seen.append((a, k))
                return orig(*a, **k)
            PL.phase2_planar = rec
            try:
                fn.phase2(*yuv, p1)
            finally:
                PL.phase2_planar = orig
            a, k = seen[0]
            _, p2_eager = once(lambda: orig(*a, **dict(k, graph=False)))
            eager = (f"; without the graph {p2_eager:.3f} s, "
                     f"{p2_eager / steps * 1e3:.3f} ms per step")
        i_args = r_i4.calls[0]
        if i_args[0][29].any():
            raise AssertionError(f"method {method}: kernel 3's rows ban "
                                 "modes (row 29 is not zero)")
        n_sb = i_args[4]
        rec = hold("i4_search", I4K.i4_scores, I4K.i4_scores_plain, i_args,
                   "webp_tpu/ops/pallas_i4.py:72", launches,
                   sum(a.numel() * a.element_size() for a in i_args
                       if isinstance(a, torch.Tensor)) + 8 * n_sb,
                   _ops_i4_per_sb(i_args[-1]) * n_sb,
                   where=f"encode() at method {method}")
        if rec["mismatches"]:
            raise AssertionError(f"method {method}: kernel 3 disagrees "
                                 "with its plain version")
        rec3 = rec3 or rec
        ms12 = {"p1_alpha": hold_exact("p1_alpha", P1K.alphas,
                                       P1K.alphas_plain, r_a.calls[0]),
                "p1_mode": hold_exact("p1_mode", P1K.mode_search,
                                      P1K.mode_search_plain, r_m.calls[0])}
        print(f"quality method {method}: encode() {W}x{H} first call "
              f"{first_s:.3f} s, then {e2e:.3f} s wall; its device program "
              f"(rgb_blob, B=1, input resident) {dev_s:.3f} s; phase 2 "
              f"(planar step loop, CUDA graph) {p2_s:.3f} s for {steps} "
              f"steps, {p2_s / steps * 1e3:.3f} ms per step{eager}; "
              f"launches {launches}; kernel 3 (ban lifted, {n_sb} lanes) "
              f"exact, {rec['ms']:.4f} ms on the card, plain "
              f"{rec['plain_ms']:.3f} ms; kernels 1 and 2 exact, "
              + ", ".join(f"{k} {v:.4f} ms" for k, v in ms12.items())
              + f"; {len(data)} bytes; {card}", flush=True)

    # Sharp YUV at the main path's configuration.
    xb = torch.as_tensor(imgs).cuda()
    imp = {k: (time_ms(f, 3), time_ms(f, 3, queued=False)) for k, f in (
        ("sharp", lambda: SY.sharp_yuv420(xb)),
        ("plain", lambda: YUV.rgb_to_yuv420(xb)))}
    KC.reset_launches()
    DE.FALLBACKS["images"] = 0
    files, batch_s = once(lambda: webp_tpu_torch.encode_batch(
        list(imgs), QUALITY, sharp_yuv=True))
    check_per_batch(dict(KC.LAUNCHES), 1,
                    f"encode_batch(sharp_yuv=True) B={len(imgs)}")
    for f in files:
        check_webp(f, W, H)
    batch2_s = wall_s(lambda: webp_tpu_torch.encode_batch(
        list(imgs), QUALITY, sharp_yuv=True), 1)
    card_p = SY.sharp_yuv420(xb[:1])
    cpu_p = SY.sharp_yuv420(torch.as_tensor(imgs[:1]))
    diff = [(c.cpu().to(torch.int32) - p.to(torch.int32)).abs()
            for c, p in zip(card_p, cpu_p)]
    n_diff = sum(int((d != 0).sum()) for d in diff)
    n_all = sum(d.numel() for d in diff)
    worst = max(int(d.max()) for d in diff)
    print(f"sharp YUV: import of B={len(imgs)} {W}x{H} on the card "
          f"{imp['sharp'][0]:.3f} ms ({imp['sharp'][0] / len(imgs):.3f} ms "
          f"per image; per call from an idle card {imp['sharp'][1]:.3f} ms), "
          f"plain import {imp['plain'][0]:.3f} ms (per call "
          f"{imp['plain'][1]:.3f} ms); encode_batch("
          f"sharp_yuv=True) first call {batch_s:.3f} s, then {batch2_s:.3f} "
          f"s; fallbacks {DE.FALLBACKS['images']}; one image's card planes "
          f"against the CPU's: {n_diff} of {n_all} samples differ, largest "
          f"difference {worst} (per plane Y/U/V: "
          + "/".join(str(int((d != 0).sum())) for d in diff)
          + f"); {card}", flush=True)
    if worst > 1 or n_diff * 10_000 > n_all:
        raise AssertionError("sharp YUV: card planes outside the tolerance")

    # Card files against CPU files at the new settings.
    for (w, h) in ((64, 48), (72, 40)):
        small = synth_images(rng, 1, h, w)[0]
        for opts in (dict(method=5), dict(method=6)):
            if webp_tpu_torch.encode(small, **opts) != webp_tpu_torch.encode(
                    small, device="cpu", **opts):
                raise AssertionError(f"{w}x{h} {opts}: card and CPU files "
                                     "differ")
        xs = torch.as_tensor(small[None])
        same = all(torch.equal(c.cpu(), p) for c, p in zip(
            SY.sharp_yuv420(xs.cuda()), SY.sharp_yuv420(xs)))
        f_card = webp_tpu_torch.encode(small, use_sharp_yuv=True)
        f_cpu = webp_tpu_torch.encode(small, device="cpu", use_sharp_yuv=True)
        if same and f_card != f_cpu:
            raise AssertionError(f"{w}x{h} sharp: equal planes, files "
                                 "differ")
        print(f"quality {w}x{h}: card == CPU files at methods 5 and 6; "
              f"sharp YUV planes {'equal' if same else 'differ'}, files "
              f"{'equal' if f_card == f_cpu else 'differ'}", flush=True)
    rec3.pop("mismatches")
    return rec3, quality


def decoding(seed, card, imgs):
    """Phase 10: the device decode at full width and what the decoder
    unblocks in encode(). Bitstreams of 1536x1024 images from encode() on
    the card at the defaults (the normal loop filter), at method 6 (I4
    rich), with the simple filter and without a filter: decode_rgba on the
    card (backend="device") equals the native decoder's (backend="host")
    on each, with every kernel launch count 0 while decoding; ms per image
    on both backends, the step loop's ms per step replayed from its CUDA
    graph and, once, without it; decode_lossy_stream_device over 32
    images against 32 single decodes; the card's decode against the CPU's
    plain versions at 64x48, 72x40 and 33x17 on the three filter
    branches; autofilter and rate control on the card (wall time, passes,
    size or PSNR against the target at full width; card == CPU files at
    64x48); encode(backend="host") on the host."""
    import dataclasses

    import webp_tpu_torch
    from webp_tpu_torch import encoder as ENC
    from webp_tpu_torch.container.parser import Parser
    from webp_tpu_torch.lossy import decode as DEC
    from webp_tpu_torch.lossy import device_decode as DD
    from webp_tpu_torch.ops import cuda as KC

    rng = np.random.default_rng(seed + 10)
    img = synth_images(rng, 1, H, W)[0]
    px = W * H
    files = {}
    for label, opts in (("normal filter (defaults)", {}),
                        ("method 6", dict(method=6)),
                        ("simple filter", dict(filter_type=0)),
                        ("no filter", dict(filter_strength=0))):
        files[label], enc_s = once(lambda: webp_tpu_torch.encode(img, **opts))
        check_webp(files[label], W, H)
        bs = Parser(files[label]).frames()[0].bitstream
        parsed = DD._parse_inputs(bs)
        ftype = int(parsed[0]["finfo"][0])
        n_i4 = int(parsed[0]["is_i4"].sum())
        KC.reset_launches()
        dev, first_s = once(lambda: webp_tpu_torch.decode_rgba(files[label]))
        launches = dict(KC.LAUNCHES)
        if any(launches.values()):
            raise AssertionError(f"decode {label}: kernels launched "
                                 f"{launches}")
        host = webp_tpu_torch.decode_rgba(files[label], backend="host")
        if not np.array_equal(dev, host):
            raise AssertionError(f"decode {label}: device and host pixels "
                                 "differ")
        dev_s = wall_s(lambda: webp_tpu_torch.decode_rgba(files[label]), 3)
        host_s = wall_s(lambda: webp_tpu_torch.decode_rgba(
            files[label], backend="host"), 3)
        fn = DD._fn(parsed, True)
        ins = [t.to(CARD) for t in DD._host_inputs(parsed)]
        prog_s = wall_s(lambda: fn(*ins), 3)
        # The step loop alone, on the inputs of this bitstream.
        xs = {}
        loop = fn.loop(1, ins[0].device)
        orig = loop.run

        def grab(x, graph):
            xs.update(x)
            return orig(x, graph)
        loop.run = grab
        try:
            fn(*ins)
        finally:
            del loop.run
        if not xs:
            raise AssertionError("the decode did not run the step loop")
        loop_s = wall_s(lambda: loop.run(xs, True), 3)
        eager = ""
        if label.startswith("normal"):
            _, eager_s = once(lambda: loop.run(xs, False))
            eager = (f"; without the graph {eager_s:.3f} s, "
                     f"{eager_s / fn.steps * 1e3:.3f} ms per step")
            if not np.array_equal(webp_tpu_torch.decode_rgba(files[label]),
                                  host):
                raise AssertionError("decode after the eager run differs")
        print(f"decode {label}: {W}x{H}, {len(files[label])} bytes (encode() "
              f"on the card {enc_s:.3f} s), filter type {ftype}, {n_i4} I4 "
              f"MBs; device == host pixels; launches while decoding "
              f"{launches}; decode_rgba on the card {dev_s * 1e3:.1f} ms per "
              f"image (first call, graph capture included, "
              f"{first_s * 1e3:.1f} ms), its device program (inputs "
              f"resident) {prog_s * 1e3:.1f} ms, the step loop "
              f"{loop_s * 1e3:.1f} ms for {fn.steps} steps, "
              f"{loop_s / fn.steps * 1e3:.3f} ms per step replayed{eager}; "
              f"the native host decoder {host_s * 1e3:.1f} ms per image "
              f"(host time); {card}", flush=True)

    # The stream over 32 images against 32 single decodes.
    files32 = webp_tpu_torch.encode_batch(list(imgs) + list(imgs), QUALITY)
    bss = [Parser(f).frames()[0].bitstream for f in files32]
    KC.reset_launches()
    outs, stream_s = once(lambda: DD.decode_lossy_stream_device(bss))
    if any(KC.LAUNCHES.values()):
        raise AssertionError(f"decode stream: kernels launched "
                             f"{dict(KC.LAUNCHES)}")
    singles, single_s = once(lambda: [DD.decode_vp8_rgb_device(b)
                                      for b in bss])
    for o, g, b in zip(outs, singles, bss[:2]):
        if not np.array_equal(o, DEC.decode_vp8_rgba(b)[..., :3]):
            raise AssertionError("decode stream differs from the host")
    if not all(np.array_equal(o, g) for o, g in zip(outs, singles)):
        raise AssertionError("decode stream differs from single decodes")
    n = len(bss)
    print(f"decode stream: decode_lossy_stream_device over {n} images "
          f"{W}x{H} {n * px / stream_s / 1e6:.2f} Mpx/s ({stream_s:.3f} s); "
          f"{n} single decodes {n * px / single_s / 1e6:.2f} Mpx/s "
          f"({single_s:.3f} s); outputs equal; {card}", flush=True)

    # The card's decode against the CPU's plain versions, small images.
    for (w, h) in ((64, 48), (72, 40), (33, 17)):
        small = synth_images(rng, 1, h, w)[0]
        for opts in ({}, dict(filter_type=0), dict(filter_strength=0),
                     dict(method=6)):
            bs = Parser(webp_tpu_torch.encode(small, backend="host",
                                              **opts)).frames()[0].bitstream
            for up in (False, True):
                fn_in = DD._parse_inputs(bs)
                on_card = DD._run_device(fn_in, up, CARD)
                on_cpu = DD._run_device(fn_in, up, torch.device("cpu"))
                on_card = [on_card] if up else on_card
                on_cpu = [on_cpu] if up else on_cpu
                if not all(torch.equal(c.cpu(), p)
                           for c, p in zip(on_card, on_cpu)):
                    raise AssertionError(f"decode {w}x{h} {opts}: card and "
                                         "CPU differ")
    print("decode parity: the card's device decode == the CPU's plain "
          "versions, byte for byte, on 64x48, 72x40 and 33x17 with the "
          "normal, simple and no filter and at method 6 (planes and RGB)",
          flush=True)

    # The options the decoder unblocks, on the card.
    default_size = len(files["normal filter (defaults)"])
    default_psnr = ENC._psnr_of(img, files["normal filter (defaults)"])
    target_size = int(default_size * 0.7)
    target_psnr = round(default_psnr - 2.0, 1)
    runs = (("autofilter", dict(autofilter=True)),
            (f"target_size={target_size}", dict(target_size=target_size)),
            (f"target_psnr={target_psnr}", dict(target_psnr=target_psnr)))
    small = synth_images(rng, 1, 48, 64)[0]
    for label, opts in runs:
        data, s_ = once(lambda: webp_tpu_torch.encode(img, **opts))
        st = ENC.LAST_STATS
        check_webp(data, W, H)
        got = webp_tpu_torch.encode(small, **opts)
        st_small = dataclasses.astuple(ENC.LAST_STATS)
        if got != webp_tpu_torch.encode(small, device="cpu", **opts) or \
                st_small != dataclasses.astuple(ENC.LAST_STATS):
            raise AssertionError(f"{label}: card and CPU files differ at "
                                 "64x48")
        print(f"encode {label}: {W}x{H} on the card {s_:.3f} s wall, "
              f"{st.passes} pass(es), {len(data)} bytes (defaults: "
              f"{default_size}), LAST_STATS.psnr {st.psnr:.3f} dB (the "
              f"defaults' file: {default_psnr:.3f} dB over RGB) at q "
              f"{st.quality:.2f}; "
              f"card == CPU file and stats at 64x48; {card}", flush=True)
        if "target_size" in opts and len(data) > target_size:
            raise AssertionError(f"{label}: {len(data)} bytes over target")
    data, host_s = once(lambda: webp_tpu_torch.encode(img, backend="host"))
    check_webp(data, W, H)
    print(f"encode backend=host: {W}x{H} {host_s:.3f} s wall on the card "
          f"machine's host CPU (host time, no device), {len(data)} bytes, "
          f"PSNR {ENC.LAST_STATS.psnr:.3f} dB", flush=True)


def alpha_plane(rng, h, w):
    """An alpha plane with soft edges (a radial ramp), fully transparent
    areas (a band and a disc) and a noisy region."""
    y = np.arange(h, dtype=np.float32)[:, None] / h
    x = np.arange(w, dtype=np.float32)[None, :] / w
    r = np.sqrt((x - 0.55) ** 2 + (y - 0.5) ** 2)
    a = np.clip((0.45 - r) * 900.0, 0, 255)
    a[: h // 8] = 0
    a[(x - 0.2) ** 2 + (y - 0.75) ** 2 < 0.01] = 0
    a[h // 2: h // 2 + h // 6, w // 10: w // 3] = rng.integers(
        0, 256, (h // 6, w // 3 - w // 10))
    return (a + 0.5).astype(np.uint8)


def lone_symbol_trees(vp8l: bytes) -> int:
    """How many Huffman trees of a VP8L bitstream's main image have a
    code-length code with a single used symbol (read with 0 bits per
    token): its headers, transforms and trees only, by the numpy
    decoder."""
    from webp_tpu_torch.lossless import decode as LD

    class Probe(LD.VP8LDecoder):
        n = 0

        def _read_code_lengths(self, cl_table, num_symbols):
            Probe.n += cl_table.single_symbol >= 0
            return super()._read_code_lengths(cl_table, num_symbols)

    d = Probe(vp8l)
    d._decode_image_stream_header(d.width, d.height, is_level0=True)
    return Probe.n


def lossless(seed, card, w=W, h=H, dev=CARD):
    """Phase 11: lossless and alpha at full width. encode(rgba) at the
    defaults on the card (kernels 1-4 once each, the ALPH plane on a host
    thread beside them) and its decode on both backends; encode(img,
    lossless=True, exact=True) on the card (the predictor search there)
    and with backend="host" (the native predictor) on a photo-like image
    and on one whose large noise area makes trees with a lone-symbol
    code-length code: equal files that decode to the source, no kernel
    launched; predictor_search on the card against the native predictor
    at bits 3, 4 and 5, the other ops/lossless.py functions card against
    CPU; card files against CPU files at 64x48, 72x40 and 33x17 (lossless,
    lossy with alpha, near_lossless=60). Returns the kernels' launches in
    the phase: {"alpha_encode": {...}, "lossless_encode": {...},
    "decode": {...}}."""
    import webp_tpu_torch
    from webp_tpu_torch import encoder as ENC
    from webp_tpu_torch.container.parser import Parser
    from webp_tpu_torch.lossless import decode as LD
    from webp_tpu_torch.lossless import encode as LE
    from webp_tpu_torch.lossy import alpha as AD
    from webp_tpu_torch.lossy import alpha_enc as AE
    from webp_tpu_torch.native import api as NA
    from webp_tpu_torch.ops import cuda as KC
    from webp_tpu_torch.ops import lossless as OL

    rng = np.random.default_rng(seed + 11)
    img = synth_images(rng, 1, h, w)[0]
    alpha = alpha_plane(rng, h, w)
    rgba = np.dstack([img, alpha])
    out = {}

    # encode(rgba) at the defaults: the lossy frame on the card, ALPH on
    # a host thread.
    KC.reset_launches()
    data, first_s = once(lambda: webp_tpu_torch.encode(rgba, device=dev))
    out["alpha_encode"] = dict(KC.LAUNCHES)
    alph_bytes = ENC.LAST_STATS.alpha_size
    check_per_batch(out["alpha_encode"], 1, f"encode(rgba) {w}x{h}")
    e2e = wall_s(lambda: webp_tpu_torch.encode(rgba, device=dev), 3)
    e2e_rgb = wall_s(lambda: webp_tpu_torch.encode(img, device=dev), 3)
    _, alph_s = once(lambda: AE.encode_alpha(alpha))
    KC.reset_launches()
    on_card, dec_s = once(lambda: webp_tpu_torch.decode_rgba(data,
                                                             device=dev))
    on_host = webp_tpu_torch.decode_rgba(data, backend="host")
    out["decode"] = dict(KC.LAUNCHES)
    if not np.array_equal(on_card[..., 3], alpha):
        raise AssertionError("encode(rgba): the decoded alpha differs from "
                             "the source's")
    if not np.array_equal(on_card, on_host):
        raise AssertionError("encode(rgba): device and host decodes differ")
    dec_card = wall_s(lambda: webp_tpu_torch.decode_rgba(data, device=dev), 3)
    dec_host = wall_s(lambda: webp_tpu_torch.decode_rgba(
        data, backend="host"), 3)
    alph = Parser(data).frames()[0].alpha
    adec_s = wall_s(lambda: AD.decode_alpha(alph, w, h), 3)
    print(f"alpha: encode(rgba) {w}x{h} at the defaults on the card: first "
          f"call {first_s:.3f} s, then {e2e:.4f} s wall (the same image "
          f"without alpha {e2e_rgb:.4f} s); {len(data)} bytes, ALPH payload "
          f"{alph_bytes} bytes, the ALPH encode alone {alph_s:.4f} s (host "
          f"thread); launches {out['alpha_encode']}; decode_rgba on the "
          f"card {dec_card * 1e3:.1f} ms (first call {dec_s * 1e3:.1f} ms), "
          f"on the host {dec_host * 1e3:.1f} ms, of which the ALPH decode "
          f"(numpy VP8L decoder and unfilter, host) {adec_s * 1e3:.1f} ms: "
          f"alpha == source, RGB device == host; {card}", flush=True)

    # Lossless on the card and with backend="host".
    noisy = img.copy()
    noisy[h // 8: h // 8 + h // 2, w // 8: w // 8 + w // 2] = rng.integers(
        0, 256, (h // 2, w // 2, 3), np.uint8)
    out["lossless_encode"] = {k: 0 for k in KC.LAUNCHES}
    for label, im in (("photo-like, with alpha", rgba),
                      ("large noise area", noisy)):
        KC.reset_launches()
        f_card, card_s = once(lambda: webp_tpu_torch.encode(
            im, lossless=True, exact=True, device=dev))
        f_host, host_s = once(lambda: webp_tpu_torch.encode(
            im, lossless=True, exact=True, backend="host"))
        for k, v in KC.LAUNCHES.items():
            out["lossless_encode"][k] += v
        if f_card != f_host:
            raise AssertionError(f"lossless {label}: card and host files "
                                 "differ")
        KC.reset_launches()
        px = webp_tpu_torch.decode_rgba(f_card, device=dev)
        for k, v in KC.LAUNCHES.items():
            out["decode"][k] += v
        src = im if im.shape[2] == 4 else np.dstack(
            [im, np.full((h, w), 255, np.uint8)])
        if not np.array_equal(px, src):
            raise AssertionError(f"lossless {label}: decode differs from "
                                 "the source")
        bs = Parser(f_card).frames()[0].bitstream
        dec_ms = wall_s(lambda: LD.decode_vp8l(bs), 3) * 1e3
        lone = lone_symbol_trees(bs)
        print(f"lossless {label}: {w}x{h} encode(lossless=True, exact=True)"
              f" on the card {card_s:.3f} s wall, backend=\"host\" "
              f"{host_s:.3f} s; files equal, {len(f_card)} bytes; decode == "
              f"source; the native VP8L decode {dec_ms:.1f} ms; "
              f"{lone} tree(s) with a lone-symbol code-length code; {card}",
              flush=True)
        if label.startswith("large") and not lone:
            raise AssertionError("the noise image made no lone-symbol tree")
    if any(out["lossless_encode"].values()) or any(out["decode"].values()):
        raise AssertionError(f"kernels launched outside the lossy encode: "
                             f"{out}")

    # predictor_search on the card against the native predictor.
    argb = LE.subtract_green(LE.rgba_to_argb(rgba))
    t = torch.from_numpy(argb.view(np.int32)).to(dev)
    for bits in (3, 4, 5):
        res, modes = OL.predictor_search(t, bits)
        n_res, n_modes = NA.vp8l_predictor_transform(argb, bits)
        if not (np.array_equal(res.cpu().numpy().astype(np.uint32), n_res)
                and np.array_equal(modes.cpu().numpy(), n_modes)):
            raise AssertionError(f"predictor_search at bits {bits} differs "
                                 "from the native predictor")
        card_ms = time_ms(lambda: OL.predictor_search(t, bits), 5)
        call_ms = time_ms(lambda: OL.predictor_search(t, bits), 5,
                          queued=False)
        host_ms = wall_s(lambda: NA.vp8l_predictor_transform(argb, bits),
                         3) * 1e3
        print(f"predictor_search bits {bits}: {w}x{h} equal to the native "
              f"predictor (modes and residuals); {card_ms:.3f} ms on the "
              f"card (runs queued), {call_ms:.3f} ms per call from an idle "
              f"card; native predictor {host_ms:.3f} ms (host); {card}",
              flush=True)
    tiles = rng.integers(0, 1 << 32, ((h + 7) >> 3) * ((w + 7) >> 3),
                         dtype=np.uint64).astype(np.uint32)
    pal = rng.integers(0, 1 << 32, 16, dtype=np.uint64).astype(np.uint32)
    packed = (rng.integers(0, 256, (h, w)).astype(np.uint32) << 8) \
        | np.uint32(0xFF000000)

    def as_t(a, d):
        return torch.from_numpy(np.ascontiguousarray(a).view(np.int32)).to(d)

    for name, fn in (
            ("add_green_inverse", lambda d: OL.add_green_inverse(as_t(argb, d))),
            ("subtract_green", lambda d: OL.subtract_green(as_t(argb, d))),
            ("color_space_inverse", lambda d: OL.color_space_inverse(
                as_t(argb, d), 3, as_t(tiles, d))),
            ("color_space_forward", lambda d: OL.color_space_forward(
                as_t(argb, d), 3, as_t(tiles, d))),
            ("color_index_inverse", lambda d: OL.color_index_inverse(
                as_t(packed, d), 1, as_t(pal, d), w * 2))):
        if not torch.equal(fn(dev).cpu(), fn(torch.device("cpu"))):
            raise AssertionError(f"{name}: card and CPU differ")
    print("ops/lossless.py: add_green_inverse, subtract_green, "
          "color_space_inverse/forward and color_index_inverse card == CPU "
          f"at {w}x{h}", flush=True)

    # Card files against CPU files, small images.
    for (sw, sh) in ((64, 48), (72, 40), (33, 17)):
        small = np.dstack([synth_images(rng, 1, sh, sw)[0],
                           alpha_plane(rng, sh, sw)])
        for label, opts in (("lossless", dict(lossless=True)),
                            ("lossy with alpha", {}),
                            ("near_lossless=60", dict(lossless=True,
                                                      near_lossless=60))):
            if webp_tpu_torch.encode(small, device=dev, **opts) != \
                    webp_tpu_torch.encode(small, device="cpu", **opts):
                raise AssertionError(f"{sw}x{sh} {label}: card and CPU "
                                     "files differ")
    print("lossless parity: card == CPU files, byte for byte, at 64x48, "
          "72x40 and 33x17: lossless, lossy with alpha, near_lossless=60",
          flush=True)
    return out


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
    from webp_tpu_torch.container import riff
    from webp_tpu_torch.lossy import device_encode as DE
    from webp_tpu_torch.ops import cuda as KC
    from webp_tpu_torch.ops import fastpath as FP
    from webp_tpu_torch.ops import i4_kernel as I4K
    from webp_tpu_torch.ops import p1_kernels as P1K
    from webp_tpu_torch.ops import p2_kernel as P2K
    from webp_tpu_torch.ops import yuv as YUV

    dev = torch.device("cuda")
    # 1. The card.
    name = torch.cuda.get_device_name(0)
    card = card_info()
    print(card, flush=True)
    print(f"torch device: {name}; torch {torch.__version__}, CUDA "
          f"{torch.version.cuda}", flush=True)

    # 2. Build every library of the path, all compilers at once.
    t0 = time.perf_counter()
    spent = _build.build(["webp_enc", "webp_dec", "vp8l_enc"]
                         + list(_build.KERNEL_LIBS))
    print(f"build: {time.perf_counter() - t0:.1f} s wall; per library "
          + ", ".join(f"{k} {v:.1f} s" for k, v in spent.items()), flush=True)
    for lib in _build.KERNEL_LIBS:
        for f in _build.ptxas_facts(lib):
            print(f"ptxas {lib}: {f['registers']} registers, {f['smem']} "
                  f"bytes static shared memory, {f['stack']} bytes stack, "
                  f"{f['spill_stores']} bytes spill stores, "
                  f"{f['spill_loads']} bytes spill loads ({f['entry']})",
                  flush=True)

    rng = np.random.default_rng(args.seed)
    rng_e = np.random.default_rng(args.seed + 3)
    imgs = synth_images(rng, B, H, W)

    # 3. The main path, counted; the kernels' card inputs are recorded.
    with Recorder(P1K, "alphas") as r_alpha, \
            Recorder(P1K, "mode_search") as r_mode, \
            Recorder(I4K, "i4_scores") as r_i4, \
            Recorder(P2K, "phase2_pack") as r_p2:
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
    check_per_batch(launches, 1, "main path (encode_batch)")
    if len(files) != B:
        raise AssertionError(f"{len(files)} files for {B} images")
    for f in files:
        check_webp(f, W, H)
    print(f"main path: {B} valid WebP files, "
          f"{sum(map(len, files)) / B / 1024:.1f} KiB mean", flush=True)

    # 4. Each kernel against its plain version at the main path's shapes.
    n_mb = (W // 16) * (H // 16)
    L, n_sb = B * n_mb, B * 16 * n_mb
    steps = W // 16 + H // 16 - 1
    a_args = r_alpha.calls[0]
    m_args = r_mode.calls[0]
    i_args = r_i4.calls[0]
    p_args = r_p2.calls[0]

    def in_bytes(args):
        return sum(a.numel() * a.element_size() for a in args
                   if isinstance(a, torch.Tensor))

    n_i4 = int(p_args[5].sum())
    # Out: nibbles 24 x 8, int16 levels 24 x 16, y2 16 x 2, bitmap 4 and
    # skip 1 bytes per MB.
    p2_out = L * (24 * 8 + 24 * 16 * 2 + 16 * 2 + 4 + 1)
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
        hold("p2_wavefront", P2K.phase2_pack, P2K.phase2_pack_plain, p_args,
             "webp_tpu/ops/pallas_p2.py:155", launches,
             in_bytes(p_args) + p2_out, _ops_p2(L - n_i4, n_i4, L),
             plain_reps=1),
    ]
    bad = [k["name"] for k in kernels if k.pop("mismatches")]
    if bad:
        raise AssertionError(f"kernels disagree with their plain versions: "
                             f"{bad}")
    # The alpha kernel on its edges: a flat MB (256 luma coefficients in
    # one bin), a checkerboard MB (bin 31), lane counts below, across and
    # at its 64-MB tile.
    for n in (1, 2, 17, 100, 192):
        src = torch.as_tensor(alpha_edge_inputs(rng_e, n)).to(dev)
        if any(not torch.equal(g, r) for g, r in
               zip(P1K.alphas(src), P1K.alphas_plain(src))):
            raise AssertionError(f"p1_alpha disagrees with its plain "
                                 f"version on the edge inputs, L = {n}")
    print("kernel p1_alpha: exact on the edge inputs (flat and "
          "checkerboard MBs; L = 1, 2, 17, 100, 192)", flush=True)
    # The phase-2 kernel per anti-diagonal step, and on the first image
    # alone (one cluster: the same chain of steps with the card otherwise
    # idle, the kernel's dependency floor as measured).
    p2_ms = kernels[-1]["ms"]
    C = P2K.cluster_size(B, H // 16, P2K.sm_count(dev))
    one = tuple(a[:1] for a in p_args[:9]) + tuple(p_args[9:])
    one_ms = time_ms(lambda: P2K.wavefront(*one), 20)
    print(f"kernel p2_wavefront: cluster size {C}, {B * C} blocks of "
          f"{P2K.THREADS} threads; {p2_ms:.3f} ms, "
          f"{p2_ms / steps:.4f} ms per anti-diagonal step "
          f"({steps} steps); {n_i4} of {L} MBs are I4; image 0 alone "
          f"(cluster size {P2K.cluster_size(1, H // 16, P2K.sm_count(dev))}) "
          f"{one_ms:.3f} ms, {one_ms / steps:.4f} ms per step", flush=True)

    # 5. Throughput and where the device time goes.
    px = B * W * H
    e2e = wall_s(lambda: webp_tpu_torch.encode_batch(list(imgs), QUALITY), 2)
    fn = FP.fast_encode_fn(W // 16, H // 16, QUALITY, 4, 50)
    planes = torch.as_tensor(np.ascontiguousarray(
        imgs.transpose(0, 3, 1, 2))).to(dev)
    dev_s = wall_s(lambda: fn.rgbp_blob(planes), 2)
    print(f"throughput: end to end {px / e2e / 1e6:.2f} Mpx/s "
          f"({e2e:.3f} s per batch); device compute only (rgbp_blob, "
          f"input resident) {px / dev_s / 1e6:.2f} Mpx/s ({dev_s:.3f} s); "
          f"{card}", flush=True)
    # encode_batch's two halves: the device round trip (RGB upload, device
    # program, blob fetch and unpack) and the host tail on 8 threads.
    (fn_b, host), blob_s = once(lambda: DE.device_blob(imgs, QUALITY))
    cfg = DE.LossyConfig(quality=QUALITY, segments=4, sns_strength=50,
                         filter_strength=60)
    with DE.concurrent.futures.ThreadPoolExecutor(max_workers=8) as ex:
        _, emit_s = once(lambda: DE._emit(host, imgs, fn_b, W, H, cfg, ex))
    print(f"encode_batch split (s): device_blob {blob_s:.4f}, entropy "
          f"coding and frame assembly on 8 threads {emit_s:.4f}", flush=True)
    stage = {}
    yuv, stage["yuv"] = once(lambda: YUV.rgb_planes_to_yuv420(
        planes[:, 0], planes[:, 1], planes[:, 2]))
    p1, stage["phase0_1_i4"] = once(lambda: fn.part1_batched(*yuv))
    wire, stage["phase2_kernel"] = once(lambda: fn.phase2(*yuv, p1))
    _, stage["pack_blob"] = once(lambda: FP._blobify(fn.pack(wire, p1)))
    print("device stages (s): " + ", ".join(
        f"{k} {v:.4f}" for k, v in stage.items())
        + f"; phase-2 steps {steps}, "
        f"{stage['phase2_kernel'] / steps * 1e3:.4f} ms per step", flush=True)

    # 6. On-card parity with the plain versions, small images.
    rng_s = np.random.default_rng(args.seed + 1)
    for (w, h, q) in ((64, 48, 75), (72, 40, 75), (16, 64, 75),
                      (64, 16, 75)):
        small = list(synth_images(rng_s, 2, h, w))
        on_cpu = webp_tpu_torch.encode_batch(small, q, device="cpu")
        on_card = webp_tpu_torch.encode_batch(small, q, device="cuda")
        if on_cpu != on_card:
            raise AssertionError(f"{w}x{h}: card and CPU files differ")
        for f in on_card:
            check_webp(f, w, h)
    small = list(synth_images(rng_s, 3, 40, 72))
    KC.reset_launches()
    on_card = DE.encode_lossy_stream(small, QUALITY, batch=2, host_yuv=True)
    check_per_batch(dict(KC.LAUNCHES), 2, "host-YUV stream, 3 images 72x40")
    if on_card != DE.encode_lossy_stream(small, QUALITY, batch=2,
                                         host_yuv=True, device="cpu"):
        raise AssertionError("stream with host YUV: card and CPU differ")
    noise = [np.random.default_rng(args.seed + 2).integers(
        0, 256, (96, 128, 3), np.uint8)]
    DE.FALLBACKS["images"] = 0
    on_card = webp_tpu_torch.encode_batch(noise, 99, device="cuda")
    if DE.FALLBACKS["images"] != 1:
        raise AssertionError("q99 noise did not take the host fallback")
    if on_card != webp_tpu_torch.encode_batch(noise, 99, device="cpu"):
        raise AssertionError("q99 noise: card and CPU files differ")
    print("parity: card == CPU plain versions, byte for byte, on 64x48, "
          "72x40, 16x64, 64x16, the host-YUV stream (72x40) and the q99 "
          "escape-overflow image", flush=True)

    # 7. The pipelined stream against encode_batch on 32 images. Both are
    # host-bound and host times vary from run to run, so they run in
    # alternating order, three times each.
    imgs32 = list(imgs) + list(synth_images(rng, B, H, W))
    runs = {
        "stream": lambda: [riff.assemble_riff([riff.Chunk(riff.VP8, b)])
                           for b in DE.encode_lossy_stream(
                               imgs32, QUALITY, batch=B, host_yuv=False)],
        "batch": lambda: [f for i in range(0, len(imgs32), B)
                          for f in webp_tpu_torch.encode_batch(
                              imgs32[i:i + B], QUALITY)]}
    px32 = len(imgs32) * W * H
    rates, out = {"stream": [], "batch": []}, {}
    for order in (("stream", "batch"), ("batch", "stream"),
                  ("stream", "batch")):
        for k in order:
            counted = k == "stream" and not rates["stream"]
            if counted:
                KC.reset_launches()
            out[k], s_ = once(runs[k])
            if counted:
                stream_launches = dict(KC.LAUNCHES)
            rates[k].append(px32 / s_ / 1e6)
    check_per_batch(stream_launches, len(imgs32) // B,
                    f"encode_lossy_stream, {len(imgs32)} images")
    for k in kernels:
        k["stream_launches"] = stream_launches[k["name"]]
    if out["stream"] != out["batch"]:
        raise AssertionError("encode_lossy_stream and encode_batch differ")
    print(f"stream: {len(imgs32)} images {W}x{H} batch {B}, Mpx/s in run "
          f"order S B B S S B: encode_lossy_stream "
          f"{', '.join(f'{r:.2f}' for r in rates['stream'])} (median "
          f"{statistics.median(rates['stream']):.2f}); encode_batch "
          f"{', '.join(f'{r:.2f}' for r in rates['batch'])} (median "
          f"{statistics.median(rates['batch']):.2f}); files equal; {card}",
          flush=True)

    # 8. The single-image entry, webp_tpu_torch.encode.
    single_image(args.seed, card, hold_exact)

    # 9. The quality modes: methods 5 and 6, sharp YUV.
    rec3, quality = quality_modes(args.seed, card, hold, imgs)

    # 10. Decoding on the card, and the options the decoder unblocks.
    decoding(args.seed, card, imgs)
    k3 = next(k for k in kernels if k["name"] == "i4_search")
    k3["quality_launches"] = {m: v["i4_search"] for m, v in quality.items()}
    k3["quality_ms"], k3["quality_plain_ms"] = rec3["ms"], rec3["plain_ms"]

    # 11. Lossless and alpha.
    phase11 = lossless(args.seed, card)
    for k in kernels:
        k["lossless_launches"] = {part: v[k["name"]]
                                  for part, v in phase11.items()}

    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
