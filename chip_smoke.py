"""Drives the PyTorch/CUDA port (webp_tpu_torch) on one NVIDIA card.

    python3 chip_smoke.py

Phases, each of which raises on failure (the script then exits nonzero):

  1. The card's name and power limit (nvidia-smi) and torch's device name.
  2. Builds the five CUDA kernels (nvcc, sm_90a) and the host libraries
     (entropy coder and YUV importer; the VP8 and VP8L decoders and the
     upsampler; the VP8L encoder's coder and searches; the PNG reader's
     row unfilter; g++) from the
     checkout's sources, all compilers at once, and prints each
     kernel's registers, shared memory and spills as ptxas reported them.
  3. The main path, counted: webp_tpu_torch.encode_batch on B=16 synthetic
     1536x1024 images (made from --seed), with every kernel's launch count
     set to 0 just before and read just after; each kernel must have run
     exactly once (one batch). Every output must carry a RIFF/WEBP/VP8
     header of the right size; the decode kernel never launched.
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
     decode_rgba on the card (the host's token parse, then one launch of
     the decode kernel, the skew-2 wavefront of reconstruction and loop
     filter, and the upsampling) equal the native decoder's pixels, with
     the decode kernel launched once and no encode kernel; ms per image
     on both backends; the decode kernel's card time at B=1 beside its
     bound and ms per anti-diagonal step, and at B=16 (each image equal
     to its B=1 decode); its plain version (the step loop on the card,
     one run) equal to it on the defaults' file, with its time; the
     pipelined decode stream over 32 images against 32 single decodes
     (the kernel once per image); card == CPU decodes at 64x48, 72x40 and
     33x17 on every filter branch; encode() with autofilter, target_size
     and target_psnr at full width (card == CPU at 64x48) and with
     backend="host" (host time).
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
 12. Animation (animation()). 24 RGBA frames at 1280x720 (a synth_images
     background, a 160x160 textured opaque sprite moving 24 px per frame,
     a semi-transparent banner on frames 8-15, frames 5 and 6 repeating
     frame 4, a cut to a new background at frame 16), 42 ms each:
     encode_animation_device on the card, counted (each kernel once per
     batch of 8 unique frames; its ANMF payloads equal
     encode_lossy_stream's bitstreams of the unique frames; wall seconds
     and Mpx/s; each kernel held against its plain version on every
     batch's recorded inputs); encode_animation at the defaults (lossy)
     and lossless (method 3) on the card and with backend="host" (equal
     files, no kernel; keyframes, sub-frames and merged frames), and
     lossless at the defaults (method 4) on the first 3 frames on both
     (equal files, canvases equal to the source); decode_animation
     of the three files on both backends and AnimDecoder on the card
     (canvases equal across backends and to the CPU compositor's, the
     lossless canvases equal to the source, the lossy files' PSNR by
     ops/metrics on the card; ms per frame; the decode kernel once per
     lossy frame, no encode kernel); the device
     decode's programs per frame geometry and a first-seen against a
     repeated geometry's ms; card files and canvases against the CPU's at
     64x48 and 72x40; ops/metrics card against CPU on 1280x720 planes.
 13. The band encoders (bands()), on 4 synthetic 1536x1024 images: the
     non-planar program (fast_encode_fn(..., planar=False): kernel 3 once,
     kernels 1, 2 and 4 never; its blob equal to the planar program's;
     wall, device time, phase 2's ms per step), the exact band pipeline
     (encode_lossy_mesh on 4 bands of one card: kernel 1 once per band,
     kernels 2 and 3 once per band and once per first-row extension, 7;
     files equal to encode_batch's; seconds per image, Phase B's steps)
     and the stream's multi-device branch (encode_lossy_stream with
     devices=: the same launches and files), the sharded encoder on a
     (dp=1, sp=4) mesh (kernels 1 and 3 once per band; its files decoded,
     PSNR beside the single-device files'), kernels 1-3 against their
     plain versions on every call of the first two, card against CPU at
     64x64 with 2 bands, and the wavefront oracle (equal to the host
     encoder's I16 path at 64x48, timed at full width; no kernel), with
     kernel 4 on the oracle's modes held against the oracle's levels at
     64x48 and 1536x1024. Bands that share one card take turns on it:
     these times are the band programs' overhead, not multi-card scaling.
     Where the machine shows several cards, the exact pipeline and the
     sharded encoder also run with one band per card (files equal to
     encode_batch's; the sharded outputs equal to 4 bands on one card
     when there are 4).
 14. The host surface (host_surface()), on a 1536x1024 image: the PNG
     writer and reader (read_png timed, pixels equal); the command line
     tool in this process, `enc in.png out.webp` counted (each kernel
     once; the file equal to encode(img)'s; wall seconds and the PNG
     read's share), `dec` (the decode kernel once; the host decoder's
     pixels), an RGBA
     image through enc/dec and enc -lossless -exact/dec, `info` on VP8,
     VP8X+ALPH and VP8L files; `python -m webp_tpu_torch.cli enc|dec|
     info` in fresh processes (exit 0, the same files); the CLI on the
     card against -device cpu at 64x48 and 72x40; a GIF round trip where
     Pillow can be imported, and a process where it cannot (PNG works,
     the GIF paths return 2); the rescaler to 768x512 (host seconds,
     within 1 of the box mean). The Pillow plugin is not driven: it
     needs Pillow, which a card machine need not have.
 15. The chroma AC quantizer delta (uv_ac()): encode_batch(...,
     uv_ac=True) on the main path's 16 images, counted (each kernel
     once), each file's signalled (dq_uv_dc, dq_uv_ac) printed (one AC
     delta at least must be non-zero); kernels 1-4 against their plain
     versions on the inputs that run gave them (per-image UV quant rows
     shifted by each image's AC delta), their card times beside phase
     4's; the stream (host_yuv=False, uv_ac=True, counted) and the exact
     band pipeline (one image, 4 bands of the card, counted) write the
     batch's files; card == CPU files at 64x48 and 72x40; bytes and PSNR
     of the 16 files with uv_ac against phase 3's without.

Kernel times ("ms") are the card's own (runs queued behind a sleep, CUDA
events); each kernel's time per call from an idle card, which also
counts the host's launch ("call_ms", the method of the kernel times
recorded before the queued timing), is printed and recorded beside it.

The line before the last is a JSON object {"kernels": [...]} with each
kernel's route, source, the TPU kernel it replaces, launches on the main
path and in the stream (stream_launches) and, for kernel 3, at methods
5 and 6 (quality_launches, with its card and plain times there), its
launches in phase 11 (lossless_launches: the alpha encode, the lossless
encodes, the decodes), its launches in phase 12 (animation_launches:
the device encode, the AnimEncoder encodes, the decodes), its launches
in phase 13 (band_launches: the non-planar program, the exact pipeline,
the stream's multi-device branch, the sharded encoder, the oracle), its
launches in phase 14 (host_surface_launches: the CLI's enc, RGBA enc,
lossless enc, decodes), its launches in phase 15 (uv_ac_launches:
encode_batch, the stream, the exact pipeline) and its card time there
(uv_ac_ms), for
kernels 1-3 their times and bounds on the exact pipeline's bands
(band_ms, band_bound_ms; kernel 3 also the non-planar program's and the
band paths' times), error,
times and bound; the last line is
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


# One edge of the loop filter on one line of pixels: the normal filter's
# mask, high-variance test and three candidate results (~60 operations, as
# ops/decode.py _filter_edge counts them), the simple filter's ~20.
_EDGE_NORMAL, _EDGE_SIMPLE = 60, 20


def _ops_decode(P, limit, inner, ftype, mb_w):
    """The decode kernel's integer operations for one parsed frame (P from
    vp8_parse, per-MB limit and inner flags): per MB 24 inverse DCTs and
    reconstructions and the two contour sums, an I4 subblock its contour's
    smoothed strips (110); per filtered edge 16 luma lines (the MB edge
    where there is a left or upper MB, 3 inner edges a direction where
    inner) and, with the normal filter, 16 chroma lines (the MB edge, 1
    inner edge a direction), where the MB's limit is not 0."""
    n_mb = len(limit)
    ops = n_mb * (24 * (_IDCT + _REC) + 64) + int(P["is_i4"].sum()) * 16 * 110
    if ftype:
        en = limit > 0
        m = np.arange(n_mb)
        mb_edges = int((en & (m % mb_w > 0)).sum() + (en & (m >= mb_w)).sum())
        n_in = int((en & inner).sum())
        if ftype == 1:
            ops += 16 * (mb_edges + 6 * n_in) * _EDGE_SIMPLE
        else:
            ops += 16 * (2 * mb_edges + 8 * n_in) * _EDGE_NORMAL
    return ops


def bound_ms(n_bytes, n_ops):
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / INT32_OPS_PER_S * 1e3
    return (max(t_bytes, t_ops), "bytes" if t_bytes > t_ops else "operations")


# The decode's kernel; the other four are the lossy encode's.
DECODE_KERNEL = "decode_wavefront"


def check_per_batch(launches, n_batches, what):
    """Every encode kernel of the path must have launched once per batch,
    the decode kernel never."""
    enc = {k: v for k, v in launches.items() if k != DECODE_KERNEL}
    if set(enc.values()) != {n_batches} or launches.get(DECODE_KERNEL):
        raise AssertionError(f"{what}: launches {launches}, expected "
                             f"{n_batches} of each encode kernel (one per "
                             f"batch) and no {DECODE_KERNEL}")
    print(f"{what}: launches {launches}, one per batch of {n_batches}",
          flush=True)


def decode_launches(launches, n):
    """{each encode kernel: 0, the decode kernel: n}: the launches of n
    device decodes of lossy frames and no encode."""
    return {k: n if k == DECODE_KERNEL else 0 for k in launches}


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


def hold_calls(name, kernel, plain, calls):
    """Kernel against its plain version on each recorded call's card
    tensors (integer outputs equal, scores within SCORE_RTOL; raises
    otherwise); returns the largest absolute error over the calls and the
    kernel's time on the card in ms for each call."""
    err, ms = 0.0, []
    for args in calls:
        got, ref = _outputs(kernel(*args)), _outputs(plain(*args))
        for g, r in zip(got, ref):
            if not (torch.allclose(g, r, rtol=SCORE_RTOL, atol=0)
                    if g.is_floating_point() else torch.equal(g, r)):
                raise AssertionError(f"{name} disagrees with its plain "
                                     "version")
            err = max(err, float((g.double() - r.double()).abs().max()))
        ms.append(time_ms(lambda: kernel(*args), 10))
    return err, ms


def hold_exact(name, kernel, plain, args):
    """hold_calls on one call; returns the kernel's time in ms."""
    return hold_calls(name, kernel, plain, [args])[1][0]


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
                    "p2_wavefront": 1, DECODE_KERNEL: 0}
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
    want = {"p1_alpha": 1, "p1_mode": 1, "i4_search": 1, "p2_wavefront": 0,
            DECODE_KERNEL: 0}
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
    on each, with one launch of the decode kernel and no encode kernel
    while decoding; ms per image on both backends; the decode kernel's
    card time at B=1 (runs queued, and per call from an idle card) beside
    its bound and its dependency chain (ms per step), and on the defaults'
    file at B=16 (with the main path's images), each image equal to its
    B=1 decode, and the plain version (the step loop on the card, one
    run) equal to the kernel, with its time; decode_lossy_stream_device
    over 32 images against 32 single decodes; the card's decode against
    the CPU's plain versions at 64x48, 72x40 and 33x17 on the three filter
    branches; autofilter and rate control on the card (wall time, passes,
    size or PSNR against the target at full width; card == CPU files at
    64x48); encode(backend="host") on the host. Returns the decode
    kernel's record for the kernels' JSON line."""
    import dataclasses

    import webp_tpu_torch
    from webp_tpu_torch import encoder as ENC
    from webp_tpu_torch.container.parser import Parser
    from webp_tpu_torch.lossy import decode as DEC
    from webp_tpu_torch.lossy import device_decode as DD
    from webp_tpu_torch.ops import cuda as KC
    from webp_tpu_torch.ops import p2_kernel as P2K

    rng = np.random.default_rng(seed + 10)
    img = synth_images(rng, 1, H, W)[0]
    px = W * H
    mb_w, mb_h = W // 16, H // 16
    n_sm = P2K.sm_count(CARD)
    bss = [Parser(f).frames()[0].bitstream
           for f in webp_tpu_torch.encode_batch(list(imgs), QUALITY)]

    def card_inputs(streams):
        """DecodeFn of the planes and its inputs on the card, the parsed
        bitstreams stacked on the batch axis."""
        parsed = [DD._parse_inputs(b) for b in streams]
        ins = [torch.cat(ts).to(CARD) for ts in zip(
            *[DD._host_inputs(q) for q in parsed])]
        return DD._fn(parsed[0], False), ins

    files = {}
    record = None
    for label, opts in (("normal filter (defaults)", {}),
                        ("method 6", dict(method=6)),
                        ("simple filter", dict(filter_type=0)),
                        ("no filter", dict(filter_strength=0))):
        files[label], enc_s = once(lambda: webp_tpu_torch.encode(img, **opts))
        check_webp(files[label], W, H)
        bs = Parser(files[label]).frames()[0].bitstream
        P, fi, inner = DD._parse_inputs(bs)
        ftype = int(P["finfo"][0])
        n_i4 = int(P["is_i4"].sum())
        KC.reset_launches()
        dev, first_s = once(lambda: webp_tpu_torch.decode_rgba(files[label]))
        launches = dict(KC.LAUNCHES)
        check_launches(launches, decode_launches(launches, 1),
                       f"decode {label}")
        host = webp_tpu_torch.decode_rgba(files[label], backend="host")
        if not np.array_equal(dev, host):
            raise AssertionError(f"decode {label}: device and host pixels "
                                 "differ")
        dev_s = wall_s(lambda: webp_tpu_torch.decode_rgba(files[label]), 3)
        host_s = wall_s(lambda: webp_tpu_torch.decode_rgba(
            files[label], backend="host"), 3)
        # The kernel alone, on this file's inputs resident on the card.
        fn, ins = card_inputs([bs])
        ms1 = time_ms(lambda: fn(*ins), 20)
        call_ms = time_ms(lambda: fn(*ins), 20, queued=False)
        one = fn(*ins)
        n_bytes = sum(t.numel() * t.element_size() for t in ins) + 384 * (
            mb_w * mb_h)
        bd, by = bound_ms(n_bytes, _ops_decode(P, fi[:, 0], inner, ftype,
                                               mb_w))
        batch = ""
        if label.startswith("normal"):
            # B=16: this file and the main path's images 1-15 (the same
            # filter type: one per launch).
            b16 = [bs] + bss[1:]
            fn16, ins16 = card_inputs(b16)
            ms16 = time_ms(lambda: fn16(*ins16), 10)
            got16 = fn16(*ins16)
            for i, b in enumerate(b16):
                alone = fn16(*card_inputs([b])[1]) if i else one
                if not all(torch.equal(g[i], a[0])
                           for g, a in zip(got16, alone)):
                    raise AssertionError(f"decode kernel: image {i} of the "
                                         "B=16 launch differs from its B=1 "
                                         "decode")
            ref, plain_s = once(lambda: fn.plain(*ins))
            if not all(torch.equal(g, r) for g, r in zip(one, ref)):
                raise AssertionError("decode kernel: disagrees with its "
                                     "plain version")
            C1 = P2K.cluster_size(1, mb_h, n_sm)
            C16 = P2K.cluster_size(B, mb_h, n_sm)
            batch = (f"; B={B} {ms16:.4f} ms on the card "
                     f"({ms16 / B:.4f} ms per image, cluster size {C16}, "
                     f"{B * C16} blocks), each image equal to its B=1 "
                     f"decode; the plain version (the step loop on the "
                     f"card, one run) {plain_s * 1e3:.1f} ms, equal to the "
                     f"kernel; cluster size {C1} at B=1")
            record = dict(
                name=DECODE_KERNEL, route="cuda",
                source=f"webp_tpu_torch/csrc/{DECODE_KERNEL}.cu",
                replaces="none: webp_tpu/ops/decode.py is a jnp step loop",
                launches=launches[DECODE_KERNEL], max_abs_err=0.0, ms=ms1,
                call_ms=call_ms, ms_b16=ms16, plain_ms=plain_s * 1e3,
                bound_ms=bd, bound_by=by, steps=fn.steps,
                ms_per_step=ms1 / fn.steps, cluster_size=C1,
                library_ms=None)
        print(f"decode {label}: {W}x{H}, {len(files[label])} bytes (encode() "
              f"on the card {enc_s:.3f} s), filter type {ftype}, {n_i4} I4 "
              f"MBs; device == host pixels; launches while decoding "
              f"{launches}; decode_rgba on the card {dev_s * 1e3:.1f} ms per "
              f"image (first call {first_s * 1e3:.1f} ms); the native host "
              f"decoder {host_s * 1e3:.1f} ms per image (host time); "
              f"kernel {DECODE_KERNEL} B=1 {ms1:.4f} ms on the card (runs "
              f"queued), {call_ms:.4f} ms per call from an idle card, "
              f"{fn.steps} steps ({ms1 / fn.steps * 1e3:.2f} us per step: "
              f"the dependency chain), bound {bd:.4f} ms by {by} "
              f"({n_bytes} bytes){batch}; {card}", flush=True)

    # The stream over 32 images against 32 single decodes.
    bss = bss + bss
    KC.reset_launches()
    outs, stream_s = once(lambda: DD.decode_lossy_stream_device(bss))
    check_launches(dict(KC.LAUNCHES), decode_launches(KC.LAUNCHES, len(bss)),
                   "decode stream")
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
    return record


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
    # One device decode of a lossy frame (the RGBA file); the VP8L
    # decodes are host work.
    n_dec = int(torch.device(dev).type == "cuda")
    if any(out["lossless_encode"].values()) or \
            out["decode"] != decode_launches(out["decode"], n_dec):
        raise AssertionError(f"kernels launched outside the lossy encode "
                             f"and decode: {out}")

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


ANIM_W, ANIM_H, ANIM_N, ANIM_MS = 1280, 720, 24, 42
# Phase 12's 24-frame lossless AnimEncoder runs at method 3: at method 4
# (the default) every sub-frame of at most 65,536 pixels runs the
# exact-size transform search (about a dozen entropy encodes per
# candidate, up to four candidates per frame), about 12x method 3 per
# rect, which on two backends would take the script past its time limit.
# The default runs on the first ANIM_DEFAULT_N frames instead.
ANIM_LOSSLESS_METHOD = 3
ANIM_DEFAULT_N = 3


def anim_scene(rng, w, h, n):
    """Phase 12's frames, RGBA: a synth_images background; a textured
    opaque sprite (160x160 at full size) moving 24 px per frame; a
    semi-transparent banner (alpha 128) on frames 8-15; frames 5 and 6
    repeat frame 4; frame 16 cuts to a new background."""
    bgs = synth_images(rng, 2, h, w)
    s = min(160, h // 3, w // 3)
    sprite = synth_images(rng, 1, s, s)[0].astype(np.int16)
    sprite = np.clip(sprite + rng.integers(-40, 41, sprite.shape), 0,
                     255).astype(np.uint8)
    frames = []
    for i in range(n):
        if i in (5, 6):
            frames.append(frames[4].copy())
            continue
        f = np.dstack([bgs[1 if i >= 16 else 0],
                       np.full((h, w), 255, np.uint8)])
        x0, y0 = (w // 20 + 24 * i) % (w - s) & ~1, (h - s) // 2 & ~1
        f[y0:y0 + s, x0:x0 + s, :3] = sprite
        if 8 <= i <= 15:
            f[h // 8: h // 4, w // 10: w - w // 10] = (250, 210, 40, 128)
        frames.append(f)
    return frames


def unique_runs(frames):
    """The frames left after merging identical neighbours."""
    out = [frames[0]]
    for a, b in zip(frames, frames[1:]):
        if not np.array_equal(a, b):
            out.append(b)
    return out


def frame_kinds(data, w, h, n):
    """(keyframes, sub-frames, merged input frames) of an animation."""
    from webp_tpu_torch.container.parser import Parser

    infos = Parser(data).frames()
    keys = sum(f.x_offset == 0 and f.y_offset == 0
               and (f.width, f.height) == (w, h) for f in infos)
    return keys, len(infos) - keys, n - len(infos)


def animation(seed, card, w=ANIM_W, h=ANIM_H, n=ANIM_N, dev=CARD,
              small=((64, 48), (72, 40))):
    """Phase 12: animation at full width. encode_animation_device on the
    card (kernels 1-4 once per batch of 8 unique frames, each held
    against its plain version on every batch's inputs; its ANMF payloads
    are encode_lossy_stream's bitstreams of the unique frames);
    encode_animation at the defaults (lossy, host VP8Encoder) and lossless
    (method 3; at the defaults on the first frames) on the card and with
    backend="host" (equal files, no kernel);
    decode_animation of the three files on both backends and AnimDecoder
    on the card (canvases equal across backends and to a CPU
    compositor's; the lossless file's canvases equal the source; the lossy
    files' PSNR by ops/metrics on the card; the decode kernel once per
    lossy frame, no encode kernel); the device decode's programs per
    frame geometry; card against CPU files and
    canvases at the small sizes; ops/metrics card against CPU on full-size
    planes. Returns the kernels' launches in the phase: {"device_encode":
    {...}, "anim_encoder": {...}, "decode": {...}}."""
    from webp_tpu_torch.animation import animation as A
    from webp_tpu_torch.container.parser import Parser
    from webp_tpu_torch.lossy import device_decode as DD
    from webp_tpu_torch.lossy import device_encode as DE
    from webp_tpu_torch.ops import cuda as KC
    from webp_tpu_torch.ops import decode as OD
    from webp_tpu_torch.ops import i4_kernel as I4K
    from webp_tpu_torch.ops import metrics as M
    from webp_tpu_torch.ops import p1_kernels as P1K
    from webp_tpu_torch.ops import p2_kernel as P2K

    t_phase = time.perf_counter()
    frames = anim_scene(np.random.default_rng(seed + 12), w, h, n)
    unique = unique_runs(frames)
    n_batches = -(-len(unique) // 8)
    out = {}

    # The frame-batch device encode, counted; the kernels' card inputs
    # are recorded.
    with Recorder(P1K, "alphas") as r_a, \
            Recorder(P1K, "mode_search") as r_m, \
            Recorder(I4K, "i4_scores") as r_i4, \
            Recorder(P2K, "phase2_pack") as r_p2:
        KC.reset_launches()
        dev_file, first_s = once(lambda: A.encode_animation_device(
            frames, ANIM_MS, device=dev))
        out["device_encode"] = dict(KC.LAUNCHES)
    check_per_batch(out["device_encode"], n_batches,
                    f"encode_animation_device, {len(unique)} unique frames")
    dev_s = wall_s(lambda: A.encode_animation_device(frames, ANIM_MS,
                                                     device=dev), 2)
    infos = Parser(dev_file).frames()
    stream = DE.encode_lossy_stream([f[..., :3] for f in unique],
                                    device=dev)
    if [f.bitstream for f in infos] != stream:
        raise AssertionError("encode_animation_device: the ANMF payloads "
                             "are not the stream's bitstreams")
    if any((f.x_offset, f.y_offset, f.width, f.height, int(f.dispose),
            int(f.blend)) != (0, 0, w, h, 0, 1) for f in infos):
        raise AssertionError("encode_animation_device: a frame is not a "
                             "full-canvas NONE/NONE frame")
    print(f"animation: encode_animation_device {n} frames {w}x{h} "
          f"({len(unique)} unique) on the card: first call {first_s:.3f} s, "
          f"then {dev_s:.3f} s wall, "
          f"{len(unique) * w * h / dev_s / 1e6:.2f} Mpx/s of unique frames; "
          f"{len(dev_file)} bytes; payloads == encode_lossy_stream's; "
          f"{card}", flush=True)
    # Kernels 1-4 against their plain versions on every batch's inputs.
    sizes = [int(c[0].shape[0]) for c in r_p2.calls]
    for kname, rec, kernel, plain in (
            ("p1_alpha", r_a, P1K.alphas, P1K.alphas_plain),
            ("p1_mode", r_m, P1K.mode_search, P1K.mode_search_plain),
            ("i4_search", r_i4, I4K.i4_scores, I4K.i4_scores_plain),
            ("p2_wavefront", r_p2, P2K.phase2_pack, P2K.phase2_pack_plain)):
        if len(rec.calls) != n_batches:
            raise AssertionError(f"{kname}: {len(rec.calls)} recorded "
                                 f"calls, expected {n_batches}")
        err, ms = hold_calls(kname, kernel, plain, rec.calls)
        print(f"animation: kernel {kname} on encode_animation_device's "
              f"{w // 16}x{h // 16}-MB batches of {sizes}: agrees with its "
              f"plain version (max abs err {err}); "
              + ", ".join(f"{t:.4f}" for t in ms) + f" ms on the card; "
              f"{card}", flush=True)

    # AnimEncoder: lossy at the defaults, lossless on both backends.
    files = {"device": dev_file}
    KC.reset_launches()
    files["lossy"], lossy_s = once(lambda: A.encode_animation(
        frames, ANIM_MS, device=dev))
    ll = dict(lossless=True, method=ANIM_LOSSLESS_METHOD)
    files["lossless"], ll_card_s = once(lambda: A.encode_animation(
        frames, ANIM_MS, device=dev, **ll))
    ll_host, ll_host_s = once(lambda: A.encode_animation(
        frames, ANIM_MS, backend="host", **ll))
    if ll_host != files["lossless"]:
        raise AssertionError("lossless animation: card and host files "
                             "differ")
    for name, secs in (("lossy", lossy_s), ("lossless", ll_card_s)):
        k, s_, m = frame_kinds(files[name], w, h, n)
        print(f"animation: encode_animation {name} "
              f"({'defaults' if name == 'lossy' else ll}) {n} frames "
              f"{w}x{h}: {secs:.3f} s wall on the card"
              + (f" (backend=\"host\" {ll_host_s:.3f} s, files equal)"
                 if name == "lossless" else "")
              + f"; {len(files[name])} bytes; {k} keyframes, {s_} "
              f"sub-frames, {m} merged; {card}", flush=True)

    # Lossless at the defaults (method 4) on the first frames, card and
    # host, beside method 3 on the same frames.
    few = frames[:ANIM_DEFAULT_N]
    d4, d4_card_s = once(lambda: A.encode_animation(
        few, ANIM_MS, lossless=True, device=dev))
    d4_host, d4_host_s = once(lambda: A.encode_animation(
        few, ANIM_MS, lossless=True, backend="host"))
    _, d3_s = once(lambda: A.encode_animation(few, ANIM_MS, device=dev, **ll))
    out["anim_encoder"] = dict(KC.LAUNCHES)
    if d4_host != d4:
        raise AssertionError("lossless animation at the defaults: card and "
                             "host files differ")
    back = [c for c, _ in A.AnimDecoder(A.decode_animation(
        d4, backend="host"), device="cpu")]
    if len(back) != len(few) or not all(
            np.array_equal(c, f) for c, f in zip(back, few)):
        raise AssertionError("lossless animation at the defaults: canvases "
                             "differ from the source")
    k, s_, m = frame_kinds(d4, w, h, len(few))
    print(f"animation: encode_animation lossless (defaults, method 4) "
          f"{len(few)} frames {w}x{h}: {d4_card_s:.3f} s wall on the card, "
          f"backend=\"host\" {d4_host_s:.3f} s, files equal, canvases == "
          f"source; method 3 on the same frames {d3_s:.3f} s on the card; "
          f"{len(d4)} bytes; {k} keyframes, {s_} sub-frames, {m} merged; "
          f"{card}", flush=True)

    # Decodes on both backends and the compositor; the device decode's
    # programs per frame geometry.
    KC.reset_launches()
    info0 = OD.decode_fn.cache_info()
    canvases = {}
    n_lossy = 0
    for name, data in files.items():
        lossy = [f for f in Parser(data).frames() if not f.is_lossless]
        lossy_geoms = {(f.width, f.height) for f in lossy}
        n_lossy += len(lossy)
        on_card, card_s = once(lambda: A.decode_animation(data, device=dev))
        on_host, host_s = once(lambda: A.decode_animation(data,
                                                          backend="host"))
        for a, b in zip(on_card.frames, on_host.frames):
            if not np.array_equal(a.rgba, b.rgba):
                raise AssertionError(f"{name}: device and host decodes "
                                     "differ")
        got, comp_s = once(lambda: [c for c, _ in A.AnimDecoder(
            on_card, device=dev)])
        want, comp_cpu_s = once(lambda: [c for c, _ in A.AnimDecoder(
            on_host, device="cpu")])
        if len(got) != len(unique) or not all(
                np.array_equal(a, b) for a, b in zip(got, want)):
            raise AssertionError(f"{name}: the card's canvases differ from "
                                 "the CPU compositor's")
        canvases[name] = got
        k = len(on_card.frames)
        print(f"animation: decode {name} ({k} frames, {len(lossy_geoms)} "
              f"lossy frame geometries): decode_animation "
              f"{card_s / k * 1e3:.1f} ms per frame on the card, "
              f"{host_s / k * 1e3:.1f} on the host; AnimDecoder "
              f"{comp_s / k * 1e3:.2f} ms per frame on the card, "
              f"{comp_cpu_s / k * 1e3:.2f} on the CPU; canvases equal; "
              f"{card}", flush=True)
    out["decode"] = dict(KC.LAUNCHES)
    info1 = OD.decode_fn.cache_info()
    if not all(np.array_equal(c, f)
               for c, f in zip(canvases["lossless"], unique)):
        raise AssertionError("lossless animation: canvases differ from the "
                             "source")
    for name in ("device", "lossy"):
        psnr = []
        for c, f in zip(canvases[name], unique):
            a = torch.from_numpy(c[..., :3]).to(dev)
            b = torch.from_numpy(np.ascontiguousarray(f[..., :3])).to(dev)
            psnr.append(float(M.psnr_from_sse(M.sse(a, b), a.numel())))
        if not all(np.isfinite(psnr)) or min(psnr) < 20.0:
            raise AssertionError(f"{name}: PSNR against the source {psnr}")
        print(f"animation: {name} canvases against the source (RGB, "
              f"ops/metrics on the card): PSNR min {min(psnr):.2f} dB, "
              f"median {statistics.median(psnr):.2f} dB", flush=True)
    # The decode kernel once per lossy frame decoded on the card.
    n_dec = n_lossy if torch.device(dev).type == "cuda" else 0
    if any(out["anim_encoder"].values()) or \
            out["decode"] != decode_launches(out["decode"], n_dec):
        raise AssertionError(f"kernels launched outside the device encode "
                             f"and decode: {out}")
    geoms = {(f.width, f.height) for d in files.values()
             for f in Parser(d).frames() if not f.is_lossless}
    print(f"animation: device decode programs: {len(geoms)} distinct lossy "
          f"frame geometries over the three files, {info1.misses - info0.misses}"
          f" decode programs built (lru_cache of {info1.maxsize}), "
          f"{info1.currsize} cached", flush=True)
    lossy_infos = Parser(files["lossy"]).frames()
    key = next(f for f in lossy_infos if (f.width, f.height) == (w, h))
    sub = next(f for f in lossy_infos if (f.width, f.height) != (w, h))
    for label, f in (("keyframe", key), ("sub-frame", sub)):
        OD.decode_fn.cache_clear()
        _, new_s = once(lambda: DD.decode_vp8_rgb_device(f.bitstream,
                                                         device=dev))
        again_s = wall_s(lambda: DD.decode_vp8_rgb_device(f.bitstream,
                                                          device=dev), 3)
        print(f"animation: device decode of a {label} {f.width}x{f.height}: "
              f"first-seen geometry {new_s * 1e3:.1f} ms, repeated "
              f"{again_s * 1e3:.1f} ms; {card}", flush=True)

    # Card against CPU, small sizes.
    for (sw, sh) in small:
        sf = anim_scene(np.random.default_rng(seed + 13), sw, sh, 10)
        pairs = [("encode_animation_device", lambda d: A.encode_animation_device(
                     sf, ANIM_MS, device=d)),
                 ("lossless", lambda d: A.encode_animation(
                     sf, ANIM_MS, lossless=True, device=d)),
                 ("allow_mixed", lambda d: A.encode_animation(
                     sf, ANIM_MS, allow_mixed=True, device=d))]
        for label, enc in pairs:
            data = enc(dev)
            if data != enc("cpu"):
                raise AssertionError(f"{sw}x{sh} {label}: card and CPU "
                                     "files differ")
            a = [c for c, _ in A.AnimDecoder(A.decode_animation(
                data, device=dev), device=dev)]
            b = [c for c, _ in A.AnimDecoder(A.decode_animation(
                data, device="cpu"), device="cpu")]
            if len(a) != len(b) or not all(
                    np.array_equal(x, y) for x, y in zip(a, b)):
                raise AssertionError(f"{sw}x{sh} {label}: card and CPU "
                                     "canvases differ")
    print("animation parity: card == CPU files and canvases at "
          + ", ".join(f"{a}x{b}" for a, b in small)
          + ": encode_animation_device, lossless, allow_mixed", flush=True)

    # ops/metrics, card against CPU, on full-size planes.
    pa = torch.from_numpy(np.ascontiguousarray(unique[0][..., 1]))
    pb = torch.from_numpy(np.ascontiguousarray(canvases["lossy"][0][..., 1]))
    s_cpu, s_card = M.sse(pa, pb), M.sse(pa.to(dev), pb.to(dev))
    blk = [t.reshape(h // 4, 4, w // 4, 4).transpose(1, 2).reshape(-1, 4, 4)
           for t in (pa, pb)]
    checks = {
        "sse": int(s_card) == int(s_cpu),
        "tdisto4x4": torch.equal(M.tdisto4x4(*[t.to(dev) for t in blk]).cpu(),
                                 M.tdisto4x4(*blk)),
        "psnr_from_sse": np.isclose(float(M.psnr_from_sse(s_card, pa.numel())),
                                    float(M.psnr_from_sse(s_cpu, pa.numel())),
                                    rtol=1e-5, atol=0),
        "ssim_plane": np.isclose(float(M.ssim_plane(pa.to(dev), pb.to(dev))),
                                 float(M.ssim_plane(pa, pb)), rtol=1e-5,
                                 atol=0)}
    if not all(checks.values()):
        raise AssertionError(f"ops/metrics: card and CPU differ: {checks}")
    print(f"ops/metrics: sse, tdisto4x4 exact, psnr_from_sse and ssim_plane "
          f"within rtol 1e-5, card == CPU on {w}x{h} planes (SSIM "
          f"{float(M.ssim_plane(pa, pb)):.5f})", flush=True)
    print(f"animation: phase 12 took {time.perf_counter() - t_phase:.1f} s; "
          f"{card}", flush=True)
    return out


def check_launches(got, want, what):
    """Raises unless the kernels' launch counts of a path are `want`."""
    if got != want:
        raise AssertionError(f"{what}: launches {got}, expected {want}")


class Timed:
    """Wraps a module function so that every call is timed on the host
    between two torch.cuda.synchronize() calls; the times go to .times."""

    def __init__(self, module, name):
        self.module, self.name = module, name
        self.orig = getattr(module, name)
        self.times = []

    def __enter__(self):
        def timed(*args, **kw):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = self.orig(*args, **kw)
            torch.cuda.synchronize()
            self.times.append(time.perf_counter() - t0)
            return out
        setattr(self.module, self.name, timed)
        return self

    def __exit__(self, *exc):
        setattr(self.module, self.name, self.orig)


def bands(seed, card, w=W, h=H, n=4, dev=CARD, small=(64, 64)):
    """Phase 13: the band encoders. n images of w x h (96x64 MBs at full
    width) from the seed, on `dev`:

    (a) the non-planar program, fast_encode_fn(..., planar=False).rgbp_blob,
        counted (kernel 3 once, kernels 1, 2 and 4 never), its blob equal
        to the planar program's; wall and device seconds, phase 2's steps
        and ms per step; kernel 3 against its plain version on its inputs;
    (b) the exact band pipeline, encode_lossy_mesh on 4 bands of [dev] * 4,
        counted (kernel 1 once per band, kernels 2 and 3 once per band and
        once per extension), its files equal to encode_batch's, and
        encode_lossy_stream(devices=[dev] * 4) with the same launches and
        files; seconds per image, Phase B's steps; kernels 1-3 against
        their plain versions on every call (the band batches' ms);
    (c) the sharded encoder on a (dp=1, sp=4) mesh of [dev] * 4, counted
        (kernels 1 and 3 once per band), its files decoded by the port's
        decoders (card and host equal), PSNR beside encode_batch's files';
    (b, c) again with one band per card where the machine shows several;
    (d) (a), (b) and (c) on dev against the CPU at `small` with 2 bands;
    (e) the wavefront oracle on dev at 64x48 against the host VP8Encoder's
        I16 path, and timed once at full width; kernel 4 on the oracle's
        modes against the oracle's levels at both sizes.
    Returns {"launches": {path: counts}, "k3": {...}, "band": {...}}
    for the kernels line."""
    import webp_tpu_torch
    from webp_tpu_torch.container import riff
    from webp_tpu_torch.encoder import _psnr_of, rgb_to_yuv420
    from webp_tpu_torch.lossy import device_encode as DE
    from webp_tpu_torch.lossy.encode import LossyConfig, VP8Encoder
    from webp_tpu_torch.ops import cuda as KC
    from webp_tpu_torch.ops import fastpath as FP
    from webp_tpu_torch.ops import i4_kernel as I4K
    from webp_tpu_torch.ops import p1_kernels as P1K
    from webp_tpu_torch.ops import p2_kernel as P2K
    from webp_tpu_torch.ops import wavefront as WF
    from webp_tpu_torch.parallel import exact as EX
    from webp_tpu_torch.parallel import mesh as ME

    t_phase = time.perf_counter()
    rng = np.random.default_rng(seed + 13)
    imgs = synth_images(rng, n, h, w)
    mb_w, mb_h = w // 16, h // 16
    px = n * w * h
    none = {k: 0 for k in KC.LAUNCHES}
    launches, k3 = {}, {}

    def riffs(frames):
        return [riff.assemble_riff([riff.Chunk(riff.VP8, f)])
                for f in frames]

    # (a) The non-planar program.
    fn = FP.fast_encode_fn(mb_w, mb_h, QUALITY, 4, 50, True, planar=False)
    x = torch.as_tensor(np.ascontiguousarray(imgs.transpose(0, 3, 1, 2))) \
        .to(dev)
    with Recorder(I4K, "i4_scores") as r_np:
        KC.reset_launches()
        blob, first_s = once(lambda: fn.rgbp_blob(x))
        launches["nonplanar"] = dict(KC.LAUNCHES)
    check_launches(launches["nonplanar"], dict(none, i4_search=1),
                   "non-planar program")
    planar = FP.fast_encode_fn(mb_w, mb_h, QUALITY, 4, 50, True)
    if not all(torch.equal(a, b) for a, b in zip(blob, planar.rgbp_blob(x))):
        raise AssertionError("non-planar blob differs from the planar one")
    wall = wall_s(lambda: fn.rgbp_blob(x), 2)
    dev_ms = time_ms(lambda: fn.rgbp_blob(x), 2, queued=False)
    with Timed(FP, "_phase2") as t_p2:
        fn.rgbp_blob(x)
    steps = mb_w + mb_h - 1
    err_np, ms_np = hold_calls("i4_search", I4K.i4_scores,
                               I4K.i4_scores_plain, r_np.calls)
    print(f"bands (a): non-planar fast_encode_fn B={n} {w}x{h}: first call "
          f"{first_s:.3f} s, then {wall:.3f} s wall, {dev_ms:.1f} ms device "
          f"(CUDA events, host launches included), {px / wall / 1e6:.2f} "
          f"Mpx/s; phase 2 {t_p2.times[0]:.3f} s over {steps} steps, "
          f"{t_p2.times[0] / steps * 1e3:.3f} ms per step (CUDA graph); "
          f"blob equal to the planar program's; launches "
          f"{launches['nonplanar']}; kernel 3 on its inputs "
          f"{ms_np[0]:.4f} ms, exact against its plain version (max abs "
          f"err {err_np}); {card}", flush=True)
    k3.update(nonplanar_ms=ms_np[0], nonplanar_wall_s=wall,
              nonplanar_p2_ms_per_step=t_p2.times[0] / steps * 1e3)

    # (b) The exact band pipeline on 4 bands.
    sp = 4
    devs = [dev] * sp
    exact_counts = dict(none, p1_alpha=sp, p1_mode=2 * sp - 1,
                        i4_search=2 * sp - 1)
    with Recorder(P1K, "alphas") as r_a, \
            Recorder(P1K, "mode_search") as r_m, \
            Recorder(I4K, "i4_scores") as r_ex:
        KC.reset_launches()
        frames, ex_first = once(lambda: EX.encode_lossy_mesh(
            list(imgs), devices=devs))
        launches["exact"] = dict(KC.LAUNCHES)
    check_launches(launches["exact"], exact_counts, "exact band pipeline")
    files_batch = webp_tpu_torch.encode_batch(list(imgs), QUALITY,
                                              device=dev)
    if riffs(frames) != files_batch:
        raise AssertionError("exact band pipeline: files differ from "
                             "encode_batch's")
    # The stream's multi-device branch, asked for with devices=.
    KC.reset_launches()
    stream = DE.encode_lossy_stream(list(imgs), QUALITY, devices=devs)
    launches["stream"] = dict(KC.LAUNCHES)
    check_launches(launches["stream"], exact_counts,
                   "encode_lossy_stream(devices=...)")
    if riffs(stream) != files_batch:
        raise AssertionError("encode_lossy_stream(devices=...): files "
                             "differ from encode_batch's")
    ex_s = wall_s(lambda: EX.encode_lossy_mesh(list(imgs), devices=devs), 1)
    with Timed(FP, "_phase2") as t_ex:
        EX.encode_lossy_mesh(list(imgs), devices=devs)
    band_steps = mb_w + mb_h // sp - 1
    p2_ms = sum(t_ex.times) / len(t_ex.times) / band_steps * 1e3
    err_ex, ms_ex = hold_calls("i4_search", I4K.i4_scores,
                               I4K.i4_scores_plain, r_ex.calls)
    err_a, ms_a = hold_calls("p1_alpha", P1K.alphas, P1K.alphas_plain,
                             r_a.calls)
    err_m, ms_m = hold_calls("p1_mode", P1K.mode_search,
                             P1K.mode_search_plain, r_m.calls)
    band_args = r_ex.calls[0]
    plain_ms = time_ms(lambda: I4K.i4_scores_plain(*band_args), 1,
                       queued=False)

    def k3_bound(args):
        """Kernel 3's bound on one call's inputs (as phase 4 counts)."""
        n_sb = args[0].shape[1]
        n_in = sum(a.numel() * a.element_size() for a in args
                   if isinstance(a, torch.Tensor))
        return bound_ms(n_in + 8 * n_sb, _ops_i4_per_sb(args[-1]) * n_sb)
    band_bd, band_by = k3_bound(band_args)
    np_bd, _ = k3_bound(r_np.calls[0])

    def lanes_bound(args, out_per_lane, ops_per_lane):
        """Kernel 1's or 2's bound on one call (as phase 4 counts)."""
        n = args[0].shape[1]
        n_in = sum(a.numel() * a.element_size() for a in args
                   if isinstance(a, torch.Tensor))
        return bound_ms(n_in + out_per_lane * n, ops_per_lane * n)[0]
    a_bd = lanes_bound(r_a.calls[0], 8, _ops_alpha_per_mb())
    m_bd = lanes_bound(r_m.calls[0], 12, _ops_mode_per_mb(r_m.calls[0][-1]))
    print(f"bands (b): encode_lossy_mesh on {sp} bands of {dev} x {sp}: "
          f"first call {ex_first:.3f} s, then {ex_s:.3f} s, "
          f"{ex_s / n:.3f} s per image; Phase B {n + sp - 1} pipeline "
          f"steps, {len(t_ex.times)} band wavefronts of {band_steps} steps, "
          f"{sum(t_ex.times):.3f} s ({p2_ms:.3f} ms per step); files equal to "
          f"encode_batch's; launches {launches['exact']}; kernel 3 on the "
          f"band batches ({n} images x {mb_h // sp} MB rows) "
          f"{', '.join(f'{m:.4f}' for m in ms_ex[:sp])} ms, on the "
          f"extensions (2 MB rows) "
          f"{', '.join(f'{m:.4f}' for m in ms_ex[sp:])} ms, plain "
          f"{plain_ms:.2f} ms on band 0, bound {band_bd:.4f} ms by "
          f"{band_by} (the non-planar batch's {np_bd:.4f} ms), exact (max "
          f"abs err {err_ex}); kernel 1 on the bands "
          f"{', '.join(f'{m:.4f}' for m in ms_a)} ms (bound {a_bd:.4f} ms, "
          f"max abs err {err_a}), kernel 2 on the bands "
          f"{', '.join(f'{m:.4f}' for m in ms_m[:sp])} ms (bound "
          f"{m_bd:.4f} ms) and the extensions "
          f"{', '.join(f'{m:.4f}' for m in ms_m[sp:])} ms (max abs err "
          f"{err_m}), against their plain versions; "
          f"encode_lossy_stream(devices=[{dev}] * {sp}) writes the same "
          f"files, launches {launches['stream']}; {card}", flush=True)
    band = {"p1_alpha": dict(band_ms=ms_a[0], band_bound_ms=a_bd),
            "p1_mode": dict(band_ms=ms_m[0], band_bound_ms=m_bd)}
    k3.update(band_ms=ms_ex[0], band_plain_ms=plain_ms,
              band_bound_ms=band_bd, nonplanar_bound_ms=np_bd,
              exact_s_per_image=ex_s / n, exact_p2_ms_per_step=p2_ms)

    # (c) The sharded encoder on a (dp=1, sp=4) mesh.
    step = ME.make_sharded_encode_fn(ME.make_mesh(devices=devs, dp=1),
                                     QUALITY)
    KC.reset_launches()
    outs, sh_first = once(lambda: step(imgs))
    launches["sharded"] = dict(KC.LAUNCHES)
    check_launches(launches["sharded"], dict(none, p1_alpha=sp,
                                             i4_search=sp),
                   "sharded encoder")
    sh_s = wall_s(lambda: step(imgs), 1)

    # One band per card, where the machine shows several.
    cards = ([torch.device(f"cuda:{i}") for i in range(
        torch.cuda.device_count())] if dev.type == "cuda" else [])
    if len(cards) > 1 and mb_h % len(cards) == 0:
        nc = len(cards)
        mc, mc_first = once(lambda: EX.encode_lossy_mesh(list(imgs),
                                                         devices=cards))
        if riffs(mc) != files_batch:
            raise AssertionError(f"exact pipeline over {nc} cards: files "
                                 "differ from encode_batch's")
        mc_s = wall_s(lambda: EX.encode_lossy_mesh(list(imgs),
                                                   devices=cards), 1)
        step_c = ME.make_sharded_encode_fn(
            ME.make_mesh(devices=cards, dp=1), QUALITY)
        outs_c = step_c(imgs)
        if nc == sp and not all(torch.equal(a, b)
                                for a, b in zip(outs_c, outs)):
            raise AssertionError(f"sharded encoder over {nc} cards differs "
                                 f"from {sp} bands on one card")
        mcs_s = wall_s(lambda: step_c(imgs), 1)
        if not np.array_equal(webp_tpu_torch.decode_rgba(
                files_batch[0], device=cards[-1]), webp_tpu_torch.decode_rgba(
                files_batch[0], backend="host")):
            raise AssertionError(f"device decode on {cards[-1]} differs from "
                                 "the host decoder")
        print(f"bands (b, c) over {nc} cards, one band each: "
              f"encode_lossy_mesh first call {mc_first:.3f} s, then "
              f"{mc_s:.3f} s ({mc_s / n:.3f} s per image), files equal to "
              f"encode_batch's; sharded {mcs_s:.3f} s per batch of {n}"
              + (f", outputs equal to {sp} bands on one card"
                 if nc == sp else "")
              + f"; the device decode on {cards[-1]} equals the host's",
              flush=True)
        k3.update(cards=nc, cards_exact_s_per_image=mc_s / n,
                  cards_sharded_s=mcs_s)
    files_sh = riffs(EX.host_tail(ME.assemble_from_sharded(
        outs, sp, mb_w, mb_h), w, h))
    for f in files_sh:
        check_webp(f, w, h)
    on_card = webp_tpu_torch.decode_rgba(files_sh[0], device=dev)
    if not np.array_equal(on_card, webp_tpu_torch.decode_rgba(
            files_sh[0], backend="host")):
        raise AssertionError("sharded file: card and host decodes differ")
    psnr_sh = [_psnr_of(im, f) for im, f in zip(imgs, files_sh)]
    psnr_one = [_psnr_of(im, f) for im, f in zip(imgs, files_batch)]
    print(f"bands (c): sharded encoder (dp=1, sp={sp}): first call "
          f"{sh_first:.3f} s, then {sh_s:.3f} s per batch of {n}; "
          f"launches {launches['sharded']}; its files decode (card == "
          f"host); PSNR sharded {', '.join(f'{p:.3f}' for p in psnr_sh)} "
          f"dB against single-device "
          f"{', '.join(f'{p:.3f}' for p in psnr_one)} dB; bytes "
          f"{sum(map(len, files_sh))} against {sum(map(len, files_batch))}",
          flush=True)

    # (d) Card against CPU at the small size, 2 bands.
    sw, sh = small
    sm = synth_images(rng, 2, sh, sw)
    cpu = torch.device("cpu")
    fn_s = FP.fast_encode_fn(sw // 16, sh // 16, QUALITY, 4, 50, True,
                             planar=False)
    a, b = (fn_s.rgb_blob(torch.as_tensor(sm).to(d)) for d in (dev, cpu))
    if not all(torch.equal(p.cpu(), q) for p, q in zip(a, b)):
        raise AssertionError("non-planar: card and CPU blobs differ")
    if (EX.encode_lossy_mesh(list(sm), devices=[dev] * 2)
            != EX.encode_lossy_mesh(list(sm), devices=[cpu] * 2)):
        raise AssertionError("exact pipeline: card and CPU files differ")
    o_card, o_cpu = (ME.make_sharded_encode_fn(ME.make_mesh(
        devices=[d] * 2, dp=1), QUALITY)(sm) for d in (dev, cpu))
    if not all(torch.equal(p.cpu(), q) for p, q in zip(o_card, o_cpu)):
        raise AssertionError("sharded encoder: card and CPU outputs differ")
    print(f"bands (d): card == CPU at {sw}x{sh}, 2 bands: the non-planar "
          "blob, the exact pipeline's files, the sharded encoder's "
          "outputs", flush=True)

    # (e) The wavefront oracle.
    ow = synth_images(rng, 1, 48, 64)[0]
    Y, U, V = rgb_to_yuv420(ow)
    KC.reset_launches()
    got = [o.cpu().numpy() for o in WF.wavefront_encode_fn(4, 3, QUALITY)(
        *(torch.as_tensor(p).to(dev) for p in (Y, U, V)))]
    enc = VP8Encoder(Y, U, V, 64, 48, LossyConfig(
        quality=QUALITY, i4_blocks=False, segments=1, sns_strength=0))
    enc.encode()
    if not (np.array_equal(got[0].reshape(enc.levels.shape), enc.levels)
            and np.array_equal(got[1].reshape(enc.y2_levels.shape),
                               enc.y2_levels)
            and np.array_equal(got[2], enc.imodes[..., 0].reshape(-1))):
        raise AssertionError("wavefront oracle differs from the host "
                             "encoder's I16 path")
    Yf, Uf, Vf = (torch.as_tensor(p).to(dev) for p in rgb_to_yuv420(imgs[0]))
    wf = WF.wavefront_encode_fn(mb_w, mb_h, QUALITY)
    full, wf_s = once(lambda: wf(Yf, Uf, Vf))
    launches["oracle"] = dict(KC.LAUNCHES)
    check_launches(launches["oracle"], none, "wavefront oracle")
    wf_steps = mb_w + 2 * mb_h - 2

    def kernel4_on(planes, out, mbw, mbh):
        """Kernel 4 on the oracle's modes (unsegmented, I4 off, rd_drop 0)
        must quantize the oracle's levels, y2 and skip flags."""
        n_mb = mbw * mbh
        plan = FP._single_plan(QUALITY, 0, 1, n_mb, dev)
        wire = P2K.phase2_pack(
            *(p[None] for p in planes), out[2][None], out[3][None],
            torch.zeros((1, n_mb), dtype=torch.bool, device=dev),
            torch.zeros((1, n_mb, 16), dtype=torch.uint8, device=dev),
            plan[0], plan[3], 0.0, max(1024, FP.ESC_BLOCKS_PER_MB * n_mb))
        wire = {k: v[0].cpu().numpy() for k, v in wire.items()}
        if int(wire["esc_cnt"]) > wire["esc_idx"].shape[0]:
            raise AssertionError("kernel 4 on the oracle's modes: escape "
                                 "overflow")
        lv = FP.unpack_levels(wire["packed"], wire["esc_idx"],
                              wire["esc_val"], int(wire["esc_cnt"]), n_mb)
        if not (np.array_equal(lv, out[0].cpu().numpy())
                and np.array_equal(wire["y2"], out[1].cpu().numpy())
                and np.array_equal(wire["skip"].astype(bool),
                                   out[4].cpu().numpy())):
            raise AssertionError(f"kernel 4 on the oracle's modes differs "
                                 f"from the oracle at {mbw}x{mbh} MBs")
    kernel4_on([torch.as_tensor(p).to(dev) for p in (Y, U, V)],
               [torch.as_tensor(o).to(dev) for o in got], 4, 3)
    kernel4_on((Yf, Uf, Vf), full, mb_w, mb_h)
    print(f"bands (e): wavefront oracle on the card equals the host "
          f"encoder's I16 levels, y2 and modes at 64x48; at {w}x{h} "
          f"{wf_s:.3f} s ({wf_steps} steps, {wf_s / wf_steps * 1e3:.2f} ms "
          f"per step), no kernel launched; kernel 4 on the oracle's modes "
          f"quantizes the oracle's levels, y2 and skip flags at 64x48 and "
          f"{w}x{h}", flush=True)
    print(f"bands: phase 13 took {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return {"launches": launches, "k3": k3, "band": band}


def _run_cli(argv):
    """webp_tpu_torch.cli.main(argv) in this process: (exit code, stdout,
    stderr)."""
    import contextlib
    import io

    from webp_tpu_torch import cli

    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = cli.main(argv)
    return rc, out.getvalue(), err.getvalue()


def host_surface(seed, card, w=W, h=H, dev=CARD,
                 small=((64, 48), (72, 40))):
    """Phase 14: the host surface. On a w x h synth_images image from the
    seed (the main path's width):

    (a) write_png, then read_png timed (host seconds) and its pixels equal
        to the image;
    (b) cli.main(["enc", in.png, out.webp]) in this process, counted (each
        kernel once, as encode() at the defaults), its file equal to
        webp_tpu_torch.encode(img); wall seconds and the PNG read's share;
    (c) cli.main(["dec", out.webp, back.png]): the decode kernel once,
        pixels equal to decode(data, backend="host"); ms;
    (d) an RGBA image (phase 11's alpha_plane) through enc -> dec (an RGBA
        PNG with the source's alpha; kernels once) and enc -lossless
        -exact -> dec (equal to the source; no encode kernel, the decode
        kernel only for the lossy RGBA file);
    (e) info on the VP8, VP8X+ALPH and VP8L files, its lines printed;
    (f) `python -m webp_tpu_torch.cli enc|dec|info` as subprocesses from
        the repository's root (the module entry on the card by default,
        from a fresh process): exit 0, the in-process files and text;
    (g) card against CPU at `small`: enc and enc -device cpu write equal
        files, dec and dec -device cpu equal PNG pixels;
    (h) whether Pillow can be imported (with it, a 3-frame animated WebP
        -> GIF -> WebP round trip through the CLI keeps 3 frames; without
        it, dec to .gif returns 2), and a process in which `import PIL`
        fails: enc of the PNG writes (b)'s file, enc of a GIF and dec of
        an animated file to .gif return 2 with the Pillow message;
    (i) utils/rescaler.rescale_rgba of the RGBA image to w/2 x h/2: host
        seconds, within 1 of the 2x2 box mean everywhere.

    The Pillow plugin (pil_plugin.py) is not driven here: it needs Pillow,
    which a card machine need not have (tests/test_torch_pil_plugin.py
    holds it against the reference's plugin on the CPU). Returns the
    kernels' launches in the phase: {"enc": ..., "enc_rgba": ...,
    "lossless": ..., "dec": ...}."""
    import importlib.util
    import tempfile

    import webp_tpu_torch
    from webp_tpu_torch.animation.animation import encode_animation
    from webp_tpu_torch.container.parser import Parser
    from webp_tpu_torch.ops import cuda as KC
    from webp_tpu_torch.utils import png, rescaler

    t_phase = time.perf_counter()
    rng = np.random.default_rng(seed + 14)
    img = synth_images(rng, 1, h, w)[0]
    rgba = np.dstack([img, alpha_plane(rng, h, w)])
    dev_arg = [] if dev == CARD else ["-device", str(dev)]
    launches = {}

    def run(argv, want_rc=0):
        rc, out, err = _run_cli(argv)
        if rc != want_rc:
            raise AssertionError(f"cli {argv}: exit {rc}, expected "
                                 f"{want_rc}; stderr {err!r}")
        return out, err

    def read(path):
        with open(path, "rb") as f:
            return f.read()

    with tempfile.TemporaryDirectory(prefix="_phase14_", dir=HERE) as d:
        p = {k: os.path.join(d, k) for k in (
            "in.png", "out.webp", "back.png", "rgba.png", "rgba.webp",
            "rgba_back.png", "ll.webp", "ll_back.png", "sub.webp",
            "sub.png")}

        # (a) The PNG writer and reader.
        data_png, write_s = once(lambda: png.write_png(img))
        with open(p["in.png"], "wb") as f:
            f.write(data_png)
        read_s = wall_s(lambda: png.read_png(data_png), 3)
        if not np.array_equal(png.read_png(data_png), img):
            raise AssertionError("read_png(write_png(img)) != img")
        print(f"host surface: write_png {w}x{h} RGB {write_s:.4f} s, "
              f"{len(data_png)} bytes; read_png {read_s:.4f} s (host, "
              f"median of 3; zlib and the native unfilter), pixels equal",
              flush=True)

        # (b) enc in this process, counted.
        KC.reset_launches()
        run(["enc"] + dev_arg + [p["in.png"], p["out.webp"]])
        launches["enc"] = dict(KC.LAUNCHES)
        check_per_batch(launches["enc"], 1, f"cli enc {w}x{h} defaults")
        data = read(p["out.webp"])
        if data != webp_tpu_torch.encode(img, device=dev):
            raise AssertionError("cli enc: the file differs from encode()'s")
        check_webp(data, w, h)
        enc_s = wall_s(lambda: run(["enc"] + dev_arg + [p["in.png"],
                                                         p["out.webp"]]), 3)
        e2e = wall_s(lambda: webp_tpu_torch.encode(img, device=dev), 3)
        print(f"host surface: cli enc {w}x{h} at the defaults "
              f"{enc_s:.4f} s wall (median of 3; encode() alone "
              f"{e2e:.4f} s), of which the PNG read {read_s:.4f} s "
              f"({read_s / enc_s:.1%}); {len(data)} bytes, equal to "
              f"encode(img); launches {launches['enc']}; {card}", flush=True)

        # (c) dec: the decode kernel once, the host decoder's pixels.
        KC.reset_launches()
        run(["dec"] + dev_arg + [p["out.webp"], p["back.png"]])
        launches["dec"] = dict(KC.LAUNCHES)
        back = png.read_png(read(p["back.png"]))
        if not np.array_equal(back, webp_tpu_torch.decode(data,
                                                          backend="host")):
            raise AssertionError("cli dec: pixels differ from the host "
                                 "decoder's")
        dec_s = wall_s(lambda: run(["dec"] + dev_arg + [p["out.webp"],
                                                         p["back.png"]]), 3)
        print(f"host surface: cli dec {w}x{h} to PNG {dec_s * 1e3:.1f} ms "
              f"wall (median of 3), pixels equal to the host decoder's; "
              f"{card}", flush=True)

        # (d) RGBA: lossy with ALPH, and lossless.
        with open(p["rgba.png"], "wb") as f:
            f.write(png.write_png(rgba))
        KC.reset_launches()
        _, rgba_s = once(lambda: run(["enc"] + dev_arg + [
            p["rgba.png"], p["rgba.webp"]]))
        launches["enc_rgba"] = dict(KC.LAUNCHES)
        check_per_batch(launches["enc_rgba"], 1, f"cli enc {w}x{h} RGBA")
        KC.reset_launches()
        _, ll_s = once(lambda: run(["enc", "-lossless", "-exact"] + dev_arg
                                   + [p["rgba.png"], p["ll.webp"]]))
        launches["lossless"] = dict(KC.LAUNCHES)
        check_launches(launches["lossless"], {k: 0 for k in KC.LAUNCHES},
                       "cli enc -lossless")
        KC.reset_launches()
        run(["dec"] + dev_arg + [p["rgba.webp"], p["rgba_back.png"]])
        run(["dec"] + dev_arg + [p["ll.webp"], p["ll_back.png"]])
        for k, v in KC.LAUNCHES.items():
            launches["dec"][k] += v
        # Two lossy files (RGB, RGBA) decoded on the device; VP8L on the
        # host.
        check_launches(launches["dec"], decode_launches(
            KC.LAUNCHES, 2 if dev == CARD else 0), "cli dec")
        got = png.read_png(read(p["rgba_back.png"]))
        if got.shape != rgba.shape or not np.array_equal(got[..., 3],
                                                         rgba[..., 3]):
            raise AssertionError("cli enc/dec RGBA: the alpha differs from "
                                 "the source's")
        if not np.array_equal(png.read_png(read(p["ll_back.png"])), rgba):
            raise AssertionError("cli enc -lossless -exact / dec: not the "
                                 "source")
        print(f"host surface: cli enc RGBA {w}x{h} {rgba_s:.3f} s (ALPH "
              f"on a host thread), dec: an RGBA PNG with the source's "
              f"alpha; enc -lossless -exact {ll_s:.3f} s, dec equal to the "
              f"source; launches {launches['enc_rgba']} (lossy), "
              f"{launches['lossless']} (lossless), {launches['dec']} (the "
              f"decodes); {card}", flush=True)

        # (e) info on the three kinds of file.
        infos = {}
        for name in ("out.webp", "rgba.webp", "ll.webp"):
            infos[name], _ = run(["info", p[name]])
            for line in infos[name].splitlines():
                print(f"host surface: info {name}: {line}", flush=True)

        # (f) The module entry in fresh processes.
        sub = {}
        for argv in (["enc", p["in.png"], p["sub.webp"]],
                     ["dec", p["sub.webp"], p["sub.png"]],
                     ["info", p["sub.webp"]]):
            t0 = time.perf_counter()
            if argv[0] != "info":
                argv = argv[:1] + dev_arg + argv[1:]
            r = subprocess.run([sys.executable, "-m", "webp_tpu_torch.cli"]
                               + argv, cwd=HERE,
                               capture_output=True, text=True, timeout=600)
            sub[argv[0]] = time.perf_counter() - t0
            if r.returncode != 0:
                raise AssertionError(f"python -m webp_tpu_torch.cli "
                                     f"{argv[0]}: exit {r.returncode}\n"
                                     f"{r.stderr[-3000:]}")
            if argv[0] == "info" and r.stdout != infos["out.webp"]:
                raise AssertionError("the subprocess's info differs")
        if read(p["sub.webp"]) != data or read(p["sub.png"]) != read(
                p["back.png"]):
            raise AssertionError("the subprocesses' files differ from the "
                                 "in-process files")
        print("host surface: python -m webp_tpu_torch.cli enc / dec / info "
              "from the repository's root: exit 0, the in-process files "
              "and text; " + ", ".join(f"{k} {v:.2f} s" for k, v in
                                       sub.items())
              + " wall per process (start-up included)", flush=True)

        # (g) Card against CPU.
        for (sw, sh) in small:
            sp = os.path.join(d, f"s{sw}x{sh}.png")
            with open(sp, "wb") as f:
                f.write(png.write_png(synth_images(rng, 1, sh, sw)[0]))
            run(["enc"] + dev_arg + [sp, sp + ".card.webp"])
            run(["enc", "-device", "cpu", sp, sp + ".cpu.webp"])
            if read(sp + ".card.webp") != read(sp + ".cpu.webp"):
                raise AssertionError(f"cli enc {sw}x{sh}: card and CPU "
                                     "files differ")
            run(["dec"] + dev_arg + [sp + ".card.webp", sp + ".card.png"])
            run(["dec", "-device", "cpu", sp + ".card.webp", sp + ".cpu.png"])
            if not np.array_equal(png.read_png(read(sp + ".card.png")),
                                  png.read_png(read(sp + ".cpu.png"))):
                raise AssertionError(f"cli dec {sw}x{sh}: card and CPU "
                                     "pixels differ")
        print("host surface: cli enc and dec on the card == -device cpu at "
              + ", ".join(f"{a}x{b}" for a, b in small), flush=True)

        # (h) Pillow, or its absence (the CLI's GIF paths, so this script
        # imports no PIL); then a fresh process in which `import PIL`
        # fails, whatever this machine has.
        has_pil = importlib.util.find_spec("PIL") is not None
        frames = [synth_images(rng, 1, 32, 48)[0] for _ in range(3)]
        anim = encode_animation([np.dstack([f, np.full((32, 48), 255,
                                                       np.uint8)])
                                 for f in frames], 100, lossless=True,
                                device=dev)
        p_anim, p_gif = os.path.join(d, "anim.webp"), os.path.join(d, "a.gif")
        with open(p_anim, "wb") as f:
            f.write(anim)
        run(["dec"] + dev_arg + [p_anim, p_gif], want_rc=0 if has_pil else 2)
        if has_pil:
            run(["enc", "-lossless"] + dev_arg + [p_gif, p_gif + ".webp"])
            n = len(Parser(read(p_gif + ".webp")).frames())
            if n != 3:
                raise AssertionError(f"GIF round trip: {n} frames, not 3")
            os.remove(p_gif + ".webp")
            print("host surface: Pillow is importable; an animated WebP -> "
                  "GIF -> WebP round trip through the CLI keeps its 3 "
                  "frames", flush=True)
        else:
            with open(p_gif, "wb") as f:
                f.write(b"GIF89a" + bytes(64))
            print("host surface: Pillow is not importable; dec of an "
                  "animated file to GIF returns 2", flush=True)
        code = ("import json, sys\n"
                "sys.modules['PIL'] = None\n"
                "from webp_tpu_torch import cli\n"
                "for argv in json.loads(sys.argv[1]):\n"
                "    print(cli.main(argv), flush=True)\n")
        nopil = [["enc"] + dev_arg + [p["in.png"], p["in.png"] + ".webp"],
                 ["enc"] + dev_arg + [p_gif, p_gif + ".webp"],
                 ["dec"] + dev_arg + [p_anim, p_anim + ".no.gif"]]
        r = subprocess.run([sys.executable, "-c", code, json.dumps(nopil)],
                           cwd=HERE, capture_output=True, text=True,
                           timeout=600)
        said = [line for line in r.stderr.splitlines() if "Pillow" in line]
        if (r.returncode, r.stdout.split(), len(said)) != (0, ["0", "2", "2"],
                                                           2):
            raise AssertionError(f"the CLI without Pillow: exit "
                                 f"{r.returncode}, {r.stdout!r}\n"
                                 f"{r.stderr[-3000:]}")
        if read(p["in.png"] + ".webp") != data or any(os.path.exists(x) for x
                in (p_gif + ".webp", p_anim + ".no.gif")):
            raise AssertionError("the CLI without Pillow: wrong files")
        print(f"host surface: a process without Pillow: enc of the PNG "
              f"writes encode(img)'s file, enc of a GIF and dec of an "
              f"animated file to GIF return 2 ({said[-1]!r})", flush=True)

    # (i) The rescaler.
    small_rgba, resc_s = once(lambda: rescaler.rescale_rgba(rgba, w // 2,
                                                            h // 2))
    box = rgba.reshape(h // 2, 2, w // 2, 2, 4).mean(axis=(1, 3))
    err = float(np.abs(small_rgba.astype(np.float64) - box).max())
    if err > 1.0:
        raise AssertionError(f"rescale_rgba: {err} from the box mean")
    print(f"host surface: rescale_rgba {w}x{h} RGBA -> {w // 2}x{h // 2} "
          f"{resc_s:.3f} s (host), at most {err} from the 2x2 box mean",
          flush=True)
    print(f"host surface: phase 14 took {time.perf_counter() - t_phase:.1f} "
          f"s", flush=True)
    return launches


def signalled_uv(data: bytes):
    """The (dq_uv_dc, dq_uv_ac) a WebP file's VP8 frame header signals,
    read by the port's header reader (lossy/decode.py)."""
    from webp_tpu_torch.container.parser import Parser
    from webp_tpu_torch.lossy.decode import VP8Decoder

    return VP8Decoder(Parser(data).frames()[0].bitstream).dq_uv


def uv_ac(seed, card, imgs, files_off=None, main_ms=None, dev=CARD,
          small=((64, 48), (72, 40))):
    """Phase 15: the chroma AC quantizer delta, uv_ac=True, at the main
    path's configuration (q75, 4 segments, SNS 50, I4, skew 1, rd_drop
    1024) on imgs (B x h x w):

    (a) encode_batch(..., uv_ac=True), counted (each kernel once), each
        file's signalled (dq_uv_dc, dq_uv_ac) printed (at least one AC
        delta must be non-zero);
    (b) kernels 1-4 against their plain versions on the inputs (a) gave
        them (recorded): integer outputs equal, scores within SCORE_RTOL;
        their card times beside main_ms, phase 4's times on the same
        images without uv_ac;
    (c) encode_lossy_stream(..., host_yuv=False, uv_ac=True) in one batch,
        counted, its files equal to (a)'s;
    (d) the first image through the exact band pipeline
        (encode_lossy_mesh, 4 bands on [dev] * 4, uv_ac=True), counted,
        its file equal to (a)'s;
    (e) card against CPU files with uv_ac=True at `small` (encode_batch
        on 2 images, encode() on one), their deltas printed;
    (f) bytes and PSNR (RGB, the host decoder) of (a)'s files beside
        files_off, encode_batch's files without uv_ac (made here when
        not given).
    Returns {"launches": {"encode_batch", "stream", "exact"}, "ms": {kernel:
    ms}} for the kernels line."""
    import webp_tpu_torch
    from webp_tpu_torch.container import riff
    from webp_tpu_torch.encoder import _psnr_of
    from webp_tpu_torch.lossy import device_encode as DE
    from webp_tpu_torch.ops import cuda as KC
    from webp_tpu_torch.ops import i4_kernel as I4K
    from webp_tpu_torch.ops import p1_kernels as P1K
    from webp_tpu_torch.ops import p2_kernel as P2K
    from webp_tpu_torch.parallel import exact as EX

    t_phase = time.perf_counter()
    n, h, w = imgs.shape[:3]
    none = {k: 0 for k in KC.LAUNCHES}
    launches, ms = {}, {}

    # (a) The batch, counted; the kernels' card inputs are recorded.
    with Recorder(P1K, "alphas") as r_a, \
            Recorder(P1K, "mode_search") as r_m, \
            Recorder(I4K, "i4_scores") as r_i4, \
            Recorder(P2K, "phase2_pack") as r_p2:
        KC.reset_launches()
        files, first_s = once(lambda: webp_tpu_torch.encode_batch(
            list(imgs), QUALITY, device=dev, uv_ac=True))
        launches["encode_batch"] = dict(KC.LAUNCHES)
    check_per_batch(launches["encode_batch"], 1,
                    f"uv_ac: encode_batch B={n} {w}x{h}")
    for f in files:
        check_webp(f, w, h)
    dq = [signalled_uv(f) for f in files]
    if not any(d[1] for d in dq):
        raise AssertionError(f"uv_ac: every file signals dq_uv_ac 0: {dq}")
    print(f"uv_ac: encode_batch B={n} {w}x{h} q{QUALITY} uv_ac=True first "
          f"call {first_s:.3f} s; signalled (dq_uv_dc, dq_uv_ac) per image: "
          f"{dq}", flush=True)

    # (b) Kernels 1-4 against their plain versions on those inputs.
    for kname, rec, kernel, plain in (
            ("p1_alpha", r_a, P1K.alphas, P1K.alphas_plain),
            ("p1_mode", r_m, P1K.mode_search, P1K.mode_search_plain),
            ("i4_search", r_i4, I4K.i4_scores, I4K.i4_scores_plain),
            ("p2_wavefront", r_p2, P2K.phase2_pack, P2K.phase2_pack_plain)):
        if len(rec.calls) != 1:
            raise AssertionError(f"{kname}: {len(rec.calls)} recorded "
                                 "calls, expected 1")
        err, (ms[kname],) = hold_calls(kname, kernel, plain, rec.calls)
        beside = ""
        if main_ms and kname in main_ms:
            beside = (f" (without uv_ac, phase 4: {main_ms[kname]:.4f} ms, "
                      f"{(ms[kname] / main_ms[kname] - 1) * 100:+.2f}%)")
        print(f"uv_ac: kernel {kname} on encode_batch(uv_ac=True)'s inputs: "
              f"agrees with its plain version (max abs err {err}); "
              f"{ms[kname]:.4f} ms on the card (runs queued){beside}; {card}",
              flush=True)
    # Kernel 2's per-image UV rows (qtab type 2, segment 0, the quant
    # step's AC position) differ between images whose AC deltas differ.
    uv_ac_q = r_m.calls[0][2].reshape(n, 3, 4, 4, 16)[:, 2, 0, 0, 1]
    print(f"uv_ac: kernel 2's UV AC quant step of segment 0 per image: "
          f"{uv_ac_q.tolist()}", flush=True)

    # (c) The stream with uv_ac=True equals the batch.
    KC.reset_launches()
    stream, stream_s = once(lambda: DE.encode_lossy_stream(
        list(imgs), QUALITY, batch=n, host_yuv=False, device=dev,
        uv_ac=True))
    launches["stream"] = dict(KC.LAUNCHES)
    check_per_batch(launches["stream"], 1, "uv_ac: encode_lossy_stream")
    if [riff.assemble_riff([riff.Chunk(riff.VP8, b)])
            for b in stream] != files:
        raise AssertionError("uv_ac: the stream's files differ from "
                             "encode_batch's")
    print(f"uv_ac: encode_lossy_stream(host_yuv=False, uv_ac=True) {n} "
          f"images in {stream_s:.3f} s; files equal to encode_batch's",
          flush=True)

    # (d) The exact band pipeline on 4 bands of one card, one image.
    sp = 4
    KC.reset_launches()
    frames, exact_s = once(lambda: EX.encode_lossy_mesh(
        [imgs[0]], devices=[dev] * sp, uv_ac=True))
    launches["exact"] = dict(KC.LAUNCHES)
    check_launches(launches["exact"], dict(
        none, p1_alpha=sp, p1_mode=2 * sp - 1, i4_search=2 * sp - 1),
        "uv_ac: exact band pipeline")
    if riff.assemble_riff([riff.Chunk(riff.VP8, frames[0])]) != files[0]:
        raise AssertionError("uv_ac: the exact band pipeline's file differs "
                             "from encode_batch's")
    print(f"uv_ac: exact band pipeline, 1 image on {sp} bands of one card, "
          f"uv_ac=True: {exact_s:.3f} s; launches {launches['exact']}; file "
          f"equal to encode_batch's", flush=True)

    # (e) Card against CPU at the small sizes.
    rng = np.random.default_rng(seed + 15)
    for sw, sh in small:
        x = list(synth_images(rng, 2, sh, sw))
        pair = [webp_tpu_torch.encode_batch(x, QUALITY, device=d, uv_ac=True)
                for d in (dev, "cpu")]
        one = [webp_tpu_torch.encode(x[0], device=d, uv_ac=True)
               for d in (dev, "cpu")]
        if pair[0] != pair[1] or one[0] != one[1] or one[0] != pair[0][0]:
            raise AssertionError(f"uv_ac {sw}x{sh}: card and CPU files "
                                 "differ")
        print(f"uv_ac: {sw}x{sh} card == CPU (encode_batch of 2, encode() "
              f"of 1), deltas {[signalled_uv(f) for f in pair[0]]}",
              flush=True)

    # (f) Bytes and PSNR with uv_ac on and off.
    if files_off is None:
        files_off = webp_tpu_torch.encode_batch(list(imgs), QUALITY,
                                                device=dev)
    size = {k: sum(map(len, v)) for k, v in (("on", files),
                                             ("off", files_off))}
    psnr = {k: [_psnr_of(im, f) for im, f in zip(imgs, v)]
            for k, v in (("on", files), ("off", files_off))}
    print(f"uv_ac: {n} images {w}x{h}: {size['on']} bytes with uv_ac, "
          f"{size['off']} without ({(size['on'] / size['off'] - 1) * 100:+.3f}"
          f"%); mean PSNR (RGB, host decoder) "
          f"{statistics.mean(psnr['on']):.4f} dB with, "
          f"{statistics.mean(psnr['off']):.4f} dB without "
          f"({statistics.mean(psnr['on']) - statistics.mean(psnr['off']):+.4f}"
          f" dB); per image bytes on/off "
          + ", ".join(f"{len(a)}/{len(b)}" for a, b in zip(files, files_off))
          + f"; {card}", flush=True)
    print(f"uv_ac: phase 15 took {time.perf_counter() - t_phase:.1f} s",
          flush=True)
    return {"launches": launches, "ms": ms}


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
    spent = _build.build(["webp_enc", "webp_dec", "vp8l_enc", "png"]
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
    dec = decoding(args.seed, card, imgs)
    k3 = next(k for k in kernels if k["name"] == "i4_search")
    k3["quality_launches"] = {m: v["i4_search"] for m, v in quality.items()}
    k3["quality_ms"], k3["quality_plain_ms"] = rec3["ms"], rec3["plain_ms"]

    # 11. Lossless and alpha.
    phase11 = lossless(args.seed, card)
    for k in kernels + [dec]:
        k["lossless_launches"] = {part: v[k["name"]]
                                  for part, v in phase11.items()}

    # 12. Animation.
    phase12 = animation(args.seed, card)
    for k in kernels + [dec]:
        k["animation_launches"] = {part: v[k["name"]]
                                   for part, v in phase12.items()}

    # 13. The band encoders.
    phase13 = bands(args.seed, card)
    for k in kernels + [dec]:
        k["band_launches"] = {part: v[k["name"]]
                              for part, v in phase13["launches"].items()}
        k.update(phase13["band"].get(k["name"], {}))
    k3.update(phase13["k3"])

    # 14. The host surface: the CLI on the card, PNG, the rescaler.
    phase14 = host_surface(args.seed, card)
    for k in kernels + [dec]:
        k["host_surface_launches"] = {part: v[k["name"]]
                                      for part, v in phase14.items()}

    # 15. The chroma AC quantizer delta on the main path's images.
    phase15 = uv_ac(args.seed, card, imgs, files_off=files,
                    main_ms={k["name"]: k["ms"] for k in kernels})
    for k in kernels:
        k["uv_ac_ms"] = phase15["ms"][k["name"]]
    for k in kernels + [dec]:
        k["uv_ac_launches"] = {part: v[k["name"]] for part, v in
                               phase15["launches"].items()}
    dec["stream_launches"] = stream_launches[DECODE_KERNEL]

    print(json.dumps({"kernels": kernels + [dec]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
