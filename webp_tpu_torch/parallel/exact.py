"""Exact multi-device closed loop: band-pipelined phase 2 over a stream
of images (PyTorch port of webp_tpu/parallel/exact.py).

mesh.py approximates the band boundary: each band's first MB row predicts
from the *source* row above. This module removes the approximation by
pipelining the bands over a batch of images, the multi-device analog of
the reference's Phase A/Phase B overlap (encode_parallel.go:238-246):

  Phase A (parallel): YUV import, segmentation (alphas from kernel 1,
    histograms summed over the bands of each image), the I16/UV mode
    search (kernel 2, ops/phase1p.py phase1_planar) and the I4 search
    (kernel 3, through fastpath._i4_dispatch) for every image, each
    band's first MB row searched again on a 2-MB-row extension that
    holds the source rows of the band above, so every mode decision sees
    exactly the context the single-device encoder sees.

  Phase B (pipelined): T = B + sp - 1 steps. At step t, band s runs the
    closed-loop wavefront of image t - s, using the RECONSTRUCTED bottom
    rows that band s - 1 produced for that image at step t - 1 (passed
    down at the end of each step). Band programs on different cards run
    at once; on one card they take turns.

The result is bit-identical to the single-device encoder's
(fast_encode_fn's) output; tests/test_torch_parallel.py holds it equal.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import fastpath as fp
from .mesh import Mesh, _assemble_device, pass_down, psum, visible_cards


def make_pipeline_mesh(n_devices: int = None, devices=None) -> Mesh:
    """A one-row mesh (dp = 1) of n_devices bands over `devices`
    (default: the visible cards; the list may repeat a device)."""
    devs = list(devices) if devices is not None else visible_cards()
    return Mesh(devs[:n_devices or len(devs)], dp=1)


def make_exact_encode_fn(mesh: Mesh, n_images: int, quality: int = 75,
                         segments: int = 4, sns_strength: int = 50,
                         i4_blocks: bool = True, rd_drop: float = 1024.0,
                         uv_ac: bool = False):
    """Returns run(rgb): the exact multi-device encode of rgb [B, H, W, 3]
    uint8 (numpy or a tensor), B = n_images, H a multiple of 16 * sp.
    The outputs follow make_sharded_encode_fn's tuple (assemble them with
    assemble_from_sharded), on the mesh's first device. uv_ac: the chroma
    AC quantizer delta from each image's mean UV alpha, summed over the
    bands (fastpath._uv_deltas), as fast_encode_fn(..., uv_ac=True)."""
    sp = mesh.shape["sp"]
    devs = mesh.devices[0]
    B = n_images

    def run(rgb):
        from ..ops import phase1p as P1
        from ..ops import yuv as devyuv

        rgb = torch.as_tensor(rgb)
        if rgb.shape[0] != B:
            raise ValueError(f"{rgb.shape[0]} images, expected {B}")
        H, W = rgb.shape[1:3]
        if H % (16 * sp) or W % 16:
            raise ValueError(f"{W}x{H} does not split into {sp} bands of "
                             "whole macroblocks")
        Hb = H // sp
        mb_w, mb_h = W // 16, Hb // 16
        n_mb = mb_w * mb_h
        esc_cap = max(1024, fp.ESC_BLOCKS_PER_MB * n_mb)
        sns = max(0, int(sns_strength))

        yuv = [devyuv.rgb_to_yuv420(rgb[:, s * Hb:(s + 1) * Hb].to(devs[s]))
               for s in range(sp)]
        # The source halo band: the last MB row of the band above, one
        # hop down.
        ext = [pass_down([b[i][:, -r:] for b in yuv], devs)
               for i, r in enumerate((16, 8, 8))]

        # --- Phase 0: segmentation (global per image). ---
        if segments > 1 and n_mb * sp >= 4:
            loc = [fp.band_stats(*b, mb_w, mb_h) for b in yuv]
            histo = psum([st[1] for st in loc], devs)
            uv_sum = psum([st[2] for st in loc], devs)
            plans = [fp._plan_tables(
                *fp._plan_from_histo(histo[s], loc[s][0], quality,
                                     sns_strength, segments),
                (uv_sum[s] // (n_mb * sp)).to(torch.int32), sns,
                fp.device_tables(str(devs[s])), uv_ac) for s in range(sp)]
        else:
            plans = [fp._single_plan(quality, sns, B, n_mb, d) for d in devs]

        def search(planes, plan, rows):
            """Phase 1 (kernel 2) and the I4 search (kernel 3) of `rows`
            MB rows, predicted from their own pixels only."""
            seg_map, _, _, qtabs, lams, tlsd4, _ = plan
            src_rows, srcs = P1.build_src(*planes, mb_w, rows)
            modes, uvmodes, i16s = P1.phase1_planar(
                src_rows, srcs, qtabs, lams["i16"], lams["uv"], tlsd4,
                seg_map, mb_w, rows, lam_mode4=lams["mode"])
            if not i4_blocks:
                return (modes, uvmodes,
                        torch.zeros_like(modes, dtype=torch.bool),
                        modes.new_zeros(modes.shape + (16,)))
            is_i4, i4m, _ = fp._i4_dispatch(planes[0], plan, i16s, mb_w,
                                            rows)
            return modes, uvmodes, is_i4, i4m

        # --- Phase 1 and the I4 search, the first MB row on the
        # extension. ---
        p1 = []
        for s in range(sp):
            out = search(yuv[s], plans[s], mb_h)
            if s > 0:
                e = [torch.cat([ext[i][s], yuv[s][i][:, :r]], dim=1)
                     for i, r in enumerate((16, 8, 8))]
                sm = plans[s][0][:, :mb_w]
                first = search(e, (torch.cat([sm, sm], dim=1),)
                               + tuple(plans[s][1:]), 2)
                out = tuple(torch.cat([a[:, mb_w:], b[:, mb_w:]], dim=1)
                            for a, b in zip(first, out))
            p1.append(out)

        # --- Phase B: the pipelined closed loop. ---
        T = B + sp - 1
        lv = [[None] * B for _ in range(sp)]
        y2 = [[None] * B for _ in range(sp)]
        carry = [tuple(torch.zeros((1, mb_w * r), dtype=torch.int32,
                                   device=d) for r in (16, 8, 8))
                 for d in devs]
        for t in range(T):
            bottoms = [None] * sp
            for s in range(sp):
                i = t - s
                if not 0 <= i < B:
                    continue
                Y, U, V = (p[i:i + 1] for p in yuv[s])
                modes, uvmodes, is_i4, i4m = (a[i:i + 1] for a in p1[s])
                plan = plans[s]
                out = fp._phase2(
                    Y, U, V, modes, uvmodes, mb_w, mb_h,
                    (plan[0][i:i + 1], fp._seg_rows(plan[3][i:i + 1])),
                    rd_drop=rd_drop, halos=carry[s], has_above=s > 0,
                    i4=(is_i4, i4m))
                lv[s][i], y2[s][i] = out[0][0], out[1][0]
                # The last MB row's reconstructed bottom rows.
                bottoms[s] = tuple(b[:, n_mb - mb_w:].reshape(1, -1)
                                   for b in (out[2], out[4], out[5]))
            carry = [carry[0]] + [
                tuple(b.to(d) for b in bot) if bot is not None else c
                for bot, c, d in zip(bottoms[:-1], carry[1:], devs[1:])]

        rows = []
        for s in range(sp):
            lv24 = torch.stack(lv[s])
            y2_s = torch.stack(y2[s])
            modes, uvmodes, is_i4, i4m = p1[s]
            seg_map, seg_q, seg_beta, _, _, _, dq_uv = plans[s]
            imodes = torch.where(
                is_i4[..., None], i4m,
                torch.cat([modes[..., None],
                           modes.new_zeros((B, n_mb, 15))], dim=-1))
            rows.append(dict(
                fp.wire_from_levels(lv24, y2_s, esc_cap), modes=modes,
                uvmodes=uvmodes, is_i4=is_i4, imodes=imodes,
                seg_map=seg_map.to(torch.uint8), seg_q=seg_q,
                seg_beta=seg_beta, dq_uv=dq_uv,
                hist=fp.level_histogram(lv24)))
        return _assemble_device([rows], devs[0])

    return run


def encode_lossy_mesh(images, quality: int = 75, segments: int = 4,
                      sns_strength: int = 50, n_devices: int = None,
                      true_width: int = None, true_height: int = None,
                      devices=None, uv_ac: bool = False):
    """Multi-device lossy encode: the band-pipelined exact closed loop over
    n_devices bands of `devices` (default: the visible cards), then the
    host's entropy coding. The bitstreams are bit-identical to the
    single-device device path's (encode_batch's).

    images: same-shaped RGB uint8 [H, W, 3] arrays with H a multiple of
    16 * sp and W of 16 (true_width/true_height: the frame's size inside
    that padding). An image whose escape list overflowed in a band is
    re-encoded by the exact host encoder, as the single-device path does
    (the reference raises OverflowError there). uv_ac: the chroma AC
    quantizer delta (make_exact_encode_fn); the files then equal
    encode_batch(..., uv_ac=True)'s. Returns the VP8 frames (list of
    bytes)."""
    from .. import trace
    from ..encoder import rgb_to_yuv420
    from ..lossy.device_encode import FALLBACKS
    from ..lossy.encode import LossyConfig, VP8Encoder
    from .mesh import assemble_from_sharded

    rgbs = np.stack([np.asarray(im)[..., :3] for im in images])
    B, H, W = rgbs.shape[:3]
    mesh = make_pipeline_mesh(n_devices, devices)
    sp = mesh.shape["sp"]
    if H % (16 * sp):
        raise ValueError(f"height {H} must divide by 16*sp={16 * sp}")
    step = make_exact_encode_fn(mesh, B, quality=quality, segments=segments,
                                sns_strength=sns_strength, uv_ac=uv_ac)
    outputs = step(rgbs)
    cap = outputs[1].shape[1] // sp
    over = (outputs[3] > cap).any(dim=1).cpu().numpy()
    trace.count(FALLBACKS, "images", int(over.sum()))
    keep = torch.as_tensor(np.flatnonzero(~over), device=outputs[0].device)
    per_image = assemble_from_sharded(
        [o[keep] for o in outputs[:-1]] + [outputs[-1]], sp=sp,
        mb_w=W // 16, mb_h=H // 16)
    tw, th = true_width or W, true_height or H
    blobs = iter(host_tail(per_image, tw, th, quality, segments,
                           sns_strength))
    cfg = LossyConfig(quality=quality, segments=segments,
                      sns_strength=sns_strength)
    return [VP8Encoder(*rgb_to_yuv420(rgbs[i]), tw, th, cfg).encode()
            if over[i] else next(blobs) for i in range(B)]


def host_tail(per_image, width: int, height: int, quality: int = 75,
              segments: int = 4, sns_strength: int = 50):
    """The host's entropy coding and frame assembly of the band encoders'
    per-image fields (assemble_from_sharded's dicts, levels unpacked)
    for width x height frames: each a frame for the device tail's writer
    (DeviceVP8Encoder.write). Returns the VP8 frames."""
    from ..lossy.device_encode import DeviceVP8Encoder
    from ..lossy.encode import LossyConfig

    tail = DeviceVP8Encoder(width, height, LossyConfig(
        quality=quality, segments=segments, sns_strength=sns_strength))
    blobs = []
    for d in per_image:
        f = tail.frame(d)
        tail.install_plan(f, d)
        blobs.append(tail.write(f))
    return blobs
