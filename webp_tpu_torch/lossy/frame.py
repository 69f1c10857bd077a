"""One VP8 frame's fields and the host's writer of its bytes.

Every producer of quantized levels ends here: the host encoder's native
MB loop (lossy/encode.py VP8Encoder), the device program's host tail
(lossy/device_encode.py DeviceVP8Encoder) and the band encoders' tail
(parallel/exact.py). Each fills a Frame and calls, in its own order:

    count_skips       the skip flag's probability
    code_tokens       the coefficient probabilities and the token
                      partitions (one native call, from the dense levels
                      or straight from the device's packed ones)
    partition0        the header, probability updates and modes (native)
    assemble          the frame tag, the partition sizes, the partitions

autofilter_search, run between count_skips and partition0 on a
reconstruction and the source luma, rewrites the loop filter's strengths,
which only partition 0 reads.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .. import trace
from ..native import api as native
from . import dsp
from . import tables as T
from .analysis import SegmentPlan, _filter_strength_from_delta


@dataclass
class Frame:
    """A keyframe's fields. The per-MB arrays are in raster order of the
    macroblocks (a leading [n_mb] or [mb_h, mb_w]): y2_levels [.., 16]
    and the levels, either dense, levels [.., 24, 16] (16 luma, 4 U and 4
    V blocks, zigzag order), or as the device packs them, packed =
    (packed u8 [n_mb, 24, 8], esc_idx i32 [K], esc_val i16 [K, 16],
    esc_cnt) (ops/fastpath.py _pack_levels) with levels None; imodes
    uint8 [.., 16] (an I16 MB's mode in column 0), uvmode uint8, is_i4
    and skip bool. The segment map is the plan's."""

    width: int
    height: int
    levels: np.ndarray
    y2_levels: np.ndarray
    imodes: np.ndarray
    uvmode: np.ndarray
    is_i4: np.ndarray
    skip: np.ndarray
    plan: SegmentPlan
    filter_simple: bool
    filter_sharpness: int
    filter_level: int
    num_parts: int
    proba: np.ndarray = None  # [4, 8, 3, 11], set by code_tokens
    skip_proba: int = 0       # set by count_skips; 0: no MB is skipped
    packed: tuple = None      # the device's packed levels, or None

    @property
    def mb_w(self) -> int:
        return (self.width + 15) >> 4

    @property
    def mb_h(self) -> int:
        return (self.height + 15) >> 4


def cfg_fields(cfg) -> dict:
    """The Frame fields a LossyConfig sets: the loop filter's type and
    sharpness, the number of token partitions."""
    return dict(filter_simple=cfg.filter_type == 0,
                filter_sharpness=max(0, min(7, cfg.filter_sharpness)),
                num_parts=1 << max(0, min(3, cfg.partitions)))


def count_skips(f: Frame) -> None:
    """The skip flag's probability: the share of MBs with levels, or 0
    when no MB is skipped (the flag is then not coded)."""
    n_skip = int(f.skip.sum())
    total = f.mb_w * f.mb_h
    f.skip_proba = (max(1, min(255, (total - n_skip) * 255 // total))
                    if n_skip else 0)


def code_tokens(f: Frame) -> list:
    """The coefficient probabilities (encode_proba.go optimizeProba: each
    entry of COEFFS_PROBA0 whose update, signalled at its cost, codes the
    frame's tokens in fewer bits), set as f.proba, and the token
    partitions they code (MB row r in partition r mod num_parts): one
    native call, which walks f.packed where the frame holds the device's
    packed levels, else the dense f.levels. Counted in trace.FRAMES."""
    trace.count(trace.FRAMES, "dense" if f.packed is None else "packed")
    f.proba, parts = native.code_frame(
        f.is_i4, f.skip, f.mb_w, f.mb_h, f.skip_proba > 0, f.num_parts,
        levels=f.levels, y2_levels=f.y2_levels, packed=f.packed)
    return parts


def partition0(f: Frame) -> bytes:
    """Partition 0 in one native call (native/api.py write_partition0):
    the frame header, the updates of f.proba against COEFFS_PROBA0 and the
    MB modes."""
    plan = f.plan
    return native.write_partition0(
        plan.num_segments, plan.quant, plan.fstrength, plan.probas,
        f.filter_simple, f.filter_level, f.filter_sharpness,
        f.num_parts.bit_length() - 1, plan.quant[0], plan.dq_uv_dc,
        plan.dq_uv_ac, f.proba, f.skip_proba > 0, f.skip_proba, f.imodes,
        f.is_i4, f.uvmode, f.skip, plan.segment_map, f.mb_w, f.mb_h)


def assemble(f: Frame, part0: bytes, parts: list) -> bytes:
    """The VP8 frame: the keyframe tag with partition 0's size, the start
    code and dimensions, partition 0, the sizes of every token partition
    but the last, the token partitions."""
    tag = (1 << 4) | (len(part0) << 5)
    out = bytearray((tag & 0xFFFFFF).to_bytes(3, "little"))
    out += bytes([0x9D, 0x01, 0x2A])
    out += (f.width & 0x3FFF).to_bytes(2, "little")
    out += (f.height & 0x3FFF).to_bytes(2, "little")
    out += part0
    for p in parts[:-1]:
        out += len(p).to_bytes(3, "little")
    for p in parts:
        out += p
    return bytes(out)


# ----------------------------------------------------------------------
# Autofilter: the in-loop filter strength search (libwebp -af analog).
# ----------------------------------------------------------------------


def _seg_filter_levels(f: Frame, fs: int) -> list:
    """Per-segment filter levels for config strength fs (the same formula
    plan_segments/finalize_device_plan use)."""
    level0 = 5 * max(0, min(100, fs))
    out = []
    for i in range(4):
        q = max(0, min(127, f.plan.quant[i]))
        qstep = int(T.AC_TABLE[q]) >> 2
        base = _filter_strength_from_delta(f.filter_sharpness, qstep)
        lv = base * level0 // (256 + f.plan.beta[i])
        out.append(0 if lv < 2 else min(lv, 63))
    return out


def _filter_score(f: Frame, levels4, coords, inner_map, seg_map, recY,
                  srcY) -> float:
    """Luma SSE vs source of the sampled MB cores after filtering a recon
    copy at the given per-segment levels."""
    sharp = f.filter_sharpness
    infos = []
    for lv in levels4:
        lv = max(0, min(63, lv))
        if lv == 0:
            infos.append(None)
            continue
        il = lv
        if sharp > 0:
            il >>= 2 if sharp > 4 else 1
            il = min(il, 9 - sharp)
        il = max(1, il)
        hev = 2 if lv >= 40 else (1 if lv >= 15 else 0)
        infos.append((2 * lv + il, il, hev))
    Y = recY.copy()
    for (mb_y, mb_x) in coords:
        fi = infos[int(seg_map[mb_y, mb_x]) & 3]
        if fi is None:
            continue
        limit, il, hev = fi
        inner = inner_map[mb_y, mb_x]
        x0, y0 = mb_x * 16, mb_y * 16
        if f.filter_simple:
            if mb_x > 0:
                dsp.filter_edge_simple(Y, False, x0, y0, 16, limit + 4)
            if inner:
                for k in (4, 8, 12):
                    dsp.filter_edge_simple(Y, False, x0 + k, y0, 16, limit)
            if mb_y > 0:
                dsp.filter_edge_simple(Y, True, y0, x0, 16, limit + 4)
            if inner:
                for k in (4, 8, 12):
                    dsp.filter_edge_simple(Y, True, y0 + k, x0, 16, limit)
        else:
            if mb_x > 0:
                dsp.filter_edge_complex(Y, False, x0, y0, 16, limit + 4,
                                        il, hev, False)
            if inner:
                for k in (4, 8, 12):
                    dsp.filter_edge_complex(Y, False, x0 + k, y0, 16,
                                            limit, il, hev, True)
            if mb_y > 0:
                dsp.filter_edge_complex(Y, True, y0, x0, 16, limit + 4,
                                        il, hev, False)
            if inner:
                for k in (4, 8, 12):
                    dsp.filter_edge_complex(Y, True, y0 + k, x0, 16,
                                            limit, il, hev, True)
    sse = 0.0
    for (mb_y, mb_x) in coords:
        y0, x0 = mb_y * 16, mb_x * 16
        d = (Y[y0:y0 + 16, x0:x0 + 16].astype(np.int64)
             - srcY[y0:y0 + 16, x0:x0 + 16].astype(np.int64))
        sse += float((d * d).sum())
    return sse


def autofilter_search(f: Frame, recY: np.ndarray, srcY: np.ndarray) -> None:
    """Searches the filter_strength knob for the setting whose in-loop
    filtered reconstruction recY is closest to the source srcY (sampled
    MBs, luma; both MB-padded), then rewrites the per-segment strengths
    and the header's level. Stands in for libwebp's autofilter
    (VP8StoreFilterStats + VP8AdjustFilterStrength); the reference Go
    encoder has no analog, so the criterion here is the sampled-core
    SSE."""
    mb_w, mb_h = f.mb_w, f.mb_h
    # Sample at most ~256 MBs on a uniform grid (the reference-style
    # every-other-MB sampling, thinned further for big images).
    step = 1
    while (mb_h // step + 1) * (mb_w // step + 1) > 256:
        step += 1
    coords = [(y, x) for y in range(0, mb_h, step)
              for x in range(0, mb_w, step)]
    inner_map = (f.is_i4 | ~f.skip).reshape(mb_h, mb_w)
    seg_map = f.plan.segment_map.reshape(mb_h, mb_w)
    cache = {}

    def score_fs(fs):
        lv = tuple(_seg_filter_levels(f, fs))
        if lv not in cache:
            cache[lv] = _filter_score(f, lv, coords, inner_map, seg_map,
                                      recY, srcY)
        return cache[lv]

    coarse = [0, 10, 25, 40, 60, 80, 100]
    best_fs = min(coarse, key=score_fs)
    for fs in range(max(0, best_fs - 8), min(100, best_fs + 8) + 1, 4):
        if score_fs(fs) < score_fs(best_fs):
            best_fs = fs
    f.plan.fstrength[:] = _seg_filter_levels(f, best_fs)
    f.filter_level = f.plan.fstrength[0]
