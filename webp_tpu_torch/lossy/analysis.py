"""Encoder analysis pass: per-MB complexity (alpha) -> k-means segments ->
per-segment quantizer modulation.

Parity with the reference internal/lossy/encode_analysis.go (libwebp
VP8EncAnalyze + VP8SetSegmentParams): DCT-histogram alpha per macroblock
(native), histogram k-means (6 iterations),
segment alpha/beta normalization, SNS power-law quantizer modulation, UV
delta derivation, and segment merging.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import List

import numpy as np

from ..native import api as native
from . import tables as T

MAX_ALPHA = 255
MAX_ITERS_KMEANS = 6


def compute_alphas(Y: np.ndarray, U: np.ndarray, V: np.ndarray,
                   mb_w: int, mb_h: int):
    """Returns (mixed alphas [nmb], global_uv_alpha), from the native
    analysis (native/src/vp8_enc_loop.cc): DC-prediction DCT histograms
    (the reference tests DC/TM; DC-of-source is the batched equivalent
    with negligible segmentation difference)."""
    return native.vp8_compute_alphas(Y, U, V, mb_w, mb_h)


@dataclass
class SegmentPlan:
    num_segments: int = 1
    segment_map: np.ndarray = None          # [nmb] uint8
    quant: List[int] = field(default_factory=lambda: [0] * 4)
    fstrength: List[int] = field(default_factory=lambda: [0] * 4)
    alpha: List[int] = field(default_factory=lambda: [0] * 4)
    beta: List[int] = field(default_factory=lambda: [0] * 4)
    dq_uv_ac: int = 0
    dq_uv_dc: int = 0
    probas: List[int] = field(default_factory=lambda: [255, 255, 255])


def assign_segments(alphas: np.ndarray, num_segs: int):
    """Histogram k-means (assignSegments, encode_analysis.go:737)."""
    histo = np.bincount(alphas, minlength=MAX_ALPHA + 1)
    nz = np.nonzero(histo)[0]
    min_a, max_a = int(nz[0]), int(nz[-1])
    range_a = max_a - min_a
    centers = [min_a + ((2 * k + 1) * range_a) // (2 * num_segs)
               for k in range(num_segs)]
    alpha_map = np.zeros(MAX_ALPHA + 1, dtype=np.int32)
    weighted_avg = 0
    for _ in range(MAX_ITERS_KMEANS):
        accum = [0] * num_segs
        dist_accum = [0] * num_segs
        n = 0
        for a in range(min_a, max_a + 1):
            if histo[a] == 0:
                continue
            while n + 1 < num_segs and abs(a - centers[n + 1]) < abs(a - centers[n]):
                n += 1
            alpha_map[a] = n
            dist_accum[n] += a * int(histo[a])
            accum[n] += int(histo[a])
        displaced = 0
        weighted_avg = 0
        total_weight = 0
        for s in range(num_segs):
            if accum[s] > 0:
                new_c = (dist_accum[s] + accum[s] // 2) // accum[s]
                displaced += abs(centers[s] - new_c)
                centers[s] = new_c
                weighted_avg += new_c * accum[s]
                total_weight += accum[s]
        if total_weight > 0:
            weighted_avg = (weighted_avg + total_weight // 2) // total_weight
        if displaced < 5:
            break
    seg_map = alpha_map[alphas].astype(np.uint8)
    # Segment alpha/beta normalization (SetSegmentAlphas).
    min_c, max_c = min(centers), max(centers)
    range_c = max(max_c - min_c, 1)
    alpha_n = [max(-127, min(127, 255 * (c - weighted_avg) // range_c))
               for c in centers]
    beta_n = [max(0, min(255, 255 * (c - min_c) // range_c)) for c in centers]
    return seg_map, centers, alpha_n, beta_n


def _quality_to_compression(quality: float) -> float:
    if quality <= 0:
        return 0.0
    if quality >= 100:
        return 1.0
    c = quality / 100.0
    linear_c = c * (2.0 / 3.0) if c < 0.75 else 2.0 * c - 1.0
    return linear_c ** (1.0 / 3.0)


def _filter_strength_from_delta(sharpness: int, delta: int) -> int:
    """Smallest filter level for which the filter modifies a step of
    `delta` (libwebp filter_enc.c kLevelsFromDelta, generated from
    VP8FilterStrengthFromDelta's closed form)."""
    pos = max(0, min(63, delta))
    if sharpness == 0:
        return pos
    # For sharpness > 0 the table is generated from the ilevel clamping rule.
    for level in range(64):
        ilevel = level
        ilevel >>= 2 if sharpness > 4 else 1
        ilevel = min(ilevel, 9 - sharpness)
        ilevel = max(1, ilevel)
        if 2 * level + ilevel >= 3 * pos:  # filter limit covers the delta
            return level
    return 63


def trivial_plan(mb_w, mb_h, quality: int, filter_strength: int,
                 filter_sharpness: int) -> SegmentPlan:
    """The plan without segmentation or SNS modulation, which reads no
    pixels: one quantizer from the quality and its filter strength."""
    plan = SegmentPlan()
    plan.segment_map = np.zeros(mb_w * mb_h, dtype=np.uint8)
    plan.quant[:] = [max(0, min(127, int(127.0 * (1.0 - _quality_to_compression(quality)))))] * 4
    if filter_strength > 0:
        qstep = int(T.AC_TABLE[plan.quant[0]]) >> 2
        base = _filter_strength_from_delta(max(0, min(7, filter_sharpness)), qstep)
        f = base * (5 * filter_strength) // 256
        plan.fstrength[:] = [0 if f < 2 else min(f, 63)] * 4
    return plan


def plan_segments(Y, U, V, mb_w, mb_h, quality: int, num_segs: int,
                  sns_strength: int, filter_strength: int,
                  filter_sharpness: int, preprocessing: int = 0) -> SegmentPlan:
    """Full analysis flow -> SegmentPlan (quantizers in absolute-delta form)."""
    num_segs = max(1, min(4, num_segs))
    if num_segs == 1 and sns_strength <= 0:
        # No segmentation, no SNS modulation: skip the analysis pass.
        return trivial_plan(mb_w, mb_h, quality, filter_strength,
                            filter_sharpness)
    plan = SegmentPlan()
    alphas, global_uv = compute_alphas(Y, U, V, mb_w, mb_h)

    if num_segs == 1:
        plan.num_segments = 1
        plan.segment_map = np.zeros(mb_w * mb_h, dtype=np.uint8)
        alpha_n = [0, 0, 0, 0]
        beta_n = [0, 0, 0, 0]
    else:
        seg_map, centers, alpha_n, beta_n = assign_segments(alphas, num_segs)
        alpha_n += [0] * (4 - len(alpha_n))
        beta_n += [0] * (4 - len(beta_n))
        plan.segment_map = seg_map
        plan.num_segments = num_segs
        if preprocessing & 1:
            plan.segment_map = _smooth_segment_map(
                seg_map.reshape(mb_h, mb_w)).reshape(-1)

    # SNS power-law quantizer modulation (setSegmentParams).
    sns = max(0, sns_strength)
    amp = 0.9 * sns / 100.0 / 128.0
    c_base = _quality_to_compression(quality)
    for i in range(plan.num_segments):
        expn = 1.0 - amp * alpha_n[i]
        c = c_base ** expn
        plan.quant[i] = max(0, min(127, int(127.0 * (1.0 - c))))
        plan.alpha[i] = alpha_n[i]
        plan.beta[i] = beta_n[i]
    for i in range(plan.num_segments, 4):
        plan.quant[i] = plan.quant[0]

    # UV deltas.
    dq_uv_ac = (global_uv - 64) * (6 - (-4)) // (100 - 30)
    dq_uv_ac = dq_uv_ac * sns // 100
    plan.dq_uv_ac = max(-4, min(6, dq_uv_ac))
    plan.dq_uv_dc = max(-15, min(15, -4 * sns // 100))

    # Per-segment filter strength (setupFilterStrength).
    if filter_strength > 0:
        level0 = 5 * filter_strength
        sharp = max(0, min(7, filter_sharpness))
        for i in range(4):
            qstep = int(T.AC_TABLE[max(0, min(127, plan.quant[i]))]) >> 2
            base = _filter_strength_from_delta(sharp, qstep)
            f = base * level0 // (256 + plan.beta[i])
            plan.fstrength[i] = 0 if f < 2 else min(f, 63)

    # Merge equivalent segments (simplifySegments).
    if plan.num_segments > 1:
        seg_remap = list(range(4))
        num_final = 1
        for s1 in range(1, plan.num_segments):
            found = False
            for s2 in range(num_final):
                if (plan.quant[s1] == plan.quant[s2]
                        and plan.fstrength[s1] == plan.fstrength[s2]):
                    seg_remap[s1] = s2
                    found = True
                    break
            if not found:
                seg_remap[s1] = num_final
                if num_final != s1:
                    plan.quant[num_final] = plan.quant[s1]
                    plan.fstrength[num_final] = plan.fstrength[s1]
                    plan.alpha[num_final] = plan.alpha[s1]
                    plan.beta[num_final] = plan.beta[s1]
                num_final += 1
        if num_final < plan.num_segments:
            remap = np.array(seg_remap, dtype=np.uint8)
            plan.segment_map = remap[plan.segment_map]
            for i in range(num_final, plan.num_segments):
                plan.quant[i] = plan.quant[num_final - 1]
                plan.fstrength[i] = plan.fstrength[num_final - 1]
        plan.num_segments = num_final

    # Segment tree probabilities (setSegmentProbas).
    counts = np.bincount(plan.segment_map, minlength=4)

    def get_proba(a, b):
        total = a + b
        return 255 if total == 0 else (255 * a + total // 2) // total

    plan.probas = [
        int(get_proba(counts[0] + counts[1], counts[2] + counts[3])),
        int(get_proba(counts[0], counts[1])),
        int(get_proba(counts[2], counts[3])),
    ]
    return plan


def _smooth_segment_map(seg: np.ndarray) -> np.ndarray:
    h, w = seg.shape
    if w < 3 or h < 3:
        return seg
    out = seg.copy()
    for y in range(1, h - 1):
        for x in range(1, w - 1):
            cnt = np.bincount(seg[y - 1 : y + 2, x - 1 : x + 2].reshape(-1),
                              minlength=4)
            m = int(np.argmax(cnt))
            if cnt[m] >= 5:
                out[y, x] = m
    return out


def finalize_device_plan(seg_map: np.ndarray, seg_q, seg_beta,
                         filter_strength: int,
                         filter_sharpness: int) -> SegmentPlan:
    """Builds a SegmentPlan from device-computed segmentation (fastpath
    phase 0): per-segment filter strengths, equivalent-segment merging and
    segment-tree probabilities (the host-side tail of plan_segments)."""
    plan = SegmentPlan()
    plan.num_segments = 4
    plan.segment_map = np.asarray(seg_map, dtype=np.uint8).reshape(-1)
    plan.quant = [int(q) for q in seg_q]
    plan.beta = [int(b) for b in seg_beta]

    if filter_strength > 0:
        level0 = 5 * filter_strength
        sharp = max(0, min(7, filter_sharpness))
        for i in range(4):
            qstep = int(T.AC_TABLE[max(0, min(127, plan.quant[i]))]) >> 2
            base = _filter_strength_from_delta(sharp, qstep)
            f = base * level0 // (256 + plan.beta[i])
            plan.fstrength[i] = 0 if f < 2 else min(f, 63)

    # Merge equivalent segments (simplifySegments).
    seg_remap = list(range(4))
    num_final = 1
    for s1 in range(1, plan.num_segments):
        found = False
        for s2 in range(num_final):
            if (plan.quant[s1] == plan.quant[s2]
                    and plan.fstrength[s1] == plan.fstrength[s2]):
                seg_remap[s1] = s2
                found = True
                break
        if not found:
            seg_remap[s1] = num_final
            if num_final != s1:
                plan.quant[num_final] = plan.quant[s1]
                plan.fstrength[num_final] = plan.fstrength[s1]
                plan.beta[num_final] = plan.beta[s1]
            num_final += 1
    if num_final < plan.num_segments:
        remap = np.array(seg_remap, dtype=np.uint8)
        plan.segment_map = remap[plan.segment_map]
        for i in range(num_final, plan.num_segments):
            plan.quant[i] = plan.quant[num_final - 1]
            plan.fstrength[i] = plan.fstrength[num_final - 1]
    plan.num_segments = num_final

    counts = np.bincount(plan.segment_map, minlength=4)

    def get_proba(a, b):
        total = a + b
        return 255 if total == 0 else (255 * a + total // 2) // total

    plan.probas = [
        int(get_proba(counts[0] + counts[1], counts[2] + counts[3])),
        int(get_proba(counts[0], counts[1])),
        int(get_proba(counts[2], counts[3])),
    ]
    return plan
