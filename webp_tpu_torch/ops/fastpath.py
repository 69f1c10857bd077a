"""Batched two-phase device VP8 encoder (PyTorch port of
webp_tpu/ops/fastpath.py, the batched planar main path).

  Phase 0 — segment analysis: per-MB texture alphas (kernel 1,
    ops/p1_kernels.py), a per-image k-means over the alpha histogram and
    the SNS quant curve.
  Phase 1 — fully parallel mode search with source-pixel context: I16 and
    UV (kernel 2, ops/p1_kernels.py), then the 10-mode I4 search
    (kernel 3, ops/i4_kernel.py) and the I4-vs-I16 split.
  Phase 2 — the closed-loop wavefront. At skew 1 without trellis or
    in-loop search (the main path, methods 0-4) the modes are fixed and
    the wavefront is fused with nibble packing (kernel 4,
    ops/p2_kernel.py), then the escape list. At the quality settings —
    skew 2 with the trellis (method 5), plus the in-loop I4/UV search and
    the closed-loop split (method 6) — it is the planar step loop
    (ops/planar.py phase2_planar), then the unskewed pack, as the
    reference routes them (its Pallas wavefront covers only the main
    path).

Configurations ported: segmented (segments > 1 and >= 4 macroblocks) or
unsegmented (one quantizer, static lambdas, no phase 0), I4 on or off,
SNS, rd_drop, skew 1 or 2, the trellis, the in-loop search, the
sharp-YUV import (ops/sharpyuv.py) in place of the plain one, and
uv_ac, the chroma AC quantizer delta that follows each image's mean UV
alpha (the reference's chroma AC switch; segmented plans only). The
quantizer, lambda and rate tables are derived here from the port's own
lossy/ copies and moved to the device by tables_from_numpy().

The non-planar formulation (fast_encode_fn(..., planar=False), the
reference's program without its planar path, and encode_band, the
row-band unit of the band encoders in parallel/) runs phase 1 as PyTorch
operations on macroblock-major tensors (_phase1: the reference's jnp code
on every backend, since a band's first MB row may predict from a source
halo, which kernel 2 does not take), the I4 search through kernel 3
(_i4_dispatch) and phase 2 as the planar step loop with optional source
or reconstruction halos (_phase2). Its tensors carry a leading batch
axis where the reference vmaps. fast_encode_fn(..., planar=False) keeps
phase 0 in PyTorch too (_mb_alphas2), as the reference's program does;
the band encoders take their alphas from kernel 1 (band_stats). It is
the reference's formulation, kept to hold the two equal; the planar
program is the fast one.
"""

from __future__ import annotations

import functools
from types import SimpleNamespace

import numpy as np
import torch

from .. import trace
from ..lossy import tables as T
from ..lossy.cost import (
    ENTROPY_COST,
    LEVEL_FIXED_COSTS,
    FIXED_COSTS_I4,
    compute_level_cost_tables,
)
from ..lossy.encode import FIXED_COSTS_I16, FIXED_COSTS_UV, quality_to_qindex
from . import dct
from .quant import quantize

BANDS = np.asarray(T.BANDS[:16])
ZIGZAG = np.asarray(T.ZIGZAG)

# Escape capacity per image, in BLOCKS: a block holding any |level| > 7
# travels as raw int16[16] on the side (the nibble plane cannot carry it);
# overflow falls back to the exact host path.
ESC_BLOCKS_PER_MB = 2


@functools.lru_cache(maxsize=4)
def all_q_tables():
    """Quantizer matrices + RD lambdas for every quant index 0..127.

    Mirrors VP8Encoder.__init__'s per-segment setup (reference
    setupSegment, lossy/encode.go:1084) with zero UV deltas.
    Returns (tabs {y1/y2/uv: [128, 4(q/iq/bias/sharpen), 16] i32},
    lam_i16, lam_uv, lam_i4 [128] f32, qi4 [128] i32).
    """
    from ..lossy.quant import SegmentQuant

    dc_t, ac_t, ac2_t = T.DC_TABLE, T.AC_TABLE, T.AC_TABLE2
    clip = lambda v, m: max(0, min(m, v))
    out = {k: [] for k in ("y1", "y2", "uv")}
    lam_i16 = np.zeros(128, np.int64)
    lam_uv = np.zeros(128, np.int64)
    lam_i4 = np.zeros(128, np.int64)
    qi4 = np.zeros(128, np.int32)
    for q in range(128):
        y1dc, y1ac = int(dc_t[q]), int(ac_t[q])
        y2dc = max(8, y1dc * 2)
        sqs = {
            "y1": SegmentQuant.make(y1dc, y1ac, 0, sharpen=True),
            "y2": SegmentQuant.make(y2dc, int(ac2_t[q]), 1),
            "uv": SegmentQuant.make(int(dc_t[clip(q, 117)]), y1ac, 2),
        }
        for k, sq in sqs.items():
            out[k].append(np.stack([sq.q, sq.iq, sq.bias, sq.sharpen]))
        q_i16 = (y2dc + 15 * int(ac2_t[q]) + 8) >> 4
        q_uv = (int(dc_t[clip(q, 117)]) + 15 * y1ac + 8) >> 4
        lam_i16[q] = max(3 * q_i16 * q_i16, 1)
        lam_uv[q] = max((3 * q_uv * q_uv) >> 6, 1)
        q_i4 = (y1dc + 15 * y1ac + 8) >> 4
        lam_i4[q] = max((3 * q_i4 * q_i4) >> 7, 1)
        qi4[q] = q_i4
    tabs = {k: np.stack(v).astype(np.int32) for k, v in out.items()}
    return (tabs, lam_i16.astype(np.float32), lam_uv.astype(np.float32),
            lam_i4.astype(np.float32), qi4)


def _lam_mode_table(qi4):
    """LambdaMode per quant index: max((q_i4^2)>>7, 1) — the I4-vs-I16
    split lambda (reference setupSegment, encode.go:1122)."""
    return np.maximum((qi4.astype(np.int64) ** 2) >> 7, 1) \
        .astype(np.float32)


def rd_params(quality: int):
    """Quantizers + RD lambdas, identical to VP8Encoder.__init__."""
    from .pipeline import quant_params

    qp = quant_params(quality)
    q = quality_to_qindex(quality)
    dc_t, ac_t, ac2_t = T.DC_TABLE, T.AC_TABLE, T.AC_TABLE2
    clip = lambda v, m: max(0, min(m, v))
    y1dc, y1ac = int(dc_t[q]), int(ac_t[q])
    y2dc = max(8, y1dc * 2)
    q_i4 = (y1dc + 15 * y1ac + 8) >> 4
    q_i16 = (y2dc + 15 * int(ac2_t[q]) + 8) >> 4
    q_uv = (int(dc_t[clip(q, 117)]) + 15 * int(ac_t[q]) + 8) >> 4
    lambdas = {
        "i16": max(3 * q_i16 * q_i16, 1),
        "uv": max((3 * q_uv * q_uv) >> 6, 1),
        "mode": max((1 * q_i4 * q_i4) >> 7, 1),
        "i4": max((3 * q_i4 * q_i4) >> 7, 1),
        "q_i4": q_i4,
    }
    return qp, lambdas


class RateTables:
    """Scalar per-level cost tables for the phase-1 searches (numpy).

    Derived from the exact per-(type, band, ctx) tables: per-position
    (band-exact) costs at ctx=1 for |level| <= 7, a piecewise-constant tail
    above, and the exact per-band EOB bit. Emission rates on the host stay
    exact.
    """

    def __init__(self, proba: np.ndarray):
        lc = compute_level_cost_tables(proba)          # [4, 8, 3, 68]
        fl = np.asarray(LEVEL_FIXED_COSTS)
        ec = np.asarray(ENTROPY_COST)
        p0 = proba[..., 0].astype(np.int64)
        cost0_p0 = ec[p0]                              # [4, 8, 3]
        comb = lc[:, BANDS] + fl[None, None, None, :68]  # [4,16,3,68]
        self.lvl = comb[:, :, 1, :8].mean(axis=1).astype(np.int32)
        base = self.lvl[:, 7:8]
        self.tail = np.stack([
            comb[:, :, 1, 8:11].mean(axis=(1, 2)),
            comb[:, :, 1, 11:19].mean(axis=(1, 2)),
            comb[:, :, 1, 19:35].mean(axis=(1, 2)),
            comb[:, :, 1, 35:68].mean(axis=(1, 2)),
        ], axis=-1).astype(np.int32) - base            # [4, 4]
        self.eob = cost0_p0[:, 2, 1].astype(np.int32)  # [4] scalar EOB cost
        c16 = comb[:, :16]                             # [4, 16, 3, 68]
        self.lvlp = c16[:, :, 1, :8].astype(np.int32)  # [4, 16, 8]
        basep = self.lvlp[:, :, 7:8]
        self.tailp = (np.stack([
            c16[:, :, 1, 8:11].mean(axis=-1),
            c16[:, :, 1, 11:19].mean(axis=-1),
            c16[:, :, 1, 19:35].mean(axis=-1),
            c16[:, :, 1, 35:68].mean(axis=-1),
        ], axis=-1) - basep).astype(np.int32)          # [4, 16, 4]
        # EOB bit cost when the last nonzero sits at position p (coded at
        # band[p+1] with ctx 1 if v==1 else 2); p==15 emits no EOB bit.
        nb = np.asarray(T.BANDS)[1:17]
        e1 = np.array(cost0_p0[:, nb, 1])              # [4, 16]
        e2 = np.array(cost0_p0[:, nb, 2])
        e1[:, 15] = 0
        e2[:, 15] = 0
        self.eob1p = e1.astype(np.int32)
        self.eob2p = e2.astype(np.int32)
        # Empty-block cost by first position (EOB at band[first], ctx=1).
        self.emptyp = cost0_p0[:, BANDS, 1].astype(np.int32)   # [4, 16]


# Packed rate constants read by the CUDA kernels (csrc/common.cuh keeps
# the same offsets): per coefficient type pt, RC_PT ints = lvl [16][8],
# tail [16][4], eob1 [16], eob2 [16], empty [16]; then the fixed mode
# costs.
RC_PT = 16 * 8 + 16 * 4 + 16 * 3
RC_FC16 = 4 * RC_PT
RC_FCUV = RC_FC16 + 4
RC_I4MODE = RC_FCUV + 4
RC_SIZE = RC_I4MODE + 10


def pack_rate_consts(rt) -> np.ndarray:
    """RateTables (the port's or the JAX package's — any object with the
    lvlp/tailp/eob1p/eob2p/emptyp arrays) -> int32 [RC_SIZE]."""
    parts = []
    for pt in range(4):
        parts += [np.asarray(rt.lvlp[pt]).reshape(-1),
                  np.asarray(rt.tailp[pt]).reshape(-1),
                  np.asarray(rt.eob1p[pt]), np.asarray(rt.eob2p[pt]),
                  np.asarray(rt.emptyp[pt])]
    parts += [np.asarray(FIXED_COSTS_I16), np.asarray(FIXED_COSTS_UV),
              np.asarray(FIXED_COSTS_I4)[0, 0]]
    out = np.concatenate([np.asarray(p, np.int64) for p in parts])
    assert out.shape == (RC_SIZE,)
    return out.astype(np.int32)


def tables_from_numpy(q_tables, rt, device):
    """The device-resident parameters of the encoder: the counterpart of
    all_q_tables / rd_params / RateTables, moved to `device`.

    q_tables: the all_q_tables() tuple (tabs, lam_i16, lam_uv, lam_i4,
    qi4), numpy; rt: a RateTables. Returns a namespace with
    q {y1/y2/uv: [128, 4, 16] i32}, lam_i16/lam_uv/lam_i4/lam_mode
    [128] f32, qi4 [128] i32, rate_consts [RC_SIZE] i32 and the numpy
    RateTables itself (rt) for the plain versions.
    """
    tabs, lam_i16, lam_uv, lam_i4, qi4 = q_tables
    i32 = dict(dtype=torch.int32, device=device)
    f32 = dict(dtype=torch.float32, device=device)
    return SimpleNamespace(
        q={k: torch.as_tensor(np.asarray(tabs[k]), **i32)
           for k in ("y1", "y2", "uv")},
        lam_i16=torch.as_tensor(np.asarray(lam_i16), **f32),
        lam_uv=torch.as_tensor(np.asarray(lam_uv), **f32),
        lam_i4=torch.as_tensor(np.asarray(lam_i4), **f32),
        lam_mode=torch.as_tensor(_lam_mode_table(np.asarray(qi4)), **f32),
        qi4=torch.as_tensor(np.asarray(qi4), **i32),
        rate_consts=torch.as_tensor(pack_rate_consts(rt), **i32),
        rt=rt,
    )


@functools.lru_cache(maxsize=8)
def device_tables(device: str):
    """The port's own tables on `device` (cached per device)."""
    return tables_from_numpy(all_q_tables(),
                             RateTables(np.asarray(T.COEFFS_PROBA0)), device)


def approx_block_rate(levels, first, pt, rt: RateTables):
    """Approximate rate of zigzag level blocks [..., 16] -> int32 [...]
    (the non-planar form of planar.approx_rate_p)."""
    from .planar import approx_rate_p

    lv = torch.movedim(levels, -1, 0)                  # [16, ...]
    flat = lv.reshape(16, -1)
    return approx_rate_p(flat, first, pt, rt).reshape(levels.shape[:-1])


# ---------------------------------------------------------------------------
# Phase 0 — segment plan (alphas -> k-means -> SNS quants), batched.
# ---------------------------------------------------------------------------

def _uv_deltas(guv, sns, uv_ac=False):
    """UV quantizer deltas (reference setSegmentParams,
    encode_analysis.go:163-170). The DC delta follows the SNS strength:
    -4 * sns // 100, clipped to +-15. The AC delta is 0 without uv_ac (the
    reference's default); with uv_ac it follows the image's mean pre-mix
    UV alpha guv: ((guv - 94) * 10 // 70) * sns // 100, clipped to
    -4..6 (the reference's chroma AC switch; midpoint 94, not the host
    analysis's 64, since this alpha reads higher). Both divisions floor,
    as the reference's do, where libwebp truncates: at SNS 30 the DC
    delta is -2 (libwebp's -1), and with sns > 0 every guv below 94 gives
    a negative AC delta.
    Returns (dq_uv_dc int, dq_uv_ac int32 tensor like guv, on its
    device)."""
    dq_dc = max(-15, min(15, -4 * sns // 100))
    if not uv_ac:
        return dq_dc, torch.zeros_like(guv, dtype=torch.int32)
    dq_ac = (guv.to(torch.int32) - 94) * 10 // 70
    return dq_dc, (dq_ac * sns // 100).clamp(-4, 6)


def _uv_rows_delta(q_idx, dq_dc, dq_ac, tabs):
    """UV quant rows [..., 4seg, 4param, 16] honoring the dc/ac deltas:
    zigzag position 0 taken at q+dq_dc, the rest at q+dq_ac (the uv table
    carries the DC quant with the 117 clip baked in). q_idx: [..., 4];
    dq_ac broadcasts over the segment axis; tabs: device_tables()."""
    tab_uv = tabs.q["uv"]                              # [128, 4, 16]
    rows_dc = tab_uv[(q_idx + dq_dc).clamp(0, 127).long()]
    rows_ac = tab_uv[(q_idx + dq_ac[..., None]).clamp(0, 127).long()]
    pos0 = torch.arange(16, device=q_idx.device) == 0
    return torch.where(pos0, rows_dc, rows_ac)


def _lam_uv_of(uv_rows):
    """Per-segment UV lambda from uv quant rows [..., 4seg, 4param, 16]:
    max((3*q_uv^2)>>6, 1), q_uv from the rows' dc/ac steps."""
    uvdc = uv_rows[..., 0, 0]
    uvac = uv_rows[..., 0, 1]
    q_uv = (uvdc + 15 * uvac + 8) >> 4
    return ((3 * q_uv * q_uv) >> 6).clamp(min=1).to(torch.float32)


@functools.lru_cache(maxsize=32)
def sns_qidx_table(quality: int, sns_strength: int):
    """Segment quant index per alpha_n in -127..127 -> int32 [255] on the
    CPU: clip(int(127 * (1 - c_base ** (1 - amp * alpha_n))), 0, 127) in
    float32 (reference setSegmentParams). Evaluated once on the CPU — a
    device `pow` may round differently — and looked up on the device."""
    from ..lossy.analysis import _quality_to_compression

    sns = max(0, int(sns_strength))
    amp = 0.9 * sns / 100.0 / 128.0
    c_base = float(_quality_to_compression(quality))
    alpha_n = torch.arange(-127, 128, dtype=torch.float32)
    expn = 1.0 - torch.tensor(amp, dtype=torch.float32) * alpha_n
    c = torch.pow(torch.tensor(c_base, dtype=torch.float32), expn)
    return (127.0 * (1.0 - c)).to(torch.int32).clamp(0, 127)


def _plan_from_histo(histo, alphas, quality, sns_strength, num_segs=4):
    """k-means over per-image 256-bin alpha histograms, batched.

    histo: [B, 256] int; alphas: [B, n_mb] int. Returns (seg_map
    [B, n_mb] i32, q_idx [B, 4] i32, beta [B, 4] i32). Ties go to the
    lower center, divisions floor, as in the reference."""
    dev = histo.device
    histo = histo.to(torch.int64)
    B = histo.shape[0]
    bins = torch.arange(256, device=dev)
    nzm = (histo > 0).to(torch.int64)
    min_a = nzm.argmax(dim=1)
    max_a = 255 - nzm.flip(1).argmax(dim=1)
    rng_a = max_a - min_a
    ks = torch.arange(num_segs, device=dev)
    centers = min_a[:, None] + ((2 * ks + 1) * rng_a[:, None]) \
        // (2 * num_segs)                                     # [B, S]

    def assign(centers):
        d = (bins[None, :, None] - centers[:, None, :]).abs()  # [B, 256, S]
        return d.argmin(dim=2)                                 # first min

    for _ in range(6):
        oh = (assign(centers)[..., None] == ks).to(torch.int64)  # [B,256,S]
        accum = (histo[..., None] * oh).sum(dim=1)
        dist = ((histo * bins)[..., None] * oh).sum(dim=1)
        centers = torch.where(accum > 0,
                              (dist + accum // 2) // accum.clamp(min=1),
                              centers)
    seg_of_alpha = assign(centers)                             # [B, 256]
    seg_map = torch.gather(seg_of_alpha, 1, alphas.to(torch.int64))

    oh = (seg_of_alpha[..., None] == ks).to(torch.int64)
    accum = (histo[..., None] * oh).sum(dim=1)
    total_w = accum.sum(dim=1).clamp(min=1)
    weighted_avg = ((centers * accum).sum(dim=1) + total_w // 2) // total_w
    min_c = centers.min(dim=1).values
    max_c = centers.max(dim=1).values
    range_c = (max_c - min_c).clamp(min=1)
    alpha_n = (255 * (centers - weighted_avg[:, None])
               // range_c[:, None]).clamp(-127, 127)
    beta_n = (255 * (centers - min_c[:, None]) // range_c[:, None]).clamp(0, 255)
    qtab = sns_qidx_table(int(quality), int(sns_strength)).to(dev)
    q_idx = qtab[alpha_n + 127]
    beta = beta_n
    if num_segs < 4:
        pad = 4 - num_segs
        q_idx = torch.cat([q_idx, q_idx[:, -1:].expand(B, pad)], dim=1)
        beta = torch.cat([beta, beta[:, -1:].expand(B, pad)], dim=1)
    return (seg_map.to(torch.int32), q_idx.to(torch.int32),
            beta.to(torch.int32))


def _seg_select(rows, seg_map):
    """rows [4, ...], seg_map [n] -> [n, ...] via a 4-way select."""
    s = seg_map.reshape(seg_map.shape + (1,) * (rows.dim() - 1))
    return torch.where(s == 0, rows[0],
                       torch.where(s == 1, rows[1],
                                   torch.where(s == 2, rows[2], rows[3])))


def _mb_quant(seg_map, q_idx, n_mb, dq_uv=None, tabs=None):
    """Per-segment quant indices -> per-MB quantizer rows and lambdas for
    one image. seg_map [n_mb], q_idx [4]; dq_uv: optional (dq_uv_dc int,
    dq_uv_ac int32 scalar tensor). Returns (qp {y1/y2/uv: 4 x [n, 1, 16]},
    lambdas {i16/uv/i4/mode: [n] f32, *_seg: [4] f32}, seg_rows
    {y1/y2/uv: [4, 4, 16]})."""
    tabs = tabs or device_tables(str(seg_map.device))
    qi = q_idx.long()
    qp, seg_rows = {}, {}
    for k in ("y1", "y2", "uv"):
        seg_rows[k] = tabs.q[k][qi]                            # [4, 4, 16]
        if k == "uv" and dq_uv is not None:
            seg_rows[k] = _uv_rows_delta(q_idx, dq_uv[0],
                                         torch.as_tensor(dq_uv[1]), tabs)
        mb = _seg_select(seg_rows[k], seg_map)                 # [n, 4, 16]
        qp[k] = tuple(mb[:, i][:, None, :] for i in range(4))
    lam16_s = tabs.lam_i16[qi]
    lamuv_s = (_lam_uv_of(seg_rows["uv"]) if dq_uv is not None
               else tabs.lam_uv[qi])
    lami4_s = tabs.lam_i4[qi]
    lammd_s = tabs.lam_mode[qi]
    return (qp, {"i16": _seg_select(lam16_s, seg_map),
                 "uv": _seg_select(lamuv_s, seg_map),
                 "i4": _seg_select(lami4_s, seg_map),
                 "mode": _seg_select(lammd_s, seg_map),
                 "i4_seg": lami4_s, "i16_seg": lam16_s,
                 "uv_seg": lamuv_s, "mode_seg": lammd_s}, seg_rows)


def _plan_tables(seg_map, seg_q, seg_beta, guv, sns, tabs, uv_ac=False):
    """The segmented plan of a batch from its k-means results: per-image
    quant rows (the UV rows at the dc/ac deltas of _uv_deltas(guv, sns,
    uv_ac)), per-segment lambdas (the UV lambda from those rows) and
    TLambdaSD. Returns (seg_map [B, n_mb], seg_q, seg_beta, qtabs
    [B, 48, 16] (type*16 + seg*4 + param), lambdas {i16, uv, i4, mode:
    [B, 4]}, tlsd4 [B, 4] or None, dq_uv [B, 2])."""
    B = seg_q.shape[0]
    dq_dc, dq_ac = _uv_deltas(guv, sns, uv_ac)                 # [B]
    qi = seg_q.long()
    seg_rows = {k: tabs.q[k][qi] for k in ("y1", "y2")}        # [B,4,4,16]
    seg_rows["uv"] = _uv_rows_delta(seg_q, dq_dc, dq_ac, tabs)
    lams = {"i16": tabs.lam_i16[qi], "uv": _lam_uv_of(seg_rows["uv"]),
            "i4": tabs.lam_i4[qi], "mode": tabs.lam_mode[qi]}
    tlsd4 = (((sns * tabs.qi4[qi]) >> 5).to(torch.float32)
             if sns > 0 else None)
    dq_uv_b = torch.stack([torch.full_like(dq_ac, dq_dc), dq_ac], dim=1)
    qtabs = torch.stack([seg_rows[k] for k in ("y1", "y2", "uv")],
                        dim=1).reshape(B, 48, 16).contiguous()
    return seg_map, seg_q, seg_beta, qtabs, lams, tlsd4, dq_uv_b


def _single_plan(quality, sns, B, n_mb, dev):
    """The unsegmented plan (reference fastpath.py:1313-1347): segment
    fields zero, the quality's one set of quant rows broadcast to every
    segment and image, the lambdas and TLambdaSD static; the same tuple
    as _plan_tables."""
    qp, lambdas = rd_params(quality)
    z4 = torch.zeros((B, 4), dtype=torch.int32, device=dev)
    one = torch.stack([torch.stack(qp[k]) for k in ("y1", "y2", "uv")])
    qtabs = one[:, None].expand(3, 4, 4, 16).reshape(48, 16).to(dev) \
        .expand(B, 48, 16).contiguous()
    lams = {k: torch.full((B, 4), float(lambdas[k]), device=dev)
            for k in ("i16", "uv", "i4", "mode")}
    tlsd4, _ = _tlsd_static(sns, lambdas["q_i4"], n_mb)
    if tlsd4 is not None:
        tlsd4 = tlsd4.to(dev).expand(B, 4).contiguous()
    return (torch.zeros((B, n_mb), dtype=torch.int32, device=dev),
            z4, z4, qtabs, lams, tlsd4,
            torch.zeros((B, 2), dtype=torch.int32, device=dev))


def _tlsd_static(sns: int, q_i4: int, n_mb: int):
    """(tlsd4 [4] f32 | None, tlsd scalar | None): TLambdaSD for the
    single-segment configuration (reference encode.go:1137)."""
    v = (int(sns) * int(q_i4)) >> 5
    if sns <= 0 or v <= 0:
        return None, None
    return (torch.full((4,), float(v), dtype=torch.float32),
            torch.tensor(float(v), dtype=torch.float32))


def _tlsd_from_seg(sns: int, seg_q, seg_map):
    """Per-segment TLambdaSD (reference encode.go:1137): seg_q [..., 4]
    -> (tlsd4 [..., 4] f32, per-MB tlsd) or (None, None) without SNS."""
    if sns <= 0:
        return None, None
    qi4 = device_tables(str(seg_q.device)).qi4
    tlsd4 = ((sns * qi4[seg_q.long()]) >> 5).to(torch.float32)
    return tlsd4, _seg_select(tlsd4, seg_map)


# ---------------------------------------------------------------------------
# Shared prediction math, lanes-first layout: every mode builder takes
# [..., S] context rows (the planar forms are ops/planar.py's).
# ---------------------------------------------------------------------------

def _preds4(size, top, left, tl, has_top, has_left):
    """[..., size] contexts (int32), tl and has_* [...] -> [..., 4, size,
    size] predictions (DC/TM/V/H), the missing edges filled with 127 above
    and 129 on the left."""
    shift = 5 if size == 16 else 4
    top_m = torch.where(has_top[..., None], top, 127)
    left_m = torch.where(has_left[..., None], left, 129)
    tl_m = torch.where(has_top & has_left, tl,
                       127 + 2 * has_top.to(torch.int32))
    sum_t = top_m.sum(dim=-1, dtype=torch.int32)
    sum_l = left_m.sum(dim=-1, dtype=torch.int32)
    dc = torch.where(
        has_top & has_left, (sum_t + sum_l + size) >> shift,
        torch.where(has_top, (sum_t + (size >> 1)) >> (shift - 1),
                    torch.where(has_left, (sum_l + (size >> 1)) >> (shift - 1),
                                0x80)))
    shape = dc.shape + (size, size)
    pred_dc = dc[..., None, None].expand(shape)
    pred_v = top_m[..., None, :].expand(shape)
    pred_h = left_m[..., :, None].expand(shape)
    pred_tm = (left_m[..., :, None] + top_m[..., None, :]
               - tl_m[..., None, None]).clamp(0, 255)
    return torch.stack([pred_dc, pred_tm, pred_v, pred_h], dim=-3)


def _unblock(x, size):
    """[..., (size/4)^2, 4, 4] raster 4x4 blocks -> [..., size, size]."""
    b = size // 4
    lead = x.shape[:-3]
    return x.reshape(*lead, b, b, 4, 4).transpose(-3, -2).reshape(
        *lead, size, size)


# ---------------------------------------------------------------------------
# The non-planar formulation: macroblock-major tensors [B, n_mb, ...].
# ---------------------------------------------------------------------------

def _block(x, size):
    """[..., S, S] -> [..., (S/4)^2, 4, 4] raster 4x4 blocks."""
    b = size // 4
    lead = x.shape[:-2]
    return x.reshape(*lead, b, 4, b, 4).transpose(-3, -2).reshape(
        *lead, b * b, 4, 4)


def _mbs(plane, mb_w, mb_h, s):
    """[B, H, W] -> [B, n_mb, s, s] macroblocks in raster order."""
    B = plane.shape[0]
    return plane.reshape(B, mb_h, s, mb_w, s).transpose(2, 3).reshape(
        B, mb_w * mb_h, s, s)


def _luma_pipe(src_b, pred_b, qp, with_recon=False):
    """The I16 transform pipeline scored in the transform domain (phase
    1). src/pred [..., 16, 4, 4] int32; qp {y1, y2: (q, iq, bias,
    sharpen)} with per-MB rows [..., 1, 16] (the y2 block drops the row
    axis). Returns (lv [..., 16, 16], y2lv [..., 16], disto_td [...] =
    sum((coeff - dequant)^2)[, recon [..., 16, 4, 4]]); the VP8 FDCT has
    an L2 gain of 4, so callers weight disto_td by 64."""
    coeffs = dct.fdct4x4(src_b, pred_b)
    flat = coeffs.reshape(*coeffs.shape[:-2], 16)
    lead = flat.shape[:-2]
    wht = dct.fwht4x4(flat[..., 0].reshape(*lead, 4, 4))
    y2q = tuple(a[..., 0, :] for a in qp["y2"])
    y2lv, y2dq = quantize(wht.reshape(*lead, 16), *y2q, ZIGZAG)
    rec_dc = dct.wht4x4(y2dq.reshape(*lead, 4, 4)).reshape(*lead, 16)
    lv, dq = quantize(flat, *qp["y1"], ZIGZAG, first=1)
    dq = dq.clone()
    dq[..., 0] = rec_dc
    disto = ((flat - dq) ** 2).sum(dim=(-2, -1), dtype=torch.int32)
    if not with_recon:
        return lv, y2lv, disto
    recon = (pred_b + dct.idct4x4(dq.reshape(coeffs.shape))).clamp(0, 255)
    return lv, y2lv, disto, recon


def _chroma_pipe(src_b, pred_b, qp):
    """[..., 4, 4, 4] chroma blocks -> (lv [..., 4, 16], disto_td [...])."""
    co = dct.fdct4x4(src_b, pred_b)
    flat = co.reshape(*co.shape[:-2], 16)
    lv, dq = quantize(flat, *qp["uv"], ZIGZAG)
    return lv, ((flat - dq) ** 2).sum(dim=(-2, -1), dtype=torch.int32)


def _hist_alpha(coeffs):
    """coeffs int32 [..., nb, 16] -> alpha [...] (DCT histogram
    complexity)."""
    from .p1_kernels import _hist_alpha_p

    lead = coeffs.shape[:-2]
    v = (coeffs.abs() >> 3).clamp(max=31).reshape(-1, coeffs.shape[-2] * 16)
    return _hist_alpha_p(v.T).reshape(lead)


def _mb_alphas2(Y, U, V, mb_w, mb_h):
    """Per-MB (texture alpha, pre-mix UV alpha) [B, n_mb] each from int32
    planes [B, H, W] (the compute_alphas analog; the UV component feeds
    dq_uv_ac)."""
    yb = _block(_mbs(Y, mb_w, mb_h, 16), 16)               # [B, n, 16, 4, 4]
    uvb = torch.cat([_block(_mbs(P, mb_w, mb_h, 8), 8) for P in (U, V)],
                    dim=2)                                 # [B, n, 8, 4, 4]

    def alpha(blocks):
        n = blocks.shape[-3] * 16
        dc = torch.round(blocks.sum(dim=(-3, -2, -1)).to(torch.float32) / n)
        co = dct.fdct4x4(blocks, dc.to(torch.int32)[..., None, None, None])
        return _hist_alpha(co.reshape(*co.shape[:-2], 16))

    luma, uv = alpha(yb), alpha(uvb)
    return (255 - ((3 * luma + uv + 2) >> 2)).clamp(0, 255), uv


def _mb_alphas(Y, U, V, mb_w, mb_h):
    """Per-MB texture alphas [B, n_mb]."""
    return _mb_alphas2(Y, U, V, mb_w, mb_h)[0]


def _alpha_histo(alphas):
    """[B, n_mb] alphas -> [B, 256] int64 histograms."""
    h = torch.zeros((alphas.shape[0], 256), dtype=torch.int64,
                    device=alphas.device)
    return h.scatter_add_(1, alphas.long(),
                          torch.ones_like(alphas, dtype=torch.int64))


def _segment_plan_device(Y, U, V, mb_w, mb_h, quality, sns_strength,
                         num_segs=4):
    """Returns (seg_map [B, n_mb] i32, q_idx [B, 4] i32, beta [B, 4] i32,
    global_uv [B] i32, the mean pre-mix UV alpha)."""
    from .phase1p import plan_segments_planar

    return plan_segments_planar(_mb_alphas2(Y, U, V, mb_w, mb_h), Y.shape[0],
                                mb_w * mb_h, quality, sns_strength, num_segs)


def _mb_rows(plan):
    """A plan's per-MB quant rows, lambdas and TLambdaSD (the reference's
    _mb_quant and _tlsd_from_seg outputs): (qp {y1/y2/uv: 4 x [B, n_mb, 1,
    16]}, lambdas {i16, uv, mode: [B, n_mb]}, tlsd [B, n_mb] or None)."""
    seg_map, _, _, qtabs, lams, tlsd4, _ = plan
    B = seg_map.shape[0]
    si = seg_map.long()
    rows = qtabs.reshape(B, 3, 4, 4, 16).transpose(1, 2)   # [B, seg, t, p, 16]
    per = rows[torch.arange(B, device=si.device)[:, None], si]
    qp = {k: tuple(per[:, :, t, p, None, :] for p in range(4))
          for t, k in enumerate(("y1", "y2", "uv"))}
    lam = {k: torch.gather(lams[k], 1, si) for k in ("i16", "uv", "mode")}
    tlsd = torch.gather(tlsd4, 1, si) if tlsd4 is not None else None
    return qp, lam, tlsd


def _mb_contexts(plane, s, halo, above):
    """Source-pixel (top [B, n, s], left [B, n, s], corner [B, n]) context
    per MB of an s-sized grid; the first MB row's top row and corners come
    from halo [B, W] when `above`, else zero (masked by has_top)."""
    B, H, W = plane.shape
    gh, gw = H // s, W // s
    g = plane.reshape(B, gh, s, gw, s)
    bottom = g[:, :, s - 1]                                 # [B, gh, gw, s]
    right = g[..., s - 1].transpose(2, 3)                   # [B, gh, gw, s]
    row0 = plane.new_zeros((B, 1, gw, s))
    tl0 = plane.new_zeros((B, 1, gw))
    if halo is not None and above:
        halo = halo.to(plane.dtype)
        row0 = halo.reshape(B, 1, gw, s)
        tl0[:, 0, 1:] = halo[:, s - 1::s][:, :gw - 1]
    top = torch.cat([row0, bottom[:, :-1]], dim=1)
    left = torch.cat([plane.new_zeros((B, gh, 1, s)), right[:, :, :-1]],
                     dim=2)
    br = g[:, :, s - 1, :, s - 1]                           # [B, gh, gw]
    tl = torch.cat([tl0, torch.nn.functional.pad(br[:, :-1, :-1], (1, 0))],
                   dim=1)
    return top.reshape(B, -1, s), left.reshape(B, -1, s), tl.reshape(B, -1)


def _phase1(Y, U, V, qp, lambdas, mb_w, mb_h, halos=None, has_above=False,
            tlsd=None):
    """Fully parallel I16 and UV mode search with source-pixel context.

    Y, U, V: int32 [B, H, W] planes; qp, lambdas, tlsd: _mb_rows of the
    plan. halos: optional (hy [B, W], hu, hv [B, W/2]) source rows of the
    band above (row-band sharding); with has_above the first MB row
    predicts from them. Returns (modes [B, n_mb] u8, uvmodes [B, n_mb]
    u8, score [B, n_mb] f32): the I16 mode chosen at lambda_i16, its total
    rescored at lambda_mode (the I4-vs-I16 split scale), and the chroma
    mode chosen at lambda_uv on the joint U+V score."""
    from .metrics import WEIGHT_Y, _hadamard4

    B = Y.shape[0]
    n_mb = mb_w * mb_h
    dev = Y.device
    above = halos is not None and bool(has_above)
    k = torch.arange(n_mb, device=dev)
    has_top = (k >= mb_w) | above
    has_left = (k % mb_w) > 0
    hy, hu, hv = halos if halos is not None else (None, None, None)
    rt = device_tables(str(dev)).rt

    topY, leftY, tlY = _mb_contexts(Y, 16, hy, above)
    src_b = _block(_mbs(Y, mb_w, mb_h, 16), 16)            # [B, n, 16, 4, 4]
    preds = _preds4(16, topY, leftY, tlY, has_top, has_left)
    if tlsd is not None:
        wt = torch.as_tensor(WEIGHT_Y, device=dev)

        def wha(x):
            return (wt * _hadamard4(x).abs()).sum(dim=(-2, -1),
                                                  dtype=torch.int32)
        ha_src = wha(src_b)
    best_score = torch.full((B, n_mb), float("inf"), device=dev)
    best_rate = torch.zeros((B, n_mb), device=dev)
    best_D = torch.zeros((B, n_mb), device=dev)
    best_mode = torch.zeros((B, n_mb), dtype=torch.uint8, device=dev)
    for m in range(4):
        res = _luma_pipe(src_b, _block(preds[:, :, m], 16), qp,
                         with_recon=tlsd is not None)
        lv, y2lv, disto = res[:3]
        rate = (approx_block_rate(lv, 1, 0, rt).sum(dim=-1, dtype=torch.int32)
                + approx_block_rate(y2lv, 0, 1, rt) + int(FIXED_COSTS_I16[m]))
        D = 64.0 * disto.to(torch.float32)
        if tlsd is not None:
            # Perceptual texture distortion (reference TDisto16x16 and
            # TLambdaSD, encode_analysis.go:1180).
            td = ((wha(res[3]) - ha_src).abs() >> 5).sum(dim=-1,
                                                         dtype=torch.int32)
            D = D + tlsd * td.to(torch.float32)
        score = rate.to(torch.float32) * lambdas["i16"] + D
        better = score < best_score
        best_score = torch.where(better, score, best_score)
        best_rate = torch.where(better, rate.to(torch.float32), best_rate)
        best_D = torch.where(better, D, best_D)
        best_mode = torch.where(better, m, best_mode)
    best_score = best_rate * lambdas["mode"] + best_D

    planes = []
    for P, h in ((U, hu), (V, hv)):
        top, left, tl = _mb_contexts(P, 8, h, above)
        planes.append((_block(_mbs(P, mb_w, mb_h, 8), 8),
                       _preds4(8, top, left, tl, has_top, has_left)))
    best_uv_score = torch.full((B, n_mb), float("inf"), device=dev)
    best_uv = torch.zeros((B, n_mb), dtype=torch.uint8, device=dev)
    for m in range(4):
        rate = torch.full((B, n_mb), int(FIXED_COSTS_UV[m]),
                          dtype=torch.int32, device=dev)
        disto = torch.zeros((B, n_mb), dtype=torch.int32, device=dev)
        for src, preds_c in planes:
            lv, d = _chroma_pipe(src, _block(preds_c[:, :, m], 8), qp)
            disto = disto + d
            rate = rate + approx_block_rate(lv, 0, 2, rt).sum(
                dim=-1, dtype=torch.int32)
        score = (rate.to(torch.float32) * lambdas["uv"]
                 + 64.0 * disto.to(torch.float32))
        better = score < best_uv_score
        best_uv_score = torch.where(better, score, best_uv_score)
        best_uv = torch.where(better, m, best_uv)
    return best_mode, best_uv, best_score


def _i4_dispatch(Y, plan, i16_score, mb_w, mb_h, allow_tr=False):
    """The I4 search of a plan through kernel 3 (ops/i4.py i4_search, one
    launch for the batch; its plain version for CPU tensors). A failure
    to build or launch the kernel raises: there is no fallback. The
    reference's segmented and unsegmented forms both arrive as a plan
    (qtabs, per-segment lambdas); allow_tr lifts the ban on the
    above-right-reading modes in the rightmost subblock column (skew 2).
    Returns (is_i4 [B, n_mb] bool, modes [B, n_mb, 16] u8, i4_score)."""
    from . import i4 as I4

    seg_map, _, _, qtabs, lams, tlsd4, _ = plan
    return I4.i4_search(Y, seg_map, qtabs[:, :16].contiguous(), lams["i4"],
                        lams["mode"], tlsd4, i16_score, mb_w, mb_h,
                        allow_tr=allow_tr)


def _phase2(Y, U, V, modes, uvmodes, mb_w, mb_h, seg, rd_drop=0.0,
            halos=None, has_above=False, i4=None, sk=1):
    """Exact levels under the true reconstructed context: the planar step
    loop (ops/planar.py phase2_planar; the reference holds its own planar
    and non-planar forms equal, tests/test_planar.py), its steps replayed
    from a CUDA graph on the card.

    seg: (seg_map [B, n_mb], seg_rows {y1/y2/uv: [B, 4, 4, 16]}); halos
    with has_above: the rows above the band's first MB row (the source's
    in encode_band, the reconstruction's in parallel/exact.py), skew 1.
    Returns (lv24 [B, n_mb, 24, 16] i16, y2 [B, n_mb, 16] i16, bottom,
    right [B, n_mb, 16], bottom_u, bottom_v [B, n_mb, 8])."""
    from .planar import phase2_planar

    out = phase2_planar(Y, U, V, modes, uvmodes, None, mb_w, mb_h,
                        rd_drop=rd_drop, seg=seg, i4=i4, sk=sk,
                        graph=Y.device.type == "cuda", halos=halos,
                        has_above=has_above)
    return out[:4] + out[-2:]


def _seg_rows(qtabs):
    """qtabs [B, 48, 16] -> {y1/y2/uv: [B, 4, 4, 16]}."""
    return dict(zip(("y1", "y2", "uv"),
                    qtabs.reshape(qtabs.shape[0], 3, 4, 4, 16).unbind(1)))


def _encode_planned(Y, U, V, plan, mb_w, mb_h, i4_blocks, rd_drop, esc_cap,
                    sk=1, halos=None, has_above=False):
    """Phases 1 and 2 and the pack of the non-planar formulation, on the
    plan of phase 0. With has_above the band's first MB row stays I16 (it
    predicts from the source halo; I4's 4x4 modes lean too hard on exact
    context there). Returns (field dict [B, ...], lv24)."""
    seg_map, seg_q, seg_beta, qtabs, lams, _, dq_uv = plan
    B = Y.shape[0]
    n_mb = mb_w * mb_h
    qp, lam, tlsd = _mb_rows(plan)
    modes, uvmodes, i16_score = _phase1(Y, U, V, qp, lam, mb_w, mb_h,
                                        halos=halos, has_above=has_above,
                                        tlsd=tlsd)
    if i4_blocks:
        is_i4, i4_modes, _ = _i4_dispatch(Y, plan, i16_score, mb_w, mb_h,
                                          allow_tr=sk == 2)
        if has_above:
            is_i4 = is_i4.clone()
            is_i4[:, :mb_w] = False
        i4 = (is_i4, i4_modes)
    else:
        is_i4 = torch.zeros((B, n_mb), dtype=torch.bool, device=Y.device)
        i4_modes = torch.zeros((B, n_mb, 16), dtype=torch.uint8,
                               device=Y.device)
        i4 = None
    lv24, y2 = _phase2(Y, U, V, modes, uvmodes, mb_w, mb_h,
                       (seg_map, _seg_rows(qtabs)), rd_drop=rd_drop,
                       halos=halos, has_above=has_above, i4=i4, sk=sk)[:2]
    imodes = torch.where(
        is_i4[..., None], i4_modes,
        torch.cat([modes[..., None], modes.new_zeros((B, n_mb, 15))], dim=-1))
    out = dict(wire_from_levels(lv24, y2, esc_cap), modes=modes,
               uvmodes=uvmodes, is_i4=is_i4, imodes=imodes,
               seg_map=seg_map.to(torch.uint8), seg_q=seg_q,
               seg_beta=seg_beta, dq_uv=dq_uv)
    return out, lv24


def band_stats(Y, U, V, mb_w, mb_h):
    """A band's share of the image-global segment statistics: (alphas
    [b, n_mb], alpha histograms [b, 256], UV-alpha sums [b]) of planes
    [b, H, W] (values 0-255, any integer type), the alphas from kernel 1
    (ops/phase1p.py alphas_planar; equal to _mb_alphas2's). The band
    encoders sum the histograms and sums over the bands (every term an
    integer, so the order does not matter)."""
    from . import phase1p as P1

    src_rows, _ = P1.build_src(*(p.to(torch.uint8) for p in (Y, U, V)),
                               mb_w, mb_h)
    alphas, uv = P1.alphas_planar(src_rows, Y.shape[0], mb_w * mb_h)
    return alphas, _alpha_histo(alphas), uv.sum(dim=1, dtype=torch.int64)


def level_histogram(lv24):
    """|level| histogram [B, 16] of lv24 [B, ...] with jnp.histogram's
    rule for bins=16, range=(0, 16): 16 lands in the last bin, larger
    values are dropped."""
    B = lv24.shape[0]
    v = lv24.abs().reshape(B, -1).long()
    return torch.zeros((B, 16), dtype=torch.int64, device=lv24.device) \
        .scatter_add_(1, v.clamp(max=15), (v <= 16).long())


def encode_band(Y, U, V, hy, hu, hv, has_above, mb_w, mb_h, esc_cap,
                quality, segments=4, sns_strength=50, i4_blocks=True,
                stats=None, rd_drop=1024.0, uv_ac=False):
    """One row band of the flagship encoder with cross-band source halos,
    for b images of the band (the multi-device sharding unit): device
    segmentation, I16 and I4 search, and the closed-loop wavefront.

    Y [b, Hb, W], U, V [b, Hb/2, W/2] planes; hy [b, W], hu, hv [b, W/2]
    the source rows above the band (zeros on the top band); has_above:
    whether there is a band above (bool). stats: (alphas [b, n_mb],
    histograms [b, 256], UV-alpha sums [b], MB count) with the
    histograms, sums and count summed over every band of the image (the
    mesh's sum, the reference's psum_axis), so every band derives the
    image's plan; None plans from this band alone (band_stats). uv_ac:
    the chroma AC delta from the image's mean UV alpha (_uv_deltas; the
    summed statistics give every band the same delta). Returns the field
    dict plus "hist" [b, 16], the |level| histogram."""
    Y, U, V = (p.to(torch.int32) for p in (Y, U, V))
    B = Y.shape[0]
    n_mb = mb_w * mb_h
    sns = max(0, int(sns_strength))
    if segments > 1:
        if stats is None:
            stats = band_stats(Y, U, V, mb_w, mb_h) + (n_mb,)
        alphas, histo, uv_sum, tot_mb = stats
        plan = _plan_tables(
            *_plan_from_histo(histo, alphas, quality, sns_strength, segments),
            (uv_sum // tot_mb).to(torch.int32), sns,
            device_tables(str(Y.device)), uv_ac)
    else:
        plan = _single_plan(quality, sns, B, n_mb, Y.device)
    out, lv24 = _encode_planned(Y, U, V, plan, mb_w, mb_h, i4_blocks,
                                rd_drop, esc_cap, halos=(hy, hu, hv),
                                has_above=bool(has_above))
    out["hist"] = level_histogram(lv24)
    return out


# ---------------------------------------------------------------------------
# Device-side nibble packing.
# ---------------------------------------------------------------------------

def escape_list(flags, blocks, esc_cap):
    """flags bool [B, n_blk], blocks i16 [B, n_blk, 16] -> (esc_idx i32
    [B, K] block indices, esc_blk i16 [B, K, 16], esc_cnt i32 [B]),
    K = min(esc_cap, n_blk).

    Escape compaction by an ascending sort of the flagged block indices
    (unflagged blocks sort last as a sentinel, read back as index 0): the
    same order and fill as the reference."""
    n_blk = flags.shape[1]
    ar = torch.arange(n_blk, dtype=torch.int32, device=flags.device)
    keys = torch.where(flags, ar, n_blk)
    idx = torch.sort(keys, dim=1).values[:, :esc_cap]
    idx = torch.where(idx >= n_blk, 0, idx)
    esc_blk = torch.gather(blocks, 1,
                           idx.long()[..., None].expand(*idx.shape, 16))
    return idx, esc_blk, flags.sum(dim=1).to(torch.int32)


def _pack_levels(lv24, esc_cap):
    """lv24: int16 [B, n_mb, 24, 16] -> (packed u8 [B, n_mb, 24, 8],
    esc_idx i32 [B, K] block indices, esc_blk i16 [B, K, 16],
    esc_cnt i32 [B]), K = min(esc_cap, 24 * n_mb). Two coefficients per
    byte as level + 8; a coefficient with |level| > 7 ships as nibble 0
    and its block goes to the escape list."""
    B = lv24.shape[0]
    v = lv24.to(torch.int32)
    esc = v.abs() > 7
    nib = torch.where(esc, 0, v.clamp(-7, 7) + 8).to(torch.uint8)
    packed = nib[..., 0::2] | (nib[..., 1::2] << 4)
    return (packed,) + escape_list(esc.any(dim=-1).reshape(B, -1),
                                   lv24.reshape(B, -1, 16), esc_cap)


def wire_from_levels(lv24, y2, esc_cap):
    """Phase 2's levels lv24 i16 [B, n_mb, 24, 16] and y2 i16 [B, n_mb, 16]
    -> the wire dict {packed, esc_idx, esc_val, esc_cnt, y2, skip} (the
    reference's part3 after its scan); an MB is skipped when every level
    is zero."""
    packed, esc_idx, esc_val, esc_cnt = _pack_levels(lv24, esc_cap)
    skip = (lv24 == 0).all(dim=-1).all(dim=-1) & (y2 == 0).all(dim=-1)
    return {"packed": packed, "esc_idx": esc_idx, "esc_val": esc_val,
            "esc_cnt": esc_cnt, "y2": y2, "skip": skip}


def unpack_levels(packed, esc_idx, esc_blk, esc_cnt, n_mb):
    """Host-side (numpy) inverse of _pack_levels -> int16 [n_mb, 24, 16]."""
    lo = (packed & 0x0F).astype(np.int16)
    hi = (packed >> 4).astype(np.int16)
    nib = np.empty((n_mb, 24, 16), np.int16)
    nib[..., 0::2] = lo
    nib[..., 1::2] = hi
    out = np.where(nib == 0, 0, nib - 8).astype(np.int16)
    cnt = int(esc_cnt)
    if cnt:
        out.reshape(-1, 16)[esc_idx[:cnt]] = esc_blk[:cnt]
    return out


# Field order inside the output blob. Fixed so host offsets are static
# per geometry.
BLOB_ORDER = ("packed", "esc_idx", "esc_val", "esc_cnt", "y2", "modes",
              "uvmodes", "skip", "is_i4", "imodes", "seg_map", "seg_q",
              "seg_beta", "dq_uv")
BLOB_CHUNKS = 4  # the blob travels as this many equal chunks


def _field_shapes(n_mb, esc_cap):
    """{field: (numpy dtype, per-image shape)} of the blob fields."""
    k = min(esc_cap, 24 * n_mb)
    return {
        "packed": (np.uint8, (n_mb, 24, 8)),
        "esc_idx": (np.int32, (k,)),
        "esc_val": (np.int16, (k, 16)),
        "esc_cnt": (np.int32, ()),
        "y2": (np.int16, (n_mb, 16)),
        "modes": (np.uint8, (n_mb,)),
        "uvmodes": (np.uint8, (n_mb,)),
        "skip": (np.bool_, (n_mb,)),
        "is_i4": (np.bool_, (n_mb,)),
        "imodes": (np.uint8, (n_mb, 16)),
        "seg_map": (np.uint8, (n_mb,)),
        "seg_q": (np.int32, (4,)),
        "seg_beta": (np.int32, (4,)),
        "dq_uv": (np.int32, (2,)),
    }


def blob_spec_of(n_mb, esc_cap):
    """{field: (dtype, shape, byte offset, byte count)} per image."""
    spec, off = {}, 0
    for k, (dt, shape) in _field_shapes(n_mb, esc_cap).items():
        dt = np.dtype(dt)
        nb = int(np.prod(shape, dtype=np.int64)) * dt.itemsize
        spec[k] = (dt, shape, off, nb)
        off += nb
    return {k: spec[k] for k in BLOB_ORDER}


def _u8flat(x):
    """Per-image little-endian byte view [B, nbytes] of a [B, ...] tensor
    (bool stored as u8)."""
    B = x.shape[0]
    if x.dtype == torch.bool:
        x = x.to(torch.uint8)
    x = x.contiguous().reshape(B, -1)
    if x.dtype != torch.uint8:
        x = x.view(torch.uint8)
    return x


def _blobify(out):
    """Field dict of [B, ...] tensors -> BLOB_CHUNKS u8 [B, chunk] tensors
    plus esc_cnt [B] (unpack_output_blob is the host inverse)."""
    blob = torch.cat([_u8flat(out[k]) for k in BLOB_ORDER], dim=1)
    B, n = blob.shape
    pad = (-n) % BLOB_CHUNKS
    if pad:
        blob = torch.cat([blob, blob.new_zeros((B, pad))], dim=1)
    blob = blob.reshape(B, BLOB_CHUNKS, -1)
    return tuple(blob[:, i] for i in range(BLOB_CHUNKS)) + (out["esc_cnt"],)


def unpack_output_blob(chunks, spec):
    """Host inverse of the device blob packing.

    chunks: BLOB_CHUNKS arrays [B, L/BLOB_CHUNKS] u8 (numpy or CPU
    tensors), plus a trailing esc_cnt [B] that is ignored here; spec:
    fn.blob_spec. Returns the field dict as numpy [B, ...]."""
    flat = np.concatenate([np.asarray(c) for c in chunks[:BLOB_CHUNKS]],
                          axis=1)
    B = flat.shape[0]
    out = {}
    for k, (dt, shape, off, nb) in spec.items():
        raw = np.ascontiguousarray(flat[:, off:off + nb])
        out[k] = raw.view(dt).reshape((B,) + shape)
    return out


# ---------------------------------------------------------------------------
# Entry: batched encoder for a fixed geometry.
# ---------------------------------------------------------------------------

class FastEncoder:
    """Batched two-phase device encoder for one geometry and config.

    fn.rgb_blob(rgbs [B, H, W, 3] u8), fn.rgbp_blob(rgbps [B, 3, H, W] u8)
    and fn.blob(Yb, Ub, Vb) (YUV 4:2:0 planes) run the whole device program
    on the inputs' device and return the blob chunks (see _blobify);
    fn(Yb, Ub, Vb) and fn.rgb(rgbs) return the field dict.
    fn.blob_spec, fn.esc_cap and fn.n_mb describe the output;
    fn.sharp_yuv says whether the RGB entries import with sharp YUV.
    With planar=False every entry runs encode_one, the non-planar
    formulation, in place of the batched planar program.
    """

    def __init__(self, mb_w, mb_h, quality, segments, sns_strength,
                 i4_blocks, rd_drop, sharp_yuv=False, sk=1, trellis=False,
                 i4_mode_search=False, planar=True, uv_ac=False):
        self.mb_w, self.mb_h = mb_w, mb_h
        self.quality = int(quality)
        self.segments = int(segments)
        self.sns = max(0, int(sns_strength))
        self.i4_blocks = bool(i4_blocks)
        self.rd_drop = float(rd_drop)
        self.sharp_yuv = bool(sharp_yuv)
        self.sk = int(sk)
        self.trellis = bool(trellis)
        self.search = bool(i4_mode_search) and self.i4_blocks
        self.n_mb = mb_w * mb_h
        self.use_segments = self.segments > 1 and self.n_mb >= 4
        self.esc_cap = max(1024, ESC_BLOCKS_PER_MB * self.n_mb)
        self.blob_spec = blob_spec_of(self.n_mb, self.esc_cap)
        self.planar = bool(planar)
        self.uv_ac = bool(uv_ac)

    def _segment_plan(self, src_rows, B, tabs):
        """Phase 0 of the segmented configuration: alphas (kernel 1), the
        k-means plans and the per-image quant rows and lambdas (the
        _plan_tables tuple)."""
        from . import phase1p as P1

        alphas = P1.alphas_planar(src_rows, B, self.n_mb)
        return _plan_tables(*P1.plan_segments_planar(
            alphas, B, self.n_mb, self.quality, self.sns, self.segments),
            self.sns, tabs, self.uv_ac)

    def part1_batched(self, Yb, Ub, Vb):
        """Phase 0 (alphas, segment plan; segmented configuration only),
        phase 1 (I16/UV search) and the I4 search (when on) over the fused
        batch x MB lane axis."""
        from . import i4 as I4
        from . import phase1p as P1

        tabs = device_tables(str(Yb.device))
        B = Yb.shape[0]
        mb_w, mb_h, n_mb = self.mb_w, self.mb_h, self.n_mb
        src_rows, srcs = P1.build_src(Yb, Ub, Vb, mb_w, mb_h)
        seg_map, seg_q, seg_beta, qtabs, lams, tlsd4, dq_uv_b = (
            self._segment_plan(src_rows, B, tabs) if self.use_segments
            else _single_plan(self.quality, self.sns, B, n_mb, Yb.device))
        modes, uvmodes, i16_score = P1.phase1_planar(
            src_rows, srcs, qtabs, lams["i16"], lams["uv"], tlsd4, seg_map,
            mb_w, mb_h, lam_mode4=lams["mode"])
        if self.i4_blocks:
            # At skew 2 the loop reconstructs each MB's above-right
            # neighbour first, so the rightmost subblock column may take
            # the strip-reading modes (allow_tr).
            is_i4, i4_modes, _ = I4.i4_search(
                Yb, seg_map, qtabs[:, :16].contiguous(), lams["i4"],
                lams["mode"], tlsd4, i16_score, mb_w, mb_h,
                allow_tr=self.sk == 2)
        else:
            is_i4 = torch.zeros((B, n_mb), dtype=torch.bool, device=Yb.device)
            i4_modes = torch.zeros((B, n_mb, 16), dtype=torch.uint8,
                                   device=Yb.device)
        return (modes, uvmodes, is_i4, i4_modes, seg_map, seg_q, seg_beta,
                qtabs, dq_uv_b, lams)

    def phase2(self, Yb, Ub, Vb, p1):
        """Phase 2 on the modes of part1_batched (p1) -> wire dict
        {packed, esc_idx, esc_val, esc_cnt, y2, skip}. At skew 1 without
        trellis or search: kernel 4 (ops/p2_kernel.py), the wavefront and
        the pack of its levels. Otherwise the planar step loop
        (planar.phase2_planar) and the unskewed pack; with the in-loop
        search the wire dict also carries the loop's is_i4, i4_modes and
        uvmodes, which replace phase 1's."""
        from . import p2_kernel as P2K
        from . import planar as PL

        modes, uvmodes, is_i4, i4_modes, seg_map, _, _, qtabs, _, lams = p1
        if self.sk == 1 and not self.trellis and not self.search:
            return P2K.phase2_pack(Yb, Ub, Vb, modes, uvmodes, is_i4,
                                   i4_modes, seg_map, qtabs, self.rd_drop,
                                   self.esc_cap)
        # The unsegmented configuration's rows and lambdas are the same in
        # every segment, so one segmented call covers both.
        seg_rows = _seg_rows(qtabs)
        search = None
        if self.search:
            search = (None, lams["i4"], lams["i16"], lams["uv"],
                      lams["mode"])
        out = PL.phase2_planar(
            Yb, Ub, Vb, modes, uvmodes, None, self.mb_w, self.mb_h,
            rd_drop=self.rd_drop, seg=(seg_map, seg_rows),
            i4=(is_i4, i4_modes) if self.i4_blocks else None, sk=self.sk,
            trellis=self.trellis, i4_search=search,
            graph=Yb.device.type == "cuda")
        wire = wire_from_levels(out[0], out[1], self.esc_cap)
        if search is not None:
            wire.update(i4_modes=out[4], is_i4=out[5], uvmodes=out[6])
        return wire

    def __call__(self, Yb, Ub, Vb):
        """Yb [B, H, W], Ub/Vb [B, H/2, W/2] u8 -> field dict [B, ...]."""
        if not self.planar:
            return self.encode_one(Yb, Ub, Vb)
        p1 = self.part1_batched(Yb, Ub, Vb)
        return self.pack(self.phase2(Yb, Ub, Vb, p1), p1)

    def encode_one(self, Yb, Ub, Vb):
        """The non-planar formulation (the reference's encode_one, over
        the batch): phase 0 and phase 1 as PyTorch operations
        (_segment_plan_device, _phase1), the I4 search through kernel 3
        (_i4_dispatch, one launch for the batch) and phase 2 as the step
        loop (_phase2), then the pack. Same field dict and blob layout as
        the planar program. As the reference's, it honours the segments,
        SNS, I4, rd_drop, the skew and the import, and ignores the trellis
        and the in-loop search."""
        Y, U, V = (p.to(torch.int32) for p in (Yb, Ub, Vb))
        B = Y.shape[0]
        if self.use_segments:
            plan = _plan_tables(*_segment_plan_device(
                Y, U, V, self.mb_w, self.mb_h, self.quality, self.sns,
                self.segments), self.sns, device_tables(str(Y.device)),
                self.uv_ac)
        else:
            plan = _single_plan(self.quality, self.sns, B, self.n_mb,
                                Y.device)
        return _encode_planned(Y, U, V, plan, self.mb_w, self.mb_h,
                               self.i4_blocks, self.rd_drop, self.esc_cap,
                               sk=self.sk)[0]

    def pack(self, wire, p1):
        """The wire fields of phase2 plus the per-MB side fields of p1 ->
        field dict [B, ...] (the in-loop search's modes and split, when
        phase2 carries them, in place of phase 1's)."""
        (modes, uvmodes, is_i4, i4_modes, seg_map, seg_q, seg_beta,
         _, dq_uv_b, _) = p1
        wire = dict(wire)
        is_i4 = wire.pop("is_i4", is_i4)
        i4_modes = wire.pop("i4_modes", i4_modes)
        uvmodes = wire.pop("uvmodes", uvmodes)
        B = modes.shape[0]
        imodes = torch.where(
            is_i4[..., None], i4_modes,
            torch.cat([modes[..., None],
                       modes.new_zeros((B, self.n_mb, 15))], dim=-1))
        return dict(wire, modes=modes, uvmodes=uvmodes, is_i4=is_i4,
                    imodes=imodes, seg_map=seg_map.to(torch.uint8),
                    seg_q=seg_q, seg_beta=seg_beta, dq_uv=dq_uv_b)

    def blob(self, Yb, Ub, Vb):
        """YUV 4:2:0 planes (u8 [B, H, W], [B, H/2, W/2]) on the device ->
        blob chunks."""
        return _blobify(self(Yb, Ub, Vb))

    def to_yuv(self, rgbs):
        """uint8 [B, H, W, 3] -> YUV 4:2:0 planes on the same device: the
        sharp-YUV refinement (ops/sharpyuv.py) or the plain import."""
        if self.sharp_yuv:
            from . import sharpyuv

            return sharpyuv.sharp_yuv420(rgbs)
        from . import yuv as devyuv

        return devyuv.rgb_to_yuv420(rgbs)

    def rgb(self, rgbs):
        """rgbs: uint8 [B, H, W, 3] on the device -> field dict."""
        return self(*self.to_yuv(rgbs))

    def rgb_blob(self, rgbs):
        """rgbs: uint8 [B, H, W, 3] on the device -> blob chunks."""
        return _blobify(self.rgb(rgbs))

    def rgbp_blob(self, rgbps):
        """rgbps: uint8 [B, 3, H, W] planes on the device -> blob chunks."""
        if self.sharp_yuv:
            return self.rgb_blob(rgbps.permute(0, 2, 3, 1))
        from . import yuv as devyuv

        return _blobify(self(*devyuv.rgb_planes_to_yuv420(
            rgbps[:, 0], rgbps[:, 1], rgbps[:, 2])))


def fast_encode_fn(mb_w: int, mb_h: int, quality: int, segments: int = 1,
                   sns_strength: int = 0, i4_blocks: bool = True,
                   sharp_yuv: bool = False, rd_drop: float = 1024.0,
                   sk: int = 1, trellis: bool = False,
                   i4_mode_search: bool = False, planar: bool = True,
                   uv_ac: bool = False):
    """The batched encoder for one geometry (cached). rd_drop enables the
    trellis-lite RD dropout inside the closed loop (ops/planar.py
    quantize_p); sharp_yuv imports RGB with the sharp-YUV refinement;
    sk=2 runs the closed loop at skew 2 (the I4 search may then take the
    strip-reading modes on the rightmost subblock column); trellis
    requantizes the I4 subblocks with the trellis in the loop; and
    i4_mode_search re-runs the I4 and UV searches and the I16-vs-I4 split
    in the loop on exact rates (methods 5 and 6 set sk=2 and trellis, 6
    also the search). planar=False runs the non-planar formulation
    (FastEncoder.encode_one; the reference's program with its planar path
    switched off), which ignores the trellis and the search. uv_ac
    derives each image's chroma AC quantizer delta from its mean UV alpha
    (_uv_deltas; segmented configurations only: the unsegmented plan has
    no delta), as the reference does with its chroma AC switch set; it is
    part of the cache key (the reference's cache leaves its switch out,
    so a toggle there reuses the stale program)."""
    if sk not in (1, 2):
        raise ValueError(f"fast_encode_fn: skew {sk} (1 or 2)")
    return _fast_encode_fn(int(mb_w), int(mb_h), int(quality), int(segments),
                           int(sns_strength), bool(i4_blocks), float(rd_drop),
                           bool(sharp_yuv), int(sk), bool(trellis),
                           bool(i4_mode_search), bool(planar), bool(uv_ac))


@functools.lru_cache(maxsize=8)
def _fast_encode_fn(*args):
    trace.count(trace.PROGRAMS, "built")
    return FastEncoder(*args)

