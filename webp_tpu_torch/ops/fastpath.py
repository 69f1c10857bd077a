"""Batched two-phase device VP8 encoder (PyTorch port of
webp_tpu/ops/fastpath.py, the batched planar main path).

  Phase 0 — segment analysis: per-MB texture alphas (kernel 1,
    ops/p1_kernels.py), a per-image k-means over the alpha histogram and
    the SNS quant curve.
  Phase 1 — fully parallel mode search with source-pixel context: I16 and
    UV (kernel 2, ops/p1_kernels.py), then the 10-mode I4 search
    (kernel 3, ops/i4_kernel.py) and the I4-vs-I16 split.
  Phase 2 — the closed-loop skew-1 wavefront with modes fixed
    (ops/planar.py phase2_planar), then nibble packing and the escape list.

Configuration ported: segments > 1, SNS, I4 on, skew 1, rd_drop, no
trellis, no in-loop search, no sharp-YUV. Other configurations raise
NotImplementedError. The quantizer, lambda and rate tables are derived
here from the port's own lossy/ copies and moved to the device by
tables_from_numpy().
"""

from __future__ import annotations

import functools
from types import SimpleNamespace

import numpy as np
import torch

from ..lossy import tables as T
from ..lossy.cost import (
    ENTROPY_COST,
    LEVEL_FIXED_COSTS,
    FIXED_COSTS_I4,
    compute_level_cost_tables,
)
from ..lossy.encode import FIXED_COSTS_I16, FIXED_COSTS_UV, quality_to_qindex

BANDS = np.asarray(T.BANDS[:16])

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

def _uv_deltas(guv, sns):
    """UV quantizer deltas (reference setSegmentParams,
    encode_analysis.go:163-170): the DC delta follows the SNS strength;
    the AC delta is off (the reference's default). Returns (dq_uv_dc int,
    dq_uv_ac int32 tensor like guv)."""
    dq_dc = max(-15, min(15, -4 * sns // 100))
    return dq_dc, torch.zeros_like(guv, dtype=torch.int32)


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
# Device-side nibble packing.
# ---------------------------------------------------------------------------

def _pack_levels(lv24, esc_cap):
    """lv24: int16 [B, n_mb, 24, 16] -> (packed u8 [B, n_mb, 24, 8],
    esc_idx i32 [B, K] block indices, esc_blk i16 [B, K, 16],
    esc_cnt i32 [B]), K = min(esc_cap, 24 * n_mb).

    Escape compaction by an ascending sort of the flagged block indices
    (unflagged blocks sort last as a sentinel, read back as index 0): the
    same order and fill as the reference."""
    B = lv24.shape[0]
    v = lv24.to(torch.int32)
    esc = v.abs() > 7
    nib = torch.where(esc, 0, v.clamp(-7, 7) + 8).to(torch.uint8)
    packed = nib[..., 0::2] | (nib[..., 1::2] << 4)
    blk = esc.any(dim=-1).reshape(B, -1)                     # [B, n_blk]
    n_blk = blk.shape[1]
    ar = torch.arange(n_blk, dtype=torch.int32, device=lv24.device)
    keys = torch.where(blk, ar, n_blk)
    idx = torch.sort(keys, dim=1).values[:, :esc_cap]
    idx = torch.where(idx >= n_blk, 0, idx)
    blocks = torch.gather(lv24.reshape(B, n_blk, 16), 1,
                          idx.long()[..., None].expand(*idx.shape, 16))
    return packed, idx, blocks, blk.sum(dim=1).to(torch.int32)


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

    fn.rgb_blob(rgbs [B, H, W, 3] u8) and fn.rgbp_blob(rgbps [B, 3, H, W]
    u8) run the whole device program on the inputs' device and return
    the blob chunks (see _blobify); fn(Yb, Ub, Vb) returns the field dict.
    fn.blob_spec, fn.esc_cap and fn.n_mb describe the output.
    """

    def __init__(self, mb_w, mb_h, quality, segments, sns_strength,
                 i4_blocks, rd_drop):
        self.mb_w, self.mb_h = mb_w, mb_h
        self.quality = int(quality)
        self.segments = int(segments)
        self.sns = max(0, int(sns_strength))
        self.rd_drop = float(rd_drop)
        self.n_mb = mb_w * mb_h
        self.esc_cap = max(1024, ESC_BLOCKS_PER_MB * self.n_mb)
        self.blob_spec = blob_spec_of(self.n_mb, self.esc_cap)
        if not (self.segments > 1 and self.n_mb >= 4 and i4_blocks):
            raise NotImplementedError(
                "fast_encode_fn: only the segmented I4 configuration "
                "(segments > 1, >= 4 macroblocks, i4_blocks) is ported")

    def part1_batched(self, Yb, Ub, Vb):
        """Phase 0 (alphas, segment plan), phase 1 (I16/UV search) and the
        I4 search over the fused batch x MB lane axis."""
        from . import i4 as I4
        from . import phase1p as P1

        tabs = device_tables(str(Yb.device))
        B = Yb.shape[0]
        mb_w, mb_h, n_mb = self.mb_w, self.mb_h, self.n_mb
        sns = self.sns
        src_rows, srcs = P1.build_src(Yb, Ub, Vb, mb_w, mb_h)
        alphas = P1.alphas_planar(src_rows, B, n_mb)
        seg_map, seg_q, seg_beta, guv = P1.plan_segments_planar(
            alphas, B, n_mb, self.quality, sns, self.segments)
        dq_dc, dq_ac = _uv_deltas(guv, sns)                    # [B]
        qi = seg_q.long()
        seg_rows = {k: tabs.q[k][qi] for k in ("y1", "y2")}    # [B,4,4,16]
        seg_rows["uv"] = _uv_rows_delta(seg_q, dq_dc, dq_ac, tabs)
        lam16_4b = tabs.lam_i16[qi]
        lamuv_4b = _lam_uv_of(seg_rows["uv"])
        lam4_4b = tabs.lam_i4[qi]
        lammd_4b = tabs.lam_mode[qi]
        tlsd4 = (((sns * tabs.qi4[qi]) >> 5).to(torch.float32)
                 if sns > 0 else None)
        dq_uv_b = torch.stack([torch.full_like(dq_ac, dq_dc), dq_ac], dim=1)
        qtabs = torch.stack([seg_rows[k] for k in ("y1", "y2", "uv")],
                            dim=1).reshape(B, 48, 16).contiguous()
        modes, uvmodes, i16_score = P1.phase1_planar(
            src_rows, srcs, qtabs, lam16_4b, lamuv_4b, tlsd4, seg_map, mb_w,
            mb_h, lam_mode4=lammd_4b)
        is_i4, i4_modes, _ = I4.i4_search(
            Yb, seg_map, seg_rows["y1"].reshape(B, 16, 16), lam4_4b,
            lammd_4b, tlsd4, i16_score, mb_w, mb_h)
        return (modes, uvmodes, is_i4, i4_modes, seg_map, seg_q, seg_beta,
                seg_rows, dq_uv_b)

    def phase2(self, Yb, Ub, Vb, p1):
        """The closed-loop wavefront with the modes of part1_batched (p1)
        fixed -> (lv24 [B, n_mb, 24, 16] i16, y2 [B, n_mb, 16] i16)."""
        from . import planar as PL

        modes, uvmodes, is_i4, i4_modes, seg_map, _, _, seg_rows, _ = p1
        lv24, y2, _, _ = PL.phase2_planar(
            Yb, Ub, Vb, modes, uvmodes, None, self.mb_w, self.mb_h,
            rd_drop=self.rd_drop, seg=(seg_map, seg_rows),
            i4=(is_i4, i4_modes))
        return lv24, y2

    def __call__(self, Yb, Ub, Vb):
        """Yb [B, H, W], Ub/Vb [B, H/2, W/2] u8 -> field dict [B, ...]."""
        p1 = self.part1_batched(Yb, Ub, Vb)
        return self.pack(*self.phase2(Yb, Ub, Vb, p1), p1)

    def pack(self, lv24, y2, p1):
        """Nibble packing, escape list and the per-MB side fields ->
        field dict [B, ...]."""
        (modes, uvmodes, is_i4, i4_modes, seg_map, seg_q, seg_beta,
         _, dq_uv_b) = p1
        packed, esc_idx, esc_val, esc_cnt = _pack_levels(lv24, self.esc_cap)
        skip = (lv24 == 0).all(dim=-1).all(dim=-1) & (y2 == 0).all(dim=-1)
        B = lv24.shape[0]
        imodes = torch.where(
            is_i4[..., None], i4_modes,
            torch.cat([modes[..., None],
                       modes.new_zeros((B, self.n_mb, 15))], dim=-1))
        return {"packed": packed, "esc_idx": esc_idx, "esc_val": esc_val,
                "esc_cnt": esc_cnt, "y2": y2, "modes": modes,
                "uvmodes": uvmodes, "skip": skip, "is_i4": is_i4,
                "imodes": imodes, "seg_map": seg_map.to(torch.uint8),
                "seg_q": seg_q, "seg_beta": seg_beta, "dq_uv": dq_uv_b}

    def rgb_blob(self, rgbs):
        """rgbs: uint8 [B, H, W, 3] on the device -> blob chunks."""
        from . import yuv as devyuv

        return _blobify(self(*devyuv.rgb_to_yuv420(rgbs)))

    def rgbp_blob(self, rgbps):
        """rgbps: uint8 [B, 3, H, W] planes on the device -> blob chunks."""
        from . import yuv as devyuv

        return _blobify(self(*devyuv.rgb_planes_to_yuv420(
            rgbps[:, 0], rgbps[:, 1], rgbps[:, 2])))


def fast_encode_fn(mb_w: int, mb_h: int, quality: int, segments: int = 1,
                   sns_strength: int = 0, i4_blocks: bool = True,
                   sharp_yuv: bool = False, rd_drop: float = 1024.0,
                   sk: int = 1, trellis: bool = False,
                   i4_mode_search: bool = False):
    """The batched encoder for one geometry (cached). rd_drop enables the
    trellis-lite RD dropout inside the closed loop (ops/planar.py
    quantize_p); sharp_yuv, sk=2, trellis and i4_mode_search are not
    ported yet."""
    if sharp_yuv or sk != 1 or trellis or i4_mode_search:
        raise NotImplementedError(
            "fast_encode_fn: sharp-YUV, skew 2, trellis and the in-loop "
            "search are not ported")
    return _fast_encode_fn(int(mb_w), int(mb_h), int(quality), int(segments),
                           int(sns_strength), bool(i4_blocks), float(rd_drop))


@functools.lru_cache(maxsize=8)
def _fast_encode_fn(mb_w, mb_h, quality, segments, sns_strength, i4_blocks,
                    rd_drop):
    return FastEncoder(mb_w, mb_h, quality, segments, sns_strength,
                       i4_blocks, rd_drop)

