"""Phase-2 wavefront kernel: the closed-loop reconstruction wavefront with
the modes of phase 1 fixed and the fused pack of its levels, a
hand-written CUDA kernel (csrc/p2_wavefront.cu) beside its plain PyTorch
version. Counterpart of webp_tpu/ops/pallas_p2.py.

Inputs, unskewed, per image and macroblock (raster order, n_mb = mb_w *
mb_h):

  Y u8 [B, H, W], U/V u8 [B, H/2, W/2]  the source planes;
  modes, uvmodes u8 [B, n_mb]  I16 and chroma modes (DC, TM, V, H);
  is_i4 bool [B, n_mb], i4_modes u8 [B, n_mb, 16]  the I4 split and the
       subblock modes (raster subblocks; DC, TM, VE, HE, RD, VR, LD, VL, HD,
       HU);
  seg_map i32 [B, n_mb];
  qtab i32 [B, 48, 16]  quant rows, row = type*16 + seg*4 + param (types
       y1/y2/uv, params q/iq/bias/sharpen), zigzag columns (as
       ops/p1_kernels.py).

Both versions return the wire fields of the reference's default path
(phase2_planar, then fastpath._pack_levels and the skip flag): packed u8
[B, n_mb, 24, 8], esc_idx i32 [B, K], esc_val i16 [B, K, 16], esc_cnt i32
[B], y2 i16 [B, n_mb, 16], skip bool [B, n_mb], K = min(esc_cap, 24 n_mb).
The TPU kernel's own pack (nibbles zeroed per escaping block, an int8
escape plane with a forced host fallback above |level| 127) is not carried
over: it saved VMEM and HBM, which the card does not need to save, and
this format keeps the card's files byte-identical to the CPU's.
"""

from __future__ import annotations

import numpy as np
import torch

from . import cuda
from .fastpath import wire_from_levels
from .planar import phase2_planar


def _wire(packed, esc_idx, esc_val, esc_cnt, y2, skip):
    return {"packed": packed, "esc_idx": esc_idx, "esc_val": esc_val,
            "esc_cnt": esc_cnt, "y2": y2, "skip": skip}


def phase2_pack_plain(Y, U, V, modes, uvmodes, is_i4, i4_modes, seg_map,
                      qtab, rd_drop, esc_cap):
    """Plain version of csrc/p2_wavefront.cu: the step loop
    planar.phase2_planar, then the per-MB pack formulas. A batch with no
    I4 MB (is_i4 all zero: the I4-off configuration) skips the I4
    reconstruction, whose levels no MB would take."""
    B, H, W = Y.shape
    seg_rows = dict(zip(("y1", "y2", "uv"),
                        qtab.reshape(B, 3, 4, 4, 16).unbind(1)))
    lv24, y2 = phase2_planar(
        Y, U, V, modes, uvmodes, None, W // 16, H // 16, rd_drop=rd_drop,
        seg=(seg_map, seg_rows),
        i4=(is_i4, i4_modes) if bool(is_i4.any()) else None)[:2]
    return wire_from_levels(lv24, y2, esc_cap)


def phase2_pack(Y, U, V, modes, uvmodes, is_i4, i4_modes, seg_map, qtab,
                rd_drop: float, esc_cap: int):
    """Phase 2 and the pack over a batch: the CUDA kernel (one launch for
    the whole wavefront, then its escape-list kernel) for CUDA tensors, the
    plain version for CPU tensors. Returns the wire dict (module
    docstring). The unsegmented and I4-off configurations pass a zero
    seg_map (with each segment's rows of qtab the quality's one set) and a
    zero is_i4, as the reference's Pallas kernel gets them
    (pallas_p2.py:573-592)."""
    cuda.check("Y", Y, torch.uint8, (None, None, None))
    B, H, W = Y.shape
    if B == 0 or H % 16 or W % 16 or H == 0 or W == 0:
        raise ValueError(f"phase2_pack: planes {tuple(Y.shape)} are not a "
                         "batch of whole macroblocks")
    mb_w, mb_h = W // 16, H // 16
    n_mb = mb_w * mb_h
    cuda.check("U", U, torch.uint8, (B, H // 2, W // 2))
    cuda.check("V", V, torch.uint8, (B, H // 2, W // 2))
    cuda.check("modes", modes, torch.uint8, (B, n_mb))
    cuda.check("uvmodes", uvmodes, torch.uint8, (B, n_mb))
    cuda.check("is_i4", is_i4, torch.bool, (B, n_mb))
    cuda.check("i4_modes", i4_modes, torch.uint8, (B, n_mb, 16))
    cuda.check("seg_map", seg_map, torch.int32, (B, n_mb))
    cuda.check("qtab", qtab, torch.int32, (B, 48, 16))
    args = (Y, U, V, modes, uvmodes, is_i4, i4_modes, seg_map, qtab)
    if cuda.on_cpu(*args):
        return phase2_pack_plain(*args, rd_drop, esc_cap)
    return _wire(*wavefront(*args, rd_drop, esc_cap))


MAX_CLUSTER = 8      # the portable thread block cluster size
THREADS = 512        # per block in csrc/p2_wavefront.cu: 8 MB slots x 2 warps


def cluster_size(B: int, mb_h: int, n_sm: int) -> int:
    """Thread blocks per image of the kernel (one cluster each): the
    largest power of two C <= 8 with B * C <= n_sm and C <= mb_h, or 1 when
    no C > 1 qualifies. 8 at B = 16 on 132 SMs, 1 at B = 128."""
    c = MAX_CLUSTER
    while c > 1 and (B * c > n_sm or c > mb_h):
        c //= 2
    return c


def sm_count(dev) -> int:
    return torch.cuda.get_device_properties(dev).multi_processor_count


def i4_taps() -> np.ndarray:
    """The kernel's per-pixel I4 predictor table, uint16 [10, 16] (mode,
    raster pixel r*4 + c), over the subblock's 13 contour pixels e = l3 l2
    l1 l0 tl t0 t1 t2 t3 tr0 tr1 tr2 tr3: bits 0-3, 4-7 and 8-11 hold
    three indices into e, bits 12-13 the operation: 0 avg3 (the middle
    index is the centre), 1 avg2 of the first two, 2 TM (e0 + e1 - e2,
    clamped), 3 DC. Equal to planar.pred4_all_p (tests/test_torch_p2_kernel.py)."""
    def a3(i):                    # avg3 centred on i, clamped to e's ends
        return (0, max(i - 1, 0), i, min(i + 1, 12))

    def a2(i):
        return (1, max(i, 0), min(i + 1, 12), 0)

    def s3(k): return a3(k + 1)
    def s2(k): return a2(k)
    def s3h(k): return a3(3 - k)          # lr = tl l0 l1 l2 l3 l3
    def s2h(k): return (1, 4 - k, max(3 - k, 0), 0)

    l3 = (1, 0, 0, 0)                  # avg2(l3, l3)
    tab = np.zeros((10, 16), np.uint16)
    for r in range(4):
        for c in range(4):
            hd0 = [s2h(0), s3(3), s3(4), s3(5)]
            hd1 = [s2h(1), s3h(0), hd0[0], hd0[1]]
            hd2 = [s2h(2), s3h(1), hd1[0], hd1[1]]
            hd3 = [s2h(3), s3h(2), hd2[0], hd2[1]]
            hu0 = [s2h(1), s3h(1), s2h(2), s3h(2)]
            hu1 = [hu0[2], hu0[3], s2h(3), s3h(3)]
            hu2 = [hu1[2], hu1[3], l3, l3]
            vr = [s2(4 + c), s3(3 + c), s3(2) if c == 0 else s2(3 + c),
                  s3(1) if c == 0 else s3(2 + c)][r]
            vl = [s2(5 + c), s3(5 + c), s2(6 + c) if c < 3 else s3(9),
                  s3(6 + c) if c < 3 else s3(10)][r]
            ops = [(3, 0, 0, 0), (2, 3 - r, 5 + c, 4), s3(4 + c), s3h(r),
                   s3(3 - r + c), vr, s3(5 + r + c) if r + c < 6 else a3(12),
                   vl, [hd0, hd1, hd2, hd3][r][c],
                   [hu0, hu1, hu2, [l3] * 4][r][c]]
            for mode, (op, i0, i1, i2) in enumerate(ops):
                tab[mode, r * 4 + c] = op << 12 | i2 << 8 | i1 << 4 | i0
    return tab


_taps: dict = {}


def _taps_on(dev) -> torch.Tensor:
    t = _taps.get(dev)
    if t is None:
        t = _taps[dev] = torch.as_tensor(i4_taps().astype(np.int16)).to(dev)
    return t


def wavefront(Y, U, V, modes, uvmodes, is_i4, i4_modes, seg_map, qtab,
              rd_drop: float, esc_cap: int):
    """The kernel's launch alone, on card tensors that phase2_pack has
    checked: the wire fields (packed, esc_idx, esc_val, esc_cnt, y2, skip)
    in the order of _wire. The wavefront kernel runs cluster_size(B, H /
    16, SMs) blocks per image; its level plane and per-MB flag words stay
    on the card for the escape-list kernel launched after it."""
    B, H, W = Y.shape
    mb_w, mb_h = W // 16, H // 16
    n_mb = mb_w * mb_h
    K = min(esc_cap, n_mb * 24)
    dev = Y.device
    C = cluster_size(B, mb_h, sm_count(dev))

    def out(shape, dtype):
        return torch.empty(shape, dtype=dtype, device=dev)

    packed, y2 = out((B, n_mb, 24, 8), torch.uint8), out((B, n_mb, 16),
                                                          torch.int16)
    levels, flags = out((B, n_mb * 24, 16), torch.int16), out((B, n_mb, 2),
                                                               torch.int32)
    esc_idx, esc_val = out((B, K), torch.int32), out((B, K, 16), torch.int16)
    esc_cnt, skip = out((B,), torch.int32), out((B, n_mb), torch.bool)
    cuda.launch("p2_wavefront", Y, U, V, modes, uvmodes, is_i4, i4_modes,
                seg_map, qtab, _taps_on(dev), B, mb_w, mb_h, C, K, rd_drop,
                rd_drop * 3.5, packed, levels, y2, flags, esc_idx, esc_val,
                esc_cnt, skip)
    return packed, esc_idx, esc_val, esc_cnt, y2, skip
