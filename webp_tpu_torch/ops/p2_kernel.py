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

import torch

from . import cuda
from .fastpath import _pack_levels, escape_list
from .planar import phase2_planar


def _wire(packed, esc_idx, esc_val, esc_cnt, y2, skip):
    return {"packed": packed, "esc_idx": esc_idx, "esc_val": esc_val,
            "esc_cnt": esc_cnt, "y2": y2, "skip": skip}


def phase2_pack_plain(Y, U, V, modes, uvmodes, is_i4, i4_modes, seg_map,
                      qtab, rd_drop, esc_cap):
    """Plain version of csrc/p2_wavefront.cu: the step loop
    planar.phase2_planar, then the per-MB pack formulas."""
    B, H, W = Y.shape
    seg_rows = dict(zip(("y1", "y2", "uv"),
                        qtab.reshape(B, 3, 4, 4, 16).unbind(1)))
    lv24, y2, _, _ = phase2_planar(
        Y, U, V, modes, uvmodes, None, W // 16, H // 16, rd_drop=rd_drop,
        seg=(seg_map, seg_rows), i4=(is_i4, i4_modes))
    skip = (lv24 == 0).all(dim=-1).all(dim=-1) & (y2 == 0).all(dim=-1)
    return _wire(*_pack_levels(lv24, esc_cap), y2, skip)


def phase2_pack(Y, U, V, modes, uvmodes, is_i4, i4_modes, seg_map, qtab,
                rd_drop: float, esc_cap: int):
    """Phase 2 and the pack over a batch: the CUDA kernel (one launch for
    the whole wavefront) for CUDA tensors, the plain version for CPU
    tensors. Returns the wire dict (module docstring)."""
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
    packed, levels, y2, bitmap, skip = wavefront(*args, rd_drop)
    bit = torch.arange(24, dtype=torch.int32, device=Y.device)
    flags = ((bitmap[..., None] >> bit) & 1).bool().reshape(B, n_mb * 24)
    return _wire(packed, *escape_list(flags, levels, esc_cap), y2,
                 skip.bool())


def wavefront(Y, U, V, modes, uvmodes, is_i4, i4_modes, seg_map, qtab,
              rd_drop: float):
    """The kernel's launch alone, on card tensors that phase2_pack has
    checked: packed u8 [B, n_mb, 24, 8], the int16 level plane [B, n_mb *
    24, 16], y2 i16 [B, n_mb, 16], the per-MB 24-bit escape bitmap i32 and
    skip u8 [B, n_mb]."""
    B, H, W = Y.shape
    n_mb = (W // 16) * (H // 16)
    dev = Y.device
    frames = (torch.empty_like(Y), torch.empty_like(U), torch.empty_like(V))
    packed = torch.empty((B, n_mb, 24, 8), dtype=torch.uint8, device=dev)
    levels = torch.empty((B, n_mb * 24, 16), dtype=torch.int16, device=dev)
    y2 = torch.empty((B, n_mb, 16), dtype=torch.int16, device=dev)
    bitmap = torch.empty((B, n_mb), dtype=torch.int32, device=dev)
    skip = torch.empty((B, n_mb), dtype=torch.uint8, device=dev)
    cuda.launch("p2_wavefront", Y, U, V, modes, uvmodes, is_i4, i4_modes,
                seg_map, qtab, B, W // 16, H // 16, rd_drop, rd_drop * 3.5,
                *frames, packed, levels, y2, bitmap, skip)
    return packed, levels, y2, bitmap, skip
