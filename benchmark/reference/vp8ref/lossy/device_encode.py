"""The lossy encode's device program and host tail for one image,
trimmed from the measured package's lossy/device_encode.py: the device
program (ops/fastpath.py, plain versions) and the host tail (level
unpacking, Python entropy coding, VP8 frame assembly). An image whose
escape list overflows the device program's capacity is re-encoded by
the host encoder (lossy/encode.py), as the measured package does.
"""

from __future__ import annotations

import numpy as np
import torch

from ..encoder import rgb_to_yuv420
from . import tables as T
from .encode import LossyConfig, VP8Encoder


def _resolve_device(device) -> torch.device:
    """None means the card; an explicit "cpu" runs the plain versions."""
    return torch.device("cuda" if device is None else device)


def planeless(width: int, height: int, cfg: LossyConfig):
    """A DeviceVP8Encoder with zero host planes: the device computes every
    field and the host plan is trivial (one segment, no SNS), so the host
    planes are read only by the overflow fallback, which imports its own."""
    mb_w, mb_h = (width + 15) >> 4, (height + 15) >> 4
    y = np.zeros((mb_h * 16, mb_w * 16), np.uint8)
    uv = np.zeros((mb_h * 8, mb_w * 8), np.uint8)
    return DeviceVP8Encoder(y, uv, uv, width, height, cfg)


class DeviceVP8Encoder(VP8Encoder):
    """VP8Encoder whose MB loop runs on the device (two-phase fast path).

    Segmentation/SNS runs on the device too (fastpath phase 0); the host
    plan is pinned trivial at init and replaced with the device plan after
    the launch.
    """

    rgb_input = None  # uint8 [H, W, 3], padded to whole MBs, for encode()
    dithering = 0.0   # the fallback's host import (rgb_to_yuv420)

    def __init__(self, y, u, v, width, height, cfg):
        import dataclasses

        self.dev_segments = max(1, min(4, cfg.segments))
        self.dev_sns = max(0, cfg.sns_strength)
        cfg = dataclasses.replace(cfg, segments=1, sns_strength=0)
        super().__init__(y, u, v, width, height, cfg)

    def encode(self, device=None, uv_ac: bool = False) -> bytes:
        """One image (rgb_input) through the device program at B=1, its
        YUV import on the device, and the host tail. An escape list that
        overflows the device's capacity re-encodes the image with the exact
        host encoder, from host planes imported then (with self.dithering;
        with sharp YUV, the host sharp converter's planes of the padded
        image, as the reference's). device: None for the card, "cpu" for
        the plain versions. Methods 0-2 (or i4_blocks off) run without
        the I4 search; methods 5 and 6 run the closed loop at skew 2 with
        the trellis, 6 with the in-loop search. uv_ac: the chroma AC
        quantizer delta from the image's mean UV alpha
        (fast_encode_fn's); the overflow fallback, on the host, does not
        read it (the host encoder's own analysis sets that delta)."""
        from ..ops.fastpath import fast_encode_fn, unpack_output_blob

        use_i4 = bool(self.cfg.i4_blocks) and self.cfg.method >= 3
        sk = 2 if self.cfg.method >= 5 and use_i4 else 1
        # uv_ac is passed only when set: the default call configures the
        # program with the reference's own arguments.
        fn = fast_encode_fn(self.mb_w, self.mb_h, self.cfg.quality,
                            self.dev_segments, self.dev_sns, use_i4,
                            sharp_yuv=bool(self.cfg.sharp_yuv), sk=sk,
                            trellis=self.cfg.method >= 5 and use_i4,
                            i4_mode_search=self.cfg.method >= 6 and use_i4,
                            **({"uv_ac": True} if uv_ac else {}))
        out = fn.rgb_blob(torch.from_numpy(np.ascontiguousarray(
            self.rgb_input[None])).to(_resolve_device(device)))
        self.recon = fn.last_recon
        host = unpack_output_blob([c.cpu().numpy() for c in out],
                                  fn.blob_spec)
        if int(host["esc_cnt"][0]) > fn.esc_cap:
            FALLBACKS["images"] += 1
            self.recon = None
            if fn.sharp_yuv:
                Y, U, V = _fallback_planes(self.rgb_input, fn)
            else:
                Y, U, V = rgb_to_yuv420(
                    self.rgb_input[:self.height, :self.width],
                    self.dithering)
            return VP8Encoder(Y, U, V, self.width, self.height,
                              self.cfg).encode()
        return self.finish({k: v[0] for k, v in host.items()})

    def finish(self, out_i: dict) -> bytes:
        """Host tail for one image's device fields: unpack the levels,
        install the device's segment plan, entropy-code, assemble."""
        from ..ops.fastpath import unpack_levels

        mb_w, mb_h = self.mb_w, self.mb_h
        lv24 = unpack_levels(out_i["packed"], out_i["esc_idx"],
                             out_i["esc_val"], out_i["esc_cnt"], mb_w * mb_h)
        self.proba = T.COEFFS_PROBA0.copy()
        self.levels = lv24.astype(np.int32).reshape(mb_h, mb_w, 24, 16)
        self.y2_levels = out_i["y2"].astype(np.int32).reshape(mb_h, mb_w, 16)
        self.imodes = out_i["imodes"].reshape(mb_h, mb_w, 16).copy()
        self.uvmode = out_i["uvmodes"].reshape(mb_h, mb_w)
        self.skip = out_i["skip"].reshape(mb_h, mb_w).copy()
        self.is_i4 = out_i["is_i4"].reshape(mb_h, mb_w).copy()
        self.apply_device_plan(out_i["seg_map"], out_i["seg_q"],
                               out_i["seg_beta"], dq_uv=out_i.get("dq_uv"))
        return self._finish_bitstream()

    def apply_device_plan(self, seg_map, seg_q, seg_beta,
                          dq_uv=None) -> None:
        """Installs the device-computed segmentation into the header plan.
        dq_uv: optional (dq_uv_dc, dq_uv_ac) the device quantized chroma
        with — written into the frame header."""
        if self.dev_segments <= 1 or self.mb_h * self.mb_w < 4:
            return
        from .analysis import finalize_device_plan

        plan = finalize_device_plan(seg_map, seg_q, seg_beta,
                                    self.cfg.filter_strength,
                                    self.cfg.filter_sharpness)
        if dq_uv is not None:
            plan.dq_uv_dc = int(dq_uv[0])
            plan.dq_uv_ac = int(dq_uv[1])
        self.plan = plan
        self.num_segments = plan.num_segments
        self.segment_map = plan.segment_map.reshape(self.mb_h, self.mb_w)
        self.base_q = plan.quant[0]
        if self.cfg.filter_strength > 0:
            self.filter_level = plan.fstrength[0]

    def _finish_bitstream(self) -> bytes:
        total = self.mb_h * self.mb_w
        self.num_skip = int(self.skip.sum())
        self.skip_proba = max(1, min(255, (total - self.num_skip) * 255 // total)) \
            if self.num_skip > 0 else 0
        self.use_skip = self.num_skip > 0
        if not self.use_skip:
            self.skip[:] = False

        self._optimize_probas()
        parts = [self._emit_tokens(i) for i in range(self.num_parts)]
        if self.cfg.autofilter:
            raise NotImplementedError("the reference has no autofilter")
        part0 = self._emit_partition0()
        self.stats_part0 = len(part0)
        self.stats_parts = [len(p) for p in parts]
        return self._assemble_vp8(part0, parts)

    def _assemble_vp8(self, part0, parts) -> bytes:
        tag = (0) | (0 << 1) | (1 << 4) | (len(part0) << 5)
        out = bytearray([tag & 0xFF, (tag >> 8) & 0xFF, (tag >> 16) & 0xFF])
        out += bytes([0x9D, 0x01, 0x2A])
        out += int(self.width & 0x3FFF).to_bytes(2, "little")
        out += int(self.height & 0x3FFF).to_bytes(2, "little")
        out += part0
        for p in parts[:-1]:
            out += len(p).to_bytes(3, "little")
        for p in parts:
            out += p
        return bytes(out)


FALLBACKS = {"images": 0}


def pad_to_macroblocks(rgbs):
    """uint8 [B, h, w, 3] -> [B, H, W, 3] with H, W the next multiples of
    16, the last row and column replicated (the input itself when no
    padding is needed)."""
    B, h, w = rgbs.shape[:3]
    if h % 16 == 0 and w % 16 == 0:
        return rgbs
    pad = np.zeros((B, (h + 15) // 16 * 16, (w + 15) // 16 * 16, 3), np.uint8)
    pad[:, :h, :w] = rgbs
    pad[:, h:, :w] = rgbs[:, h - 1:h, :]
    pad[:, :, w:] = pad[:, :, w - 1:w]
    return pad


def _fallback_planes(rgb, fn):
    """Host YUV planes for the escape-overflow fallback, from the import
    the device program used: the host sharp converter when fn imports
    with sharp YUV, else the plain importer."""
    if fn.sharp_yuv:
        raise NotImplementedError("the reference has no sharp YUV import")
    return rgb_to_yuv420(rgb)
