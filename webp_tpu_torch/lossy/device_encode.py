"""Device-accelerated lossy encode: the batched device program on the card
(ops/fastpath.py) plus the host tail — level unpacking, native entropy
coding and VP8 frame assembly. Counterpart of
webp_tpu/lossy/device_encode.py (its single-device batched path).

The device returns each image's fields as one byte blob (BLOB_CHUNKS
chunks); the host unpacks them, installs the device's segment plan into
the frame header and entropy-codes the levels. An image whose escape
list overflowed the device's capacity is re-encoded by the exact host
encoder.
"""

from __future__ import annotations

import concurrent.futures

import numpy as np
import torch

from ..encoder import rgb_to_yuv420
from . import tables as T
from .encode import LossyConfig, VP8Encoder


def _resolve_device(device) -> torch.device:
    """None means the card; an explicit "cpu" runs the plain versions."""
    return torch.device("cuda" if device is None else device)


def _finish_one(out_i: dict, mb_w: int, mb_h: int, width: int, height: int,
                cfg: LossyConfig) -> bytes:
    """Host tail for one image: unpack levels, entropy-code, frame-assemble."""
    from ..ops.fastpath import unpack_levels

    n_mb = mb_w * mb_h
    lv24 = unpack_levels(out_i["packed"], out_i["esc_idx"], out_i["esc_val"],
                         out_i["esc_cnt"], n_mb)
    dummyY = np.zeros((mb_h * 16, mb_w * 16), np.uint8)
    dummyU = np.zeros((mb_h * 8, mb_w * 8), np.uint8)
    enc = DeviceVP8Encoder(dummyY, dummyU, dummyU, width, height, cfg)
    enc.proba = T.COEFFS_PROBA0.copy()
    enc.levels = lv24.astype(np.int32).reshape(mb_h, mb_w, 24, 16)
    enc.y2_levels = out_i["y2"].astype(np.int32).reshape(mb_h, mb_w, 16)
    enc.imodes = out_i["imodes"].reshape(mb_h, mb_w, 16).copy()
    enc.uvmode = out_i["uvmodes"].reshape(mb_h, mb_w)
    enc.skip = out_i["skip"].reshape(mb_h, mb_w).copy()
    enc.is_i4 = out_i["is_i4"].reshape(mb_h, mb_w).copy()
    enc.apply_device_plan(out_i["seg_map"], out_i["seg_q"],
                          out_i["seg_beta"], dq_uv=out_i.get("dq_uv"))
    return enc._finish_bitstream()


class DeviceVP8Encoder(VP8Encoder):
    """VP8Encoder whose MB loop runs on the device (two-phase fast path).

    Segmentation/SNS runs on the device too (fastpath phase 0); the host
    plan is pinned trivial at init and replaced with the device plan after
    the launch.
    """

    def __init__(self, y, u, v, width, height, cfg):
        import dataclasses

        self.dev_segments = max(1, min(4, cfg.segments))
        cfg = dataclasses.replace(cfg, segments=1, sns_strength=0)
        super().__init__(y, u, v, width, height, cfg)

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
        if self.cfg.autofilter:
            raise NotImplementedError(
                "the device path's autofilter needs the VP8 decoder, which "
                "is not ported")
        total = self.mb_h * self.mb_w
        self.num_skip = int(self.skip.sum())
        self.skip_proba = max(1, min(255, (total - self.num_skip) * 255 // total)) \
            if self.num_skip > 0 else 0
        self.use_skip = self.num_skip > 0
        if not self.use_skip:
            self.skip[:] = False

        self._optimize_probas()
        parts = [self._emit_tokens(i) for i in range(self.num_parts)]
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


# Images that took the exact host fallback since the last reset (read by
# chip_smoke.py; it should stay 0 on natural content).
FALLBACKS = {"images": 0}


def device_blob(rgbs, quality: int = 75, segments: int = 4,
                sns_strength: int = 50, device=None):
    """Runs the device program on a batch: numpy uint8 [B, H, W, 3] (H, W
    multiples of 16) -> (fn, host field dict of numpy [B, ...] arrays)."""
    from ..ops.fastpath import fast_encode_fn, unpack_output_blob

    B, H, W, _ = rgbs.shape
    fn = fast_encode_fn(W // 16, H // 16, quality, segments, sns_strength)
    x = torch.from_numpy(np.ascontiguousarray(rgbs)).to(
        _resolve_device(device))
    chunks = fn.rgb_blob(x)
    host = unpack_output_blob([c.cpu().numpy() for c in chunks], fn.blob_spec)
    return fn, host


def encode_lossy_batch(rgbs, quality: int = 75, partitions: int = 0,
                       filter_strength: int = 60, num_threads: int = 8,
                       true_width: int = None, true_height: int = None,
                       segments: int = 4, sns_strength: int = 50,
                       device=None):
    """Batched device encode: one device program over a stack of
    same-sized images, then parallel host entropy coding (the native C++
    calls release the GIL).

    rgbs: numpy uint8 [B, H, W, 3] with H, W multiples of 16 (pre-padded).
    device: None for the card, "cpu" for the plain versions.
    Returns a list of VP8 bitstreams.
    """
    B, H, W, _ = rgbs.shape
    mb_w, mb_h = W // 16, H // 16
    fn, host = device_blob(rgbs, quality, segments, sns_strength, device)

    tw = true_width or W
    th = true_height or H
    cfg = LossyConfig(quality=quality, partitions=partitions,
                      filter_strength=filter_strength, segments=segments,
                      sns_strength=sns_strength)
    overflow = host["esc_cnt"] > fn.esc_cap
    FALLBACKS["images"] += int(overflow.sum())

    def emit(i):
        if overflow[i]:
            Y, U, V = rgb_to_yuv420(rgbs[i])
            return VP8Encoder(Y, U, V, tw, th, cfg).encode()
        return _finish_one({k: v[i] for k, v in host.items()},
                           mb_w, mb_h, tw, th, cfg)

    with concurrent.futures.ThreadPoolExecutor(max_workers=num_threads) as ex:
        return list(ex.map(emit, range(B)))
