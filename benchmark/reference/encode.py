"""The reference encoder: the WebP file that `encode(img, **options)`
must write and the VP8 frame that `encode_lossy_stream` must return for
an image, at a configuration's options, each with the reconstruction
the encoder's closed loop predicted from.

Both run the frozen device program's plain PyTorch versions on `device`
(a torch device; the CPU by default) and the Python host tail. Only the
options a configuration file may set are accepted, at methods 0-4 and
without preprocessing; anything else raises, so a configuration the
reference cannot follow never passes as checked.

The reconstruction is (Y, U, V) uint8 on the macroblock grid, or None
where the escape list overflowed and the host encoder wrote the file.
"""

from __future__ import annotations

import numpy as np
import torch

from .vp8ref.container import riff
from .vp8ref.encoder import rgb_to_yuv420
from .vp8ref.lossy.device_encode import (VP8Encoder, pad_to_macroblocks,
                                         planeless)
from .vp8ref.lossy.encode import LossyConfig

# encode()'s option defaults (its EncoderOptions) for the keys a
# configuration may set.
ENCODE_DEFAULTS = {"quality": 75, "method": 4, "segments": 4,
                   "sns_strength": 50, "filter_strength": 60,
                   "filter_sharpness": 0, "filter_type": 1, "partitions": 0,
                   "preprocessing": 0}
# What encode_lossy_stream takes from a configuration; the rest of
# ENCODE_DEFAULTS is fixed in the stream (its LossyConfig defaults) and a
# configuration that asks for other values cannot run through it.
STREAM_KEYS = ("quality", "segments", "sns_strength", "filter_strength",
               "partitions")


def _options(options: dict) -> dict:
    unknown = set(options) - set(ENCODE_DEFAULTS)
    if unknown:
        raise ValueError(f"the reference does not follow options "
                         f"{sorted(unknown)}")
    opts = dict(ENCODE_DEFAULTS, **options)
    if opts["preprocessing"]:
        raise ValueError("the reference has no preprocessing")
    if not 0 <= int(opts["method"]) <= 4:
        raise ValueError("the reference follows methods 0-4")
    return opts


def _planes(recon, mb_w: int, mb_h: int):
    """The step loop's per-MB reconstruction of image 0 -> (Y, U, V)
    uint8 planes on the MB grid (None stays None)."""
    if recon is None:
        return None
    out = []
    for r, n in zip(recon, (16, 8, 8)):
        a = r[0].cpu().numpy().astype(np.uint8).reshape(mb_h, mb_w, n, n)
        out.append(a.transpose(0, 2, 1, 3).reshape(mb_h * n, mb_w * n))
    return tuple(out)


def _config(opts: dict) -> LossyConfig:
    return LossyConfig(
        quality=int(opts["quality"]), method=int(opts["method"]),
        segments=int(opts["segments"]),
        filter_strength=int(opts["filter_strength"]),
        filter_sharpness=int(opts["filter_sharpness"]),
        filter_type=int(opts["filter_type"]),
        partitions=int(opts["partitions"]),
        sns_strength=int(opts["sns_strength"]))


def encode_file(rgb: np.ndarray, options: dict,
                device=torch.device("cpu")):
    """encode(rgb, **options)'s file: the device YUV import and program on
    the padded image, the host tail, a simple RIFF container. Returns
    (file, reconstruction)."""
    opts = _options(options)
    h, w = rgb.shape[:2]
    enc = planeless(w, h, _config(opts))
    enc.rgb_input = pad_to_macroblocks(np.asarray(rgb)[None, ..., :3])[0]
    vp8 = enc.encode(device=device)
    return (riff.assemble_riff([riff.Chunk(riff.VP8, vp8)]),
            _planes(enc.recon, enc.mb_w, enc.mb_h))


def stream_frame(rgb: np.ndarray, options: dict,
                 device=torch.device("cpu")):
    """encode_lossy_stream's VP8 frame for rgb with host YUV (the stream's
    default): the numpy importer on the padded image, the device program
    on its planes, the host tail; the host encoder from the unpadded
    image where the escape list overflows. Returns (frame,
    reconstruction)."""
    from .vp8ref.ops.fastpath import fast_encode_fn, unpack_output_blob

    opts = _options(options)
    fixed = {k: v for k, v in opts.items() if k not in STREAM_KEYS}
    if fixed != {k: ENCODE_DEFAULTS[k] for k in fixed} \
            and fixed != {k: getattr(LossyConfig(), k) for k in fixed}:
        raise ValueError(f"the stream takes none of {sorted(fixed)}")
    h, w = rgb.shape[:2]
    padded = pad_to_macroblocks(np.asarray(rgb)[None, ..., :3])[0]
    H, W = padded.shape[:2]
    fn = fast_encode_fn(W // 16, H // 16, int(opts["quality"]),
                        int(opts["segments"]), int(opts["sns_strength"]))
    cfg = LossyConfig(quality=int(opts["quality"]),
                      partitions=int(opts["partitions"]),
                      filter_strength=int(opts["filter_strength"]),
                      segments=int(opts["segments"]),
                      sns_strength=int(opts["sns_strength"]))
    planes = [torch.from_numpy(p[None]).to(device)
              for p in rgb_to_yuv420(padded)]
    host = unpack_output_blob([c.cpu().numpy() for c in fn.blob(*planes)],
                              fn.blob_spec)
    if int(host["esc_cnt"][0]) > fn.esc_cap:
        Y, U, V = rgb_to_yuv420(np.ascontiguousarray(rgb[..., :3]))
        return VP8Encoder(Y, U, V, w, h, cfg).encode(), None
    return (planeless(w, h, cfg).finish({k: v[0] for k, v in host.items()}),
            _planes(fn.last_recon, W // 16, H // 16))

