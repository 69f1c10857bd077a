"""Device-accelerated lossy encode: the batched device program on the card
(ops/fastpath.py) plus the host tail — the frame writer's native entropy
coding, straight from the packed levels, and VP8 frame assembly
(lossy/frame.py).
Counterpart of webp_tpu/lossy/device_encode.py (its single-device batched
path).

The device returns each image's fields as one byte blob (BLOB_CHUNKS
chunks); the host tail (DeviceVP8Encoder.finish) installs the device's
segment plan into the frame header and entropy-codes the levels straight
from their packed fields. encode_image runs one image; an image whose
escape list overflowed the device's capacity is re-encoded by the exact
host encoder (from host planes of the same import: sharp-YUV planes from the
host converter sharpyuv/convert.py when the device imported with sharp
YUV). encode_lossy_batch runs one batch; encode_lossy_stream pipelines a
stream of batches (upload, compute and host tail overlapped), or, when
given devices=, spreads them over several (parallel/exact.py). _get_fn
is the exact-parity wavefront oracle (ops/wavefront.py).
"""

from __future__ import annotations

import concurrent.futures
import dataclasses
import functools

import numpy as np
import torch

from .. import trace
from ..encoder import rgb_to_yuv420
from . import frame as F
from .analysis import finalize_device_plan, trivial_plan
from .encode import LossyConfig, VP8Encoder


def _resolve_device(device) -> torch.device:
    """None means the card; an explicit "cpu" runs the plain versions."""
    return torch.device("cuda" if device is None else device)


def _upload(t: torch.Tensor, dev: torch.device) -> torch.Tensor:
    """t.to(dev), counting the bytes a copy to a CUDA device moves."""
    if dev.type == "cuda":
        trace.count(trace.BYTES, "h2d", t.nbytes)
    return t.to(dev)


def _fetch(tensors) -> list:
    """The tensors as numpy arrays on the host (a blocking copy from the
    device), counting the bytes a copy from a CUDA device moves."""
    out = [t.cpu().numpy() for t in tensors]
    if tensors[0].device.type == "cuda":
        trace.count(trace.BYTES, "d2h", sum(a.nbytes for a in out))
    return out


@functools.lru_cache(maxsize=16)
def _get_fn(mb_w: int, mb_h: int, quality: int):
    """The exact-parity wavefront (ops/wavefront.py), kept for
    differential tests."""
    from ..ops.wavefront import wavefront_encode_fn

    return wavefront_encode_fn(mb_w, mb_h, quality)


def _mesh_devices(images, devices, sharp_yuv):
    """The devices encode_lossy_stream spreads its batches over (the
    reference's multi-device branch), or None for the single-device
    stream. The branch is taken only when the caller names two or more
    devices, the images are not sharp-YUV and their MB rows (after the
    padding to whole macroblocks) divide evenly over the devices: on
    several cards it is slower than one card's stream (ROADMAP queue 2),
    so the reference's default of every visible device is not followed."""
    if devices is None or len(devices) < 2 or sharp_yuv:
        return None
    if (images[0].shape[0] + 15) // 16 % len(devices):
        return None
    return [torch.device(d) for d in devices]


class DeviceVP8Encoder:
    """The host tail of the device program: one image's device fields
    (its part of unpack_output_blob's dict) to a VP8 frame. The device
    computes the segmentation and SNS too (fastpath phase 0); the tail
    turns its segment tables into the frame header's plan. cfg: the
    frame's options (quality, segments, filter, partitions, autofilter);
    srcY: the host luma plane the autofilter search compares with, read
    only with cfg.autofilter. After finish() or write(): part0_size,
    token_sizes and, with cfg.autofilter, recY (the probe decode's
    reconstruction)."""

    def __init__(self, width: int, height: int, cfg: LossyConfig,
                 srcY: np.ndarray = None):
        self.width, self.height, self.cfg, self.srcY = width, height, cfg, srcY
        self.mb_w, self.mb_h = (width + 15) >> 4, (height + 15) >> 4
        self.part0_size, self.token_sizes, self.recY = 0, (), None

    def finish(self, out_i: dict) -> bytes:
        """Host tail for one image's device fields: install the device's
        segment plan, code the levels straight from their packed fields,
        assemble."""
        with trace.span("tail"):
            f = self.frame(out_i)
            with trace.span("tail.plan"):
                self.install_plan(f, out_i)
            return self.write(f)

    def frame(self, fields) -> F.Frame:
        """The frame of the device's per-MB fields, without its plan
        (install_plan makes it). Its levels are the packed fields as the
        device sent them, or, where fields holds "lv24" [n_mb, 24, 16]
        (the band encoders' unpacked levels), those."""
        dense = "lv24" in fields
        return F.Frame(
            self.width, self.height, fields["lv24"] if dense else None,
            fields["y2"], fields["imodes"], fields["uvmodes"],
            fields["is_i4"], fields["skip"].copy(), plan=None,
            filter_level=0, packed=None if dense else tuple(
                fields[k] for k in ("packed", "esc_idx", "esc_val",
                                    "esc_cnt")),
            **F.cfg_fields(self.cfg))

    def install_plan(self, f: F.Frame, fields) -> None:
        """The frame's plan: where the device segmented (more than one
        segment and at least 4 MBs), its segmentation (seg_map, seg_q,
        seg_beta; dq_uv, where present, the (dc, ac) chroma deltas the
        device quantized with), else one segment without SNS."""
        cfg = self.cfg
        if max(1, min(4, cfg.segments)) <= 1 or self.mb_w * self.mb_h < 4:
            plan = trivial_plan(self.mb_w, self.mb_h, cfg.quality,
                                cfg.filter_strength, cfg.filter_sharpness)
        else:
            plan = finalize_device_plan(fields["seg_map"], fields["seg_q"],
                                        fields["seg_beta"],
                                        cfg.filter_strength,
                                        cfg.filter_sharpness)
            dq_uv = fields.get("dq_uv")
            if dq_uv is not None:
                plan.dq_uv_dc = int(dq_uv[0])
                plan.dq_uv_ac = int(dq_uv[1])
        f.plan = plan
        f.filter_level = plan.fstrength[0]

    def write(self, f: F.Frame) -> bytes:
        """The frame's bytes, in the device tail's order: the
        probabilities and the token partitions, the autofilter search on
        their probe decode (cfg.autofilter), partition 0, the assembly."""
        F.count_skips(f)
        with trace.span("tail.code"):
            parts = F.code_tokens(f)
        if self.cfg.autofilter:
            self.recY = _probe_autofilter(f, parts, self.srcY)
        with trace.span("tail.partition0"):
            part0 = F.partition0(f)
        self.part0_size, self.token_sizes = len(part0), tuple(map(len, parts))
        with trace.span("tail.assemble"):
            return F.assemble(f, part0, parts)


def _probe_autofilter(f: F.Frame, parts, srcY) -> np.ndarray:
    """The device path's autofilter: the device keeps no host
    reconstruction, so the frame is probe-decoded with the in-loop filter
    off (the native decoder) to recover the unfiltered reconstruction, on
    which the filter-strength search runs against the host luma srcY.
    Returns that reconstruction, MB-padded by edge replication."""
    from .decode import decode_vp8_yuv

    f.plan.fstrength[:] = [0] * 4
    f.filter_level = 0
    Y, _, _ = decode_vp8_yuv(F.assemble(f, F.partition0(f), parts))
    recY = np.zeros((f.mb_h * 16, f.mb_w * 16), np.uint8)
    recY[:Y.shape[0], :Y.shape[1]] = Y
    if Y.shape[1] < recY.shape[1]:
        recY[:Y.shape[0], Y.shape[1]:] = Y[:, -1:]
    if Y.shape[0] < recY.shape[0]:
        recY[Y.shape[0]:] = recY[Y.shape[0] - 1]
    F.autofilter_search(f, recY, srcY)
    return recY


def encode_image(rgb, width: int, height: int, cfg: LossyConfig,
                 dithering: float = 0.0, srcY=None, device=None,
                 uv_ac: bool = False):
    """One image through the device program at B=1, its YUV import on the
    device, and the host tail. rgb: uint8 [H, W, 3], the width x height
    image padded to whole MBs. An escape list that overflows the device's
    capacity re-encodes the image with the exact host encoder, from host
    planes imported then (with `dithering`; with sharp YUV, the host sharp
    converter's planes of the padded image, as the reference's). srcY:
    the host luma plane the autofilter search reads (cfg.autofilter).
    device: None for the card, "cpu" for the plain versions. Methods 0-2
    (or i4_blocks off) run without the I4 search; methods 5 and 6 run the
    closed loop at skew 2 with the trellis, 6 with the in-loop search.
    uv_ac: the chroma AC quantizer delta from the image's mean UV alpha
    (fast_encode_fn's); the overflow fallback, on the host, does not read
    it (the host encoder's own analysis sets that delta).

    Returns (the VP8 frame, partition 0's size, the token partitions'
    sizes, the autofilter probe's reconstruction or None). The fallback
    encodes with one segment and no SNS, and reports sizes 0 and () and
    no reconstruction, as the reference's single-image fallback does
    (ROADMAP queue A)."""
    from ..ops.fastpath import fast_encode_fn, unpack_output_blob

    use_i4 = bool(cfg.i4_blocks) and cfg.method >= 3
    sk = 2 if cfg.method >= 5 and use_i4 else 1
    # uv_ac is passed only when set: the default call configures the
    # program with the reference's own arguments.
    fn = fast_encode_fn((width + 15) >> 4, (height + 15) >> 4, cfg.quality,
                        max(1, min(4, cfg.segments)),
                        max(0, cfg.sns_strength), use_i4,
                        sharp_yuv=bool(cfg.sharp_yuv), sk=sk,
                        trellis=cfg.method >= 5 and use_i4,
                        i4_mode_search=cfg.method >= 6 and use_i4,
                        **({"uv_ac": True} if uv_ac else {}))
    with trace.span("encode.upload"):
        x = _upload(torch.from_numpy(np.ascontiguousarray(rgb[None])),
                    _resolve_device(device))
    with trace.span("device.program"):
        out = fn.rgb_blob(x)
    with trace.span("encode.fetch"):
        chunks = _fetch(out)
    with trace.span("encode.unpack"):
        host = unpack_output_blob(chunks, fn.blob_spec)
    if int(host["esc_cnt"][0]) > fn.esc_cap:
        trace.count(FALLBACKS, "images")
        with trace.span("fallback"):
            if fn.sharp_yuv:
                Y, U, V = _fallback_planes(rgb, fn)
            else:
                Y, U, V = rgb_to_yuv420(rgb[:height, :width], dithering)
            one = dataclasses.replace(cfg, segments=1, sns_strength=0)
            return VP8Encoder(Y, U, V, width, height, one).encode(), 0, (), None
    tail = DeviceVP8Encoder(width, height, cfg, srcY)
    vp8 = tail.finish({k: v[0] for k, v in host.items()})
    return vp8, tail.part0_size, tail.token_sizes, tail.recY


# Images that took the exact host fallback since the last reset (read by
# chip_smoke.py; it should stay 0 on natural content).
FALLBACKS = trace.register("fallbacks", {"images": 0})


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
        from ..sharpyuv.convert import sharp_rgb_to_yuv420

        return sharp_rgb_to_yuv420(rgb)
    return rgb_to_yuv420(rgb)


def device_blob(rgbs, quality: int = 75, segments: int = 4,
                sns_strength: int = 50, device=None, sharp_yuv=False,
                uv_ac=False):
    """Runs the device program on a batch: numpy uint8 [B, H, W, 3] (H, W
    multiples of 16) -> (fn, host field dict of numpy [B, ...] arrays).
    uv_ac: the chroma AC quantizer delta (fast_encode_fn's)."""
    from ..ops.fastpath import fast_encode_fn, unpack_output_blob

    B, H, W, _ = rgbs.shape
    fn = fast_encode_fn(W // 16, H // 16, quality, segments, sns_strength,
                        sharp_yuv=sharp_yuv, uv_ac=uv_ac)
    x = _upload(torch.from_numpy(np.ascontiguousarray(rgbs)),
                _resolve_device(device))
    chunks = fn.rgb_blob(x)
    host = unpack_output_blob(_fetch(chunks), fn.blob_spec)
    return fn, host


def _emit(host, rgbs, fn, width, height, cfg, ex):
    """Host tail of one batch: entropy-codes each image's device fields on
    the pool, or re-encodes with the exact host encoder (from its RGB in
    rgbs, imported as fn's device import) an image whose escape list
    overflowed."""
    overflow = host["esc_cnt"] > fn.esc_cap
    trace.count(FALLBACKS, "images", int(overflow.sum()))

    def emit(i):
        if overflow[i]:
            with trace.span("fallback"):
                Y, U, V = _fallback_planes(rgbs[i], fn)
                return VP8Encoder(Y, U, V, width, height, cfg).encode()
        return DeviceVP8Encoder(width, height, cfg).finish(
            {k: v[i] for k, v in host.items()})

    return list(ex.map(trace.carry(emit), range(len(rgbs))))


def encode_lossy_batch(rgbs, quality: int = 75, partitions: int = 0,
                       filter_strength: int = 60, num_threads: int = 8,
                       true_width: int = None, true_height: int = None,
                       segments: int = 4, sns_strength: int = 50,
                       device=None, sharp_yuv: bool = False,
                       uv_ac: bool = False):
    """Batched device encode: one device program over a stack of
    same-sized images, then parallel host entropy coding (the native C++
    calls release the GIL).

    rgbs: numpy uint8 [B, H, W, 3] with H, W multiples of 16 (pre-padded).
    device: None for the card, "cpu" for the plain versions. sharp_yuv:
    import with the sharp-YUV refinement on the device. uv_ac: derive
    each image's chroma AC quantizer delta from its mean UV alpha (the
    reference's chroma AC switch; fast_encode_fn); the frame header
    signals it. The escape-overflow fallback ignores it, as the
    reference's host encoder ignores the switch.
    Returns a list of VP8 bitstreams.
    """
    B, H, W, _ = rgbs.shape
    fn, host = device_blob(rgbs, quality, segments, sns_strength, device,
                           sharp_yuv, uv_ac)
    cfg = LossyConfig(quality=quality, partitions=partitions,
                      filter_strength=filter_strength, segments=segments,
                      sns_strength=sns_strength)
    with concurrent.futures.ThreadPoolExecutor(max_workers=num_threads) as ex:
        return _emit(host, rgbs, fn, true_width or W, true_height or H, cfg,
                     ex)


@trace.traced("stream")
def encode_lossy_stream(images, quality: int = 75, batch: int = 8,
                        partitions: int = 0, filter_strength: int = 60,
                        num_threads: int = 12, host_yuv: bool = None,
                        segments: int = 4, sns_strength: int = 50,
                        sharp_yuv: bool = False, device=None, devices=None,
                        uv_ac: bool = False):
    """Pipelined encode of a stream of same-sized images (counterpart of
    the reference's encode_lossy_stream).

    Three overlapped stages, batch by batch:
      upload(i+1)  ||  device compute(i)  ||  fetch + entropy coding(i-1).
    The upload stage pads each image to whole macroblocks and, with
    host_yuv, converts it to YUV 4:2:0 with the native importer on the
    thread pool, which halves the bytes to upload; the planes (or the RGB
    batch) are staged in pinned host memory and copied to the card by
    non_blocking copies on a side stream, behind an event. The device
    program (fn.blob on YUV planes, fn.rgb_blob on RGB) waits on that
    event on the current stream; its blob chunks are copied back into
    pinned buffers behind a second event, which the drain of the batch
    waits on before the host pool entropy-codes it. Python only blocks on
    the previous batch's fetch, never on the current compute.

    host_yuv=None (the default) means host YUV, as the reference's
    stream default does once its native importer is built (the port's is
    always built; a failed build raises): the files are those of the
    reference's stream at its defaults. They differ from encode_batch's
    on some images: the host importer takes its chroma from gamma tables
    with interpolation, the device conversion (ops/yuv.py) from float
    power curves, and the two differ by 1 on some chroma samples (in the
    reference too). host_yuv=False converts on the device, and then the
    files equal encode_batch's.

    sharp_yuv imports with the sharp-YUV refinement, which runs on the
    device from RGB, so it turns host_yuv off (as the reference's stream
    does).

    The stream runs on the device it is given: None means the card,
    "cpu" runs the plain versions (no streams or pinned memory, the same
    three stages). devices (two or more; a device may repeat) asks for
    the reference's multi-device branch instead: where the images are
    not sharp-YUV and their MB rows divide evenly over the devices
    (_mesh_devices), each batch goes through the exact band pipeline
    over them (parallel/exact.py encode_lossy_mesh), one band per
    device; otherwise the single-device stream runs on `device`. That
    branch converts YUV on the devices and takes only quality, segments
    and sns_strength (host_yuv, partitions, filter_strength and
    num_threads are ignored, as in the reference), so its files are
    encode_batch's. The reference takes the branch whenever it sees more
    than one device; the port only when asked, since its band pipeline
    is slower than one card's stream (ROADMAP queue 2).
    uv_ac derives each image's chroma AC quantizer delta from its mean
    UV alpha (encode_lossy_batch's), on both branches.
    An image whose escape list
    overflows is re-encoded by the exact host encoder from the caller's
    unpadded image, as the reference's stream does (encode_lossy_batch
    starts from the padded one, so on sizes that are not whole
    macroblocks the two fallbacks may differ in the padding's chroma).

    images: list of uint8 [h, w, 3] arrays of one size. Returns the VP8
    bitstreams in order.
    """
    from ..ops.fastpath import fast_encode_fn

    if not images:
        return []
    h, w = images[0].shape[:2]
    mesh = _mesh_devices(images, devices, sharp_yuv)
    if mesh is not None:
        from ..parallel.exact import encode_lossy_mesh

        frames = []
        for i in range(0, len(images), batch):
            rgbs = np.stack([np.asarray(im)[..., :3]
                             for im in images[i:i + batch]])
            frames += encode_lossy_mesh(
                pad_to_macroblocks(rgbs), quality=quality, segments=segments,
                sns_strength=sns_strength, true_width=w, true_height=h,
                devices=mesh, uv_ac=uv_ac)
        return frames
    if sharp_yuv:
        host_yuv = False  # the refinement runs on the device from RGB
    elif host_yuv is None:
        host_yuv = True
    dev = _resolve_device(device)
    on_card = dev.type == "cuda"
    H, W = (h + 15) // 16 * 16, (w + 15) // 16 * 16
    fn = fast_encode_fn(W // 16, H // 16, quality, segments, sns_strength,
                        sharp_yuv=sharp_yuv, uv_ac=uv_ac)
    cfg = LossyConfig(quality=quality, partitions=partitions,
                      filter_strength=filter_strength, segments=segments,
                      sns_strength=sns_strength)
    side = torch.cuda.Stream(dev) if on_card else None

    def prep_one(img):
        with trace.span("stream.prep"):
            rgb = pad_to_macroblocks(img[None])[0]
            return (rgb,) + (rgb_to_yuv420(rgb) if host_yuv else ())

    def upload(imgs):
        with trace.span("stream.upload"):
            rgbs = [np.asarray(img)[..., :3] for img in imgs]
            prepped = list(ex.map(trace.carry(prep_one), rgbs))
            with trace.span("stream.pin"):
                planes = [torch.from_numpy(np.stack(p))
                          for p in zip(*prepped)]
                planes = planes[1:] if host_yuv else planes[:1]
                if not on_card:
                    return rgbs, planes, None
                staged = [p.pin_memory() for p in planes]
                with torch.cuda.stream(side):
                    planes = [p.to(dev, non_blocking=True) for p in staged]
                    ready = torch.cuda.Event()
                    ready.record(side)
                trace.count(trace.BYTES, "h2d",
                            sum(p.nbytes for p in staged))
            return rgbs, planes, ready

    def launch(up):
        rgbs, planes, ready = up
        if ready is not None:
            stream = torch.cuda.current_stream(dev)
            stream.wait_event(ready)
            for p in planes:
                p.record_stream(stream)
        with trace.span("device.program"):
            chunks = fn.blob(*planes) if host_yuv else fn.rgb_blob(planes[0])
        if ready is None:
            return rgbs, chunks, None
        host = [torch.empty(c.shape, dtype=c.dtype, pin_memory=True)
                for c in chunks]
        for dst, c in zip(host, chunks):
            dst.copy_(c, non_blocking=True)
        trace.count(trace.BYTES, "d2h", sum(c.nbytes for c in host))
        done = torch.cuda.Event()
        done.record()
        return rgbs, host, done

    batches = [images[i:i + batch] for i in range(0, len(images), batch)]
    results = []
    # Uploads run on their own thread: they wait on the pool's
    # conversions, which must not queue behind them.
    with concurrent.futures.ThreadPoolExecutor(max_workers=num_threads) as ex, \
            concurrent.futures.ThreadPoolExecutor(max_workers=1) as up_ex:
        up = upload(batches[0])
        inflight = None
        for i in range(len(batches)):
            out = launch(up)
            up_fut = (up_ex.submit(trace.carry(upload), batches[i + 1])
                      if i + 1 < len(batches) else None)
            if inflight is not None:
                results.extend(_drain(inflight, fn, w, h, cfg, ex))
            inflight = out
            if up_fut is not None:
                up = up_fut.result()
        results.extend(_drain(inflight, fn, w, h, cfg, ex))
    return results


def _drain(inflight, fn, width, height, cfg, ex):
    """Fetches one batch's blob (waiting on its copy-back event) and
    entropy-codes it on the pool."""
    from ..ops.fastpath import unpack_output_blob

    with trace.span("stream.drain"):
        rgbs, chunks, done = inflight
        if done is not None:
            with trace.span("stream.fetch_wait"):
                done.synchronize()
        with trace.span("encode.unpack"):
            host = unpack_output_blob([c.numpy() for c in chunks],
                                      fn.blob_spec)
        return _emit(host, rgbs, fn, width, height, cfg, ex)
