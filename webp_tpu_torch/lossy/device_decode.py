"""Device VP8 decode entry points: the native token parse on the host,
then the reconstruction, loop filter and upsampling on the device
(ops/decode.py). Counterpart of webp_tpu/lossy/device_decode.py.

Entropy decoding is bit-serial and stays on the host CPU (native
vp8_parse); every pixel-shaped stage runs as batched device work. The
stream overlaps the host parse of image i+1 with the device's
reconstruction of image i.
"""

from __future__ import annotations

import concurrent.futures

import numpy as np
import torch

from .. import trace
from ..native import api as native
from .device_encode import _fetch, _resolve_device, _upload


def _parse_inputs(data: bytes):
    """The native parse of one VP8 bitstream and its per-MB filter
    parameters: (parse dict, finfo [n_mb, 4] = limit, ilevel, hev
    threshold, I4 flag, inner [n_mb] bool)."""
    with trace.span("decode.parse"):
        P = native.vp8_parse(data)
        tab = P["finfo"][1:].reshape(4, 2, 4)
        fi = tab[P["segment"] & 3, P["is_i4"]]
        inner = P["is_i4"].astype(bool) | P["has_nz"].astype(bool)
        return P, fi, inner


def _host_inputs(parsed):
    """The decode function's eight inputs as CPU tensors [1, ...]."""
    P, fi, inner = parsed
    arrays = (P["coeffs"], P["is_i4"].astype(bool), P["imodes"], P["uvmode"],
              np.ascontiguousarray(fi[:, 0], dtype=np.int32),
              np.ascontiguousarray(fi[:, 1], dtype=np.int32),
              np.ascontiguousarray(fi[:, 2], dtype=np.int32), inner)
    return [torch.from_numpy(np.ascontiguousarray(a)[None]) for a in arrays]


def _fn(parsed, upsample: bool):
    from ..ops.decode import decode_fn

    mbw, mbh, w, h = parsed[0]["dims"]
    return decode_fn(mbw, mbh, int(parsed[0]["finfo"][0]), upsample=upsample,
                     width=w, height=h)


def _run_device(parsed, upsample: bool, dev: torch.device):
    with trace.span("decode.upload"):
        ins = [_upload(t, dev) for t in _host_inputs(parsed)]
    with trace.span("device.program"):
        return _fn(parsed, upsample)(*ins)


def _crop(planes, dims):
    _, _, w, h = dims
    Y, U, V = (np.asarray(p[0]) for p in planes)
    cw, ch = (w + 1) >> 1, (h + 1) >> 1
    return Y[:h, :w], U[:ch, :cw], V[:ch, :cw]


def decode_vp8_yuv_device(data: bytes, device=None):
    """One VP8 bitstream through the device decode -> cropped (Y, U, V)
    uint8 planes. device: None for the card, "cpu" for the plain
    versions."""
    parsed = _parse_inputs(data)
    out = _run_device(parsed, False, _resolve_device(device))
    with trace.span("decode.fetch"):
        return _crop(_fetch(out), parsed[0]["dims"])


def decode_vp8_rgb_device(data: bytes, device=None) -> np.ndarray:
    """One VP8 bitstream through the device decode, fancy upsampling and
    YUV -> RGB included -> RGB uint8 [h, w, 3]."""
    out = _run_device(_parse_inputs(data), True, _resolve_device(device))
    with trace.span("decode.fetch"):
        return _fetch([out[0]])[0]


def decode_lossy_stream_device(datas, upsample: bool = True, device=None):
    """Pipelined device decode of a list of VP8 bitstreams: the host parse
    of image i+1 (on a worker thread, the native parse releases the GIL)
    overlaps the device's decode of image i. On the card each image's
    inputs are staged in pinned memory and copied on a side stream behind
    an event, which the decode waits on; its output is copied back into
    pinned memory behind a second event, which the fetch of that image
    waits on after the next image is launched. Returns RGB arrays (or
    cropped (Y, U, V) tuples with upsample=False), in order."""
    dev = _resolve_device(device)
    on_card = dev.type == "cuda"
    side = torch.cuda.Stream(dev) if on_card else None

    def upload(data):
        parsed = _parse_inputs(data)
        host = _host_inputs(parsed)
        if not on_card:
            return parsed, host, None
        staged = [t.pin_memory() for t in host]
        with torch.cuda.stream(side):
            ins = [t.to(dev, non_blocking=True) for t in staged]
            ready = torch.cuda.Event()
            ready.record(side)
        trace.count(trace.BYTES, "h2d", sum(t.nbytes for t in staged))
        return parsed, ins, ready

    def launch(up):
        parsed, ins, ready = up
        if ready is not None:
            stream = torch.cuda.current_stream(dev)
            stream.wait_event(ready)
            for t in ins:
                t.record_stream(stream)
        with trace.span("device.program"):
            out = _fn(parsed, upsample)(*ins)
        out = [out] if upsample else list(out)
        if ready is None:
            return parsed, out, None
        host = [torch.empty(o.shape, dtype=o.dtype, pin_memory=True)
                for o in out]
        for dst, o in zip(host, out):
            dst.copy_(o, non_blocking=True)
        trace.count(trace.BYTES, "d2h", sum(h.nbytes for h in host))
        done = torch.cuda.Event()
        done.record()
        return parsed, host, done

    def fetch(inflight):
        parsed, out, done = inflight
        if done is not None:
            done.synchronize()
        if upsample:
            return out[0][0].numpy()
        return _crop(out, parsed[0]["dims"])

    results = []
    with concurrent.futures.ThreadPoolExecutor(max_workers=1) as ex:
        fut = ex.submit(trace.carry(upload), datas[0]) if datas else None
        inflight = None
        for i in range(len(datas)):
            up = fut.result()
            fut = ex.submit(trace.carry(upload), datas[i + 1]) \
                if i + 1 < len(datas) else None
            out = launch(up)
            if inflight is not None:
                results.append(fetch(inflight))
            inflight = out
        if inflight is not None:
            results.append(fetch(inflight))
    return results
