"""Opt-in Pillow integration: route PIL.Image.open/save through this codec.

The port's counterpart of webp_tpu/pil_plugin.py (the reference
registers its decoder with Go's image package, webp.go:23-34,
image.RegisterFormat; the Pillow analog is an ImageFile plugin). After
register(), Image.open() decodes .webp files with webp_tpu_torch and
Image.save(..., format="WEBP") encodes with it. register() replaces
Pillow's built-in WEBP plugin entries for the process; unregister()
restores them.

The port's device rule holds here too: register(device=None) and
open_bytes(data, device=None) decode and encode on the card unless
`device` asks for another ("cpu" runs the kernels' plain versions).
This module needs Pillow, so webp_tpu_torch does not import it.

    import webp_tpu_torch.pil_plugin
    webp_tpu_torch.pil_plugin.register()
    im = PIL.Image.open("photo.webp")        # decoded by webp_tpu_torch
    im.save("out.webp", quality=80)          # encoded by webp_tpu_torch
"""

from __future__ import annotations

import functools
import io

import numpy as np
from PIL import Image, ImageFile

import webp_tpu_torch

_MAGIC_RIFF = b"RIFF"
_MAGIC_WEBP = b"WEBP"


def _accept(prefix: bytes) -> bool:
    return prefix[:4] == _MAGIC_RIFF and prefix[8:12] == _MAGIC_WEBP


class WebPTpuImageFile(ImageFile.ImageFile):
    format = "WEBP"
    format_description = "WebP (webp_tpu_torch codec)"

    def __init__(self, fp=None, filename=None, device=None):
        self._device = device
        super().__init__(fp, filename)

    def _open(self):
        self._webp_data = self.fp.read()
        feats = webp_tpu_torch.get_features(self._webp_data)
        self._size = (feats.width, feats.height)
        self._mode = "RGBA" if feats.has_alpha else "RGB"
        if feats.has_anim:
            from .container.parser import Parser

            self.n_frames = max(1, len(Parser(self._webp_data).frames()))
        else:
            self.n_frames = 1
        self.is_animated = self.n_frames > 1
        self._frame = 0
        self._composited = None
        self.tile = []

    def seek(self, frame: int) -> None:
        if frame == self._frame:
            return
        if frame < 0 or frame >= self.n_frames:
            raise EOFError(f"no frame {frame}")
        self._frame = frame
        self._im = None  # force reload

    def tell(self) -> int:
        return self._frame

    def _decode_frame(self) -> np.ndarray:
        if self.n_frames == 1:
            return webp_tpu_torch.decode(self._webp_data,
                                         device=self._device)
        if self._composited is None:
            from .animation.animation import AnimDecoder, decode_animation

            anim = decode_animation(self._webp_data, device=self._device)
            self._composited = list(AnimDecoder(anim, device=self._device))
        canvas, duration = self._composited[self._frame]
        self.info["duration"] = duration
        return canvas

    def load(self):
        if getattr(self, "_im", None) is None and self.tile == []:
            arr = np.asarray(self._decode_frame())
            decoded = Image.fromarray(arr)
            self.im = decoded.im
            self._mode = decoded.mode
            self._size = decoded.size
        return Image.Image.load(self)


def _save(im: Image.Image, fp, filename, device=None) -> None:
    params = im.encoderinfo or {}
    if im.mode not in ("RGB", "RGBA"):
        im = im.convert("RGBA" if "A" in im.mode or "transparency" in im.info
                        else "RGB")
    arr = np.asarray(im)
    opts = {}
    for k in ("lossless", "quality", "method", "exact", "alpha_quality"):
        if k in params:
            opts[k] = params[k]
    if "use_sharp_yuv" in params:
        opts["use_sharp_yuv"] = params["use_sharp_yuv"]
    fp.write(webp_tpu_torch.encode(arr, device=device, **opts))


_saved_entries: dict = {}


def register(device=None) -> None:
    """Installs this codec as Pillow's WEBP handler (process-wide); its
    decodes and encodes run on `device` (None: the card)."""
    Image.init()  # load built-in plugins first so ours replaces theirs
    _saved_entries.setdefault("open", Image.OPEN.get("WEBP"))
    _saved_entries.setdefault("save", Image.SAVE.get("WEBP"))
    Image.register_open(WebPTpuImageFile.format,
                        functools.partial(WebPTpuImageFile, device=device),
                        _accept)
    Image.register_save(WebPTpuImageFile.format,
                        functools.partial(_save, device=device))
    Image.register_extension(WebPTpuImageFile.format, ".webp")
    Image.register_mime(WebPTpuImageFile.format, "image/webp")


def unregister() -> None:
    """Restores Pillow's own WEBP plugin entries."""
    if _saved_entries.get("open") is not None:
        Image.OPEN["WEBP"] = _saved_entries["open"]
    else:
        Image.OPEN.pop("WEBP", None)
    if _saved_entries.get("save") is not None:
        Image.SAVE["WEBP"] = _saved_entries["save"]
    else:
        Image.SAVE.pop("WEBP", None)
    _saved_entries.clear()


def open_bytes(data: bytes, device=None) -> Image.Image:
    """Decodes WebP bytes to a PIL Image via this codec, on `device`
    (None: the card), with no registration."""
    f = WebPTpuImageFile(io.BytesIO(data), device=device)
    f.load()
    return f
