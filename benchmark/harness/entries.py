"""How a mix's entry point is called: the measured package's public
entry points, with a configuration's options, on a pool of inputs made
in set-up."""

from __future__ import annotations

import hashlib

import numpy as np
import torch

from . import images, traffic

# encode()'s defaults for the options a configuration may set.
ENCODE_DEFAULTS = {"quality": 75, "method": 4, "segments": 4,
                   "sns_strength": 50, "filter_strength": 60,
                   "filter_sharpness": 0, "filter_type": 1, "partitions": 0,
                   "preprocessing": 0}
# The options the batched entries (encode_lossy_stream, encode_batch)
# take; the rest is fixed there at encode()'s defaults.
BATCH_KEYS = ("quality", "segments", "sns_strength", "filter_strength",
              "partitions")


def batch_options(options: dict, entry: str) -> dict:
    """The options a batched entry takes; raises where the configuration
    asks for a value the entry cannot give."""
    opts = dict(ENCODE_DEFAULTS, **options)
    fixed = {k: v for k, v in opts.items() if k not in BATCH_KEYS}
    wrong = {k: v for k, v in fixed.items() if v != ENCODE_DEFAULTS.get(k)}
    if wrong:
        raise ValueError(f"{entry} cannot run with {wrong}")
    return {k: int(opts[k]) for k in BATCH_KEYS}


def make_images(mix: dict, seed: int, device) -> list:
    """The pool's images as numpy uint8 [h, w, 3], made on `device`."""
    g = images.generator(seed, device)
    sizes = traffic.pool_sizes(mix)
    out = []
    for w, h in dict.fromkeys(sizes):
        n = sizes.count((w, h))
        out += list(images.synth_images(g, n, h, w, device).cpu().numpy())
    return out


def make_files(mix: dict, options: dict, imgs: list, device) -> list:
    """The decode pool: each image written by the entry the mix names
    (encode_batch, in batches of files["batch"] same-sized images)."""
    import webp_tpu_torch

    spec = mix["files"]
    if spec.get("entry") != "encode_batch":
        raise ValueError(f"files by {spec.get('entry')!r} are not supported")
    kw = batch_options(options, "encode_batch")
    quality = kw.pop("quality")
    n = int(spec.get("batch", 16))
    out = []
    for i in range(0, len(imgs), n):
        out += webp_tpu_torch.encode_batch(imgs[i:i + n], quality,
                                           device=device, **kw)
    return out


def pool_hash(items: list) -> str:
    h = hashlib.sha256()
    for x in items:
        h.update(x if isinstance(x, bytes) else np.ascontiguousarray(x).data)
    return h.hexdigest()[:16]


def make_call(mix: dict, options: dict, inputs: list, device):
    """call(items) -> outputs, one per item, through the mix's entry."""
    extra = dict(mix.get("call_options", {}))
    entry = mix["entry"]
    if entry == "encode":
        from webp_tpu_torch import encode

        kw = dict(options, **extra)
        return lambda items: [encode(inputs[items[0]], device=device, **kw)]
    if entry == "encode_lossy_stream":
        from webp_tpu_torch.lossy.device_encode import encode_lossy_stream

        kw = dict(batch_options(options, entry), **extra)
        return lambda items: encode_lossy_stream(
            [inputs[i] for i in items], device=device, **kw)
    if entry == "decode":
        from webp_tpu_torch import decode

        return lambda items: [decode(inputs[items[0]], device=device,
                                     **extra)]
    raise ValueError(f"unknown entry {entry!r}")


def warm(call, mix: dict) -> int:
    """One request per geometry of the pool, of the window's length:
    every shape the window uses is compiled and captured here. Returns
    the requests made."""
    sizes = traffic.pool_sizes(mix)
    per = int(mix.get("items_per_request", 1))
    geometries = list(dict.fromkeys(sizes))
    for wh in geometries:
        same = [i for i, s in enumerate(sizes) if s == wh]
        call([same[k % len(same)] for k in range(per)])
    return len(geometries)


def synchronize(device) -> None:
    if torch.device(device if device is not None else "cuda").type == "cuda":
        torch.cuda.synchronize()
