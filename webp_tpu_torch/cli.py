"""gwebp-equivalent CLI: enc / dec / info subcommands.

The port's counterpart of webp_tpu/cli.py, with the same subcommands,
flags, preset handling, exit codes and info text: encode (PNG/JPEG/GIF
-> WebP, animated GIF -> ANIM), decode (WebP -> PNG or JPEG, animated
WebP -> GIF), info (container summary). stdin/stdout via '-'.

Usage:
  python -m webp_tpu_torch.cli enc [-q N] [-m N] [-lossless] ... [-device D] in out
  python -m webp_tpu_torch.cli dec [-fmt F] [-device D] in out
  python -m webp_tpu_torch.cli info in

The port's entry points run on the card unless the caller asks for the
CPU, so two things differ from webp_tpu.cli: enc's -backend defaults to
"device" (the reference's to "host"), and enc and dec take -device (the
torch device of the device backends: the card by default, "cpu" for the
kernels' plain versions). `enc in.png out.webp` therefore writes the
bytes of `python -m webp_tpu.cli enc -backend device in.png out.webp`,
and `enc -backend host` those of the reference's defaults.

PNG input (told by its signature, since '-' has no name) and output
need no Pillow (utils/png.py). JPEG and GIF input, an APNG, and JPEG,
GIF or any other -fmt output go through Pillow, imported inside the
function that needs it, with the reference's calls; without Pillow such
a command prints one line to stderr and returns 2.
"""

from __future__ import annotations

import argparse
import io
import sys

import numpy as np


def _read(path: str) -> bytes:
    if path == "-":
        return sys.stdin.buffer.read()
    with open(path, "rb") as f:
        return f.read()


def _write(path: str, data: bytes) -> None:
    if path == "-":
        sys.stdout.buffer.write(data)
    else:
        with open(path, "wb") as f:
            f.write(data)


def _pillow(cmd: str, what: str):
    """PIL.Image, or None after one line to stderr if Pillow is absent."""
    try:
        from PIL import Image
    except ImportError:
        print(f"{cmd}: {what} needs Pillow, which is not installed; PNG "
              f"needs none (use a .png file)", file=sys.stderr)
        return None
    return Image


def cmd_enc(args) -> int:
    import webp_tpu_torch
    from .utils import png

    raw = _read(args.input)
    if png.is_png(raw) and not png.is_apng(raw):
        arr = png.read_png(raw)
    else:
        Image = _pillow("enc", "an input other than PNG")
        if Image is None:
            return 2
        im = Image.open(io.BytesIO(raw))
        if getattr(im, "is_animated", False):
            from .animation.animation import AnimEncodeOptions, AnimEncoder

            # GIF (or any animated input) -> animated WebP with full
            # compositing.
            opts = AnimEncodeOptions(lossless=args.lossless, quality=args.q,
                                     method=args.m,
                                     loop_count=im.info.get("loop", 0))
            w, h = im.size
            enc = AnimEncoder(w, h, opts, device=args.device,
                              backend=args.backend)
            for i in range(im.n_frames):
                im.seek(i)
                dur = int(im.info.get("duration", 100)) or 100
                enc.add_frame(np.array(im.convert("RGBA")), dur)
            _write(args.output, enc.assemble())
            return 0
        arr = np.array(im.convert("RGBA" if "A" in im.getbands() else "RGB"))

    # Preset defaults first, explicit flags override (cwebp semantics;
    # reference cmd/gwebp/main.go:115-140).
    from .encoder import PRESETS

    if args.preset not in PRESETS:
        print(f"enc: unknown preset {args.preset!r}", file=sys.stderr)
        return 2
    kw = dict(PRESETS[args.preset])
    kw.update(lossless=args.lossless, quality=args.q, method=args.m,
              use_sharp_yuv=args.sharp_yuv, exact=args.exact,
              alpha_quality=args.alpha_q, partitions=args.partitions,
              target_size=args.size, target_psnr=args.psnr,
              filter_sharpness=args.sharpness, preprocessing=args.pre,
              near_lossless=args.near_lossless,
              alpha_compression=args.alpha_method,
              autofilter=args.af, partition_limit=args.partition_limit,
              backend=args.backend)
    if args.f >= 0:
        kw["filter_strength"] = args.f
    if args.sns >= 0:
        kw["sns_strength"] = args.sns
    if args.segments >= 0:
        kw["segments"] = args.segments
    if args.passes >= 0:
        kw["pass_count"] = args.passes
    if args.alpha_filter:
        kw["alpha_filtering"] = {"none": 0, "fast": 1,
                                 "best": 2}[args.alpha_filter]
    if args.nostrong:
        kw["filter_type"] = 0
    data = webp_tpu_torch.encode(arr, device=args.device, **kw)
    _write(args.output, data)
    return 0


def cmd_dec(args) -> int:
    import webp_tpu_torch
    from .container.parser import get_features
    from .utils import png

    data = _read(args.input)
    f = get_features(data)
    if f.has_anim:
        Image = _pillow("dec", "GIF output (animated WebP)")
        if Image is None:
            return 2
        from .animation.animation import AnimDecoder, decode_animation

        anim = decode_animation(data, device=args.device)
        dec = AnimDecoder(anim, device=args.device)
        frames = []
        durations = []
        for canvas, dur in dec:
            frames.append(Image.fromarray(canvas))
            durations.append(max(dur, 10))
        buf = io.BytesIO()
        frames[0].save(buf, format="GIF", save_all=True,
                       append_images=frames[1:], duration=durations,
                       loop=anim.loop_count, disposal=2)
        _write(args.output, buf.getvalue())
        return 0

    fmt = (args.fmt or "").lower() or (
        "jpeg" if args.output.lower().endswith((".jpg", ".jpeg")) else "png")
    if fmt != "png":
        Image = _pillow("dec", f"{fmt.upper()} output")
        if Image is None:
            return 2
    dev = args.device
    img = (webp_tpu_torch.decode(data, device=dev) if fmt == "jpeg"
           else webp_tpu_torch.decode_rgba(data, device=dev) if f.has_alpha
           else webp_tpu_torch.decode(data, device=dev))
    if fmt == "png":
        _write(args.output, png.write_png(img))
        return 0
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format=fmt.upper())
    _write(args.output, buf.getvalue())
    return 0


def cmd_info(args) -> int:
    from .container.parser import Parser

    data = _read(args.input)
    p = Parser(data)
    f = p.features
    print(f"format:      {f.format.name}")
    print(f"dimensions:  {f.width}x{f.height}")
    print(f"alpha:       {f.has_alpha}")
    print(f"animation:   {f.has_anim}")
    if f.has_anim:
        print(f"frames:      {len(p.frames())}")
        print(f"loop count:  {f.loop_count}")
    meta = [name for name, present in
            (("ICCP", f.has_iccp), ("EXIF", f.has_exif), ("XMP", f.has_xmp))
            if present]
    print(f"metadata:    {', '.join(meta) if meta else 'none'}")
    print(f"file size:   {len(data)} bytes")
    print("chunks:      " + " ".join(
        f"{c.tag.decode('ascii', 'replace').strip()}({len(c.payload)})"
        for c in p.chunks()))
    return 0


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="webp_tpu_torch",
        description="WebP codec CLI (PyTorch/CUDA port of webp_tpu)")
    sub = ap.add_subparsers(dest="cmd", required=True)
    device_help = ("torch device of the device backends (default: the "
                   "card; cpu runs the kernels' plain versions)")

    enc = sub.add_parser("enc", help="encode image to WebP")
    enc.add_argument("-q", type=float, default=75, help="quality 0-100")
    enc.add_argument("-m", type=int, default=4, help="method 0-6")
    enc.add_argument("-lossless", action="store_true")
    enc.add_argument("-preset", default="default",
                     help="default/picture/photo/drawing/icon/text")
    enc.add_argument("-sharp_yuv", action="store_true")
    enc.add_argument("-exact", action="store_true")
    enc.add_argument("-size", type=int, default=0,
                     help="target size in bytes (0=use quality)")
    enc.add_argument("-psnr", type=float, default=0.0,
                     help="target PSNR in dB (0=use quality)")
    enc.add_argument("-sns", type=int, default=-1,
                     help="spatial noise shaping 0-100 (-1=preset)")
    enc.add_argument("-f", type=int, default=-1,
                     help="filter strength 0-100 (-1=preset)")
    enc.add_argument("-sharpness", type=int, default=0,
                     help="filter sharpness 0-7")
    enc.add_argument("-strong", action="store_true",
                     help="strong filter (default)")
    enc.add_argument("-nostrong", action="store_true",
                     help="simple filter instead of strong")
    enc.add_argument("-segments", type=int, default=-1,
                     help="segments 1-4 (-1=preset)")
    enc.add_argument("-pass", dest="passes", type=int, default=-1,
                     help="analysis passes 1-10 (-1=default)")
    enc.add_argument("-alpha_q", type=int, default=100)
    enc.add_argument("-alpha_method", type=int, default=1,
                     help="alpha compression 0-1")
    enc.add_argument("-alpha_filter", default="",
                     help="alpha filter: none/fast/best")
    enc.add_argument("-pre", type=int, default=0,
                     help="pre-processing filter 0-3")
    enc.add_argument("-near_lossless", type=int, default=100,
                     help="near-lossless strength 0-100")
    enc.add_argument("-partitions", type=int, default=0)
    enc.add_argument("-af", action="store_true",
                     help="autofilter: search the loop-filter strength")
    enc.add_argument("-partition_limit", type=int, default=0,
                     help="0-100: degrade I4 headers to fit partition 0")
    enc.add_argument("-backend", default="device",
                     choices=("host", "device", "auto"),
                     help="encode backend (device = the card's program, "
                          "host = the exact host encoder)")
    enc.add_argument("-device", default=None, help=device_help)
    enc.add_argument("input")
    enc.add_argument("output")
    enc.set_defaults(fn=cmd_enc)

    dec = sub.add_parser("dec", help="decode WebP to PNG (or GIF if animated)")
    dec.add_argument("-fmt", default="",
                     help="output format: png/jpeg (default: by extension)")
    dec.add_argument("-device", default=None, help=device_help)
    dec.add_argument("input")
    dec.add_argument("output")
    dec.set_defaults(fn=cmd_dec)

    info = sub.add_parser("info", help="show WebP file info")
    info.add_argument("input")
    info.set_defaults(fn=cmd_info)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
