"""The port's command line tool (webp_tpu_torch/cli.py) against the
reference's (webp_tpu/cli.py) on the same files, on the CPU (the port
with -device cpu): enc writes the same WebP bytes (the port's default
backend is "device", the reference's "host", so each is compared with
the other's matching backend), dec the same PNG pixels and the same
JPEG and GIF bytes, info the same text; stdin/stdout, the error paths,
and a process where Pillow cannot be imported, in which PNG still works
and JPEG/GIF return 2.

One reference device program is compiled here (64x48 at the defaults,
which tests/test_torch_ratecontrol.py also compiles); every other
reference encode runs its host backend."""

import io
import os
import subprocess
import sys

import numpy as np
import pytest
from PIL import Image

import webp_tpu_torch
from test_torch_encode import _images
from webp_tpu.cli import main as ref_main
from webp_tpu_torch.cli import main
from webp_tpu_torch.utils.png import read_png, write_png

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CPU = ["-device", "cpu"]
IMG = _images(1, 48, 64, 21)[0]


def _alpha():
    y, x = np.mgrid[0:48, 0:64]
    a = np.clip((x - 20) * 9, 0, 255)
    a[:10] = 0
    a[24:36, 32:] = np.random.default_rng(3).integers(0, 256, (12, 32))
    return a.astype(np.uint8)


RGBA = np.dstack([IMG, _alpha()])


def _gif_frames():
    rng = np.random.default_rng(0)
    base = rng.integers(0, 255, (32, 48, 3), np.uint8)
    frames = []
    for i in range(3):
        f = base.copy()
        f[8 * i: 8 * i + 8] = (255, 0, 0)
        frames.append(Image.fromarray(f))
    return frames


@pytest.fixture(scope="module")
def files(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli")
    out = {"dir": d}
    for name, arr in (("rgb", IMG), ("rgba", RGBA)):
        out[name] = str(d / f"{name}.png")
        with open(out[name], "wb") as f:
            f.write(write_png(arr))
    out["la"] = str(d / "la.png")
    Image.fromarray(np.dstack([IMG[..., 1], _alpha()]), "LA").save(out["la"])
    frames = _gif_frames()
    out["gif"] = str(d / "a.gif")
    frames[0].save(out["gif"], save_all=True, append_images=frames[1:],
                   duration=100, loop=0)
    out["apng"] = str(d / "a.png")
    frames[0].save(out["apng"], format="PNG", save_all=True,
                   append_images=frames[1:], duration=[80, 120, 100], loop=0)
    return out


def _enc(fn, args, src, dst):
    assert fn(["enc"] + args + [src, dst]) == 0
    with open(dst, "rb") as f:
        return f.read()


@pytest.mark.parametrize("src", ["rgb", "rgba", "la"])
def test_enc_default_equals_reference_device_backend(files, src, tmp_path):
    """The port's defaults (the device program) write the reference's
    `enc -backend device` file."""
    got = _enc(main, CPU, files[src], str(tmp_path / "p.webp"))
    want = _enc(ref_main, ["-backend", "device"], files[src],
                str(tmp_path / "r.webp"))
    assert got == want


@pytest.mark.parametrize("src", ["rgb", "rgba", "la"])
def test_enc_host_backend_equals_reference_default(files, src, tmp_path):
    got = _enc(main, ["-backend", "host"], files[src],
               str(tmp_path / "p.webp"))
    want = _enc(ref_main, [], files[src], str(tmp_path / "r.webp"))
    assert got == want


@pytest.mark.parametrize("src", ["rgb", "rgba"])
@pytest.mark.parametrize("flags", [["-lossless"], ["-lossless", "-exact"],
                                   ["-lossless", "-near_lossless", "60"]],
                         ids=" ".join)
def test_enc_lossless_equals_reference(files, src, flags, tmp_path):
    """Lossless files are the same on every backend: the port's default
    (predictor search in PyTorch on `-device`) against the reference's."""
    got = _enc(main, flags + CPU, files[src], str(tmp_path / "p.webp"))
    want = _enc(ref_main, flags, files[src], str(tmp_path / "r.webp"))
    assert got == want
    if "-near_lossless" not in flags:
        back = webp_tpu_torch.decode(got, device="cpu")
        src_px = read_png(open(files[src], "rb").read())
        keep = src_px[..., 3] > 0 if src == "rgba" and "-exact" not in \
            flags else np.ones(src_px.shape[:2], bool)
        assert np.array_equal(back[keep], src_px[keep])


EXTENDED = [
    ["-preset", "photo", "-sns", "30", "-sharpness", "2", "-pass", "2",
     "-q", "60"],
    ["-size", "900"], ["-psnr", "40"], ["-af"], ["-nostrong"],
    ["-segments", "2"], ["-partitions", "2"], ["-partition_limit", "50"],
    ["-alpha_filter", "best", "-alpha_q", "50"], ["-f", "20", "-m", "6"],
    ["-sharp_yuv"], ["-pre", "2"], ["-alpha_method", "0"],
    ["-preset", "text"], ["-preset", "icon", "-q", "90", "-strong"]]


@pytest.mark.parametrize("flags", EXTENDED, ids=" ".join)
def test_enc_extended_flags_host_backend_equal_reference(files, flags,
                                                         tmp_path):
    src = files["rgba" if flags[0].startswith("-alpha") else "rgb"]
    got = _enc(main, ["-backend", "host"] + flags, src,
               str(tmp_path / "p.webp"))
    want = _enc(ref_main, flags, src, str(tmp_path / "r.webp"))
    assert got == want


@pytest.mark.parametrize("flags", [["-lossless"], ["-q", "60"]], ids=" ".join)
@pytest.mark.parametrize("src", ["gif", "apng"])
def test_animated_input_equals_reference(files, src, flags, tmp_path):
    """An animated GIF (and an APNG, which Pillow also opens as an
    animation) becomes the reference's animated WebP; dec turns it into
    the reference's GIF bytes."""
    got = _enc(main, flags + CPU, files[src], str(tmp_path / "p.webp"))
    want = _enc(ref_main, flags, files[src], str(tmp_path / "r.webp"))
    assert got == want
    im = Image.open(io.BytesIO(got))
    assert getattr(im, "is_animated", False) and im.n_frames == 3
    assert main(["dec"] + CPU + [str(tmp_path / "p.webp"),
                                 str(tmp_path / "p.gif")]) == 0
    assert ref_main(["dec", str(tmp_path / "r.webp"),
                     str(tmp_path / "r.gif")]) == 0
    gif = open(tmp_path / "p.gif", "rb").read()
    assert gif == open(tmp_path / "r.gif", "rb").read()
    assert Image.open(io.BytesIO(gif)).n_frames == 3


@pytest.fixture(scope="module")
def webps(files):
    """A VP8 file, a VP8X file with ALPH and metadata, a VP8L file and an
    ANIM file."""
    d = files["dir"]
    out = {}
    blobs = {
        "vp8": webp_tpu_torch.encode(IMG, backend="host"),
        "vp8x_alph_meta": webp_tpu_torch.encode(
            RGBA, backend="host", iccp=b"icc-bytes", exif=b"Exif\0\0II",
            xmp=b"<x/>"),
        "vp8l": webp_tpu_torch.encode(IMG, lossless=True, device="cpu"),
    }
    for name, data in blobs.items():
        out[name] = str(d / f"{name}.webp")
        with open(out[name], "wb") as f:
            f.write(data)
    out["anim"] = str(d / "anim.webp")
    assert main(["enc", "-lossless"] + CPU + [files["gif"], out["anim"]]) == 0
    return out


@pytest.mark.parametrize("name", ["vp8", "vp8x_alph_meta", "vp8l", "anim"])
def test_info_prints_the_reference_text(webps, name, capsys):
    assert main(["info", webps[name]]) == 0
    got = capsys.readouterr().out
    assert ref_main(["info", webps[name]]) == 0
    assert got == capsys.readouterr().out
    assert "format:" in got and "chunks:" in got


@pytest.mark.parametrize("name", ["vp8", "vp8x_alph_meta", "vp8l"])
def test_dec_png_pixels_and_jpeg_bytes_equal_reference(webps, name,
                                                       tmp_path):
    src = webps[name]
    assert main(["dec"] + CPU + [src, str(tmp_path / "p.png")]) == 0
    assert ref_main(["dec", src, str(tmp_path / "r.png")]) == 0
    got = read_png(open(tmp_path / "p.png", "rb").read())
    want = np.array(Image.open(tmp_path / "r.png"))
    assert got.shape == want.shape and np.array_equal(got, want)
    assert np.array_equal(np.array(Image.open(tmp_path / "p.png")), want)
    if name == "vp8x_alph_meta":
        return  # an RGBA decode: JPEG cannot hold it, in either tool
    for out, fmt in (("x.jpg", []), ("x.JPEG", []), ("x.bin", ["-fmt",
                                                               "jpeg"])):
        assert main(["dec"] + fmt + CPU + [src, str(tmp_path / out)]) == 0
        assert ref_main(["dec"] + fmt + [src, str(tmp_path / f"r{out}")]) \
            == 0
        jpg = open(tmp_path / out, "rb").read()
        assert jpg == open(tmp_path / f"r{out}", "rb").read()
        assert Image.open(io.BytesIO(jpg)).format == "JPEG"


def test_stdin_and_stdout(files, tmp_path, monkeypatch, capsysbinary):
    png = open(files["rgb"], "rb").read()
    want = _enc(main, ["-backend", "host"], files["rgb"],
                str(tmp_path / "f.webp"))
    monkeypatch.setattr(sys, "stdin", io.TextIOWrapper(io.BytesIO(png)))
    assert main(["enc", "-backend", "host", "-", "-"]) == 0
    assert capsysbinary.readouterr().out == want
    monkeypatch.setattr(sys, "stdin", io.TextIOWrapper(io.BytesIO(want)))
    assert main(["dec"] + CPU + ["-", "-"]) == 0
    back = read_png(capsysbinary.readouterr().out)
    assert np.array_equal(back, webp_tpu_torch.decode(want, backend="host"))


def test_missing_input_raises_and_unknown_preset_returns_2(files, tmp_path,
                                                           capsys):
    missing = str(tmp_path / "missing.webp")
    for fn in (main, ref_main):
        for argv in (["info", missing], ["dec", missing, missing + ".png"],
                     ["enc", missing, missing]):
            with pytest.raises(FileNotFoundError):
                fn(argv)
    out = str(tmp_path / "o.webp")
    assert main(["enc", "-preset", "nope", files["rgb"], out]) == 2
    err = capsys.readouterr().err
    assert ref_main(["enc", "-preset", "nope", files["rgb"], out]) == 2
    assert err == capsys.readouterr().err == "enc: unknown preset 'nope'\n"
    assert not os.path.exists(out)


_NO_PILLOW = r"""
import json, sys
import webp_tpu_torch.cli as cli
loaded = sorted(m for m in sys.modules if m.split(".")[0] == "PIL")
sys.modules["PIL"] = None
d, anim = sys.argv[1], sys.argv[2]
rc = {
    "enc": cli.main(["enc", "-device", "cpu", d + "/rgb.png", d + "/d.webp"]),
    "enc_host": cli.main(["enc", "-backend", "host", d + "/rgba.png",
                          d + "/h.webp"]),
    "enc_ll": cli.main(["enc", "-lossless", "-device", "cpu",
                        d + "/rgb.png", d + "/l.webp"]),
    "dec": cli.main(["dec", "-device", "cpu", d + "/h.webp", d + "/h.png"]),
    "info": cli.main(["info", d + "/d.webp"]),
    "gif_in": cli.main(["enc", "-device", "cpu", d + "/a.gif", d + "/g.webp"]),
    "apng_in": cli.main(["enc", "-device", "cpu", d + "/a.png",
                         d + "/g.webp"]),
    "jpeg_out": cli.main(["dec", "-device", "cpu", d + "/d.webp",
                          d + "/x.jpg"]),
    "gif_out": cli.main(["dec", "-device", "cpu", anim, d + "/x.gif"]),
}
print(json.dumps({"loaded": loaded, "rc": rc}))
"""


def test_without_pillow_png_works_and_jpeg_gif_return_2(files, webps,
                                                         tmp_path):
    """In a process where `import PIL` fails: importing the CLI loads no
    PIL, enc/dec/info of PNG give the bytes and pixels they give with
    Pillow, and the JPEG and GIF paths print one line naming Pillow and
    return 2, writing nothing."""
    import json
    import shutil

    d = tmp_path
    for name in ("rgb", "rgba", "gif", "apng"):
        shutil.copy(files[name], d / os.path.basename(files[name]))
    out = subprocess.run(
        [sys.executable, "-c", _NO_PILLOW, str(d), webps["anim"]],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    lines = out.stdout.strip().splitlines()
    res = json.loads(lines[-1])
    assert res["loaded"] == []
    assert res["rc"] == {"enc": 0, "enc_host": 0, "enc_ll": 0, "dec": 0,
                         "info": 0, "gif_in": 2, "apng_in": 2,
                         "jpeg_out": 2, "gif_out": 2}
    err = [l for l in out.stderr.splitlines() if "Pillow" in l]
    assert len(err) == 4, out.stderr
    for name in ("g.webp", "x.jpg", "x.gif"):
        assert not (d / name).exists()
    got = {n: open(d / n, "rb").read() for n in ("d.webp", "h.webp",
                                                 "l.webp")}
    assert got["d.webp"] == webp_tpu_torch.encode(IMG, device="cpu")
    assert got["h.webp"] == webp_tpu_torch.encode(RGBA, backend="host")
    assert got["l.webp"] == webp_tpu_torch.encode(IMG, lossless=True,
                                                  device="cpu")
    assert np.array_equal(read_png(open(d / "h.png", "rb").read()),
                          webp_tpu_torch.decode(got["h.webp"],
                                                backend="host"))
    info = "\n".join(lines[:-1])
    assert "format:      VP8\n" in info + "\n" and "64x48" in info
