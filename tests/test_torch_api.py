"""The single-image entry end to end on the CPU: webp_tpu_torch.encode(img,
device="cpu", **options) (every kernel's plain version) writes the file
webp_tpu.encode(img, backend="device", **options) writes, byte for byte,
for the options this package ports (backend="host" writes the file of
the reference's default backend), and raises NotImplementedError for
those it does not port yet. Methods 5 and 6 and sharp YUV are held here
by the device program's settings (as the reference's encode() asks for
them) and byte for byte in test_torch_method5.py, test_torch_method6.py
and test_torch_sharpyuv.py.

Each reference configuration (geometry, quality, segments, SNS, I4)
compiles its own JAX program on the CPU, ~5-25 s each, so the cases use
the smallest geometries that reach their branch and share compiles where
the device program is the same: the 32x16 cases (fewer than 4 MBs, so
unsegmented at any setting) all run the text preset's program, with the
dithering, metadata and opaque-RGBA options on top, and the default
configuration is compared with the port's own encode_batch (which
tests/test_torch_encode.py holds equal to the reference)."""

import dataclasses

import numpy as np
import pytest
import torch

import webp_tpu
import webp_tpu_torch
from test_torch_encode import _images
from webp_tpu import encoder as ENC_ref
from webp_tpu_torch import encoder as ENC
from webp_tpu_torch.lossy import device_encode as DE
from webp_tpu_torch.ops import cuda


def _noise(h, w, seed):
    return np.random.default_rng(seed).integers(0, 256, (h, w, 3), np.uint8)


def _opaque_rgba(img):
    return np.concatenate([img, np.full(img.shape[:2] + (1,), 255,
                                        np.uint8)], axis=-1)


META = dict(iccp=b"icc-profile-bytes", exif=b"Exif\0\0II*\0",
            xmp=b"<x:xmpmeta xmlns:x='adobe:ns:meta/'/>")

# The text preset's options (2 segments, SNS 0, no filter), given as
# keywords: the 32x16 cases share its device program.
TEXT = webp_tpu_torch.PRESETS["text"]

# case -> (image, options, fallbacks expected). 64x16 is the smallest
# segmented geometry (4 MBs); 32x16 (2 MBs) is unsegmented at any
# segments setting.
CASES = {
    "method2_i4_off": (lambda: _images(1, 16, 64, 11)[0], dict(method=2), 0),
    "segments1": (lambda: _images(1, 16, 64, 12)[0], dict(segments=1), 0),
    "32x16": (lambda: _images(1, 16, 32, 13)[0], TEXT, 0),
    "preset_text": (lambda: _images(1, 16, 32, 14)[0], "text", 0),
    "preprocessing2": (lambda: _images(1, 16, 32, 13)[0],
                       dict(TEXT, preprocessing=2), 0),
    "icc_exif_xmp": (lambda: _images(1, 16, 32, 13)[0], dict(TEXT, **META),
                     0),
    "opaque_rgba": (lambda: _opaque_rgba(_images(1, 16, 32, 13)[0]), TEXT,
                    0),
    # q99 noise overflows the escape list (48 MBs, capacity 1024 blocks):
    # the exact host encoder re-encodes it from the host planes, dithered
    # in the second case. Methods 0-2 and one segment keep the (unused)
    # device program's compile short.
    "q99_fallback": (lambda: _noise(96, 128, 0),
                     dict(quality=99, method=2, segments=1), 1),
    "q99_fallback_dithered": (lambda: _noise(96, 128, 0),
                              dict(quality=99, method=2, segments=1,
                                   preprocessing=2), 1),
}


def _encode_both(img, opts):
    """(port file, port stats, reference file, reference stats)."""
    if isinstance(opts, str):        # a preset, through options=
        got = webp_tpu_torch.encode(
            img, device="cpu", options=webp_tpu_torch.options_for_preset(
                opts, 75))
        stats = webp_tpu_torch.LAST_STATS
        ref = webp_tpu.encode(img, options=dataclasses.replace(
            ENC_ref.options_for_preset(opts, 75), backend="device"))
    else:
        got = webp_tpu_torch.encode(img, device="cpu", **opts)
        stats = webp_tpu_torch.LAST_STATS
        ref = webp_tpu.encode(img, backend="device", **opts)
    return got, stats, ref, ENC_ref.LAST_STATS


@pytest.mark.parametrize("case", list(CASES))
def test_encode_byte_identical_to_reference(case):
    make, opts, fallbacks = CASES[case]
    img = make()
    DE.FALLBACKS["images"] = 0
    got, stats, ref, ref_stats = _encode_both(img, opts)
    assert DE.FALLBACKS["images"] == fallbacks
    assert got[:4] == b"RIFF" and got[8:12] == b"WEBP"
    assert got == ref
    assert dataclasses.astuple(stats) == dataclasses.astuple(ref_stats)
    if case == "icc_exif_xmp":
        assert got[12:16] == b"VP8X"
        assert all(v in got for v in META.values())


@pytest.mark.parametrize("geom", [(64, 48), (72, 40)])
def test_encode_defaults_equal_encode_batch(geom):
    """At the defaults (method 4, 4 segments, SNS 50) encode() runs the
    batched path's program at B=1: its file equals encode_batch's, whose
    files tests/test_torch_encode.py holds equal to the reference's."""
    w, h = geom
    img = _images(1, h, w, seed=w + 1)[0]
    cuda.reset_launches()
    got = webp_tpu_torch.encode(img, device="cpu")
    assert all(n == 0 for n in cuda.LAUNCHES.values())
    assert got == webp_tpu_torch.encode_batch([img], device="cpu")[0]
    assert webp_tpu_torch.LAST_STATS.size == int.from_bytes(got[16:20],
                                                            "little")


def test_single_configuration_runs_no_alpha_kernel_and_no_i4_search(
        monkeypatch):
    """Unsegmented, the device program skips phase 0 (no segment alphas);
    with I4 off it skips the I4 search; phase 2 then gets a zero segment
    map and a zero I4 split."""
    from webp_tpu_torch.ops import i4_kernel as I4K
    from webp_tpu_torch.ops import p1_kernels as P1K
    from webp_tpu_torch.ops import p2_kernel as P2K

    called, seen = [], {}

    def boom(name):
        def f(*a, **k):
            called.append(name)
            raise AssertionError(f"{name} ran")
        return f

    orig = P2K.phase2_pack

    def p2(*a):
        seen["is_i4"], seen["seg_map"] = a[5], a[7]
        return orig(*a)

    monkeypatch.setattr(P1K, "alphas", boom("alphas"))
    monkeypatch.setattr(I4K, "i4_scores", boom("i4_scores"))
    monkeypatch.setattr(P2K, "phase2_pack", p2)
    img = _images(1, 16, 32, 13)[0]
    webp_tpu_torch.encode(img, device="cpu", method=2)
    assert not called and set(seen) == {"is_i4", "seg_map"}
    assert not any(bool(t.any()) for t in seen.values())


@pytest.mark.parametrize("opts", [dict(lossless=True), "alpha"], ids=str)
def test_options_outside_the_slice_raise_not_implemented(opts):
    """Each option whose slice is not ported raises before any work and
    names where it is planned; so does an image with alpha < 255."""
    img = _images(1, 16, 32, 13)[0]
    if opts == "alpha":
        img, opts = _opaque_rgba(img), {}
        img[0, 0, 3] = 0
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        webp_tpu_torch.encode(img, device="cpu", **opts)


@pytest.mark.parametrize("opts", [
    dict(backend="host"), dict(backend="auto"), dict(TEXT, autofilter=True),
    dict(target_size=2000), dict(target_psnr=40.0)], ids=str)
def test_options_the_decoder_unblocked_equal_the_reference(opts):
    """The options that raised until the decoder was ported write the
    reference's files at 32x16: the host backend (the reference's
    default), "auto" (the device program in both packages), autofilter
    on the device path (with the text preset, whose device program the
    other 32x16 cases compile) and rate control (on the host backend
    here: on the device one every pass is a new reference program;
    tests/test_torch_ratecontrol.py holds that controller)."""
    img = _images(1, 16, 32, 13)[0]
    if "target_size" in opts or "target_psnr" in opts:
        opts = dict(opts, backend="host")
    got = webp_tpu_torch.encode(img, device="cpu", **opts)
    stats = dataclasses.astuple(webp_tpu_torch.LAST_STATS)
    if opts.get("backend") == "auto":
        assert got == webp_tpu_torch.encode(img, device="cpu")
        return
    assert got == webp_tpu.encode(img, **dict(dict(backend="device"),
                                              **opts))
    assert stats == dataclasses.astuple(ENC_ref.LAST_STATS)


def test_unknown_backend_raises():
    with pytest.raises(ValueError, match="backend"):
        webp_tpu_torch.encode(_images(1, 16, 32, 13)[0], backend="tpu")


@pytest.mark.parametrize("opts", [dict(method=5), dict(method=6),
                                  dict(use_sharp_yuv=True)], ids=str)
def test_quality_options_configure_the_reference_program(opts, monkeypatch):
    """Methods 5 and 6 and sharp YUV ask the device program for the
    settings the reference's encode() asks for (skew, trellis, in-loop
    search, sharp import), read from both fast_encode_fn calls; the
    reference's program is not compiled here (its files are held against
    the port's in test_torch_method5.py, test_torch_method6.py and
    test_torch_sharpyuv.py)."""
    from webp_tpu.ops import fastpath as FP_ref
    from webp_tpu_torch.ops import fastpath as FP

    seen = {}

    class Stop(Exception):
        pass

    def spy(key, orig):
        def f(*a, **k):
            seen[key] = (a, k)
            if key == "ref":
                raise Stop
            return orig(*a, **k)
        return f

    monkeypatch.setattr(FP, "fast_encode_fn", spy("port", FP.fast_encode_fn))
    monkeypatch.setattr(FP_ref, "fast_encode_fn",
                        spy("ref", FP_ref.fast_encode_fn))
    img = _images(1, 16, 32, 13)[0]
    got = webp_tpu_torch.encode(img, device="cpu", **opts)
    assert got[:4] == b"RIFF" and got[12:16] == b"VP8 "
    with pytest.raises(Stop):
        webp_tpu.encode(img, backend="device", **opts)
    assert seen["port"] == seen["ref"]


def test_bad_input_raises_webp_error():
    with pytest.raises(webp_tpu_torch.WebPError):
        webp_tpu_torch.encode(np.zeros((16, 16), np.uint8), device="cpu")
    with pytest.raises(webp_tpu_torch.WebPError):
        webp_tpu_torch.encode(np.zeros((0, 16, 3), np.uint8), device="cpu")
    with pytest.raises(webp_tpu_torch.WebPError):
        webp_tpu_torch.options_for_preset("poster")


def test_encode_without_a_card_raises():
    """device=None asks for the card: without one encode() raises rather
    than running the plain versions on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    with pytest.raises((RuntimeError, AssertionError)):
        webp_tpu_torch.encode(_images(1, 16, 32, 13)[0])


def test_dithered_import_equals_reference():
    """The dithered host import (numpy, VP8Random stream) equals the
    reference's on an odd-sized image, and differs from the plain one."""
    img = _images(1, 21, 37, 5)[0]
    got = ENC.rgb_to_yuv420(img, dithering=0.75)
    ref = ENC_ref.rgb_to_yuv420(img, dithering=0.75)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g, r)
    assert not np.array_equal(got[0], ENC.rgb_to_yuv420(img)[0])
