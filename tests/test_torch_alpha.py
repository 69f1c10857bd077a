"""The port's alpha on the CPU, against webp_tpu: utils/alpha.py
(premultiply, extraction, the transparent-area cleanup), the ALPH encoder
(level quantization, the filters and their estimate, the headerless VP8L
payload) and decoder (the unfilters), encode(rgba) with alpha < 255 on
the host backend, with metadata, and decode/decode_rgba of lossy files
with an ALPH chunk made by the port, the reference and Pillow, on both
backends. Every comparison is exact. No reference JAX program is
compiled here: the device backend's encode(rgba) is held against the
reference's in tests/test_torch_ratecontrol.py, whose module fixture
already compiles the reference's program for that image."""

import io

import numpy as np
import pytest
from PIL import Image

import webp_tpu
import webp_tpu_torch
from webp_tpu.lossy import alpha as alpha_ref
from webp_tpu.lossy import alpha_enc as aenc_ref
from webp_tpu.utils import alpha as ua_ref
from webp_tpu_torch.lossy import alpha
from webp_tpu_torch.lossy import alpha_enc as aenc
from webp_tpu_torch.utils import alpha as ua


def rgba_image(h, w, seed):
    """RGB gradients and a noisy patch under an alpha plane with a soft
    edge, a fully transparent band and a noisy region."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    rgb = np.stack([x * 255 // max(w - 1, 1), y * 255 // max(h - 1, 1),
                    ((x + 3 * y) * 5) % 256], -1).astype(np.int32)
    rgb[h // 4: h // 2, : w // 2] += rng.integers(-50, 50,
                                                  (h // 2 - h // 4, w // 2, 3))
    a = np.clip((x - w // 3) * 8, 0, 255)
    a[: h // 5] = 0
    a[h // 2: 3 * h // 4, w // 2:] = rng.integers(0, 256, (
        3 * h // 4 - h // 2, w - w // 2))
    return np.clip(np.dstack([rgb, a]), 0, 255).astype(np.uint8)


def alpha_planes():
    rng = np.random.default_rng(0)
    y, x = np.mgrid[0:48, 0:64]
    return {
        "soft": rgba_image(48, 64, 1)[..., 3],
        "binary": ((x // 7 + y // 5) % 2 * 255).astype(np.uint8),
        "ramp_33x17": (np.arange(17 * 33).reshape(17, 33) % 256)
        .astype(np.uint8),
        "noise_96": rng.integers(0, 256, (96, 96), np.uint8),
        "noise_160": np.random.default_rng(5).integers(0, 256, (160, 160),
                                                        np.uint8),
        "few_levels": (rng.integers(0, 4, (40, 50)) * 85).astype(np.uint8),
        "tiny_3x2": np.array([[0, 128], [255, 7], [9, 9]], np.uint8),
    }


PLANES = alpha_planes()


# ---------------------------------------------------------------------------
# utils/alpha.py
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("geom", [(8, 8), (37, 45), (64, 64), (5, 100),
                                  (100, 3)], ids=str)
def test_alpha_utils_equal_reference(geom):
    h, w = geom
    rgba = rgba_image(h, w, h + w)
    for inverse in (False, True):
        assert (ua.premultiply(rgba, inverse) ==
                ua_ref.premultiply(rgba, inverse)).all()
    a, has = ua.extract_alpha(rgba)
    a_ref, has_ref = ua_ref.extract_alpha(rgba)
    assert (a == a_ref).all() and has == has_ref
    assert (ua.dispatch_alpha(rgba[..., :3], a) ==
            ua_ref.dispatch_alpha(rgba[..., :3], a)).all()
    argb = rgba.astype(np.uint32) @ np.array([1 << 16, 1 << 8, 1, 1 << 24],
                                              np.uint32)
    assert (ua.extract_green(argb) == ua_ref.extract_green(argb)).all()
    # Fully transparent runs across 8x8 blocks, mixed blocks, edges.
    rgba[: h // 2, : w // 2, 3] = 0
    got = ua.cleanup_transparent_lossy(rgba)
    assert (got == ua_ref.cleanup_transparent_lossy(rgba)).all()
    assert (got[..., 3] == rgba[..., 3]).all()


# ---------------------------------------------------------------------------
# The ALPH encoder and decoder.
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", list(PLANES))
def test_filters_levels_and_estimate_equal_reference(name):
    a = PLANES[name]
    for f in range(4):
        filtered = aenc.FILTERS[f](a)
        assert (filtered == aenc_ref.FILTERS[f](a)).all()
        assert (alpha.UNFILTERS[f](filtered) ==
                alpha_ref.UNFILTERS[f](filtered)).all()
        assert (alpha.UNFILTERS[f](filtered) == a).all()
    assert aenc._estimate_best_filter(a) == aenc_ref._estimate_best_filter(a)
    for q in (0, 30, 70, 90, 99):
        n = aenc._alpha_levels_for_quality(q)
        assert n == aenc_ref._alpha_levels_for_quality(q)
        assert (aenc.quantize_levels(a, n) ==
                aenc_ref.quantize_levels(a, n)).all()


# (quality, method, filtering, effort): the defaults, each filter mode,
# raw, level quantization and the efforts that change the VP8L settings.
ENCODE_OPTS = [(100, 1, 1, 4), (100, 1, 0, 4), (100, 1, 2, 4),
               (100, 0, 1, 4), (50, 1, 1, 4), (90, 1, 2, 6), (100, 1, 1, 6),
               (100, 1, 1, 1), (20, 1, 0, 0)]


@pytest.mark.parametrize("opts", ENCODE_OPTS, ids=str)
@pytest.mark.parametrize("name", ["soft", "ramp_33x17", "noise_96",
                                  "few_levels"])
def test_encode_alpha_and_decode_alpha_equal_reference(name, opts):
    a = PLANES[name]
    q, m, f, e = opts
    got = aenc.encode_alpha(a, quality=q, method=m, filtering=f, effort=e)
    assert got == aenc_ref.encode_alpha(a, quality=q, method=m,
                                        filtering=f, effort=e)
    h, w = a.shape
    out = alpha.decode_alpha(got, w, h)
    assert (out == alpha_ref.decode_alpha(got, w, h)).all()
    if q == 100:
        assert (out == a).all()


@pytest.mark.parametrize("name", ["binary", "noise_160", "tiny_3x2"])
def test_encode_alpha_other_planes_equal_reference(name):
    a = PLANES[name]
    h, w = a.shape
    for e in (4, 6):
        got = aenc.encode_alpha(a, effort=e)
        assert got == aenc_ref.encode_alpha(a, effort=e)
        assert (alpha.decode_alpha(got, w, h) == a).all()


def test_decode_alpha_bad_input_raises():
    a = PLANES["soft"]
    h, w = a.shape
    good = aenc.encode_alpha(a)
    for bad in (b"", bytes([0]) + a.tobytes()[:10], bytes([3]) + good[1:],
                good[:1] + bytes(20)):
        with pytest.raises(webp_tpu_torch.WebPError):
            alpha.decode_alpha(bad, w, h)


# ---------------------------------------------------------------------------
# encode(rgba) and decoding ALPH files.
# ---------------------------------------------------------------------------

HOST_CASES = {
    "defaults": dict(),
    "exact": dict(exact=True),
    "alpha_q50_filter2": dict(alpha_quality=50, alpha_filtering=2),
    "alpha_raw_method6": dict(alpha_compression=0, method=6),
    "alpha_filter0_method2": dict(alpha_filtering=0, method=2, quality=40),
    "metadata": dict(iccp=b"icc-bytes", exif=b"Exif\0\0II", xmp=b"<x/>"),
    "sharp_yuv_autofilter": dict(use_sharp_yuv=True, autofilter=True),
    "target_size": dict(target_size=900),
}


@pytest.mark.parametrize("case", list(HOST_CASES))
def test_encode_rgba_host_equals_reference(case):
    """backend="host" with alpha < 255 writes webp_tpu.encode(rgba)'s
    file (the cleanup, the ALPH chunk, VP8X, LAST_STATS.alpha_size)."""
    img = rgba_image(48, 64, 3)
    got = webp_tpu_torch.encode(img, backend="host", **HOST_CASES[case])
    stats = webp_tpu_torch.LAST_STATS
    want = webp_tpu.encode(img, **HOST_CASES[case])
    assert got == want
    assert stats.alpha_size == webp_tpu.encoder.LAST_STATS.alpha_size
    assert stats.size == webp_tpu.encoder.LAST_STATS.size
    assert got[12:16] == b"VP8X" and b"ALPH" in got
    out = webp_tpu_torch.decode(got, backend="host")
    if HOST_CASES[case].get("alpha_quality", 100) == 100:
        assert (out[..., 3] == img[..., 3]).all()


def test_encode_opaque_rgba_has_no_alpha_chunk():
    img = rgba_image(32, 40, 4)
    img[..., 3] = 255
    got = webp_tpu_torch.encode(img, backend="host")
    assert got == webp_tpu.encode(img) == webp_tpu.encode(img[..., :3])
    assert b"ALPH" not in got and webp_tpu_torch.LAST_STATS.alpha_size == 0


def _pillow(img, **kw):
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="WEBP", **kw)
    return buf.getvalue()


def _files():
    """name -> a function that makes the file (made in the test that
    reads it, not while every worker collects the module)."""
    out = {}
    for h, w in ((48, 64), (17, 33)):
        img = rgba_image(h, w, w)
        out[f"pillow_q60_{w}x{h}"] = lambda img=img: _pillow(img, quality=60)
        out[f"pillow_q90_m6_{w}x{h}"] = lambda img=img: _pillow(
            img, quality=90, method=6)
        out[f"reference_{w}x{h}"] = lambda img=img: webp_tpu.encode(img)
        for name, opts in (("aq30", dict(alpha_quality=30)),
                           ("afilter2", dict(alpha_filtering=2)),
                           ("araw", dict(alpha_compression=0)),
                           ("simple_filter", dict(filter_type=0))):
            out[f"port_{name}_{w}x{h}"] = lambda img=img, opts=opts: \
                webp_tpu_torch.encode(img, backend="host", **opts)
    return out


FILES = _files()


@pytest.mark.parametrize("name", list(FILES))
def test_decode_alpha_files_equal_reference(name):
    """decode_rgba and decode give webp_tpu.decode_rgba's pixels on both
    backends: the host decoder, and the device decode's plain versions
    with the alpha plane decoded on the host."""
    data = FILES[name]()
    want = webp_tpu.decode_rgba(data)
    for kw in (dict(backend="host"), dict(backend="device", device="cpu")):
        assert (webp_tpu_torch.decode_rgba(data, **kw) == want).all()
        got = webp_tpu_torch.decode(data, **kw)
        assert got.shape == want.shape and (got == want).all()
    pil = np.array(Image.open(io.BytesIO(data)).convert("RGBA"))
    assert (pil[..., 3] == want[..., 3]).all()
