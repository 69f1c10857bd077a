"""The port's container parser, host VP8 decoders and public decode API on
the CPU, against webp_tpu: get_features/decode_config, the parser's
chunks and frames, the native decoder and upsampler, the numpy
VP8Decoder, and decode/decode_rgba on both backends (backend="device"
with device="cpu", the device decode's plain versions), on files made by
Pillow's libwebp and by the port's own encoder at 64x48, 120x90 and
33x17; truncated and garbage input raises WebPError; VP8L frames and
ALPH chunks raise NotImplementedError (the lossless decoder is not
ported). Every comparison is exact. No reference JAX program is
compiled: the reference's decode runs its native host decoder."""

import io

import numpy as np
import pytest
from PIL import Image

import webp_tpu
import webp_tpu_torch
from test_torch_encode import _images
from webp_tpu.container import parser as parser_ref
from webp_tpu.lossy import decode as dec_ref
from webp_tpu.lossy import yuv as yuv_ref
from webp_tpu_torch.container import parser
from webp_tpu_torch.lossy import decode as dec
from webp_tpu_torch.lossy import yuv as yuv_np
from webp_tpu_torch.native import api as native

SIZES = [(64, 48), (120, 90), (33, 17)]


def _pillow(img, **kw):
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="WEBP", **kw)
    return buf.getvalue()


def _files():
    """name -> WebP file: Pillow's at two qualities and method 6, the
    port's own (host backend) with the normal, simple and no loop filter,
    one with metadata (VP8X), at each size."""
    out = {}
    for w, h in SIZES:
        img = _images(1, h, w, w + h)[0]
        out[f"pillow_q30_{w}x{h}"] = _pillow(img, quality=30)
        out[f"pillow_q85_m6_{w}x{h}"] = _pillow(img, quality=85, method=6)
        for name, opts in (("normal", {}), ("simple", dict(filter_type=0)),
                           ("nofilter", dict(filter_strength=0))):
            out[f"port_{name}_{w}x{h}"] = webp_tpu_torch.encode(
                img, backend="host", quality=40, **opts)
    img = _images(1, 48, 64, 7)[0]
    out["port_vp8x_64x48"] = webp_tpu_torch.encode(
        img, backend="host", iccp=b"icc", exif=b"Exif\0\0", xmp=b"<x/>")
    return out


FILES = _files()


@pytest.mark.parametrize("name", list(FILES))
def test_features_and_parse_equal_reference(name):
    data = FILES[name]
    f, f_ref = webp_tpu_torch.get_features(data), webp_tpu.get_features(data)
    assert vars(f) == vars(f_ref)
    assert vars(webp_tpu_torch.decode_config(data)) == vars(f_ref)
    p, p_ref = parser.Parser(data), parser_ref.Parser(data)
    assert [(c.tag, c.payload) for c in p.chunks()] == \
        [(c.tag, c.payload) for c in p_ref.chunks()]
    assert [vars(fr) for fr in p.frames()] == \
        [vars(fr) for fr in p_ref.frames()]
    bs = p.frames()[0].bitstream
    assert parser.parse_vp8_dimensions(bs) == \
        parser_ref.parse_vp8_dimensions(bs)


@pytest.mark.parametrize("name", list(FILES))
def test_decode_both_backends_equal_reference(name):
    """decode and decode_rgba with the native decoder (host) and the
    device decode's plain versions (device="cpu") give the reference's
    pixels; the RGB decode drops alpha as the reference's does."""
    data = FILES[name]
    want = webp_tpu.decode(data)
    want_rgba = webp_tpu.decode_rgba(data)
    for kw in (dict(backend="host"), dict(backend="device", device="cpu")):
        got = webp_tpu_torch.decode(data, **kw)
        assert got.dtype == np.uint8 and np.array_equal(got, want)
        assert np.array_equal(webp_tpu_torch.decode_rgba(data, **kw),
                              want_rgba)


@pytest.mark.parametrize("name", list(FILES))
def test_host_decoders_equal_reference(name):
    """The native decoder's planes, the numpy VP8Decoder's and the
    reference's native decoder's are equal; so are the native upsampler's
    RGBA and the numpy upsample's RGB."""
    bs = parser.Parser(FILES[name]).frames()[0].bitstream
    planes = dec.decode_vp8_yuv(bs)
    for got, ref, oracle in zip(planes, dec_ref.decode_vp8_yuv(bs),
                                dec.VP8Decoder(bs).decode()):
        assert np.array_equal(got, ref)
        assert np.array_equal(oracle, ref)
    rgba = dec.decode_vp8_rgba(bs)
    assert np.array_equal(rgba, dec_ref.decode_vp8_rgba(bs))
    assert np.array_equal(rgba[..., :3], yuv_np.yuv_to_rgb_fancy(*planes))
    assert (rgba[..., 3] == 255).all()


def test_numpy_upsample_equals_reference_on_random_planes():
    rng = np.random.default_rng(0)
    for h, w in ((1, 1), (2, 3), (17, 33), (16, 16)):
        y = rng.integers(0, 256, (h, w), np.uint8)
        u = rng.integers(0, 256, ((h + 1) // 2, (w + 1) // 2), np.uint8)
        v = rng.integers(0, 256, u.shape, np.uint8)
        got = yuv_np.yuv_to_rgb_fancy(y, u, v)
        assert np.array_equal(got, yuv_ref.yuv_to_rgb_fancy(y, u, v))
        assert np.array_equal(native.native_upsample_rgba(y, u, v, 3), got)


def test_native_filter_selftest_passes():
    """The native loop filter's SIMD edge filters equal its scalar ones."""
    for seed in (0, 1, 7):
        assert native.vp8_filter_selftest(seed) == 0


def test_native_parse_equals_reference():
    """vp8_parse (the device decode's host half) exports what the
    reference's exports, on a Pillow file with I4 macroblocks and
    segments."""
    from webp_tpu.native import api as native_ref

    bs = parser.Parser(FILES["pillow_q85_m6_120x90"]).frames()[0].bitstream
    got, ref = native.vp8_parse(bs), native_ref.vp8_parse(bs)
    assert got.keys() == ref.keys()
    for k in got:
        assert np.array_equal(np.asarray(got[k]), np.asarray(ref[k])), k
    assert got["is_i4"].any() and not got["is_i4"].all()


def _truncations(data):
    return [data[:n] for n in (0, 5, 11, 12, 19, 20, 29, 40,
                               len(data) // 2, len(data) - 3)]


@pytest.mark.parametrize("name", ["pillow_q30_64x48", "port_simple_33x17"])
def test_truncated_input_raises_webp_error(name):
    for cut in _truncations(FILES[name]):
        for kw in (dict(backend="host"),
                   dict(backend="device", device="cpu")):
            with pytest.raises(webp_tpu_torch.WebPError):
                webp_tpu_torch.decode(cut, **kw)
    with pytest.raises(webp_tpu_torch.WebPError):
        webp_tpu_torch.get_features(FILES[name][:11])


def test_garbage_input_raises_webp_error():
    rng = np.random.default_rng(3)
    good = FILES["port_normal_64x48"]
    bad = [b"", b"RIFF", b"not a webp file at all",
           bytes(rng.integers(0, 256, 200, np.uint8)),
           b"RIFF" + good[4:8] + b"WEBX" + good[12:],
           good[:20] + b"\x01" + good[21:]]          # not a keyframe
    for data in bad:
        for kw in (dict(backend="host"),
                   dict(backend="device", device="cpu")):
            with pytest.raises(webp_tpu_torch.WebPError):
                webp_tpu_torch.decode(data, **kw)


def test_lossless_and_alpha_raise_not_implemented():
    img = _images(1, 17, 33, 2)[0]
    rgba = np.concatenate([img, np.full(img.shape[:2] + (1,), 128,
                                        np.uint8)], axis=-1)
    for data in (_pillow(img, lossless=True), _pillow(rgba, quality=50)):
        for kw in (dict(backend="host"),
                   dict(backend="device", device="cpu")):
            with pytest.raises(NotImplementedError, match="ROADMAP"):
                webp_tpu_torch.decode(data, **kw)
    with pytest.raises(ValueError, match="backend"):
        webp_tpu_torch.decode(FILES["port_normal_64x48"], backend="tpu")


def test_decode_without_a_card_raises():
    """backend="device" with device=None asks for the card: without one
    decode() raises rather than running the plain versions."""
    import torch

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    with pytest.raises((RuntimeError, AssertionError)):
        webp_tpu_torch.decode(FILES["port_normal_64x48"])
