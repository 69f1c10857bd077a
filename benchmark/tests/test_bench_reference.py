"""The plain reference on the CPU at tiny sizes: the reference encoder
against the measured package (the same files; the package's device="cpu"
runs its kernels' plain versions), the independent decoder against
libwebp through Pillow and against the package, and the encoder's
reconstruction against the decoder's."""

import io

import numpy as np
import pytest
import torch

from benchmark.harness import images
from benchmark.reference import decode as RD
from benchmark.reference import encode as RE
from benchmark.reference import vp8dec

# The photo preset's numbers at the default method, which the reference
# follows (the preset's preprocessing is not followed; see PERF.md).
PHOTO = dict(sns_strength=80, filter_strength=30, filter_sharpness=3)


def synth(seed, n, h, w):
    g = images.generator(seed, "cpu")
    return list(images.synth_images(g, n, h, w, "cpu").numpy())


@pytest.fixture(scope="module")
def program():
    import webp_tpu_torch

    return webp_tpu_torch


@pytest.fixture(scope="module")
def pillow():
    pytest.importorskip("PIL.WebPImagePlugin")
    from PIL import Image, features

    if not features.check("webp"):
        pytest.skip("Pillow without WebP")
    return Image


@pytest.mark.parametrize("h,w", [(48, 64), (40, 72)])
@pytest.mark.parametrize("opts", [{}, PHOTO], ids=["default", "photo"])
def test_encode_file_equals_the_program(program, h, w, opts):
    for img in synth(h * w, 2, h, w):
        assert RE.encode_file(img, opts)[0] == program.encode(
            img, device="cpu", **opts)


def test_stream_frames_equal_the_program(program):
    from webp_tpu_torch.lossy.device_encode import encode_lossy_stream

    imgs = synth(5, 3, 48, 64)
    got = encode_lossy_stream(imgs, batch=2, device="cpu")
    assert got == [RE.stream_frame(im, {})[0] for im in imgs]


@pytest.mark.parametrize("h,w", [(48, 64), (37, 53), (16, 16)])
@pytest.mark.parametrize("opts", [{}, PHOTO], ids=["default", "photo"])
def test_the_reconstruction_is_what_the_decoder_reads_back(h, w, opts):
    stream_opts = {k: v for k, v in opts.items() if k in RE.STREAM_KEYS}
    for fn, o in ((RE.encode_file, opts), (RE.stream_frame, stream_opts)):
        data, recon = fn(synth(h + w, 1, h, w)[0], o)
        back = RD.decode_unfiltered(data)
        assert recon is not None
        for a, b in zip(back, recon):
            assert a.shape == b.shape and np.array_equal(a, b)


@pytest.mark.parametrize("opts", [
    {}, dict(filter_strength=0), dict(filter_type=0, filter_strength=40),
    dict(filter_sharpness=6, filter_strength=100), dict(partitions=2),
    dict(segments=1, quality=95), dict(quality=20), PHOTO],
    ids=["default", "unfiltered", "simple", "sharp6", "partitions",
         "one_segment", "q20", "photo"])
def test_decode_equals_the_program_and_libwebp(program, pillow, opts):
    for img in synth(9, 2, 40, 72):
        data = program.encode(img, device="cpu", **opts)
        got = RD.decode_rgb(data)
        assert np.array_equal(got, program.decode(data, device="cpu"))
        want = np.asarray(pillow.open(io.BytesIO(data)).convert("RGB"))
        assert np.array_equal(got, want)


@pytest.mark.parametrize("h,w,kw", [
    (48, 64, dict(quality=75, method=4)), (37, 53, dict(quality=50)),
    (64, 96, dict(quality=90, method=6)), (33, 17, dict(quality=10,
                                                        method=2)),
    (1, 1, dict(quality=75)), (130, 35, dict(quality=100, method=0))])
def test_decode_equals_libwebp_on_its_own_files(pillow, h, w, kw):
    """Files libwebp writes (its modes, segments and token statistics, not
    the measured package's) decode to libwebp's pixels."""
    img = synth(h * 7 + w, 1, max(h, 16), max(w, 16))[0][:h, :w]
    buf = io.BytesIO()
    pillow.fromarray(np.ascontiguousarray(img)).save(buf, "WEBP", **kw)
    data = buf.getvalue()
    want = np.asarray(pillow.open(io.BytesIO(data)).convert("RGB"))
    assert np.array_equal(RD.decode_rgb(data), want)


def test_the_control_decode_leaves_the_loop_filter_out(program):
    img = synth(11, 1, 48, 64)[0]
    data = program.encode(img, device="cpu")
    f = vp8dec.decode_frame(vp8dec.vp8_payload(data))
    assert f.filter_type == 2
    assert not np.array_equal(RD.decode_rgb(data),
                              RD.decode_rgb(data, loop_filter=False))
    assert np.array_equal(f.y_unfiltered,
                          vp8dec.decode_frame(vp8dec.vp8_payload(data),
                                              loop_filter=False).y)


def test_partition0_modes_count_every_macroblock(program):
    img = synth(3, 1, 48, 64)[0]
    data = program.encode(img, device="cpu")
    m = RD.partition0_modes(data)
    assert m["mbs"] == 12 and m["i16"] + m["i4"] == 12
    assert RD.partition0_modes(RD.vp8_payload(data)) == m


def test_malformed_frames_are_refused():
    with pytest.raises(ValueError):
        RD.decode_rgb(b"RIFF\x00\x00\x00\x00WEBPVP8L")
    with pytest.raises(ValueError):
        vp8dec.decode_frame(b"\x01\x00\x00" + bytes(7))   # not a key frame
    with pytest.raises(ValueError):
        vp8dec.decode_frame(b"\x00\x00\x00\x9d\x01\x2b" + bytes(4))


@pytest.mark.parametrize("opts", [{"preprocessing": 2}, {"lossless": True},
                                  {"method": 6}])
def test_options_the_reference_cannot_follow_are_refused(opts):
    with pytest.raises(ValueError):
        RE.encode_file(synth(1, 1, 16, 16)[0], opts)


def test_the_stream_refuses_what_it_cannot_take():
    with pytest.raises(ValueError):
        RE.stream_frame(synth(1, 1, 16, 16)[0], {"filter_sharpness": 3})


def test_images_follow_the_seed():
    a = images.synth_images(images.generator(2 ** 31 + 5, "cpu"), 2, 32,
                            48, "cpu")
    b = images.synth_images(images.generator(2 ** 31 + 5, "cpu"), 2, 32,
                            48, "cpu")
    c = images.synth_images(images.generator(2 ** 31 + 6, "cpu"), 2, 32,
                            48, "cpu")
    assert a.dtype == torch.uint8 and a.shape == (2, 32, 48, 3)
    assert torch.equal(a, b) and not torch.equal(a, c)
