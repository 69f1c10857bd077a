"""The port's Pillow plugin (webp_tpu_torch/pil_plugin.py): the
reference's seven plugin tests (tests/test_pil_plugin.py) against the
port registered with device="cpu", plus parity: its decodes give the
reference plugin's pixels (animated frames and durations too), and its
saves write webp_tpu_torch.encode(..., device="cpu")'s bytes. Both
plugins claim "WEBP" process-wide, so the fixture restores Pillow's own
entries after every test."""

import io

import numpy as np
import pytest
from PIL import Image

import webp_tpu.pil_plugin as ref_plugin
import webp_tpu_torch
import webp_tpu_torch.pil_plugin as plugin
from webp_tpu_torch.animation.animation import encode_animation

CPU = "cpu"


@pytest.fixture
def rgb_img():
    rng = np.random.default_rng(7)
    base = rng.integers(0, 255, (40, 56, 3), np.uint8)
    # smooth it so lossy round-trips land close
    return (base // 4 + 96).astype(np.uint8)


@pytest.fixture(autouse=True)
def registered():
    Image.init()
    pillows = Image.OPEN.get("WEBP"), Image.SAVE.get("WEBP")
    plugin.register(device=CPU)
    yield
    plugin.unregister()
    assert (Image.OPEN.get("WEBP"), Image.SAVE.get("WEBP")) == pillows


def _frames(im):
    out = []
    for i in range(im.n_frames):
        im.seek(i)
        out.append((np.asarray(im.convert("RGBA")).copy(),
                    im.info.get("duration")))
    return out


def test_open_routes_through_webp_tpu_torch(rgb_img):
    data = webp_tpu_torch.encode(rgb_img, lossless=True, device=CPU)
    im = Image.open(io.BytesIO(data))
    assert isinstance(im, plugin.WebPTpuImageFile)
    assert im.format == "WEBP"
    assert im.size == (56, 40)
    out = np.asarray(im.convert("RGB"))
    assert np.array_equal(out, rgb_img)


def test_save_routes_through_webp_tpu_torch(rgb_img, tmp_path):
    p = tmp_path / "x.webp"
    Image.fromarray(rgb_img).save(p, lossless=True)
    assert p.read_bytes() == webp_tpu_torch.encode(rgb_img, lossless=True,
                                                   device=CPU)
    got = webp_tpu_torch.decode(p.read_bytes(), device=CPU)
    assert np.array_equal(got, rgb_img)


def test_save_lossy_quality_param(rgb_img, tmp_path):
    """A lossy save is the port's device encode on `device`, byte for
    byte, and its decode through the plugin is the reference plugin's."""
    p = tmp_path / "q.webp"
    Image.fromarray(rgb_img).save(p, quality=75, method=6)
    data = p.read_bytes()
    assert data == webp_tpu_torch.encode(rgb_img, quality=75, method=6,
                                         device=CPU)
    f = webp_tpu_torch.get_features(data)
    assert (f.width, f.height) == (56, 40)
    got = np.asarray(Image.open(io.BytesIO(data)))
    assert np.array_equal(got, np.asarray(ref_plugin.open_bytes(data)))
    err = np.abs(got.astype(np.int32) - rgb_img.astype(np.int32)).mean()
    assert err < 16.0  # noise image at q75


def test_rgba_roundtrip(tmp_path):
    rng = np.random.default_rng(3)
    rgba = rng.integers(0, 255, (24, 24, 4), np.uint8)
    p = tmp_path / "a.webp"
    Image.fromarray(rgba, "RGBA").save(p, lossless=True, exact=True)
    assert p.read_bytes() == webp_tpu_torch.encode(
        rgba, lossless=True, exact=True, device=CPU)
    im = Image.open(p)
    assert im.mode == "RGBA"
    assert np.array_equal(np.asarray(im), rgba)


def test_animated_frames_via_pil():
    frames = [np.full((16, 16, 4), (i * 60, 0, 0, 255), np.uint8)
              for i in range(3)]
    data = encode_animation(frames, 50, lossless=True, device=CPU)
    im = Image.open(io.BytesIO(data))
    assert im.n_frames == 3
    assert im.is_animated
    im.seek(2)
    arr = np.asarray(im.convert("RGBA"))
    assert arr[0, 0, 0] == 120
    assert im.info["duration"] == 50
    im.seek(0)
    assert np.asarray(im.convert("RGBA"))[0, 0, 0] == 0


def test_unregister_restores_pillow():
    plugin.unregister()
    assert Image.OPEN.get("WEBP") is not None  # Pillow's own is back
    assert Image.OPEN["WEBP"][0] is not plugin.WebPTpuImageFile
    assert not isinstance(Image.open(io.BytesIO(webp_tpu_torch.encode(
        np.zeros((8, 8, 3), np.uint8), lossless=True, device=CPU))),
        plugin.WebPTpuImageFile)
    plugin.register(device=CPU)  # the fixture unregisters after the test


def test_open_bytes_helper(rgb_img):
    data = webp_tpu_torch.encode(rgb_img, lossless=True, device=CPU)
    im = plugin.open_bytes(data, device=CPU)
    assert np.array_equal(np.asarray(im.convert("RGB")), rgb_img)


def test_decodes_equal_the_reference_plugins():
    """Lossy, lossy with ALPH, lossless and animated files (lossy and
    lossless frames, varying durations): the port's plugin gives the
    reference plugin's pixels, frame by frame, and its durations."""
    rng = np.random.default_rng(12)
    y, x = np.mgrid[0:32, 0:48]
    rgb = np.stack([x * 5, y * 7, (x * y) % 256], -1).astype(np.uint8)
    rgba = np.dstack([rgb, np.clip(x * 6, 0, 255).astype(np.uint8)])
    still = [webp_tpu_torch.encode(rgb, backend="host"),
             webp_tpu_torch.encode(rgba, backend="host"),
             webp_tpu_torch.encode(rgba, lossless=True, device=CPU)]
    for data in still:
        got = plugin.open_bytes(data, device=CPU)
        want = ref_plugin.open_bytes(data)
        assert got.mode == want.mode and got.size == want.size
        assert np.array_equal(np.asarray(got), np.asarray(want))
    frames = [np.dstack([rgb, np.full((32, 48), 255, np.uint8)])]
    for i in range(2):
        f = frames[-1].copy()
        f[8 * i:8 * i + 10, 4:20] = rng.integers(0, 256, (10, 16, 4))
        f[..., 3] = 255
        frames.append(f)
    for lossless in (False, True):
        data = encode_animation(frames, [40, 70, 100], lossless=lossless,
                                device=CPU, backend="host")
        got = _frames(Image.open(io.BytesIO(data)))
        want = _frames(ref_plugin.open_bytes(data))
        assert [d for _, d in got] == [d for _, d in want] == [40, 70, 100]
        for (g, _), (w, _) in zip(got, want):
            assert np.array_equal(g, w)


@pytest.mark.parametrize("mode", ["L", "P", "LA", "RGBA"])
def test_save_converts_other_modes_as_the_reference(mode, tmp_path):
    """A save of an L, P or LA image converts it as the reference's
    _save does (RGBA where it has alpha, else RGB) and writes the port's
    encode of that array."""
    rng = np.random.default_rng(4)
    im = Image.fromarray(rng.integers(0, 256, (12, 20, 4), np.uint8),
                         "RGBA").convert(mode)
    p = tmp_path / "m.webp"
    im.save(p, lossless=True)
    arr = np.asarray(im if mode == "RGBA" else im.convert(
        "RGBA" if "A" in mode else "RGB"))
    assert p.read_bytes() == webp_tpu_torch.encode(arr, lossless=True,
                                                   device=CPU)
