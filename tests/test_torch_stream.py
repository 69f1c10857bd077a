"""The port's pipelined stream entry and what it stands on: the host YUV
importer against the reference's numpy import, the YUV-plane device entry
fn.blob against fn.rgbp_blob, and encode_lossy_stream against the port's
encode_batch (itself held against webp_tpu.encode_batch), on the CPU."""

import numpy as np
import pytest

import torch

import webp_tpu.encoder as enc_ref
import webp_tpu.lossy.device_encode as de_ref
import webp_tpu.native.api as native_ref
import webp_tpu_torch
from webp_tpu_torch.container import riff
from webp_tpu_torch.lossy import device_encode as DE
from webp_tpu_torch.native.api import native_yuv_import
from webp_tpu_torch.ops import fastpath as FP
from webp_tpu_torch.ops import yuv


def _images(n, h, w, seed):
    """Gradients with a noisy patch and a flat band (numpy)."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    out = []
    for i in range(n):
        img = np.stack([x * 255 // max(w - 1, 1), y * 255 // max(h - 1, 1),
                        ((x + 2 * y) * (3 + i)) % 256], -1).astype(np.int32)
        img[h // 4: h // 2, w // 3:] += rng.integers(-50, 50, (h // 2 - h // 4,
                                                               w - w // 3, 3))
        img[3 * h // 4:, : w // 2] = rng.integers(0, 256, 3)
        out.append(np.clip(img, 0, 255).astype(np.uint8))
    return out


@pytest.mark.parametrize("hw", [(1, 1), (17, 33), (31, 30), (40, 72)])
def test_native_yuv_import_equals_reference_numpy_import(hw, monkeypatch):
    """Exact planes, padding included, on odd and even sizes against the
    reference's numpy path (its own native importer switched off)."""
    h, w = hw
    rgb = np.random.default_rng(h * w).integers(0, 256, (h, w, 3), np.uint8)
    monkeypatch.setattr(native_ref, "native_yuv_import", lambda rgb: None)
    ref = enc_ref.rgb_to_yuv420(rgb, dithering=0.0)
    got = native_yuv_import(rgb)
    for g, r in zip(got, ref):
        assert g.dtype == np.uint8 and g.shape == r.shape
        np.testing.assert_array_equal(g, r)


def test_blob_of_yuv_planes_equals_rgbp_blob():
    """fn.blob on the planes of the device conversion gives rgbp_blob's
    chunks byte for byte."""
    rgbp = np.stack([im.transpose(2, 0, 1) for im in _images(2, 48, 64, 3)])
    fn = FP.fast_encode_fn(4, 3, 75, 4, 50, True)
    planes = torch.as_tensor(rgbp)
    Y, U, V = yuv.rgb_planes_to_yuv420(planes[:, 0], planes[:, 1],
                                       planes[:, 2])
    got = fn.blob(Y, U, V)
    ref = fn.rgbp_blob(planes)
    assert len(got) == len(ref) == FP.BLOB_CHUNKS + 1
    for g, r in zip(got, ref):
        assert torch.equal(g, r)


def _files(bitstreams):
    return [riff.assemble_riff([riff.Chunk(riff.VP8, b)]) for b in bitstreams]


def test_stream_equals_encode_batch_with_a_ragged_last_batch():
    """5 images at 72x40 in batches of 2 (the last batch holds 1): with
    device YUV the stream's files equal encode_batch's byte for byte."""
    imgs = _images(5, 40, 72, 1)
    got = DE.encode_lossy_stream(imgs, 75, batch=2, host_yuv=False,
                                 device="cpu")
    assert _files(got) == webp_tpu_torch.encode_batch(imgs, 75,
                                                      device="cpu")


def test_stream_host_yuv_uploads_the_native_importers_planes():
    """With host_yuv the stream feeds fn.blob the native importer's planes
    of the padded images; one thread in the pool is enough."""
    imgs = _images(3, 40, 72, 2)
    got = DE.encode_lossy_stream(imgs, 75, batch=2, host_yuv=True,
                                 num_threads=1, device="cpu")
    fn = FP.fast_encode_fn(5, 3, 75, 4, 50)
    rgbs = DE.pad_to_macroblocks(np.stack(imgs))
    planes = [torch.as_tensor(np.stack(p))
              for p in zip(*map(native_yuv_import, rgbs))]
    host = FP.unpack_output_blob([c.numpy() for c in fn.blob(*planes)],
                                 fn.blob_spec)
    cfg = DE.LossyConfig(quality=75, segments=4, sns_strength=50,
                         filter_strength=60)
    with DE.concurrent.futures.ThreadPoolExecutor(2) as ex:
        want = DE._emit(host, rgbs, fn, 72, 40, cfg, ex)
    assert got == want


def test_stream_host_yuv_equals_reference_stream():
    """Both streams at their default host_yuv (host YUV: the reference's
    once its native importer is built, the port's always) write the same
    bitstreams: 5 images at 120x88 (not whole macroblocks) in batches of 2,
    a ragged last batch, q99. One noise image overflows its escape list
    (48 MBs, 1152 blocks, cap 1024) and takes the exact host fallback,
    which both streams start from the unpadded image. One geometry and
    quality, so the reference compiles its device program once."""
    imgs = _images(5, 88, 120, 4)
    imgs[3] = np.random.default_rng(9).integers(0, 256, (88, 120, 3),
                                                 np.uint8)
    DE.FALLBACKS["images"] = 0
    got = DE.encode_lossy_stream(imgs, 99, batch=2, device="cpu")
    assert DE.FALLBACKS["images"] == 1, "premise: one image falls back"
    assert got == de_ref.encode_lossy_stream(imgs, 99, batch=2)


def test_encode_animation_device_equals_reference():
    """The frame-batch animation encode: identical frames merge into one
    ANMF frame, the unique ones go through the stream at its default host
    YUV. The geometry, quality and batch of the stream test above (120x88,
    q99, batch 2, a ragged last batch), so the reference reuses its
    stream program. The file's payloads are the stream's bitstreams."""
    from webp_tpu.animation import animation as anim_ref
    from webp_tpu_torch.animation import animation as anim
    from webp_tpu_torch.container.parser import Parser

    imgs = _images(5, 88, 120, 6)
    frames = [imgs[0], imgs[0], imgs[1], imgs[2], imgs[2], imgs[2], imgs[3],
              imgs[0]]
    durations = [40, 10, 50, 60, 1, 2, 70, 90]
    got = anim.encode_animation_device(frames, durations, quality=99,
                                       loop_count=3, batch=2, device="cpu")
    assert got == anim_ref.encode_animation_device(
        frames, durations, quality=99, loop_count=3, batch=2)
    infos = Parser(got).frames()
    assert [f.duration_ms for f in infos] == [50, 50, 63, 70, 90]
    unique = [imgs[0], imgs[1], imgs[2], imgs[3], imgs[0]]
    assert [f.bitstream for f in infos] == DE.encode_lossy_stream(
        unique, 99, batch=2, device="cpu")


def test_stream_default_device_is_the_card_and_never_falls_back():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    with pytest.raises((RuntimeError, AssertionError)):
        DE.encode_lossy_stream(_images(1, 32, 32, 0), 75)
