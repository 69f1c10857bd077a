"""Sharp YUV in the port, against the JAX package on the CPU: the host
converter (numpy), the C library's powf over an array (the CPU form of the
device conversion's transfer curves), the device conversion
ops/sharpyuv.sharp_yuv420, and the encode entries with sharp YUV on —
encode(use_sharp_yuv=True), encode_batch(sharp_yuv=True), the stream and
the escape-overflow fallback from the host sharp planes — byte for byte.

Every entry case runs the same reference program (64x48, the defaults
with sharp YUV, B=1), so the file compiles it once."""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import webp_tpu
import webp_tpu.lossy.device_encode as DE_ref
import webp_tpu.ops.fastpath as FP_ref
import webp_tpu_torch
from test_torch_encode import _images
from webp_tpu.ops import sharpyuv as SY_ref
from webp_tpu.sharpyuv import convert as HC_ref
from webp_tpu_torch.lossy import device_encode as DE
from webp_tpu_torch.native.api import powf_array
from webp_tpu_torch.ops import fastpath as FP
from webp_tpu_torch.ops import sharpyuv as SY
from webp_tpu_torch.sharpyuv import convert as HC


def _noise(h, w, seed):
    return np.random.default_rng(seed).integers(0, 256, (h, w, 3), np.uint8)


def _smooth(h, w):
    """A smooth colour gradient: the content on which a one-ulp `pow`
    difference flips a sample."""
    y, x = np.mgrid[0:h, 0:w]
    img = np.stack([x * 255 // (w - 1), y * 255 // (h - 1),
                    (x + y) * 255 // (w + h - 2)], -1)
    return img.astype(np.uint8)


@pytest.mark.parametrize("case", ["noise17x33", "noise40x72", "images48x64",
                                  "srgb", "pq"])
def test_host_converter_equals_reference(case):
    """The host converter's planes (and its padded MB planes) equal the
    reference's numpy converter, on odd sizes and other transfers."""
    transfer = {"srgb": "iec61966", "pq": "smpte2084"}.get(case, "bt709")
    if case.startswith("noise"):
        h, w = map(int, case[5:].split("x"))
        rgb = _noise(h, w, h * w)
    else:
        rgb = _images(1, 48, 64, 3)[0]
    got = HC.sharp_rgb_to_yuv420_planes(rgb, transfer)
    ref = HC_ref.sharp_rgb_to_yuv420_planes(rgb, transfer)
    for g, r in zip(got, ref):
        assert g.dtype == np.uint8
        np.testing.assert_array_equal(g, r)
    for g, r in zip(HC.sharp_rgb_to_yuv420(rgb), HC_ref.sharp_rgb_to_yuv420(rgb)):
        np.testing.assert_array_equal(g, r)


@pytest.mark.parametrize("e", [SY._E_TO_LIN, SY._E_FROM_LIN])
def test_powf_array_equals_jnp_power(e):
    """The native powf equals the reference's float32 pow on 10^6 random
    inputs in [0, 1) and on the curves' end points; PyTorch's own CPU pow
    does not (the reason for the native one)."""
    x = np.random.default_rng(7).random(1_000_000, dtype=np.float32)
    x[:4] = [0.0, 1.0, np.float32(1e-8), np.float32(SY._T_LIN)]
    ref = np.asarray(jax.jit(lambda a: jnp.power(a, np.float32(e)))(x))
    np.testing.assert_array_equal(powf_array(x, e), ref)
    assert (torch.pow(torch.from_numpy(x), e).numpy() != ref).any()


@pytest.fixture(scope="module")
def sharp_ref():
    return jax.jit(SY_ref.sharp_yuv420)


@pytest.mark.parametrize("case", ["noise64x48", "images72x40",
                                  "smooth256x256", "saturated192x128",
                                  "photo384x256"])
def test_sharp_yuv420_equals_reference(case, sharp_ref):
    """Y, U and V equal the reference's device conversion exactly; two
    images in one batch each equal their own (the early exit is per
    image). The last two are the smallest images found on which the
    reference's float order shows: saturated noise, whose refinement runs
    three iterations (its 2x2 means summed in sequence and the luma
    difference's two contractions decide a sample), and a photo-like
    image of chip_smoke.py's that stops after two."""
    if case == "noise64x48":
        imgs = [_noise(48, 64, 1), _noise(48, 64, 2)]
    elif case == "images72x40":
        imgs = _images(2, 40, 72, 5)
    elif case == "saturated192x128":
        imgs = [(np.random.default_rng(1).integers(0, 2, (128, 192, 3))
                 * 255).astype(np.uint8)]
    elif case == "photo384x256":
        from chip_smoke import synth_images

        imgs = [synth_images(np.random.default_rng(0), 1, 256, 384)[0]]
    else:
        imgs = [_smooth(256, 256)]
    got = SY.sharp_yuv420(torch.as_tensor(np.stack(imgs)))
    for i, img in enumerate(imgs):
        ref = sharp_ref(img)
        for g, r in zip(got, ref):
            assert g.dtype == torch.uint8
            np.testing.assert_array_equal(g[i].numpy(), np.asarray(r))


def test_planar_entry_with_sharp_yuv_equals_rgb_entry():
    """fn.rgbp_blob (planes [B, 3, H, W]) imports with sharp YUV as
    fn.rgb_blob does, as the reference's planar entry stacks its planes
    channel-last for the same conversion."""
    rgb = np.stack(_images(2, 48, 64, 23))
    fn = FP.fast_encode_fn(4, 3, 75, 4, 50, sharp_yuv=True)
    got = fn.rgbp_blob(torch.as_tensor(rgb.transpose(0, 3, 1, 2)).contiguous())
    ref = fn.rgb_blob(torch.as_tensor(rgb))
    assert all(torch.equal(g, r) for g, r in zip(got, ref))


# --- The entries, one reference program (64x48, B=1, sharp YUV). ---------

def _imgs():
    return _images(2, 48, 64, 17)


def test_encode_sharp_equals_reference():
    for img in _imgs():
        got = webp_tpu_torch.encode(img, device="cpu", use_sharp_yuv=True)
        ref = webp_tpu.encode(img, backend="device", use_sharp_yuv=True)
        assert got == ref
        assert got != webp_tpu_torch.encode(img, device="cpu")


def test_encode_batch_and_stream_sharp_equal_reference():
    """encode_batch(sharp_yuv=True) at B=1 and the stream (batch 1, host
    YUV asked for and turned off) write the reference's files."""
    imgs = _imgs()
    for img in imgs:
        got = webp_tpu_torch.encode_batch([img], device="cpu",
                                          sharp_yuv=True)
        assert got == webp_tpu.encode_batch([img], sharp_yuv=True)
    got = DE.encode_lossy_stream(imgs, batch=1, sharp_yuv=True,
                                 host_yuv=True, device="cpu")
    ref = DE_ref.encode_lossy_stream(imgs, batch=1, sharp_yuv=True)
    assert got == ref


def test_sharp_fallback_equals_reference(monkeypatch):
    """An image whose escape list overflows re-encodes on the host from
    the host converter's sharp planes, in encode() and encode_batch, as
    the reference's does (the overflow is forced: every blob reads as
    overflowing)."""
    def overflowing(unpack):
        def f(*a):
            host = unpack(*a)
            host["esc_cnt"] = np.full_like(host["esc_cnt"], 1 << 30)
            return host
        return f

    monkeypatch.setattr(FP, "unpack_output_blob",
                        overflowing(FP.unpack_output_blob))
    monkeypatch.setattr(FP_ref, "unpack_output_blob",
                        overflowing(FP_ref.unpack_output_blob))
    img = _imgs()[0]
    DE.FALLBACKS["images"] = 0
    got = webp_tpu_torch.encode(img, device="cpu", use_sharp_yuv=True)
    assert DE.FALLBACKS["images"] == 1
    assert got == webp_tpu.encode(img, backend="device", use_sharp_yuv=True)
    got = webp_tpu_torch.encode_batch([img], device="cpu", sharp_yuv=True)
    assert DE.FALLBACKS["images"] == 2
    assert got == webp_tpu.encode_batch([img], sharp_yuv=True)
    fn = dataclasses.make_dataclass("F", [("sharp_yuv", bool)])
    for sharp in (False, True):
        for g, r in zip(DE._fallback_planes(img, fn(sharp)),
                        DE_ref._fallback_planes(img, fn(sharp))):
            np.testing.assert_array_equal(g, r)
