"""The slice end to end: webp_tpu_torch.encode_batch on the CPU (every
kernel's plain version) writes WebP files byte-identical to
webp_tpu.encode_batch, on images where segments, I4 macroblocks and
escape-sized levels all occur, and on q99 noise, which overflows the
escape list and takes the exact host fallback; and the device program's
output blob (the planar entry rgbp_blob, the main path's) field by field
against the reference's program that webp_tpu.encode_batch runs, which
the two tests share (one compile per geometry). The kernels themselves
are held against their plain versions on the card by chip_smoke.py and
tests/test_torch_cuda.py."""

import numpy as np
import pytest
import torch

import webp_tpu
import webp_tpu_torch
from webp_tpu.ops import fastpath as FP_ref
from webp_tpu_torch.lossy import device_encode as DE
from webp_tpu_torch.ops import fastpath as FP


def _images(n, h, w, seed):
    """Smooth gradients, a textured patch, hard edges and stripes."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    out = []
    for i in range(n):
        img = np.stack([x * 255 // (w - 1), y * 255 // (h - 1),
                        ((x + 2 * y) * (3 + i)) % 256], -1).astype(np.int32)
        img[: h // 2, w // 2:] += rng.integers(-60, 60, (h // 2, w - w // 2,
                                                         3))
        img[h // 2:, : w // 3] = rng.integers(0, 256, 3)
        img[:, (5 + 7 * i) % w::11] = 255 * (i % 2)
        out.append(np.clip(img, 0, 255).astype(np.uint8))
    return out


@pytest.mark.parametrize("geom", [(64, 48), (72, 40)])
def test_encode_batch_byte_identical_to_reference(geom):
    w, h = geom
    imgs = _images(3, h, w, seed=w)
    ref = webp_tpu.encode_batch(imgs, 75)
    got = webp_tpu_torch.encode_batch(imgs, 75, device="cpu")
    assert len(got) == len(ref) == 3
    for g, r in zip(got, ref):
        assert g[:4] == b"RIFF" and g[8:16] == b"WEBPVP8 "
        assert g == r


@pytest.mark.parametrize("geom", [(64, 48), (72, 40)])
def test_rgbp_blob_equals_reference_byte_for_byte(geom):
    """The whole device program at the main path's configuration, on
    encode_batch's images: the port's planar entry (rgbp_blob) against
    the reference's RGB entry (rgb_blob, the program encode_batch runs):
    the output blob's chunks byte for byte, and every field unpacked."""
    import jax.numpy as jnp

    w, h = geom
    imgs = np.stack([np.pad(im, ((0, -h % 16), (0, -w % 16), (0, 0)),
                            mode="edge") for im in _images(3, h, w, seed=w)])
    mb_w, mb_h = imgs.shape[2] // 16, imgs.shape[1] // 16
    fn = FP.fast_encode_fn(mb_w, mb_h, 75, 4, 50, True)
    fn_ref = FP_ref.fast_encode_fn(mb_w, mb_h, 75, 4, 50, True,
                                   rd_drop=1024.0)
    got = fn.rgbp_blob(torch.as_tensor(imgs.transpose(0, 3, 1, 2).copy()))
    ref = fn_ref.rgb_blob(jnp.asarray(imgs))
    assert len(got) == len(ref) == FP.BLOB_CHUNKS + 1
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    spec_ref = {k: (np.dtype(v[0]), tuple(v[1]), v[2], v[3])
                for k, v in fn_ref.blob_spec.items()}
    assert {k: (np.dtype(v[0]), tuple(v[1]), v[2], v[3])
            for k, v in fn.blob_spec.items()} == spec_ref
    assert fn.esc_cap == fn_ref.esc_cap
    f = FP.unpack_output_blob([c.numpy() for c in got], fn.blob_spec)
    f_ref = FP_ref.unpack_output_blob([np.asarray(c) for c in ref],
                                      fn_ref.blob_spec)
    assert list(f) == list(FP.BLOB_ORDER) == list(f_ref)
    for k in f:
        assert f[k].dtype == f_ref[k].dtype, k
        np.testing.assert_array_equal(f[k], f_ref[k], err_msg=k)
    assert f["is_i4"].any() and len(np.unique(f["seg_map"])) > 1


@pytest.mark.parametrize("geom", [(64, 48), (72, 40)])
def test_slice_images_exercise_segments_i4_and_escapes(geom):
    """The parity images reach every branch of the device program:
    several segments, I4 and I16 macroblocks, and escaped blocks that
    stay within the escape capacity."""
    w, h = geom
    imgs = _images(3, h, w, seed=w)
    pad = np.stack([np.pad(im, ((0, -h % 16), (0, -w % 16), (0, 0)),
                           mode="edge") for im in imgs])
    fn, host = DE.device_blob(pad, 75, device="cpu")
    assert all(len(np.unique(s)) > 1 for s in host["seg_map"])
    assert host["is_i4"].any() and not host["is_i4"].all()
    assert (host["esc_cnt"] > 0).all() and (host["esc_cnt"]
                                            <= fn.esc_cap).all()


def test_escape_overflow_takes_the_host_fallback_byte_identically():
    """q99 noise overflows the escape list (128x96: 48 MBs, capacity
    1024 blocks); both packages re-encode on the host, identically."""
    noise = [np.random.default_rng(0).integers(0, 256, (96, 128, 3),
                                               np.uint8)]
    DE.FALLBACKS["images"] = 0
    got = webp_tpu_torch.encode_batch(noise, 99, device="cpu")
    assert DE.FALLBACKS["images"] == 1
    assert got == webp_tpu.encode_batch(noise, 99)
