"""The slice end to end: webp_tpu_torch.encode_batch on the CPU (every
kernel's plain version) writes WebP files byte-identical to
webp_tpu.encode_batch, on images where segments, I4 macroblocks and
escape-sized levels all occur, and on q99 noise, which overflows the
escape list and takes the exact host fallback. The kernels themselves
are held against their plain versions on the card by chip_smoke.py and
tests/test_torch_cuda.py."""

import numpy as np
import pytest

import webp_tpu
import webp_tpu_torch
from webp_tpu_torch.lossy import device_encode as DE


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
