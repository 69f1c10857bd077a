"""Method 5 end to end on the CPU: webp_tpu_torch.encode(img,
device="cpu", method=5) writes the file webp_tpu.encode(img,
backend="device", method=5) writes, byte for byte — the closed loop at
skew 2 with the trellis on the I4 subblocks (ops/planar.py,
ops/trellis.py), after kernels 1-3 with the I4 search's skew-1 ban
lifted — and the device program's fields equal the reference's.

Every case runs one reference program (64x48, B=1, the defaults with
method 5), compiled once by the module's fixture."""

import numpy as np
import pytest
import torch

import webp_tpu
import webp_tpu_torch
from test_torch_encode import _images
from webp_tpu.ops import fastpath as FP_ref
from webp_tpu_torch.ops import fastpath as FP

W, H = 64, 48


def _cases():
    """Noise, the gradients-and-stripes images, and an image flat in its
    lower half."""
    rng = np.random.default_rng(55)
    half = _images(1, H, W, 56)[0]
    half[H // 2:] = (40, 90, 200)
    return {"noise": rng.integers(0, 256, (H, W, 3), np.uint8),
            "gradients": _images(1, H, W, 57)[0], "half_flat": half}


def _method_fixture(method):
    """{case: (image, reference file)} for every case, at `method` (the
    first reference encode compiles the program; the rest reuse it)."""
    return {k: (img, webp_tpu.encode(img, backend="device", method=method))
            for k, img in _cases().items()}


def _fields_equal(method, img):
    """The port's device program and the reference's on one image: every
    field of the blob equal. Returns the port's fields."""
    kw = dict(sk=2, trellis=True, i4_mode_search=method >= 6)
    fn = FP.fast_encode_fn(W // 16, H // 16, 75, 4, 50, True, **kw)
    fn_ref = FP_ref.fast_encode_fn(W // 16, H // 16, 75, 4, 50, True, **kw)
    got = FP.unpack_output_blob(
        [c.numpy() for c in fn.rgb_blob(torch.as_tensor(img[None]))],
        fn.blob_spec)
    ref = FP_ref.unpack_output_blob(
        [np.asarray(c) for c in fn_ref.rgb_blob(img[None])],
        fn_ref.blob_spec)
    for k in got:
        np.testing.assert_array_equal(got[k], ref[k], err_msg=k)
    return got


@pytest.fixture(scope="module")
def refs():
    return _method_fixture(5)


@pytest.mark.parametrize("case", list(_cases()))
def test_encode_method5_equals_reference(case, refs):
    img, ref = refs[case]
    got = webp_tpu_torch.encode(img, device="cpu", method=5)
    assert got[:4] == b"RIFF" and got == ref


def test_method5_device_fields_equal_reference(refs):
    """Levels, modes, split and segment plan equal the reference's on the
    gradients image; the rightmost subblock column takes strip-reading
    modes (VE, LD, VL), which skew 1 bans."""
    got = _fields_equal(5, refs["gradients"][0])
    modes = got["imodes"][0].reshape(-1, 4, 4)[got["is_i4"][0]]
    assert np.isin(modes[:, :, 3], (2, 6, 7)).any()
