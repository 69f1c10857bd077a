"""Method 6 end to end on the CPU: webp_tpu_torch.encode(img,
device="cpu", method=6) writes the file webp_tpu.encode(img,
backend="device", method=6) writes, byte for byte — the skew-2 closed
loop with the trellis and the in-loop search: the 10-mode I4 search per
subblock and the 4-mode UV search against the reconstructed context on
exact chained rates, and the I16-vs-I4 split taken in the loop — and the
device program's fields (the loop's modes and split among them) equal
the reference's.

Every case runs one reference program (64x48, B=1, the defaults with
method 6), compiled once by the module's fixture."""

import pytest
import torch

import webp_tpu_torch
from test_torch_method5 import _cases, _fields_equal, _method_fixture
from webp_tpu_torch.ops import fastpath as FP


@pytest.fixture(scope="module")
def refs():
    return _method_fixture(6)


@pytest.mark.parametrize("case", list(_cases()))
def test_encode_method6_equals_reference(case, refs):
    img, ref = refs[case]
    got = webp_tpu_torch.encode(img, device="cpu", method=6)
    assert got[:4] == b"RIFF" and got == ref


def test_method6_device_fields_equal_reference(refs):
    """Levels, the loop's I4 modes, split and UV modes, and the segment
    plan equal the reference's on the half-flat image, where the loop
    takes both I4 and I16 MBs and its UV search changes modes that phase
    1 chose (the port's method-5 program keeps phase 1's)."""
    img = refs["half_flat"][0]
    got = _fields_equal(6, img)
    assert got["is_i4"].any() and not got["is_i4"].all()
    fn5 = FP.fast_encode_fn(4, 3, 75, 4, 50, True, sk=2, trellis=True)
    m5 = FP.unpack_output_blob(
        [c.numpy() for c in fn5.rgb_blob(torch.as_tensor(img[None]))],
        fn5.blob_spec)
    assert (m5["uvmodes"] != got["uvmodes"]).any()
