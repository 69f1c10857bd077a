"""The port's fixed-point rescaler (webp_tpu_torch/utils/rescaler.py)
against the reference's (webp_tpu/utils/rescaler.py), output for output:
shrink, expand and mixed shapes, the degenerate ones (1x1, identity, one
pixel wide or high), the incremental Rescaler row by row, and
rescale_rgba."""

import numpy as np
import pytest

from webp_tpu.utils import rescaler as R_ref
from webp_tpu_torch.utils import rescaler as R

SRC = [(1, 1), (7, 13), (16, 16), (5, 40), (33, 7), (1, 23), (19, 1)]
DST = [(1, 1), (3, 2), (40, 5), (26, 14), (13, 7), (64, 64), (1, 9),
       (11, 1), (8, 30), (2, 60)]


@pytest.mark.parametrize("src_hw", SRC, ids=lambda s: f"src{s[1]}x{s[0]}")
@pytest.mark.parametrize("dst_wh", DST, ids=lambda s: f"dst{s[0]}x{s[1]}")
def test_rescale_plane_equals_reference(src_hw, dst_wh):
    h, w = src_hw
    rng = np.random.default_rng(h * 1000 + w * 10 + dst_wh[0])
    a = rng.integers(0, 256, (h, w), np.uint8)
    got = R.rescale_plane(a, *dst_wh)
    assert got.shape == dst_wh[::-1] and got.dtype == np.uint8
    np.testing.assert_array_equal(got, R_ref.rescale_plane(a, *dst_wh))


@pytest.mark.parametrize("img", ["noise", "flat", "gradient", "edges"])
def test_identity_and_the_reference_tests_shapes(img):
    """40x5 from 7x13 (the reference's flat-image shape), identity copies,
    and integer factors on structured content."""
    rng = np.random.default_rng(3)
    y, x = np.mgrid[0:48, 0:64]
    a = {"noise": rng.integers(0, 256, (48, 64)),
         "flat": np.full((48, 64), 200),
         "gradient": (x * 4 + y) % 256,
         "edges": ((x // 7 + y // 5) % 2) * 255}[img].astype(np.uint8)
    for src in (a, a[:13, :7], a[:1], a[:, :1]):
        h, w = src.shape
        for dw, dh in ((w, h), (40, 5), (w // 2 or 1, h // 2 or 1),
                       (w * 3, h * 2), (w * 2, max(h // 3, 1)),
                       (max(w // 4, 1), h * 3)):
            got = R.rescale_plane(src, dw, dh)
            np.testing.assert_array_equal(got,
                                          R_ref.rescale_plane(src, dw, dh))
    same = R.rescale_plane(a, 64, 48)
    assert same is not a
    np.testing.assert_array_equal(same, a)


@pytest.mark.parametrize("src_wh,dst_wh", [((13, 7), (40, 5)),
                                           ((40, 5), (13, 7)),
                                           ((9, 9), (4, 20))])
def test_incremental_rescaler_row_by_row(src_wh, dst_wh):
    """The Rescaler's import/export walk: the same rows at the same
    points, and the same fixed-point state after every import."""
    rng = np.random.default_rng(11)
    a = rng.integers(0, 256, src_wh[::-1], np.uint8)
    r, r_ref = R.Rescaler(*src_wh, *dst_wh), R_ref.Rescaler(*src_wh, *dst_wh)
    for attr in ("x_add", "x_sub", "y_add", "y_sub", "y_accum", "fx_scale",
                 "fy_scale", "fxy_scale"):
        assert getattr(r, attr) == getattr(r_ref, attr), attr
    for row in a:
        r.import_row(row)
        r_ref.import_row(row)
        np.testing.assert_array_equal(r.frow, r_ref.frow)
        np.testing.assert_array_equal(r.irow, r_ref.irow)
        while r_ref.has_dst_row():
            assert r.has_dst_row()
            np.testing.assert_array_equal(r.export_row(), r_ref.export_row())
        assert not r.has_dst_row() and r.export_row() is None
    assert (r.src_y, r.dst_y) == (r_ref.src_y, r_ref.dst_y)


def test_rescale_rgba_and_fixed_point_helpers_equal_reference():
    rng = np.random.default_rng(2)
    img = rng.integers(0, 256, (10, 14, 4), np.uint8)
    for dw, dh in ((7, 5), (30, 21), (14, 3)):
        np.testing.assert_array_equal(R.rescale_rgba(img, dw, dh),
                                      R_ref.rescale_rgba(img, dw, dh))
    assert (R.RFIX, R.ONE) == (R_ref.RFIX, R_ref.ONE) == (32, 1 << 32)
    for x, y in ((0, 1), (1, 3), (5, 7), (12345, 0), (1 << 40, 99)):
        assert R._frac(x, y) == R_ref._frac(x, y)
        assert R._mult_fix(x, y) == R_ref._mult_fix(x, y)
