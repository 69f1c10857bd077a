"""The port's quality metrics (webp_tpu_torch.ops.metrics) against the
reference's jnp functions (webp_tpu.ops.metrics), on the CPU: sse and
tdisto4x4 exactly where the reference's int32 sum stays below 2^31,
psnr_from_sse and ssim_plane within rtol 1e-5, and the reference's
wrapping SSE on a pair where it wraps.

Inputs come from numpy seeds. Eager jnp compiles each operation once per
shape, so the cases share a few shapes."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from webp_tpu.ops import metrics as ref
from webp_tpu_torch.ops import metrics as M
from webp_tpu_torch.ops import p1_kernels

RTOL = 1e-5


def _pair(seed, shape, spread=255):
    """A plane and a noisy copy (uint8)."""
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 256, shape, np.uint8)
    b = np.clip(a.astype(np.int32) + rng.integers(-spread, spread + 1, shape),
                0, 255).astype(np.uint8)
    return a, b


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def test_weight_y_is_one_table():
    """WEIGHT_Y lives in ops/metrics.py; the phase-1 kernels' plain
    versions import it, and it is the reference's."""
    assert p1_kernels.WEIGHT_Y is M.WEIGHT_Y
    assert np.array_equal(M.WEIGHT_Y, ref.WEIGHT_Y)
    assert M.WEIGHT_Y.dtype == np.int32 and M.WEIGHT_Y.shape == (4, 4)


@pytest.mark.parametrize("shape,axes,spread", [
    ((48, 64), None, 255), ((48, 64), None, 9), ((3, 48, 64), (1, 2), 255),
    ((3, 48, 64), -1, 30), ((720, 1280), None, 40)],
    ids=["plane", "close", "per_image", "per_row", "1280x720"])
def test_sse_equals_reference_where_it_does_not_wrap(shape, axes, spread):
    a, b = _pair(1, shape, spread)
    want = np.asarray(ref.sse(jnp.asarray(a), jnp.asarray(b), axes=axes))
    assert np.abs(want).max() < 2 ** 31 and want.min() >= 0, \
        "premise: the reference's int32 sum does not wrap"
    got = M.sse(_t(a), _t(b), axes=axes)
    assert got.dtype == torch.int64
    assert np.array_equal(got.numpy(), want.astype(np.int64))


def test_sse_wraps_in_the_reference_and_not_in_the_port():
    """An all-0 against an all-255 1280x720 plane: the reference's int32
    sum wraps to -202,502,144 and its PSNR claims a perfect 99 dB; the
    port's int64 sum is 59,927,040,000 and its PSNR 0.0 dB."""
    a = np.zeros((720, 1280), np.uint8)
    b = np.full((720, 1280), 255, np.uint8)
    s_ref = int(np.asarray(ref.sse(jnp.asarray(a), jnp.asarray(b))))
    assert s_ref == -202_502_144
    assert float(np.asarray(ref.psnr_from_sse(s_ref, a.size))) == 99.0
    s = M.sse(_t(a), _t(b))
    assert int(s) == 59_927_040_000 == 720 * 1280 * 255 * 255
    assert float(M.psnr_from_sse(s, a.size)) == 0.0


@pytest.mark.parametrize("s,count", [(100, 1024), (0, 1024), (1, 1),
                                     (12345678, 921600), (5, 0),
                                     (2 ** 31 - 1, 921600)])
def test_psnr_from_sse_equals_reference(s, count):
    want = float(np.asarray(ref.psnr_from_sse(jnp.float32(s), count)))
    got = M.psnr_from_sse(s, count)
    assert got.dtype == torch.float64
    assert float(got) == pytest.approx(want, rel=RTOL)


def test_psnr_from_sse_on_tensors():
    """Per-image SSEs (a tensor) and a tensor count give per-image PSNRs."""
    a, b = _pair(2, (3, 48, 64), 20)
    b[1] = a[1]
    s = M.sse(_t(a), _t(b), axes=(1, 2))
    got = M.psnr_from_sse(s, torch.tensor(48 * 64))
    want = np.asarray(ref.psnr_from_sse(
        ref.sse(jnp.asarray(a), jnp.asarray(b), axes=(1, 2)), 48 * 64))
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL)
    assert float(got[1]) == 99.0


@pytest.mark.parametrize("seed,spread", [(3, 255), (4, 6), (5, 0)])
def test_tdisto4x4_equals_reference(seed, spread):
    a, b = _pair(seed, (64, 4, 4), spread)
    want = np.asarray(ref.tdisto4x4(jnp.asarray(a), jnp.asarray(b)))
    got = M.tdisto4x4(_t(a), _t(b))
    assert got.dtype == torch.int32
    assert np.array_equal(got.numpy(), want)
    if spread == 0:
        assert int(got.max()) == 0


def test_tdisto4x4_with_explicit_weights():
    a, b = _pair(6, (64, 4, 4))
    w = np.arange(16, dtype=np.int32).reshape(4, 4)
    want = np.asarray(ref.tdisto4x4(jnp.asarray(a), jnp.asarray(b),
                                    jnp.asarray(w)))
    assert np.array_equal(M.tdisto4x4(_t(a), _t(b), _t(w)).numpy(), want)


@pytest.mark.parametrize("shape,spread", [((48, 64), 8), ((48, 64), 255),
                                          ((48, 64), 0), ((720, 1280), 12)],
                         ids=["noisy", "unrelated", "same", "1280x720"])
def test_ssim_plane_equals_reference(shape, spread):
    """float32 as the reference computes it (its float64 cast is float32
    with JAX's x64 off); the window sums are exact in float32."""
    a, b = _pair(7, shape, spread)
    want = float(np.asarray(ref.ssim_plane(jnp.asarray(a), jnp.asarray(b))))
    got = M.ssim_plane(_t(a), _t(b))
    assert got.dtype == torch.float32
    assert float(got) == pytest.approx(want, rel=RTOL)
    if spread == 0:
        assert float(got) == pytest.approx(1.0, rel=1e-6)
