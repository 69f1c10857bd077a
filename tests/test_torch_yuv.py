"""The port's RGB -> YUV 4:2:0 import against the JAX reference: exact
planes, and both float32 gamma curves checked on their whole integer
domain (the port looks them up; the reference evaluates jnp.power)."""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from webp_tpu.ops import yuv as yuv_ref
from webp_tpu_torch.ops import yuv


def test_to_linear_table_equals_reference_pow_on_all_256_inputs():
    xf = jnp.arange(256, dtype=jnp.int32).astype(jnp.float32) * (1.0 / 255.0)
    ref = jnp.floor(jnp.power(xf, 0.80) * 4095.0 + 0.5).astype(jnp.int32)
    lin, _ = yuv.gamma_luts_cpu()
    np.testing.assert_array_equal(lin.numpy(), np.asarray(ref))


def test_to_gamma_table_equals_reference_pow_on_0_to_16380():
    acc = jnp.arange(yuv.LIN_MAX + 1, dtype=jnp.int32)
    af = acc.astype(jnp.float32) * (1.0 / (4.0 * 4095.0))
    ref = jnp.floor(jnp.power(af, 1.25) * 1020.0 + 0.5).astype(jnp.int32)
    _, gam = yuv.gamma_luts_cpu()
    assert gam.shape == (16381,)
    np.testing.assert_array_equal(gam.numpy(), np.asarray(ref))


@pytest.mark.parametrize("shape", [(2, 48, 64), (1, 40, 72), (3, 16, 16)])
def test_rgb_planes_to_yuv420_exact(shape):
    rng = np.random.default_rng(sum(shape))
    r, g, b = (rng.integers(0, 256, shape, np.uint8) for _ in range(3))
    got = yuv.rgb_planes_to_yuv420(*(torch.as_tensor(p) for p in (r, g, b)))
    ref = yuv_ref.rgb_planes_to_yuv420(*(jnp.asarray(p) for p in (r, g, b)))
    for a, e in zip(got, ref):
        assert a.dtype == torch.uint8
        np.testing.assert_array_equal(a.numpy(), np.asarray(e))


def test_rgb_to_yuv420_interleaved_exact_on_extremes():
    rng = np.random.default_rng(9)
    rgb = rng.integers(0, 256, (2, 32, 48, 3), np.uint8)
    rgb[0, :8] = 0
    rgb[0, 8:16] = 255
    got = yuv.rgb_to_yuv420(torch.as_tensor(rgb))
    ref = yuv_ref.rgb_to_yuv420(jnp.asarray(rgb))
    for a, e in zip(got, ref):
        np.testing.assert_array_equal(a.numpy(), np.asarray(e))
