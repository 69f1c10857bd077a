"""The port's exact-parity wavefront oracle (ops/wavefront.py) against the
reference's wavefront_encode_fn and against the port's host VP8Encoder
(the I16 path, as tests/test_vp8_encode.py holds the reference's):
levels, y2, modes, chroma modes and skip flags exact. Then the device
encoder's closed loop against the oracle: phase 2 on the oracle's modes
gives the oracle's levels."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from webp_tpu.ops import pipeline as PP_ref
from webp_tpu.ops import wavefront as WF_ref
from webp_tpu_torch.encoder import rgb_to_yuv420
from webp_tpu_torch.lossy import device_encode as DE
from webp_tpu_torch.lossy.encode import LossyConfig, VP8Encoder
from webp_tpu_torch.ops import fastpath as FP
from webp_tpu_torch.ops import p2_kernel as P2K
from webp_tpu_torch.ops import pipeline as PP
from webp_tpu_torch.ops import wavefront as WF


def photo(h, w, seed):
    """Gradients, a noisy textured half, a flat patch and hard stripes, so
    every I16 and chroma mode is chosen somewhere."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w].astype(np.float64)
    img = np.stack([200 * x / w + 30 * np.sin(y / 3), 180 * y / h,
                    100 + 80 * np.cos(x / 5)], -1)
    img[:, w // 2:] += rng.normal(0, 40, (h, w - w // 2, 3))
    img[: h // 3, : w // 4] = (40, 200, 90)
    img[:, 3::9] = 250
    img[h // 2::7] = 10
    return np.clip(img, 0, 255).astype(np.uint8)


def _host(Y, U, V, w, h):
    enc = VP8Encoder(Y, U, V, w, h, LossyConfig(quality=75, i4_blocks=False,
                                                segments=1, sns_strength=0))
    enc.encode()
    return enc


def test_oracle_equals_reference_and_host_encoder():
    """64x48 (4x3 MBs, 8 skewed diagonals): every output equal to the
    reference's wavefront, and levels, y2 and modes to the host encoder's
    I16 path."""
    h, w = 48, 64
    Y, U, V = rgb_to_yuv420(photo(h, w, 40))
    mbw, mbh = w // 16, h // 16
    ref = [np.asarray(o) for o in WF_ref.wavefront_encode_fn(mbw, mbh, 75)(
        Y, U, V)]
    got = [o.numpy() for o in DE._get_fn(mbw, mbh, 75)(
        *map(torch.as_tensor, (Y, U, V)))]
    for name, g, r in zip(("levels", "y2", "modes", "uvmodes", "skip"), got,
                          ref):
        np.testing.assert_array_equal(g, r, err_msg=name)
    enc = _host(Y, U, V, w, h)
    assert np.array_equal(got[0].reshape(mbh, mbw, 24, 16), enc.levels)
    assert np.array_equal(got[1].reshape(mbh, mbw, 16), enc.y2_levels)
    assert np.array_equal(got[2].reshape(mbh, mbw), enc.imodes[..., 0])
    assert np.array_equal(got[3].reshape(mbh, mbw), enc.uvmode)
    assert len(set(got[2])) >= 3 and len(set(got[3])) >= 3


@pytest.mark.parametrize("geom", [(80, 64), (16, 48), (96, 16)])
def test_oracle_equals_host_encoder(geom):
    """Wider and narrower frames (one MB column, one MB row) against the
    host encoder alone, no reference compile; fn.rgb imports on the
    device first and gives the same result on the same planes."""
    w, h = geom
    img = photo(h, w, 41)
    Y, U, V = rgb_to_yuv420(img)
    fn = WF.wavefront_encode_fn(w // 16, h // 16, 75)
    got = [o.numpy() for o in fn(*map(torch.as_tensor, (Y, U, V)))]
    enc = _host(Y, U, V, w, h)
    assert np.array_equal(got[0].reshape(enc.levels.shape), enc.levels)
    assert np.array_equal(got[1].reshape(enc.y2_levels.shape), enc.y2_levels)
    assert np.array_equal(got[2], enc.imodes[..., 0].reshape(-1))
    assert np.array_equal(got[3], enc.uvmode.reshape(-1))
    from webp_tpu_torch.ops import yuv as devyuv

    dY, dU, dV = (p[0] for p in devyuv.rgb_to_yuv420(
        torch.as_tensor(img)[None]))
    want = fn(dY, dU, dV)
    for g, r in zip(fn.rgb(torch.as_tensor(img)), want):
        assert torch.equal(g, r)
    batch = fn.rgb_batch(torch.as_tensor(np.stack([img, img])))
    assert torch.equal(batch[0][1], want[0])


@pytest.mark.parametrize("ptype,first", [(0, 1), (1, 0), (2, 0), (3, 0)])
def test_residual_cost_vec_equals_reference(ptype, first):
    """The vectorized rate on random blocks (levels to +-80, beyond the
    67 clamp) and every first-coefficient context."""
    rng = np.random.default_rng(42 + ptype)
    lv = rng.integers(-3, 4, (3, 64, 16)).astype(np.int32)
    lv[0] = np.where(rng.random((64, 16)) < 0.1,
                     rng.integers(-80, 81, (64, 16)), lv[0])
    lv[1, :, 6:] = 0
    lv[2] = 0
    lv[2, :8, 15] = 1
    ctx0 = rng.integers(0, 3, (3, 64)).astype(np.int32)
    qp_r, qp = PP_ref.quant_params(75), PP.quant_params(75)
    lam = {"i16": 1, "uv": 1, "mode": 1}
    proba = np.asarray(WF_ref.T.COEFFS_PROBA0)
    tb_r = WF_ref.make_tables(proba, qp_r, lam)
    ref = jax.jit(lambda l, c: WF_ref.residual_cost_vec(l, first, c, ptype,
                                                        tb_r))(lv, ctx0)
    got = WF.residual_cost_vec(torch.as_tensor(lv), first,
                               torch.as_tensor(ctx0), ptype,
                               WF.make_tables(proba, qp, lam))
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def phase2_on_oracle_modes(Y, U, V, mbw, mbh, path):
    """The oracle's outputs and the device encoder's phase 2 (kernel 4's
    wrapper, or the non-planar _phase2 step loop) run on its I16 and
    chroma modes: unsegmented at q75 without SNS, I4 off, rd_drop 0 (the
    oracle's configuration). Returns (oracle outputs, (lv24, y2, skip))
    as numpy arrays."""
    n = mbw * mbh
    planes = [torch.as_tensor(p) for p in (Y, U, V)]
    want = [o.cpu().numpy() for o in DE._get_fn(mbw, mbh, 75)(*planes)]
    Yb, Ub, Vb = (p[None] for p in planes)
    modes, uvm = (torch.as_tensor(want[i])[None].to(Yb.device)
                  for i in (2, 3))
    plan = FP._single_plan(75, 0, 1, n, Yb.device)
    if path == "kernel4":
        wire = P2K.phase2_pack(
            Yb, Ub, Vb, modes, uvm, torch.zeros((1, n), dtype=torch.bool),
            torch.zeros((1, n, 16), dtype=torch.uint8), plan[0], plan[3],
            0.0, 1024)
        wire = {k: v[0].cpu().numpy() for k, v in wire.items()}
        lv = FP.unpack_levels(wire["packed"], wire["esc_idx"],
                              wire["esc_val"], int(wire["esc_cnt"]), n)
        return want, (lv, wire["y2"], wire["skip"].astype(bool))
    lv, y2 = FP._phase2(Yb, Ub, Vb, modes, uvm, mbw, mbh,
                        (plan[0], FP._seg_rows(plan[3])))[:2]
    lv, y2 = lv[0].numpy(), y2[0].numpy()
    return want, (lv, y2, ~(lv.any(axis=(1, 2)) | y2.any(axis=1)))


@pytest.mark.parametrize("path", ["kernel4", "step_loop"])
@pytest.mark.parametrize("geom", [(64, 48), (80, 64), (16, 48), (96, 16)])
def test_phase2_on_the_oracles_modes_equals_the_oracle(geom, path):
    """The oracle as the reference of the device path's closed loop:
    with the oracle's modes, kernel 4's plain version (the planar main
    path) and the non-planar step loop reconstruct the same context and
    quantize the same levels, y2 and skip flags."""
    w, h = geom
    Y, U, V = rgb_to_yuv420(photo(h, w, 42))
    want, got = phase2_on_oracle_modes(Y, U, V, w // 16, h // 16, path)
    for name, g, r in zip(("levels", "y2", "skip"), got,
                          (want[0], want[1], want[4])):
        np.testing.assert_array_equal(g, r, err_msg=name)
