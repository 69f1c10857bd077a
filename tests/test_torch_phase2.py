"""The port's phase-2 wavefront (the Python step loop that stands in for
the reference's lax.scan), the nibble pack and escape list, and the whole
device program's output blob, against the JAX package on the CPU."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from webp_tpu.ops import fastpath as FP_ref
from webp_tpu.ops import planar as PL_ref
from webp_tpu_torch.ops import fastpath as FP
from webp_tpu_torch.ops import planar as PL


def _planes(B, W, H, seed):
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:H, 0:W]
    Y = np.broadcast_to((x * 3 + y * 2) % 256, (B, H, W)).copy()
    Y[:, :, W // 2:] = rng.integers(0, 256, (B, H, W - W // 2))
    U = rng.integers(100, 160, (B, H // 2, W // 2))
    V = np.broadcast_to((x[::2, ::2] * 5) % 256, (B, H // 2, W // 2))
    return [np.ascontiguousarray(p).astype(np.uint8) for p in (Y, U, V)]


@pytest.mark.parametrize("geom", [(64, 48), (80, 48)])
def test_phase2_planar_levels_equal_reference(geom):
    """lv24 and y2 exact at the main path's configuration: skew 1,
    rd_drop 1024, four segments, the I4 walk on."""
    W, H = geom
    B, mb_w, mb_h = 2, W // 16, H // 16
    n_mb = mb_w * mb_h
    Y, U, V = _planes(B, W, H, 1)
    rng = np.random.default_rng(2)
    modes = rng.integers(0, 4, (B, n_mb)).astype(np.uint8)
    uvmodes = rng.integers(0, 4, (B, n_mb)).astype(np.uint8)
    is_i4 = rng.random((B, n_mb)) < 0.5
    i4m = rng.integers(0, 10, (B, n_mb, 16)).astype(np.uint8)
    seg_map = rng.integers(0, 4, (B, n_mb)).astype(np.int32)
    seg_q = rng.integers(10, 120, (B, 4))
    tabs = FP_ref.all_q_tables()[0]
    seg_rows = {k: tabs[k][seg_q].astype(np.int32) for k in ("y1", "y2",
                                                              "uv")}
    ref = PL_ref.phase2_planar(
        *(jnp.asarray(p) for p in (Y, U, V)), jnp.asarray(modes),
        jnp.asarray(uvmodes), None, mb_w, mb_h, rd_drop=1024.0,
        seg=(jnp.asarray(seg_map),
             {k: jnp.asarray(v) for k, v in seg_rows.items()}),
        i4=(jnp.asarray(is_i4), jnp.asarray(i4m)))
    t = torch.as_tensor
    got = PL.phase2_planar(
        *(t(p) for p in (Y, U, V)), t(modes), t(uvmodes), None, mb_w, mb_h,
        rd_drop=1024.0, seg=(t(seg_map), {k: t(v) for k, v in
                                          seg_rows.items()}),
        i4=(t(is_i4), t(i4m)))
    for name, g, r in zip(("lv24", "y2", "bottom", "right"), got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r),
                                      err_msg=name)
    assert got[0].dtype == torch.int16 and got[1].dtype == torch.int16
    assert (got[0].abs() > 7).any(), "premise: escape-sized levels occur"


def test_phase2_planar_other_configurations_raise():
    z = torch.zeros((1, 16, 16), dtype=torch.uint8)
    m = torch.zeros((1, 1), dtype=torch.uint8)
    for kw in ({"sk": 2}, {"trellis": True}, {"i4_search": ()},
               {"wire_pack": 1}, {}):
        with pytest.raises(NotImplementedError):
            PL.phase2_planar(z, z[:, :8, :8], z[:, :8, :8], m, m, None, 1,
                             1, **kw)


@pytest.mark.parametrize("sk", [1, 2])
def test_skew_unskew_equal_reference_and_invert(sk):
    rng = np.random.default_rng(sk)
    B, mb_h, mb_w = 2, 3, 5
    T_steps = mb_w + sk * (mb_h - 1)
    a = rng.integers(0, 100, (B, mb_h, mb_w, 6)).astype(np.int32)
    got = PL._skew_b(torch.as_tensor(a), mb_w, mb_h, T_steps, sk)
    ref = PL_ref._skew_b(jnp.asarray(a), mb_w, mb_h, T_steps, sk)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    back = PL._unskew_b(got, B, mb_w, mb_h, T_steps, sk)
    np.testing.assert_array_equal(back.numpy(), a.reshape(B, -1, 6))


def _levels(B, n_mb, seed, esc_rate):
    rng = np.random.default_rng(seed)
    lv = rng.integers(-7, 8, (B, n_mb, 24, 16))
    lv[rng.random(lv.shape) < 0.6] = 0
    big = rng.random(lv.shape) < esc_rate
    lv[big] = rng.integers(-2047, 2048, int(big.sum()))
    return lv.astype(np.int16)


@pytest.mark.parametrize("esc_rate,esc_cap", [(0.0, 1024), (0.002, 1024),
                                              (0.05, 40)])
def test_pack_levels_equals_reference_and_unpacks(esc_rate, esc_cap):
    B, n_mb = 2, 12
    lv = _levels(B, n_mb, 3, esc_rate)
    got = FP._pack_levels(torch.as_tensor(lv), esc_cap)
    ref = jax.vmap(lambda x: FP_ref._pack_levels(x, esc_cap))(jnp.asarray(lv))
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    for b in range(B):
        if int(got[3][b]) > esc_cap:
            continue            # overflow: the host re-encodes the image
        back = FP.unpack_levels(*(x[b].numpy() for x in got), n_mb)
        np.testing.assert_array_equal(back, lv[b])


@pytest.mark.parametrize("geom", [(64, 48), (80, 48)])
def test_rgbp_blob_equals_reference_byte_for_byte(geom):
    """The whole device program at the main path's configuration: the
    output blob's chunks byte for byte, and every field unpacked."""
    W, H = geom
    rng = np.random.default_rng(W)
    y, x = np.mgrid[0:H, 0:W]
    rgbp = np.stack([np.stack([(x * 4) % 256, (y * 5) % 256,
                               (x * y) % 256])] * 2).astype(np.int64)
    rgbp[1] = rgbp[1] // 2 + rng.integers(0, 128, rgbp[1].shape)
    rgbp = rgbp.astype(np.uint8)
    fn = FP.fast_encode_fn(W // 16, H // 16, 75, 4, 50, True)
    fn_ref = FP_ref.fast_encode_fn(W // 16, H // 16, 75, 4, 50, True,
                                   rd_drop=1024.0)
    got = fn.rgbp_blob(torch.as_tensor(rgbp))
    ref = fn_ref.rgbp_blob(jnp.asarray(rgbp))
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


def test_fast_encode_fn_other_configurations_raise():
    for kw in ({"sharp_yuv": True}, {"sk": 2}, {"trellis": True},
               {"i4_mode_search": True}):
        with pytest.raises(NotImplementedError):
            FP.fast_encode_fn(4, 3, 75, 4, 50, **kw)
    with pytest.raises(NotImplementedError):
        FP.fast_encode_fn(4, 3, 75, 1, 50)
