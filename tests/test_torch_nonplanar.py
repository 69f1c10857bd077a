"""The port's non-planar formulation (ops/fastpath.py: _phase1, _phase2,
_i4_dispatch, encode_band and fast_encode_fn(..., planar=False)) against
the JAX package on the CPU, every output exact: encode_band on two row
bands with source halos, the skew-2 _phase2, and the reference's
non-planar program (its WEBPTPU_NO_PLANAR branch). Inputs are made from
seeds with numpy; each reference program is compiled once per module."""

import functools

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from webp_tpu.ops import fastpath as fp_ref
from webp_tpu.ops import i4 as I4_ref
from webp_tpu_torch.ops import cuda
from webp_tpu_torch.ops import fastpath as FP
from webp_tpu_torch.ops import i4_kernel as I4K

W = H = 64
BAND_H = 32
ESC = 1024


def planes(B, h, w, seed):
    """YUV 4:2:0 planes: a waved ramp under noise (luma), soft chroma."""
    rng = np.random.default_rng(seed)
    y = np.linspace(0, 1, h)[:, None]
    x = np.linspace(0, 1, w)[None, :]
    Y = 120 + 90 * np.sin(7 * x + 3 * y) + rng.normal(0, 18, (B, h, w))
    Y[:, : h // 2, : w // 2] = 90 + 60 * x[:, : w // 2]     # a smooth block
    U = 128 + 40 * np.cos(5 * y[::2]) + rng.normal(0, 6, (B, h // 2, w // 2))
    V = 128 + 30 * x[:, ::2] + rng.normal(0, 6, (B, h // 2, w // 2))
    return [np.clip(p, 0, 255).astype(np.uint8) for p in (Y, U, V)]


def rgbs(B, h, w, seed):
    rng = np.random.default_rng(seed)
    y = np.linspace(0, 1, h)[:, None]
    x = np.linspace(0, 1, w)[None, :]
    base = np.stack([200 * x + 30 * np.sin(9 * y), 180 * y + 20 * np.cos(7 * x),
                     100 + 80 * x * y], -1)
    return np.clip(base + rng.normal(0, 14, (B, h, w, 3)), 0,
                   255).astype(np.uint8)


@functools.lru_cache(maxsize=1)
def _ref_band_fn():
    rt = fp_ref.RateTables(np.asarray(fp_ref.T.COEFFS_PROBA0))

    def one(y, u, v, hy, hu, hv, above):
        return fp_ref.encode_band(y, u, v, hy, hu, hv, above, rt, W // 16,
                                  BAND_H // 16, ESC, 75, 4, 50, True, None,
                                  1024.0)

    return jax.jit(jax.vmap(one, in_axes=(0, 0, 0, 0, 0, 0, None)))


def _band(Y, U, V, s):
    """Band s of the planes and the source rows above it (zeros on top)."""
    ys, cs = slice(s * BAND_H, (s + 1) * BAND_H), slice(
        s * BAND_H // 2, (s + 1) * BAND_H // 2)
    band = (Y[:, ys], U[:, cs], V[:, cs])
    if s == 0:
        halos = (np.zeros_like(Y[:, 0]), np.zeros_like(U[:, 0]),
                 np.zeros_like(V[:, 0]))
    else:
        halos = (Y[:, ys.start - 1], U[:, cs.start - 1], V[:, cs.start - 1])
    return band, halos


@pytest.mark.parametrize("s", [0, 1])
def test_encode_band_with_halos_equals_reference(s):
    """Band s of two 64x32 bands of a 64x64 image (two images per band):
    4 segments planned from the band alone (the reference's
    psum_axis=None), I4 on, rd_drop 1024; band 1 predicts its first MB row
    from the source row above and keeps it I16. Every field and the level
    histogram exact."""
    Y, U, V = planes(2, H, W, 5)
    band, halos = _band(Y, U, V, s)
    ref = _ref_band_fn()(*band, *halos, jnp.asarray(s > 0))
    got = FP.encode_band(*map(torch.as_tensor, band + halos), s > 0,
                         W // 16, BAND_H // 16, ESC, 75, 4, 50, True)
    assert set(got) == set(ref)
    for k in ref:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(ref[k]),
                                      err_msg=k)
    is_i4 = got["is_i4"].numpy()
    assert is_i4.any() and not is_i4.all(), "premise: both I4 and I16 MBs"
    if s:
        assert not is_i4[:, : W // 16].any()


def test_encode_band_unsegmented_runs_the_static_plan():
    """segments=1: the quality's one quantizer, zero segment fields (the
    port's plan against the reference's rd_params path is held in the
    sharded test of test_torch_parallel.py at 4 segments; here the
    unsegmented band equals the unsegmented non-planar encoder when it
    has no band above)."""
    Y, U, V = planes(1, H, W, 6)
    z = [torch.zeros((1, n), dtype=torch.uint8) for n in (W, W // 2, W // 2)]
    got = FP.encode_band(*map(torch.as_tensor, (Y, U, V)), *z, False,
                         W // 16, H // 16, ESC, 75, 1, 50, True)
    want = FP.fast_encode_fn(W // 16, H // 16, 75, 1, 50, True,
                             planar=False)(*map(torch.as_tensor, (Y, U, V)))
    for k in want:
        assert torch.equal(got[k], want[k]), k
    assert not got["seg_q"].any() and not got["dq_uv"].any()


def test_phase2_skew2_equals_reference():
    """The non-planar _phase2 at skew 2 with the I4 walk, 4 segments and
    rd_drop 1024 at 5x3 MBs, on modes from the reference's phase 1 and
    I4 search (tests/test_planar.py's setup, on structured planes): lv24, y2 and the
    reconstructed contours exact."""
    B, mb_w, mb_h, sk = 2, 5, 3, 2
    n_mb = mb_w * mb_h
    Y, U, V = (p.astype(np.int32) for p in planes(B, mb_h * 16, mb_w * 16,
                                                   20))
    rt = fp_ref.RateTables(np.asarray(fp_ref.T.COEFFS_PROBA0))
    qp, _ = fp_ref.rd_params(75)

    def ref_one(Yi, Ui, Vi):
        seg_map, seg_q, _, _ = fp_ref._segment_plan_device(
            Yi, Ui, Vi, mb_w, mb_h, 75, 50, 4)
        qp_i, lam_i, seg_rows = fp_ref._mb_quant(seg_map, seg_q, n_mb)
        modes, uvmodes, i16 = fp_ref._phase1(Yi, Ui, Vi, qp_i, lam_i, rt,
                                             mb_w, mb_h)
        src_b = fp_ref._block(Yi.reshape(mb_h, 16, mb_w, 16)
                              .transpose(0, 2, 1, 3).reshape(n_mb, 16, 16),
                              16)
        is_i4, i4m, _ = I4_ref.i4_search(
            Yi, src_b, qp_i["y1"], lam_i["i4"], rt, mb_w, mb_h, i16,
            fp_ref.approx_block_rate, allow_tr=True,
            lam_mode=lam_i["mode"])
        out = fp_ref._phase2(Yi, Ui, Vi, modes, uvmodes, qp, mb_w, mb_h,
                             rd_drop=1024.0, seg=(seg_map, seg_rows),
                             i4=(is_i4, i4m), sk=sk)
        return (modes, uvmodes, is_i4, i4m, seg_map, seg_rows) + out

    ref = jax.jit(jax.vmap(ref_one))(Y, U, V)
    modes, uvmodes, is_i4, i4m, seg_map, seg_rows = ref[:6]
    t = lambda a: torch.as_tensor(np.array(a))
    got = FP._phase2(
        *(torch.as_tensor(p) for p in (Y, U, V)), t(modes), t(uvmodes),
        mb_w, mb_h, (t(seg_map), {k: t(v) for k, v in seg_rows.items()}),
        rd_drop=1024.0, i4=(t(is_i4), t(i4m)), sk=sk)
    assert np.asarray(is_i4).any() and not np.asarray(is_i4).all()
    for name, g, r in zip(("lv24", "y2", "bottom", "right", "bottom_u",
                           "bottom_v"), got, ref[6:]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r),
                                      err_msg=name)


@pytest.fixture(scope="module")
def ref_nonplanar(request):
    """The reference's non-planar device program (WEBPTPU_NO_PLANAR, read
    inside its lru_cached factory, so the cache is cleared around it) at
    a geometry no other test uses: 48x32, q75, 4 segments, SNS 50, I4."""
    mp = pytest.MonkeyPatch()
    fp_ref._fast_encode_fn.cache_clear()
    mp.setenv("WEBPTPU_NO_PLANAR", "1")
    try:
        fn = fp_ref.fast_encode_fn(3, 2, 75, 4, 50, True, rd_drop=1024.0)
    finally:
        mp.undo()
        fp_ref._fast_encode_fn.cache_clear()
    return fn


def test_nonplanar_blob_equals_reference_and_planar(ref_nonplanar):
    """fast_encode_fn(planar=False).rgb_blob equals the reference's
    non-planar program's blob and the port's planar blob, byte for
    byte."""
    x = rgbs(2, 32, 48, 21)
    ref = [np.asarray(c) for c in ref_nonplanar.rgb_blob(x)]
    fn = FP.fast_encode_fn(3, 2, 75, 4, 50, True, planar=False)
    got = fn.rgb_blob(torch.as_tensor(x))
    planar = FP.fast_encode_fn(3, 2, 75, 4, 50, True).rgb_blob(
        torch.as_tensor(x))
    assert fn.blob_spec == ref_nonplanar.blob_spec
    for g, p, r in zip(got, planar, ref):
        np.testing.assert_array_equal(g.numpy(), r)
        assert torch.equal(g, p)
    fields = FP.unpack_output_blob([c.numpy() for c in got], fn.blob_spec)
    assert fields["is_i4"].any() and fields["seg_q"].any()


@pytest.mark.parametrize("config", [
    dict(segments=1), dict(i4_blocks=False), dict(sk=2),
    dict(sharp_yuv=True), dict(rd_drop=0.0)])
def test_nonplanar_equals_planar(config):
    """The two formulations give the same fields (the reference asserts
    it of its own, tests/test_planar.py): unsegmented, I4 off, skew 2,
    sharp YUV and rd_drop 0, at 64x48 with two images."""
    opts = dict(segments=4, sns_strength=50, i4_blocks=True)
    opts.update(config)
    x = torch.as_tensor(rgbs(2, 48, 64, 22))
    a = FP.fast_encode_fn(4, 3, 75, **opts).rgb_blob(x)
    b = FP.fast_encode_fn(4, 3, 75, planar=False, **opts).rgb_blob(x)
    for g, r in zip(b, a):
        assert torch.equal(g, r)


def test_nonplanar_ignores_trellis_and_search():
    """As the reference's encode_one, the non-planar program ignores the
    trellis and the in-loop search: its blob at skew 2 with both equals
    the one without."""
    x = torch.as_tensor(rgbs(1, 48, 64, 23))
    a = FP.fast_encode_fn(4, 3, 75, 4, 50, True, sk=2, planar=False)
    b = FP.fast_encode_fn(4, 3, 75, 4, 50, True, sk=2, trellis=True,
                          i4_mode_search=True, planar=False)
    for g, r in zip(a.rgb_blob(x), b.rgb_blob(x)):
        assert torch.equal(g, r)


def test_nonplanar_launches_only_kernel_3_and_never_falls_back(monkeypatch):
    """With the tensors taken for card tensors, the non-planar program
    launches kernel 3 once for the batch and no other kernel (phases 0, 1
    and 2 are PyTorch operations); its outputs, filled in by the plain
    version, give the CPU's blob. A refused launch raises out of the
    encoder: there is no fallback to the plain version."""
    x = torch.as_tensor(rgbs(2, 48, 64, 24))
    fn = FP.fast_encode_fn(4, 3, 75, 4, 50, True, planar=False)
    want = fn.rgb_blob(x)
    calls = []

    def launch(name, *a):
        calls.append(name)
        data, qtab, lams, rc, N, n_sb, use_td, mode, score = a
        m, s = I4K.i4_scores_plain(data, qtab, lams, rc, n_sb, use_td)
        mode.copy_(m)
        score.copy_(s)

    monkeypatch.setattr(cuda, "on_cpu", lambda *t: False)
    monkeypatch.setattr(cuda, "launch", launch)
    got = fn.rgb_blob(x)
    assert calls == ["i4_search"]
    assert all(torch.equal(g, r) for g, r in zip(got, want))

    def refused(name, *a):
        raise RuntimeError(f"{name}: kernel launch failed")

    monkeypatch.setattr(cuda, "launch", refused)
    with pytest.raises(RuntimeError, match="i4_search"):
        fn.rgb_blob(x)


def test_level_histogram_follows_jnp_histogram():
    """|level| 16 lands in the last bin and larger values are dropped, as
    jnp.histogram(bins=16, range=(0, 16)) does."""
    rng = np.random.default_rng(25)
    lv = rng.integers(-40, 41, (3, 7, 24, 16)).astype(np.int16)
    lv[0, 0, 0, :4] = [16, -16, 17, 15]
    got = FP.level_histogram(torch.as_tensor(lv)).numpy()
    for b in range(3):
        ref = np.asarray(jnp.histogram(jnp.abs(jnp.asarray(lv[b])).astype(
            jnp.int32), bins=16, range=(0, 16))[0])
        np.testing.assert_array_equal(got[b], ref)
