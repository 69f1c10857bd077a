"""Kernels 1 and 2 of the port (segment alphas; the I16/UV mode search),
through their plain PyTorch versions, against the JAX package's Pallas
kernels run in interpret mode: alphas, segment plans and modes exact,
f32 scores within rtol 3e-7 (the reference's own Mosaic-vs-XLA bound,
tests/test_pallas_p1.py)."""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from webp_tpu.lossy import tables as T_ref
from webp_tpu.ops import fastpath as FP_ref
from webp_tpu.ops import phase1p as P1_ref
from webp_tpu_torch.ops import cuda
from webp_tpu_torch.ops import fastpath as FP
from webp_tpu_torch.ops import p1_kernels as K
from webp_tpu_torch.ops import phase1p as P1

SCORE_RTOL = 3e-7


def _planes(B, W, H, seed):
    """Smooth-ish luma with a textured half, random chroma (numpy)."""
    rng = np.random.default_rng(seed)
    base = rng.integers(0, 256, (B, H, W), np.uint8)
    ramp = (np.arange(W) * 200 // W).astype(np.uint8)[None, None, :]
    Y = np.where(np.arange(W)[None, None, :] < W // 2, ramp,
                 base // 2 + ramp // 2).astype(np.uint8)
    U = rng.integers(0, 256, (B, H // 2, W // 2), np.uint8)
    V = (U // 3 + 60).astype(np.uint8)
    return Y, U, V


def _both(Y, U, V, mb_w, mb_h):
    t = tuple(torch.as_tensor(p) for p in (Y, U, V))
    j = tuple(jnp.asarray(p) for p in (Y, U, V))
    return t, j


@pytest.mark.parametrize("geom,seed", [((64, 48), 5), ((80, 48), 6)])
def test_alphas_plain_equals_pallas_alpha_kernel(geom, seed):
    W, H = geom
    B, mb_w, mb_h = 2, W // 16, H // 16
    n_mb = mb_w * mb_h
    (Yt, Ut, Vt), (Yj, Uj, Vj) = _both(*_planes(B, W, H, seed), mb_w, mb_h)
    src, _ = P1.build_src(Yt, Ut, Vt, mb_w, mb_h)
    src_j, _, n_mb_p = P1_ref.build_src_pallas(Yj, Uj, Vj, mb_w, mb_h)
    unpadded = np.asarray(src_j).reshape(384, B, n_mb_p)[:, :, :n_mb]
    np.testing.assert_array_equal(src.numpy(),
                                  unpadded.reshape(384, B * n_mb))
    a, uv = K.alphas(src)
    a_r, uv_r = P1_ref.alphas_planar_pallas(src_j, B, n_mb, n_mb_p,
                                            interpret=True)
    np.testing.assert_array_equal(a.reshape(B, n_mb).numpy(), np.asarray(a_r))
    np.testing.assert_array_equal(uv.reshape(B, n_mb).numpy(),
                                  np.asarray(uv_r))


@pytest.mark.parametrize("quality,sns", [(75, 50), (30, 100)])
def test_plan_segments_planar_equals_reference(quality, sns):
    W, H, B = 64, 48, 2
    mb_w, mb_h = W // 16, H // 16
    n_mb = mb_w * mb_h
    (Yt, Ut, Vt), (Yj, Uj, Vj) = _both(*_planes(B, W, H, 3), mb_w, mb_h)
    src, _ = P1.build_src(Yt, Ut, Vt, mb_w, mb_h)
    got = P1.plan_segments_planar(P1.alphas_planar(src, B, n_mb), B, n_mb,
                                  quality, sns, 4)
    srcs = [P1_ref._src_planar(p, mb_h, mb_w, s)
            for p, s in ((Yj, 16), (Uj, 8), (Vj, 8))]
    ref = P1_ref.plan_segments_planar(*srcs, B, n_mb, quality, sns, 4)
    for name, g, r in zip(("seg_map", "seg_q", "seg_beta", "guv"), got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r), err_msg=name)
    assert len(np.unique(got[0].numpy())) > 1, "premise: several segments"


def _segment_tables(B, n_mb, seed):
    """Random 4-segment plans, per-image quant rows and lambdas (numpy),
    built from the reference's tables as tests/test_pallas_p1.py does."""
    rng = np.random.default_rng(seed)
    seg_q = rng.integers(20, 100, (B, 4)).astype(np.int32)
    seg_map = rng.integers(0, 4, (B, n_mb)).astype(np.int32)
    tabs, lam16, lamuv, lam4, qi4 = FP_ref.all_q_tables()
    qtab = np.stack([tabs[k][seg_q] for k in ("y1", "y2", "uv")],
                    axis=1).reshape(B, 48, 16).astype(np.int32)
    lam_mode = FP_ref._lam_mode_table(qi4)
    tlsd4 = ((50 * qi4[seg_q]) >> 5).astype(np.float32)
    return (seg_q, seg_map, qtab, lam16[seg_q], lamuv[seg_q],
            lam_mode[seg_q], tlsd4)


@pytest.mark.parametrize("use_td", [False, True])
@pytest.mark.parametrize("geom", [(64, 48), (80, 48)])
def test_mode_search_plain_equals_pallas_mode_kernel(use_td, geom):
    W, H = geom
    B, mb_w, mb_h = 2, W // 16, H // 16
    n_mb = mb_w * mb_h
    (Yt, Ut, Vt), (Yj, Uj, Vj) = _both(*_planes(B, W, H, 7), mb_w, mb_h)
    _, seg_map, qtab, lam16, lamuv, lammd, tlsd4 = _segment_tables(
        B, n_mb, 11)
    if not use_td:
        tlsd4 = None
    rt = FP_ref.RateTables(np.asarray(T_ref.COEFFS_PROBA0))
    m_r, uv_r, sc_r = P1_ref.phase1_planar_pallas(
        Yj, Uj, Vj, jnp.asarray(qtab), lam16, lamuv, tlsd4,
        jnp.asarray(seg_map), rt, mb_w, mb_h, interpret=True,
        lam_mode4=lammd)

    src, srcs = P1.build_src(Yt, Ut, Vt, mb_w, mb_h)
    f = torch.as_tensor
    m, uv, sc = P1.phase1_planar(
        src, srcs, f(qtab), f(lam16), f(lamuv),
        None if tlsd4 is None else f(tlsd4), f(seg_map), mb_w, mb_h,
        lam_mode4=f(lammd))
    np.testing.assert_array_equal(m.numpy(), np.asarray(m_r))
    np.testing.assert_array_equal(uv.numpy(), np.asarray(uv_r))
    np.testing.assert_allclose(sc.numpy(), np.asarray(sc_r), rtol=SCORE_RTOL)
    assert len(np.unique(m.numpy())) > 1 and len(np.unique(uv.numpy())) > 1


def test_packed_rate_constants_hold_the_rate_tables():
    """The rate constants the kernels read carry the RateTables fields
    and fixed mode costs at the offsets csrc/common.cuh names."""
    from webp_tpu_torch.lossy.cost import FIXED_COSTS_I4
    from webp_tpu_torch.lossy.encode import FIXED_COSTS_I16, FIXED_COSTS_UV

    tabs = FP.device_tables("cpu")
    rc = K.unpack_rate_consts(tabs.rate_consts)
    for f in ("lvlp", "tailp", "eob1p", "eob2p", "emptyp"):
        np.testing.assert_array_equal(getattr(rc, f).numpy(),
                                      getattr(tabs.rt, f))
    np.testing.assert_array_equal(rc.fc16.numpy(), FIXED_COSTS_I16)
    np.testing.assert_array_equal(rc.fcuv.numpy(), FIXED_COSTS_UV)
    np.testing.assert_array_equal(rc.i4mode.numpy(),
                                  np.asarray(FIXED_COSTS_I4)[0, 0])
    with open(FP.__file__.replace("ops/fastpath.py", "csrc/common.cuh")) as fh:
        cuh = fh.read()
    for name, val in (("RC_LVL", 0), ("RC_TAIL", 128), ("RC_EOB1", 192),
                      ("RC_EOB2", 208), ("RC_EMPTY", 224), ("RC_PT", 240)):
        assert f"constexpr int {name} = {val};" in cuh, name
    for name, expr in (("RC_FC16", "4 * RC_PT"), ("RC_FCUV", "RC_FC16 + 4"),
                       ("RC_I4MODE", "RC_FCUV + 4"),
                       ("RC_SIZE", "RC_I4MODE + 10")):
        assert f"constexpr int {name} = {expr};" in cuh, name
    assert (FP.RC_PT, FP.RC_FC16, FP.RC_FCUV, FP.RC_I4MODE, FP.RC_SIZE) == (
        240, 960, 964, 968, 978)


def test_wrappers_check_their_tensors():
    src = torch.zeros((384, 12), dtype=torch.uint8)
    with pytest.raises(TypeError):
        K.alphas(src.to(torch.int32))
    with pytest.raises(ValueError):
        K.alphas(torch.zeros((383, 12), dtype=torch.uint8))
    with pytest.raises(ValueError):
        K.alphas(torch.zeros((12, 384), dtype=torch.uint8).T)
    with pytest.raises(ValueError):
        K.alphas(src.to("meta"))
    ctx = torch.zeros((K.N_CTX, 12), dtype=torch.uint8)
    qtab = torch.zeros((2, 48, 16), dtype=torch.int32)
    lams = torch.zeros((2, 16), dtype=torch.float32)
    rc = FP.device_tables("cpu").rate_consts
    with pytest.raises(ValueError):
        K.mode_search(src, ctx, qtab, lams, rc, 5, True)   # 12 % 5 != 0
    with pytest.raises(ValueError):
        K.mode_search(src, ctx, qtab[:1], lams, rc, 6, True)
    with pytest.raises(ValueError):
        cuda.on_cpu(src, src.to("meta"))


def test_plain_versions_are_not_counted_as_launches():
    cuda.reset_launches()
    W, H, B = 32, 32, 1
    (Yt, Ut, Vt), _ = _both(*_planes(B, W, H, 1), 2, 2)
    src, _ = P1.build_src(Yt, Ut, Vt, 2, 2)
    K.alphas(src)
    assert all(v == 0 for v in cuda.LAUNCHES.values())
