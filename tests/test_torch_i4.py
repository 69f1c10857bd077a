"""Kernel 3 of the port (the 10-mode I4 search) and the I4-vs-I16 split,
through the plain PyTorch version, against the JAX package: the planar
subblock rows exactly, the Pallas I4 kernel in interpret mode (modes
exact, f32 scores within rtol 3e-7) and i4_search_pallas (is_i4 and
modes exact)."""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from webp_tpu.lossy import tables as T_ref
from webp_tpu.ops import fastpath as FP_ref
from webp_tpu.ops import i4 as I4_ref
from webp_tpu.ops import pallas_i4 as PI4_ref
from webp_tpu_torch.ops import fastpath as FP
from webp_tpu_torch.ops import i4 as I4
from webp_tpu_torch.ops import i4_kernel as K

SCORE_RTOL = 3e-7
W, H, B = 64, 48, 2
MB_W, MB_H = W // 16, H // 16
N_MB = MB_W * MB_H


def _inputs(seed):
    """Luma with flat, ramped, edged and textured regions, and a random
    4-segment plan with the reference's per-segment tables (numpy)."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:H, 0:W]
    Y = np.where(x < W // 3, 90 + (y * 3) % 40,
                 np.where(x < 2 * W // 3, (x * 7 + y * 2) % 256,
                          rng.integers(0, 256, (H, W))))
    Y = np.broadcast_to(Y, (B, H, W)).copy()
    Y[1] = 255 - Y[1]
    Y[:, 20:24] = 240
    Y = Y.astype(np.uint8)
    seg_q = rng.integers(20, 110, (B, 4)).astype(np.int32)
    seg_map = rng.integers(0, 4, (B, N_MB)).astype(np.int32)
    tabs, _, _, lam4, qi4 = FP_ref.all_q_tables()
    qtab16 = tabs["y1"][seg_q].reshape(B, 16, 16).astype(np.int32)
    lammd = FP_ref._lam_mode_table(qi4)[seg_q]
    tlsd4 = ((50 * qi4[seg_q]) >> 5).astype(np.float32)
    return Y, seg_map, qtab16, lam4[seg_q], lammd, tlsd4, seg_q


def _rt_ref():
    return FP_ref.RateTables(np.asarray(T_ref.COEFFS_PROBA0))


def test_planar_inputs_equal_reference():
    Y, seg_map, *_ = _inputs(1)
    data = I4._planar_inputs(torch.as_tensor(Y), torch.as_tensor(seg_map),
                             MB_W, MB_H).numpy()
    n_sb = 16 * N_MB
    for b in range(B):
        src16, ctx = I4_ref._planar_inputs(jnp.asarray(Y[b], jnp.int32),
                                           jnp.asarray(seg_map[b]), MB_W,
                                           MB_H)
        ref = np.concatenate([np.asarray(src16), np.asarray(ctx)])
        np.testing.assert_array_equal(data[:, b * n_sb:(b + 1) * n_sb], ref)


@pytest.mark.parametrize("use_td", [False, True])
def test_i4_scores_plain_equals_pallas_i4_kernel(use_td):
    Y, seg_map, qtab16, lam4, lammd, tlsd4, _ = _inputs(2)
    n_sb = 16 * N_MB
    data = I4._planar_inputs(torch.as_tensor(Y), torch.as_tensor(seg_map),
                             MB_W, MB_H)
    lams = np.concatenate([lam4, tlsd4 if use_td else 0 * lam4, lammd],
                          axis=1).astype(np.float32)
    mode, score = K.i4_scores(data, torch.as_tensor(qtab16),
                              torch.as_tensor(lams),
                              FP.device_tables("cpu").rate_consts, n_sb,
                              use_td)
    rt = _rt_ref()
    for b in range(B):
        src16, ctx = I4_ref._planar_inputs(jnp.asarray(Y[b], jnp.int32),
                                           jnp.asarray(seg_map[b]), MB_W,
                                           MB_H)
        m_r, s_r = PI4_ref.i4_scores_planar(
            src16, ctx, jnp.asarray(qtab16[b]), lam4[b], rt.lvlp[3],
            rt.tailp[3], rt.eob1p[3], rt.eob2p[3], rt.emptyp[3][0],
            I4_ref.I4_MODE_COST, I4_ref.TR_MODES, interpret=True,
            tlsd4=tlsd4[b] if use_td else None, lam_mode4=lammd[b])
        sl = slice(b * n_sb, (b + 1) * n_sb)
        np.testing.assert_array_equal(mode[sl].numpy(), np.asarray(m_r))
        np.testing.assert_allclose(score[sl].numpy(), np.asarray(s_r),
                                   rtol=SCORE_RTOL)
    assert len(np.unique(mode.numpy())) >= 8, "premise: most modes chosen"


def test_i4_search_equals_i4_search_pallas():
    """The batched split decision: one kernel launch over both images
    against the reference's per-image i4_search_pallas."""
    Y, seg_map, qtab16, lam4, lammd, tlsd4, _ = _inputs(3)
    rt = _rt_ref()
    ref = []
    for b in range(B):
        ref.append(I4_ref.i4_search_pallas(
            jnp.asarray(Y[b], jnp.int32), None, jnp.asarray(seg_map[b]),
            jnp.asarray(qtab16[b]), lam4[b], rt, MB_W, MB_H,
            jnp.zeros((N_MB,), jnp.float32), interpret=True,
            tlsd4=tlsd4[b], lam_mode4=lammd[b]))
    i4_score_r = np.stack([np.asarray(r[2]) for r in ref])
    # An I16 score on each side of the I4 score, so both outcomes occur.
    rng = np.random.default_rng(0)
    i16 = (i4_score_r * rng.choice([0.95, 1.05], i4_score_r.shape)) \
        .astype(np.float32)
    is_i4, modes, i4_score = I4.i4_search(
        torch.as_tensor(Y), torch.as_tensor(seg_map),
        torch.as_tensor(qtab16), torch.as_tensor(lam4),
        torch.as_tensor(lammd), torch.as_tensor(tlsd4), torch.as_tensor(i16),
        MB_W, MB_H)
    np.testing.assert_array_equal(modes.numpy(),
                                  np.stack([np.asarray(r[1]) for r in ref]))
    np.testing.assert_allclose(i4_score.numpy(), i4_score_r, rtol=SCORE_RTOL)
    np.testing.assert_array_equal(is_i4.numpy(), i4_score_r < i16)
    assert is_i4.any() and not is_i4.all()


def test_i4_search_split_equals_reference_cpu_path():
    """The reference's own CPU path (jnp i4_search on per-MB rows, the
    path its encode_batch takes off the TPU) takes the same split and
    modes on the same inputs, with the I16 scores set to its I4 scores
    rescaled up and down."""
    Y, seg_map, qtab16, lam4, lammd, tlsd4, seg_q = _inputs(4)
    rt = _rt_ref()
    for b in range(B):
        qp_i, lam_i, _ = FP_ref._mb_quant(jnp.asarray(seg_map[b]),
                                          jnp.asarray(seg_q[b]), N_MB)
        Yj = jnp.asarray(Y[b], jnp.int32)
        src_b = FP_ref._block(Yj.reshape(MB_H, 16, MB_W, 16)
                              .transpose(0, 2, 1, 3).reshape(N_MB, 16, 16),
                              16)
        tl = jnp.asarray(tlsd4[b])[jnp.asarray(seg_map[b])]
        _, m_r, s_r = I4_ref.i4_search(
            Yj, src_b, qp_i["y1"], lam_i["i4"], rt, MB_W, MB_H,
            jnp.zeros((N_MB,), jnp.float32), FP_ref.approx_block_rate,
            tlsd=tl, lam_mode=lam_i["mode"])
        s_r = np.asarray(s_r)
        i16 = (s_r * np.where(np.arange(N_MB) % 2, 0.97, 1.03)) \
            .astype(np.float32)
        is_i4, modes, i4_score = I4.i4_search(
            torch.as_tensor(Y[b:b + 1]), torch.as_tensor(seg_map[b:b + 1]),
            torch.as_tensor(qtab16[b:b + 1]), torch.as_tensor(lam4[b:b + 1]),
            torch.as_tensor(lammd[b:b + 1]), torch.as_tensor(tlsd4[b:b + 1]),
            torch.as_tensor(i16[None]), MB_W, MB_H)
        np.testing.assert_array_equal(modes[0].numpy(), np.asarray(m_r))
        np.testing.assert_array_equal(i4_score[0].numpy(), s_r)
        np.testing.assert_array_equal(is_i4[0].numpy(), s_r < i16)


def test_ctx_mode_rate_delta_equals_reference():
    rng = np.random.default_rng(7)
    modes = rng.integers(0, 10, (2, 12, 16)).astype(np.uint8)
    got = I4.ctx_mode_rate_delta(torch.as_tensor(modes))
    ref = I4_ref.ctx_mode_rate_delta(jnp.asarray(modes), 4, 3)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_i4_wrapper_checks_its_tensors():
    rc = FP.device_tables("cpu").rate_consts
    data = torch.zeros((32, 64), dtype=torch.uint8)
    qtab = torch.zeros((2, 16, 16), dtype=torch.int32)
    lams = torch.zeros((2, 12), dtype=torch.float32)
    with pytest.raises(ValueError):
        K.i4_scores(data, qtab, lams, rc, 48, True)         # 64 % 48 != 0
    with pytest.raises(ValueError):
        K.i4_scores(data, qtab, lams[:, :8].contiguous(), rc, 32, True)
    with pytest.raises(TypeError):
        K.i4_scores(data, qtab.float(), lams, rc, 32, True)
    with pytest.raises(ValueError):
        K.i4_scores(data.to("meta"), qtab.to("meta"), lams.to("meta"),
                    rc.to("meta"), 32, True)
