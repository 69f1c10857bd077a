"""The pieces of the quality modes (methods 5 and 6) against the JAX
package on the CPU, exactly, at small lane counts: the trellis
(ops/trellis.py trellis_p and tlam_i4), the exact chained rates of the
in-loop search (ops/planar.py exact_rate_p, luma_rate16_p, uv_rate4_p)
and the I4 search with the skew-2 ban lifted (i4_search(allow_tr=True)).
The whole closed loop with the trellis and
the search is held against the reference through encode() in
test_torch_method5.py and test_torch_method6.py (phase 2 at skew 2
without them in test_torch_phase2.py)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from test_torch_i4 import B, MB_H, MB_W, N_MB, _inputs, _rt_ref
from webp_tpu.ops import fastpath as FP_ref
from webp_tpu.ops import i4 as I4_ref
from webp_tpu.ops import pipeline as PP_ref
from webp_tpu.ops import planar as PL_ref
from webp_tpu.ops import trellis as TR_ref
from webp_tpu_torch.ops import i4 as I4
from webp_tpu_torch.ops import planar as PL
from webp_tpu_torch.ops import trellis as TR


def _rows(quality):
    return [np.asarray(a, np.int32).reshape(16, 1)
            for a in PP_ref.quant_params(quality)["y1"]]


def _coeffs(rng, shape):
    """Raster coefficients with zero runs, large values (past the level
    cap at the quantizers used) and both signs."""
    c = rng.integers(-700, 700, shape).astype(np.int32)
    c[rng.random(shape) < 0.4] = 0
    c[..., 5, :] = rng.choice([-1, 1], shape[:-2] + shape[-1:]) * 30000
    return c


@pytest.mark.parametrize("case", ["ctx0", "ctx1", "ctx2", "mixed_q30",
                                  "zero_blocks", "lanes_per_lane_lambda"])
def test_trellis_equals_reference(case):
    """Levels and dequantized coefficients exact for every start context,
    a second quality, all-zero blocks and a per-lane lambda."""
    rng = np.random.default_rng(len(case))
    shape = (2, 16, 5)
    craw = _coeffs(rng, shape)
    q, iq, _, sharpen = _rows(30 if case == "mixed_q30" else 75)
    if case.startswith("ctx"):
        ctx0 = np.full((2, 5), int(case[3]), np.int32)
    else:
        ctx0 = rng.integers(0, 3, (2, 5)).astype(np.int32)
    if case == "zero_blocks":
        craw[:, :, :3] = 0
    # A per-lane lambda in every case, so that one compile serves all.
    tlam = np.broadcast_to(np.asarray(TR_ref.tlam_i4(jnp.asarray(q))), (5,))
    if case == "lanes_per_lane_lambda":
        tlam = (rng.integers(50, 5000, 5) * np.float32(1.37)) \
            .astype(np.float32)
    ref = jax.jit(TR_ref.trellis_p)(craw, q, iq, sharpen, tlam, ctx0)
    t = torch.as_tensor
    got = TR.trellis_p(t(craw), t(q), t(iq), t(sharpen), t(tlam), t(ctx0))
    for g, r in zip(got, ref):
        assert g.dtype == torch.int32
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    assert (got[0] != 0).any() and (got[0] == 0).any()


def test_tlam_i4_equals_reference():
    rows = np.stack([_rows(q)[0] for q in (0, 30, 75, 100)], axis=1)[..., 0]
    got = TR.tlam_i4(torch.as_tensor(rows))
    ref = TR_ref.tlam_i4(jnp.asarray(rows))
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("first,pt", [(0, 3), (1, 0), (0, 1), (0, 2)])
def test_exact_rate_equals_reference(first, pt):
    """Empty blocks, a lone last coefficient, levels past the 67 clamp and
    every start context."""
    rng = np.random.default_rng(first * 4 + pt)
    lv = rng.integers(-3, 4, (3, 16, 6)).astype(np.int32)
    lv[:, 9:] = 0
    lv[0] = 0
    lv[1, :, 0] = 0
    lv[1, 15, 0] = 1
    lv[2, 4, 1] = -90
    ctx0 = rng.integers(0, 3, (3, 6)).astype(np.int32)
    got = PL.exact_rate_p(torch.as_tensor(lv), first, pt,
                          torch.as_tensor(ctx0))
    ref = PL_ref.exact_rate_p(jnp.asarray(lv), first, pt, jnp.asarray(ctx0))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_luma_and_chroma_chained_rates_equal_reference():
    rng = np.random.default_rng(11)
    lv = rng.integers(-2, 3, (16, 16, 7)).astype(np.int32)
    lv[rng.random((16, 16, 7)) < 0.6] = 0
    tnz = rng.integers(0, 16, 7).astype(np.int32)
    lnz = rng.integers(0, 16, 7).astype(np.int32)
    t = torch.as_tensor
    got = PL.luma_rate16_p(t(lv), t(tnz), t(lnz))
    ref = jax.jit(PL_ref.luma_rate16_p)(lv, tnz, lnz)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    uv = lv[:4]
    got = PL.uv_rate4_p(t(uv), t(tnz & 3), t(lnz & 3))
    ref = jax.jit(PL_ref.uv_rate4_p)(uv, tnz & 3, lnz & 3)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


def test_i4_search_allow_tr_equals_reference_cpu_path():
    """With the skew-2 ban lifted (allow_tr), the split and the modes
    equal the reference's jnp search with allow_tr=True (the path its
    method-5 program takes), and the rightmost subblock column takes the
    above-right-reading modes the ban would forbid."""
    Y, seg_map, qtab16, lam4, lammd, tlsd4, seg_q = _inputs(6)
    rt = _rt_ref()
    tr_in_c3 = 0
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
            tlsd=tl, allow_tr=True, lam_mode=lam_i["mode"])
        s_r = np.asarray(s_r)
        i16 = (s_r * np.where(np.arange(N_MB) % 2, 0.97, 1.03)) \
            .astype(np.float32)
        is_i4, modes, i4_score = I4.i4_search(
            torch.as_tensor(Y[b:b + 1]), torch.as_tensor(seg_map[b:b + 1]),
            torch.as_tensor(qtab16[b:b + 1]), torch.as_tensor(lam4[b:b + 1]),
            torch.as_tensor(lammd[b:b + 1]), torch.as_tensor(tlsd4[b:b + 1]),
            torch.as_tensor(i16[None]), MB_W, MB_H, allow_tr=True)
        np.testing.assert_array_equal(modes[0].numpy(), np.asarray(m_r))
        np.testing.assert_array_equal(i4_score[0].numpy(), s_r)
        np.testing.assert_array_equal(is_i4[0].numpy(), s_r < i16)
        c3 = modes[0].numpy().reshape(N_MB, 4, 4)[:, :, 3]
        tr_in_c3 += int(np.isin(c3, (2, 6, 7)).sum())
    assert tr_in_c3 > 0, "premise: the lifted ban changes some choice"
    data = I4._planar_inputs(torch.as_tensor(Y), torch.as_tensor(seg_map),
                             MB_W, MB_H, allow_tr=True)
    assert not data[29].any()
