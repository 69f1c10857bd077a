"""The port's transform, quantizer, predictor and rate building blocks
(ops/dct.py, ops/quant.py, ops/planar.py part A) against the JAX package
on the same random inputs: every output exact."""

import numpy as np
import pytest

import jax.numpy as jnp
import torch

from webp_tpu.lossy import tables as T_ref
from webp_tpu.ops import dct as dct_ref
from webp_tpu.ops import fastpath as FP_ref
from webp_tpu.ops import planar as PL_ref
from webp_tpu.ops import quant as quant_ref
from webp_tpu_torch.ops import dct
from webp_tpu_torch.ops import fastpath as FP
from webp_tpu_torch.ops import planar as PL
from webp_tpu_torch.ops import quant

N = 96
RNG_SEED = 4


def _rng():
    return np.random.default_rng(RNG_SEED)


def _coeffs(rng, shape, big=False):
    hi = 2048 if big else 600
    c = rng.integers(-hi, hi, shape)
    c[rng.random(shape) < 0.5] = 0
    return c.astype(np.int32)


def _quant_rows(rng, n_lanes=None):
    """(q, iq, bias, sharpen) zigzag rows of a random quant index, type y1,
    as [16] (n_lanes None) or per-lane [16, n_lanes]."""
    tabs = FP_ref.all_q_tables()[0]["y1"]
    if n_lanes is None:
        return tuple(tabs[rng.integers(0, 128)])
    q = rng.integers(0, 128, n_lanes)
    return tuple(np.ascontiguousarray(tabs[q][:, i].T) for i in range(4))


def _pair(fn_t, fn_j, *args, **kw):
    got = fn_t(*(torch.as_tensor(a) if isinstance(a, np.ndarray) else a
                 for a in args), **kw)
    ref = fn_j(*(jnp.asarray(a) if isinstance(a, np.ndarray) else a
                 for a in args), **kw)
    if not isinstance(got, (tuple, list)):
        got, ref = [got], [ref]
    assert len(got) == len(ref)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


def test_dct_family_equals_reference():
    rng = _rng()
    src = rng.integers(0, 256, (N, 4, 4)).astype(np.int32)
    ref = rng.integers(0, 256, (N, 4, 4)).astype(np.int32)
    _pair(dct.fdct4x4, dct_ref.fdct4x4, src, ref)
    _pair(dct.idct4x4, dct_ref.idct4x4, _coeffs(rng, (N, 4, 4), big=True))
    _pair(dct.fwht4x4, dct_ref.fwht4x4, _coeffs(rng, (N, 4, 4)))
    _pair(dct.wht4x4, dct_ref.wht4x4, _coeffs(rng, (N, 4, 4), big=True))


@pytest.mark.parametrize("first,rd_drop", [(0, 0.0), (1, 0.0), (0, 1024.0),
                                           (1, 3584.0)])
def test_quantize_equals_reference(first, rd_drop):
    rng = _rng()
    co = _coeffs(rng, (N, 16))
    rows = tuple(torch.as_tensor(np.asarray(r)) for r in _quant_rows(rng))
    got = quant.quantize(torch.as_tensor(co), *rows, np.asarray(T_ref.ZIGZAG),
                         first=first, rd_drop=rd_drop)
    ref = quant_ref.quantize(jnp.asarray(co), *(jnp.asarray(r.numpy())
                                                for r in rows),
                             np.asarray(T_ref.ZIGZAG), first=first,
                             rd_drop=rd_drop)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


def test_planar_transforms_equal_reference():
    rng = _rng()
    src = rng.integers(0, 256, (3, 4, 4, N)).astype(np.int32)
    pred = rng.integers(0, 256, (3, 4, 4, N)).astype(np.int32)
    _pair(PL.fdct4x4_p, PL_ref.fdct4x4_p, src, pred)
    _pair(PL.idct4x4_p, PL_ref.idct4x4_p, _coeffs(rng, (3, 4, 4, N), True))
    _pair(PL.fwht4x4_p, PL_ref.fwht4x4_p, _coeffs(rng, (4, 4, N)))
    _pair(PL.wht4x4_p, PL_ref.wht4x4_p, _coeffs(rng, (4, 4, N), True))
    blocks = rng.integers(0, 256, (16, 4, 4, N)).astype(np.int32)
    _pair(lambda x: PL.blocks_to_plane_p(x, 16),
          lambda x: PL_ref.blocks_to_plane_p(x, 16), blocks)
    plane = rng.integers(0, 256, (8, 8, N)).astype(np.int32)
    _pair(lambda x: PL.plane_to_blocks_p(x, 8),
          lambda x: PL_ref.plane_to_blocks_p(x, 8), plane)


@pytest.mark.parametrize("per_lane,first,rd_drop",
                         [(False, 0, 0.0), (True, 1, 0.0), (True, 0, 1024.0),
                          (True, 1, 1024.0)])
def test_quantize_p_equals_reference(per_lane, first, rd_drop):
    rng = _rng()
    co = _coeffs(rng, (5, 16, N))
    rows = _quant_rows(rng, N if per_lane else None)
    rows = [np.asarray(r, np.int32).reshape(16, -1) for r in rows]
    _pair(lambda c, *r: PL.quantize_p(c, *r, first=first, rd_drop=rd_drop),
          lambda c, *r: PL_ref.quantize_p(c, *r, first=first,
                                          rd_drop=rd_drop), co, *rows)


@pytest.mark.parametrize("size", [16, 8])
def test_preds4_p_equals_reference(size):
    rng = _rng()
    top = rng.integers(0, 256, (size, N)).astype(np.int32)
    left = rng.integers(0, 256, (size, N)).astype(np.int32)
    tl = rng.integers(0, 256, (N,)).astype(np.int32)
    ht = rng.random(N) < 0.5
    hl = rng.random(N) < 0.5
    _pair(lambda *a: PL.preds4_p(size, *a),
          lambda *a: PL_ref.preds4_p(size, *a), top, left, tl, ht, hl)


def test_pred4_all_p_equals_reference():
    rng = _rng()
    t, l, tr = (rng.integers(0, 256, (2, 4, N)).astype(np.int32)
                for _ in range(3))
    tl = rng.integers(0, 256, (2, N)).astype(np.int32)
    _pair(PL.pred4_all_p, PL_ref.pred4_all_p, t, l, tl, tr)


@pytest.mark.parametrize("first,pt", [(0, 3), (1, 0), (0, 1), (0, 2)])
def test_approx_rates_equal_reference(first, pt):
    rng = _rng()
    lv = _coeffs(rng, (4, 16, N)) // 20
    lv[:, :, :5] = 0                             # empty blocks
    lv[:, 3, 5:9] = np.array([8, 12, 25, 1000])  # each tail band
    rt = FP.RateTables(np.asarray(T_ref.COEFFS_PROBA0))
    rt_r = FP_ref.RateTables(np.asarray(T_ref.COEFFS_PROBA0))
    got = PL.approx_rate_p(torch.as_tensor(lv), first, pt, rt)
    ref = PL_ref.approx_rate_p(jnp.asarray(lv), first, pt, rt_r)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    blocks = np.moveaxis(lv, 1, -1)              # [4, N, 16]
    got = FP.approx_block_rate(torch.as_tensor(blocks), first, pt, rt)
    ref = FP_ref.approx_block_rate(jnp.asarray(blocks), first, pt, rt_r)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def test_luma_chroma_pipes_and_i4_walk_equal_reference():
    rng = _rng()
    tabs = FP_ref.all_q_tables()[0]
    qi = rng.integers(0, 128, N)
    qp = {k: tuple(np.ascontiguousarray(tabs[k][qi][:, i].T)
                   for i in range(4)) for k in ("y1", "y2", "uv")}
    qp_t = {k: tuple(torch.as_tensor(a) for a in v) for k, v in qp.items()}
    qp_j = {k: tuple(jnp.asarray(a) for a in v) for k, v in qp.items()}
    src = rng.integers(0, 256, (16, 4, 4, N)).astype(np.int32)
    pred = rng.integers(0, 256, (16, 4, 4, N)).astype(np.int32)
    for g, r in zip(PL.luma_pipe_p(torch.as_tensor(src),
                                   torch.as_tensor(pred), qp_t, 1024.0),
                    PL_ref.luma_pipe_p(jnp.asarray(src), jnp.asarray(pred),
                                       qp_j, 1024.0)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    for g, r in zip(PL.chroma_pipe_p(torch.as_tensor(src[:4]),
                                     torch.as_tensor(pred[:4]), qp_t),
                    PL_ref.chroma_pipe_p(jnp.asarray(src[:4]),
                                         jnp.asarray(pred[:4]), qp_j)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    modes = rng.integers(0, 10, (16, N)).astype(np.int32)
    top, left = (rng.integers(0, 256, (16, N)).astype(np.int32)
                 for _ in range(2))
    tl = rng.integers(0, 256, (N,)).astype(np.int32)
    trs = rng.integers(0, 256, (4, N)).astype(np.int32)
    ht, hl = rng.random(N) < 0.7, rng.random(N) < 0.7
    args = (src, modes, top, left, tl, trs, ht, hl)
    got = PL.i4_reconstruct_p(*(torch.as_tensor(a) for a in args),
                              qp_t["y1"], rd_drop=1024.0)
    ref = PL_ref.i4_reconstruct_p(*(jnp.asarray(a) for a in args),
                                  qp_j["y1"], rd_drop=1024.0)
    # Levels, reconstruction, the (zero) nonzero masks and the modes; the
    # search's mode chains and rate sums are (None, None) without it.
    assert len(got) == len(ref) == 7
    for g, r in zip(got[:5], ref[:5]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    assert got[5:] == ref[5:] == ((None, None), (None, None))
