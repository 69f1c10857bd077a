"""Kernel 4 of the port (the phase-2 wavefront with the fused pack),
through its plain PyTorch version, against the JAX package on the CPU:
the reference's phase2_planar step loop followed by its _pack_levels and
skip formula, every field exact (tolerance 0). The reference's own
tests/test_pallas_p2.py holds its Pallas kernel equal to phase2_planar
+ _pack_levels in the same run, so no Pallas interpret compile is needed
here."""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
import torch

from test_torch_cuda import broadcast_qtab
from test_torch_cuda import p2_args as _args
from test_torch_cuda import p2_inputs as _inputs
from webp_tpu.ops import fastpath as FP_ref
from webp_tpu.ops import planar as PL_ref
from webp_tpu_torch.ops import planar as PL
from webp_tpu_torch.ops import cuda
from webp_tpu_torch.ops import p2_kernel as P2K


def _reference(d, rd_drop, esc_cap):
    B, H, W = d["Y"].shape
    j = jnp.asarray
    lv24, y2, _, _ = PL_ref.phase2_planar(
        j(d["Y"]), j(d["U"]), j(d["V"]), j(d["modes"]), j(d["uvmodes"]),
        None, W // 16, H // 16, rd_drop=rd_drop,
        seg=(j(d["seg_map"]), {k: j(v) for k, v in d["seg_rows"].items()}),
        i4=(j(d["is_i4"]), j(d["i4_modes"])))
    packed, esc_idx, esc_val, esc_cnt = jax.vmap(
        lambda x: FP_ref._pack_levels(x, esc_cap))(lv24)
    skip = (lv24 == 0).all(axis=(-2, -1)) & (y2 == 0).all(axis=-1)
    return {"packed": packed, "esc_idx": esc_idx, "esc_val": esc_val,
            "esc_cnt": esc_cnt, "y2": y2, "skip": skip}


def _assert_wire_equal(got, ref):
    assert list(got) == list(ref)
    for k in ref:
        r = np.asarray(ref[k])
        g = got[k].numpy()
        assert g.dtype == r.dtype, k
        np.testing.assert_array_equal(g, r, err_msg=k)


@pytest.mark.parametrize("geom", [(64, 48), (80, 48), (16, 64), (64, 16)])
def test_phase2_pack_equals_reference_planar_and_pack(geom):
    """Every wire field exact at the main path's configuration (skew 1,
    rd_drop 1024, four segments, the I4 walk), including one-MB-column
    and one-MB-row frames, whose anti-diagonals hold a single MB."""
    W, H = geom
    d = _inputs(2, W, H, W * 7 + H)
    cuda.reset_launches()
    got = P2K.phase2_pack(*_args(d), 1024.0, 1024)
    assert all(v == 0 for v in cuda.LAUNCHES.values())
    ref = _reference(d, 1024.0, 1024)
    _assert_wire_equal(got, ref)
    assert (got["esc_cnt"] > 0).all(), "premise: escapes occur"
    assert d["is_i4"].any() and not d["is_i4"].all()


@pytest.mark.parametrize("config", ["unsegmented", "i4_off", "both"])
def test_phase2_pack_without_segments_or_i4_equals_reference(config):
    """A zero segment map with one set of quant rows and/or a zero I4
    split, as the unsegmented and I4-off configurations pass them: every
    wire field exact against the reference's phase2_planar with seg=None
    and/or i4=None, then its pack (64x16 at B = 2; 4 MBs in one row)."""
    from webp_tpu.ops import pipeline as PP_ref

    d = _inputs(2, 64, 16, 31)
    qp = PP_ref.quant_params(75)
    segmented, with_i4 = config == "i4_off", config == "unsegmented"
    if not segmented:
        d["qtab"] = broadcast_qtab(2, qp)
    args = list(_args(d))
    if not with_i4:
        args[5], args[6] = torch.zeros_like(args[5]), torch.zeros_like(args[6])
    if not segmented:
        args[7] = torch.zeros_like(args[7])
    got = P2K.phase2_pack(*args, 1024.0, 1024)
    j = jnp.asarray
    lv24, y2, _, _ = PL_ref.phase2_planar(
        j(d["Y"]), j(d["U"]), j(d["V"]), j(d["modes"]), j(d["uvmodes"]), qp,
        4, 1, rd_drop=1024.0,
        seg=((j(d["seg_map"]), {k: j(v) for k, v in d["seg_rows"].items()})
             if segmented else None),
        i4=(j(d["is_i4"]), j(d["i4_modes"])) if with_i4 else None)
    packed, esc_idx, esc_val, esc_cnt = jax.vmap(
        lambda x: FP_ref._pack_levels(x, 1024))(lv24)
    skip = (lv24 == 0).all(axis=(-2, -1)) & (y2 == 0).all(axis=-1)
    _assert_wire_equal(got, {"packed": packed, "esc_idx": esc_idx,
                             "esc_val": esc_val, "esc_cnt": esc_cnt,
                             "y2": y2, "skip": skip})


def test_phase2_pack_escape_overflow_keeps_the_sentinel_semantics():
    """An escape list longer than esc_cap keeps its first esc_cap
    ascending block indices and reports the full count (the caller's
    signal for the host fallback), as the reference does."""
    d = _inputs(2, 64, 48, 5)
    got = P2K.phase2_pack(*_args(d), 1024.0, 7)
    ref = _reference(d, 1024.0, 7)
    _assert_wire_equal(got, ref)
    assert got["esc_idx"].shape == (2, 7)
    assert (got["esc_cnt"] > 7).all(), "premise: the list overflows"


def test_phase2_pack_checks_its_tensors():
    d = _inputs(1, 32, 32, 1)
    args = list(_args(d))
    with pytest.raises(TypeError):                      # dtype
        P2K.phase2_pack(args[0].to(torch.int32), *args[1:], 1024.0, 64)
    bad = list(args)
    bad[1] = args[1][:, :8]                             # U shape
    with pytest.raises(ValueError):
        P2K.phase2_pack(*bad, 1024.0, 64)
    with pytest.raises(ValueError):                     # not whole MBs
        P2K.phase2_pack(args[0][:, :24], *args[1:], 1024.0, 64)
    bad = list(args)
    bad[8] = args[8].to("meta")                         # device
    with pytest.raises(ValueError):
        P2K.phase2_pack(*bad, 1024.0, 64)
    bad = list(args)
    bad[5] = args[5].to(torch.uint8)                    # is_i4 is bool
    with pytest.raises(TypeError):
        P2K.phase2_pack(*bad, 1024.0, 64)


def test_card_tensors_reach_the_kernel_never_the_step_loop(monkeypatch):
    """For tensors on a card the wrapper launches the kernel (here a
    stand-in that records the call) and never runs planar.phase2_planar;
    the launch is counted."""
    calls = []

    def loop(*a, **k):
        raise AssertionError("the step loop ran for card tensors")

    def launch(name, *a):
        calls.append(name)
        cuda.LAUNCHES[name] += 1

    monkeypatch.setattr(P2K, "phase2_planar", loop)
    monkeypatch.setattr(P2K, "sm_count", lambda dev: 132)
    monkeypatch.setattr(cuda, "on_cpu", lambda *t: False)
    monkeypatch.setattr(cuda, "launch", launch)
    cuda.reset_launches()
    out = P2K.phase2_pack(*_args(_inputs(1, 32, 32, 2)), 1024.0, 64)
    assert calls == ["p2_wavefront"] and cuda.LAUNCHES["p2_wavefront"] == 1
    assert set(out) == {"packed", "esc_idx", "esc_val", "esc_cnt", "y2",
                        "skip"}


@pytest.mark.parametrize("B", [1, 3, 16, 128, 200])
@pytest.mark.parametrize("mb_h", [1, 4, 64])
def test_cluster_size_fills_the_card_within_its_limits(B, mb_h):
    """Blocks per image: a power of two, at most 8 and at most mb_h; with
    more than one, B * C blocks fit the 132 SMs; and no larger power of
    two would qualify."""
    C = P2K.cluster_size(B, mb_h, 132)
    assert C in (1, 2, 4, 8) and C <= mb_h
    if C > 1:
        assert B * C <= 132
    if C < 8:
        assert 2 * C > mb_h or B * 2 * C > 132
    assert P2K.cluster_size(16, 64, 132) == 8
    assert P2K.cluster_size(128, 64, 132) == 1


def test_i4_tap_table_equals_the_i4_predictors():
    """The kernel's per-pixel tap table reproduces all 10 I4 predictors of
    the plain version (planar.pred4_all_p) on random contours, saturated
    ones included."""
    rng = np.random.default_rng(3)
    e = rng.integers(0, 256, (13, 3000))
    e[:, :100] = rng.integers(250, 256, (13, 100))
    e[:, 100:200] = rng.integers(0, 6, (13, 100))
    t = torch.as_tensor(e[5:9])
    l = torch.as_tensor(e[3::-1].copy())
    ref = torch.stack(PL.pred4_all_p(t, l, torch.as_tensor(e[4]),
                                     torch.as_tensor(e[9:13]))).numpy()
    taps = P2K.i4_taps().astype(np.int64)
    ops = taps >> 12
    i0, i1, i2 = (e[(taps >> s) & 15] for s in (0, 4, 8))  # [10, 16, N]
    dc = (e[[0, 1, 2, 3, 5, 6, 7, 8]].sum(0) + 4) >> 3
    got = np.select([ops[..., None] == k for k in range(4)],
                    [(i0 + 2 * i1 + i2 + 2) >> 2, (i0 + i1 + 1) >> 1,
                     np.clip(i0 + i1 - i2, 0, 255),
                     np.broadcast_to(dc, i0.shape)])
    np.testing.assert_array_equal(got, ref.reshape(10, 16, -1))

