"""A frame's tokens in one native call (native/api.py code_frame): the
device's packed levels coded in place against the same levels unpacked
through the dense walk and against the reference's pure-Python
statistics, probability rule and token writer; the escape lists it
refuses; and the `frames` counter on every device entry and on the host
encoder, on the CPU (no JAX program)."""

import numpy as np
import pytest
import torch

import webp_tpu.lossy.encode as enc_ref
import webp_tpu.native.api as native_ref
import webp_tpu_torch
from webp_tpu_torch import trace
from webp_tpu_torch.native import api
from webp_tpu_torch.ops import fastpath

from test_torch_partition0 import SEAM_ENTRIES

# name: (mb_w, mb_h, num_parts, use_skip, I4 share, escapes), escapes one
# of "none", "some", "fill" (as many escaped blocks as the list holds),
# "last" (the frame's last block alone) and "all_skipped" (every MB
# skipped, no levels).
CASES = {
    "no_escapes": (5, 4, 1, True, 0.5, "none"),
    "escapes_fill_the_list": (4, 3, 2, True, 0.5, "fill"),
    "escape_in_the_last_block": (3, 5, 4, False, 0.3, "last"),
    "every_mb_skipped": (4, 4, 2, True, 0.5, "all_skipped"),
    "all_i16": (6, 3, 1, True, 0.0, "some"),
    "all_i4": (3, 6, 2, False, 1.0, "some"),
    "skip_off_eight_parts": (2, 9, 8, False, 0.5, "some"),
    "skip_on_eight_parts": (3, 11, 8, True, 0.6, "some"),
    "one_mb": (1, 1, 1, False, 0.0, "some"),
    "one_row_four_parts": (7, 1, 4, True, 0.4, "some"),
    "one_column_two_parts": (1, 7, 2, True, 0.5, "fill"),
}


def _levels(seed, mb_w, mb_h, i4_share, escapes):
    """(lv24 int16 [n_mb, 24, 16], y2 int16 [n_mb, 16], is_i4, skip,
    the escaped block count) drawn from the seed: sparse levels, an I16
    MB's luma DC in its Y2 block, some MBs all zero (skipped)."""
    rng = np.random.default_rng(seed)
    n_mb = mb_w * mb_h
    lv = rng.integers(-7, 8, (n_mb, 24, 16)) * (
        rng.random((n_mb, 24, 16)) < 0.3)
    y2 = rng.integers(-300, 301, (n_mb, 16)) * (rng.random((n_mb, 16)) < 0.4)
    is_i4 = rng.random(n_mb) < i4_share
    lv[~is_i4, :16, 0] = 0
    y2[is_i4] = 0
    n_blk = 24 * n_mb
    esc = {"none": [], "all_skipped": [], "last": [n_blk - 1],
           "some": sorted(rng.choice(n_blk, min(5, n_blk), replace=False)),
           "fill": sorted(rng.choice(n_blk, n_blk // 3, replace=False))}[
        escapes]
    for b in esc:
        mb, blk = divmod(int(b), 24)
        k = rng.integers(0 if blk >= 16 or is_i4[mb] else 1, 16)
        lv[mb, blk, k] = rng.choice([-1, 1]) * rng.integers(8, 2049)
    zero = (rng.random(n_mb) < 0.3) | (escapes == "all_skipped")
    zero[[b // 24 for b in esc]] = False
    lv[zero] = 0
    y2[zero] = 0
    skip = (lv == 0).all(axis=(1, 2)) & (y2 == 0).all(axis=1)
    return (lv.astype(np.int16), y2.astype(np.int16), is_i4, skip,
            len(esc))


def _packed(lv, esc_cap):
    """The device's packed fields of lv (ops/fastpath.py _pack_levels)."""
    packed, idx, val, cnt = fastpath._pack_levels(
        torch.from_numpy(lv)[None], esc_cap)
    return packed[0].numpy(), idx[0].numpy(), val[0].numpy(), int(cnt[0])


def _reference(lv, y2, is_i4, skip, mb_w, mb_h, use_skip, num_parts):
    """The reference's probabilities and partitions from its pure-Python
    statistics, probability loop and token writer."""
    enc = object.__new__(enc_ref.VP8Encoder)
    enc.mb_w, enc.mb_h, enc.num_parts, enc.use_skip = (mb_w, mb_h,
                                                       num_parts, use_skip)
    enc.levels = lv.astype(np.int32).reshape(mb_h, mb_w, 24, 16)
    enc.y2_levels = y2.astype(np.int32).reshape(mb_h, mb_w, 16)
    enc.is_i4 = is_i4.reshape(mb_h, mb_w)
    enc.skip = skip.reshape(mb_h, mb_w)
    enc._optimize_probas()
    return enc.proba, [enc._emit_tokens(i) for i in range(num_parts)]


@pytest.mark.parametrize("name", list(CASES))
def test_packed_levels_code_as_the_dense_walk_and_the_reference(
        name, monkeypatch):
    mb_w, mb_h, num_parts, use_skip, i4_share, escapes = CASES[name]
    lv, y2, is_i4, skip, n_esc = _levels(list(CASES).index(name), mb_w,
                                         mb_h, i4_share, escapes)
    use_skip = use_skip and bool(skip.any())
    esc_cap = n_esc if escapes == "fill" else 1024
    fields = _packed(lv, esc_cap)
    assert fields[3] == n_esc
    if escapes == "fill":
        assert fields[1].size == n_esc
    if escapes == "last":
        assert list(fields[1][:1]) == [24 * mb_w * mb_h - 1]
    common = (is_i4, skip, mb_w, mb_h, use_skip, num_parts)
    before = trace.counters()["native"]["calls"]
    proba, parts = api.code_frame(*common, y2_levels=y2, packed=fields)
    assert trace.counters()["native"]["calls"] - before == 1
    dense = fastpath.unpack_levels(*fields, mb_w * mb_h)
    assert np.array_equal(dense, lv)
    d_proba, d_parts = api.code_frame(*common, levels=dense,
                                      y2_levels=y2.astype(np.int32))
    monkeypatch.setattr(native_ref, "available", lambda: False)
    r_proba, r_parts = _reference(lv, y2, is_i4, skip, mb_w, mb_h,
                                  use_skip, num_parts)
    assert np.array_equal(proba, d_proba) and np.array_equal(proba, r_proba)
    assert parts == d_parts == r_parts
    assert len(parts) == num_parts


def test_a_short_first_buffer_is_retried(monkeypatch):
    lv, y2, is_i4, skip, _ = _levels(4, 5, 3, 0.5, "some")
    common = (is_i4, skip, 5, 3, True, 2)
    want = api.code_frame(*common, y2_levels=y2, packed=_packed(lv, 1024))
    monkeypatch.setattr(api, "_tokens_cap", lambda n_mb: 1)
    before = trace.counters()["native"]["calls"]
    proba, parts = api.code_frame(*common, y2_levels=y2,
                                  packed=_packed(lv, 1024))
    assert trace.counters()["native"]["calls"] - before == 2
    assert np.array_equal(proba, want[0]) and parts == want[1]


@pytest.mark.parametrize("bad", ["out_of_order", "out_of_range",
                                 "repeated", "more_than_the_list"])
def test_an_escape_list_out_of_order_or_range_is_refused(bad):
    lv, y2, is_i4, skip, _ = _levels(3, 4, 3, 0.5, "some")
    packed, idx, val, cnt = _packed(lv, 1024)
    idx = idx.copy()
    if bad == "out_of_order":
        idx[[1, 2]] = idx[[2, 1]]
    elif bad == "out_of_range":
        idx[cnt - 1] = 24 * 12
    elif bad == "repeated":
        idx[1] = idx[0]
    else:
        cnt = idx.size + 1
    with pytest.raises(ValueError, match="escape"):
        api.code_frame(is_i4, skip, 4, 3, True, 1, y2_levels=y2,
                       packed=(packed, idx, val, cnt))


def _images():
    rng = np.random.default_rng(11)
    y, x = np.mgrid[0:32, 0:48]
    return [(np.stack([x * (3 + i), y * 5, (x + y) * 2], -1)
             + rng.integers(0, 30, (32, 48, 3))).clip(0, 255).astype(
                 np.uint8) for i in range(3)]


@pytest.mark.parametrize("entry", list(SEAM_ENTRIES) + ["host_encoder"])
def test_each_frame_counts_the_levels_it_was_coded_from(entry, monkeypatch):
    """Every device entry codes each image from its packed fields and
    never unpacks the levels on the host; the host encoder codes dense
    levels."""
    def unpacked(*a, **k):
        raise AssertionError("a device tail unpacked its levels")

    monkeypatch.setattr(fastpath, "unpack_levels", unpacked)
    run = SEAM_ENTRIES.get(entry, lambda imgs: [
        webp_tpu_torch.encode(im, backend="host") for im in imgs])
    saved = trace.counters()
    try:
        trace.reset_counters()
        run(_images())
        packed = 0 if entry == "host_encoder" else 3
        assert trace.counters()["frames"] == {"packed": packed,
                                              "dense": 3 - packed}
    finally:
        for name, g in saved.items():
            trace.COUNTERS[name].update(g)
