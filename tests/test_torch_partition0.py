"""Partition 0 in one native call: the port's frame writer (lossy/frame.py
partition0) against the reference's pure-Python writer on the same
encoder fields, its retry when the first buffer is short, the `native`
counter's crossings per image of the device path's host tail (2: the
tokens of every partition, then partition 0), and the
host tail's one entry (DeviceVP8Encoder.finish) on every device path, on
the CPU (no JAX program)."""

from types import SimpleNamespace

import numpy as np
import pytest

import webp_tpu.lossy.encode as enc_ref
import webp_tpu.native.api as native_ref
import webp_tpu_torch
from webp_tpu_torch import trace
from webp_tpu_torch.lossy import device_encode as DE
from webp_tpu_torch.lossy import frame as F
from webp_tpu_torch.lossy import tables as T
from webp_tpu_torch.lossy.encode import LossyConfig
from webp_tpu_torch.native import api


def _every_band_proba(rng):
    """COEFFS_PROBA0 with at least one changed entry in every (type,
    band), plus random others."""
    proba = T.COEFFS_PROBA0.astype(np.int32).copy()
    for t in range(4):
        for b in range(8):
            c, p = rng.integers(0, 3), rng.integers(0, 11)
            proba[t, b, c, p] = 1 + (proba[t, b, c, p] + 100) % 255
    extra = rng.random(proba.shape) < 0.2
    proba[extra] = rng.integers(1, 256, int(extra.sum()))
    return proba


def _fields(seed, mb_w, mb_h, segments, seg_probas, num_parts, simple,
            sharpness, dq, use_skip, every_band):
    """Encoder fields for partition 0, drawn from the seed."""
    rng = np.random.default_rng(seed)
    nmb = mb_w * mb_h
    is_i4 = rng.random((mb_h, mb_w)) < 0.5
    imodes = rng.integers(0, 10, (mb_h, mb_w, 16)).astype(np.uint8)
    imodes[~is_i4] = rng.integers(0, 4, (int((~is_i4).sum()), 1))
    skip = (rng.random((mb_h, mb_w)) < 0.3) if use_skip else \
        np.zeros((mb_h, mb_w), bool)
    num_skip = int(skip.sum())
    assert (num_skip > 0) == use_skip
    plan = SimpleNamespace(
        num_segments=segments,
        quant=[int(q) for q in rng.integers(0, 128, 4)],
        fstrength=[int(f) for f in rng.integers(0, 64, 4)],
        probas=list(seg_probas), dq_uv_dc=dq[0], dq_uv_ac=dq[1])
    return dict(
        mb_w=mb_w, mb_h=mb_h, num_segments=segments, plan=plan,
        segment_map=rng.integers(0, segments, (mb_h, mb_w)).astype(np.uint8),
        base_q=plan.quant[0], filter_simple=simple,
        filter_level=int(rng.integers(0, 64)), filter_sharpness=sharpness,
        num_parts=num_parts,
        proba=(_every_band_proba(rng) if every_band
               else T.COEFFS_PROBA0.copy()),
        imodes=imodes, is_i4=is_i4,
        uvmode=rng.integers(0, 4, (mb_h, mb_w)).astype(np.uint8),
        skip=skip, num_skip=num_skip,
        skip_proba=(max(1, min(255, (nmb - num_skip) * 255 // nmb))
                    if num_skip else 0))


def _encoder(cls, fields):
    """An encoder of class cls holding only the fields partition 0 reads."""
    enc = object.__new__(cls)
    for k, v in fields.items():
        setattr(enc, k, v.copy() if isinstance(v, np.ndarray) else v)
    return enc


def _frame(fields):
    """The port's frame of the same fields (the segment map in its plan)."""
    f = {k: v.copy() if isinstance(v, np.ndarray) else v
         for k, v in fields.items()}
    plan = SimpleNamespace(**vars(f["plan"]), segment_map=f["segment_map"])
    return F.Frame(
        16 * f["mb_w"], 16 * f["mb_h"], levels=None, y2_levels=None,
        imodes=f["imodes"], uvmode=f["uvmode"], is_i4=f["is_i4"],
        skip=f["skip"], plan=plan, filter_simple=f["filter_simple"],
        filter_sharpness=f["filter_sharpness"],
        filter_level=f["filter_level"], num_parts=f["num_parts"],
        proba=f["proba"], skip_proba=f["skip_proba"])


# (segments, tree probabilities, num_parts, simple filter, sharpness,
#  (dq_uv_dc, dq_uv_ac), skip used, an update in every band, short buffer)
CASES = {
    "one_segment_default_table": (1, (255, 255, 255), 1, False, 0, (0, 0),
                                  False, False, False),
    "four_segments_all_probas": (4, (120, 7, 200), 2, True, 7, (4, -3),
                                 True, True, False),
    "four_segments_one_255": (4, (31, 255, 90), 4, False, 7, (-4, 6),
                              True, True, False),
    "one_segment_eight_parts": (1, (255, 255, 255), 8, True, 0, (-15, 15),
                                False, True, False),
    "four_segments_default_table": (4, (255, 255, 255), 1, False, 3,
                                    (0, 2), False, False, False),
    "short_buffer_retried": (4, (64, 128, 255), 2, True, 0, (3, 0), True,
                             True, True),
    "one_segment_short_buffer": (1, (255, 255, 255), 1, False, 7, (0, -2),
                                 True, False, True),
}


@pytest.mark.parametrize("name", list(CASES))
def test_partition0_equals_the_reference(name, monkeypatch):
    (segments, seg_probas, num_parts, simple, sharpness, dq, use_skip,
     every_band, short) = CASES[name]
    seed = list(CASES).index(name)
    mb_w, mb_h = (11, 7) if seed % 2 else (5, 9)
    fields = _fields(seed, mb_w, mb_h, segments, seg_probas, num_parts,
                     simple, sharpness, dq, use_skip, every_band)
    # The reference's own writer, bit by bit in Python.
    monkeypatch.setattr(native_ref, "available", lambda: False)
    want = _encoder(enc_ref.VP8Encoder, fields)._emit_partition0()
    if short:
        monkeypatch.setattr(api, "_part0_cap", lambda n_mb: 1)
    before = trace.counters()["native"]["calls"]
    got = F.partition0(_frame(fields))
    assert got == want
    assert trace.counters()["native"]["calls"] - before == (2 if short
                                                            else 1)


@pytest.fixture(scope="module")
def device_fields():
    """One 48x32 image's device fields from the plain versions on the
    CPU."""
    rng = np.random.default_rng(5)
    y, x = np.mgrid[0:32, 0:48]
    img = np.stack([x * 5, y * 7, (x + y) * 3], -1) + rng.integers(
        0, 20, (32, 48, 3))
    fn, host = DE.device_blob(img.clip(0, 255).astype(np.uint8)[None],
                              device="cpu")
    assert int(host["esc_cnt"][0]) <= fn.esc_cap
    return {k: v[0] for k, v in host.items()}


@pytest.mark.parametrize("partitions", [0, 2])
def test_the_tail_crosses_into_native_code_twice_whatever_the_partitions(
        device_fields, partitions):
    """One call codes the tokens of every partition, one writes
    partition 0."""
    cfg = LossyConfig(partitions=partitions)
    saved = trace.counters()
    assert trace.COUNTERS["native"] is trace.NATIVE
    assert trace.COUNTERS["frames"] is trace.FRAMES
    try:
        trace.reset_counters()
        assert trace.counters()["native"] == {"calls": 0}
        enc = DE.DeviceVP8Encoder(48, 32, cfg)
        enc.finish(device_fields)
        assert trace.counters()["native"]["calls"] == 2
        assert trace.counters()["frames"] == {"packed": 1, "dense": 0}
        assert len(enc.token_sizes) == 1 << partitions
    finally:
        for name, g in saved.items():
            trace.COUNTERS[name].update(g)


@pytest.mark.parametrize("bad", ["mb_w", "proba", "seg_probas"])
def test_partition0_refuses_fields_of_another_size(bad):
    f = _fields(0, 5, 4, 4, (1, 2, 3), 1, False, 0, (0, 0), True, False)
    plan, nmb = f["plan"], 20
    args = dict(
        num_segments=4, seg_quant=plan.quant, seg_fstrength=plan.fstrength,
        seg_probas=plan.probas, filter_simple=False, filter_level=10,
        filter_sharpness=0, log2_parts=0, base_q=plan.quant[0], dq_uv_dc=0,
        dq_uv_ac=0, proba=f["proba"], use_skip=True, skip_prob=f["skip_proba"],
        imodes=f["imodes"].reshape(nmb, 16), is_i4=f["is_i4"].reshape(nmb),
        uvmode=f["uvmode"].reshape(nmb), skip=f["skip"].reshape(nmb),
        seg_map=f["segment_map"].reshape(nmb), mb_w=5, mb_h=4)
    assert len(api.write_partition0(**args)) > 0
    args.update({"mb_w": dict(mb_w=6), "proba": dict(proba=f["proba"][:3]),
                 "seg_probas": dict(seg_probas=[1, 2])}[bad])
    with pytest.raises(ValueError, match="field sizes"):
        api.write_partition0(**args)


# The entry points whose device tails the benchmark's host-tail metrics
# time, each on 3 images of 48x32 (the stream in batches of 2).
SEAM_ENTRIES = {
    "encode_lossy_stream": lambda imgs: DE.encode_lossy_stream(
        imgs, batch=2, device="cpu"),
    "encode_lossy_batch": lambda imgs: DE.encode_lossy_batch(
        np.stack(imgs), device="cpu"),
    "encode": lambda imgs: [webp_tpu_torch.encode(im, device="cpu")
                            for im in imgs],
}


@pytest.mark.parametrize("entry", list(SEAM_ENTRIES))
def test_every_device_tail_enters_finish_once_per_image(entry, monkeypatch):
    """benchmark/harness/spans.py times the host tail by replacing
    DeviceVP8Encoder.finish on the class in traced runs: each device tail
    must call it through an instance, looked up at call time, once per
    image, and the wrapped tails write the same files."""
    rng = np.random.default_rng(11)
    y, x = np.mgrid[0:32, 0:48]
    imgs = [(np.stack([x * (3 + i), y * 5, (x + y) * 2], -1)
             + rng.integers(0, 30, (32, 48, 3))).clip(0, 255).astype(
                 np.uint8) for i in range(3)]
    run = SEAM_ENTRIES[entry]
    want = run(imgs)
    finish = DE.DeviceVP8Encoder.finish
    calls = []

    def counted(self, out_i):
        calls.append(1)
        return finish(self, out_i)

    monkeypatch.setattr(DE.DeviceVP8Encoder, "finish", counted)
    assert run(imgs) == want
    assert len(calls) == len(imgs)
