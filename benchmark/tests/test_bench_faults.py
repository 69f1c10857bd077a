"""A run with the timed path broken underneath comes out not correct,
once for each fault the cells can have: an answer altered where it is
produced (a byte of a file, a pixel of a decode) and half of a batch left
out. The run skips the look for a card and drives the measured package's
plain versions on the CPU at tiny sizes; everything else is a run's.
The control of each configuration (the reference with one guarantee
broken, put in the program's place) is not correct either. The same
tiny runs show the reference a configuration names doing the check, and
the package's spans and counters reaching the readers."""

import os
import sys
import types

import numpy as np
import pytest

from benchmark.harness import check, readings, runner

TINY = {
    "default.stream_1536x1024": dict(
        sizes=[{"w": 64, "h": 48, "share": 1}], distinct_per_size=4,
        items_per_request=4, call_options={"batch": 2}),
    "default.decode_1536x1024": dict(
        sizes=[{"w": 64, "h": 48, "share": 1}], distinct_per_size=3,
        files={"entry": "encode_batch", "batch": 2}),
    "default.single_mixed": dict(
        sizes=[{"w": 48, "h": 32, "share": 1},
               {"w": 32, "h": 48, "share": 1}],
        distinct_per_size=2, check_items=2),
}
SEED = 2 ** 31 + 99


def tiny_cell(name):
    cell = runner.Cell(name)
    cell.mix = dict(cell.mix, **TINY[name])
    return cell


def run(name, seconds=0.5, trace=False):
    return runner.run(tiny_cell(name), SEED, seconds, trace, device="cpu",
                      workers=2)


@pytest.mark.parametrize("name", sorted(TINY))
def test_a_sound_run_is_correct(name):
    result, nums = run(name)
    assert result["correct"], nums
    assert result["failed"] == 0 and result["attempted"] > 0


@pytest.mark.parametrize("name", sorted(
    n for n in TINY if "decode" not in n))
def test_a_byte_altered_in_the_host_tail_is_caught(monkeypatch, name):
    from webp_tpu_torch.lossy.device_encode import DeviceVP8Encoder

    finish = DeviceVP8Encoder.finish

    def altered(self, out_i):
        data = bytearray(finish(self, out_i))
        data[-1] ^= 1
        return bytes(data)

    monkeypatch.setattr(DeviceVP8Encoder, "finish", altered)
    result, nums = run(name)
    assert not result["correct"] and nums["files_differing"][0] > 0


def test_a_level_altered_on_the_device_is_caught(monkeypatch):
    from webp_tpu_torch.ops import fastpath

    unpack = fastpath.unpack_levels

    def altered(*a, **k):
        lv = unpack(*a, **k).copy()
        lv[0, 1, 0] += 1
        return lv

    monkeypatch.setattr(fastpath, "unpack_levels", altered)
    result, nums = run("default.single_mixed")
    assert not result["correct"] and nums["files_differing"][0] > 0


def test_a_pixel_altered_in_the_decode_is_caught(monkeypatch):
    from webp_tpu_torch.lossy import device_decode

    dec = device_decode.decode_vp8_rgb_device

    def altered(*a, **k):
        rgb = dec(*a, **k).copy()
        rgb[0, 0, 0] ^= 4
        return rgb

    monkeypatch.setattr(device_decode, "decode_vp8_rgb_device", altered)
    result, nums = run("default.decode_1536x1024")
    assert not result["correct"] and nums["pixels_differing"][0] > 0


def test_a_pool_file_altered_in_set_up_is_caught(monkeypatch):
    from benchmark.harness import entries

    make = entries.make_files

    def altered(*a, **k):
        files = make(*a, **k)
        files[1] = files[1][:-1] + bytes([files[1][-1] ^ 1])
        return files

    monkeypatch.setattr(entries, "make_files", altered)
    result, nums = run("default.decode_1536x1024")
    assert not result["correct"] and nums["pool_files_differing"][0] == 1


def test_a_file_unlike_the_reconstruction_is_caught():
    import webp_tpu_torch

    from benchmark.harness import images

    img = images.synth_images(images.generator(SEED, "cpu"), 1, 48, 64,
                              "cpu").numpy()[0]
    good = webp_tpu_torch.encode(img, device="cpu")
    ref, differs, compared = check._encode_job(check.REFERENCE, "encode",
                                               img, {}, good)
    assert ref == good and compared and differs == 0
    # A token altered: the file, read back, is not what the encoder's
    # closed loop reconstructed.
    bad = bytearray(good)
    bad[len(bad) * 2 // 3] ^= 0x10
    assert check._encode_job(check.REFERENCE, "encode", img, {},
                             bytes(bad))[1:] == (1, True)


def test_half_of_a_batch_left_out_is_caught(monkeypatch):
    from webp_tpu_torch.lossy import device_encode

    stream = device_encode.encode_lossy_stream

    def half(images, **k):
        return stream(images, **k)[:len(images) // 2]

    monkeypatch.setattr(device_encode, "encode_lossy_stream", half)
    result, nums = run("default.stream_1536x1024")
    assert not result["correct"] and nums["outputs_missing"][0] > 0
    assert result["failed"] == 0


@pytest.mark.parametrize("name", sorted(TINY))
def test_the_control_is_not_correct(name):
    from benchmark.control import control_numbers

    out = control_numbers(tiny_cell(name), SEED, 2, device="cpu")
    assert all(v <= lim for v, lim in out["program"].values())
    assert any(v > lim for v, lim in out["control"].values())


@pytest.mark.cuda
def test_a_tiny_traced_run_on_the_card_is_correct(card):
    result, nums = runner.run(tiny_cell("default.single_mixed"), SEED, 0.5,
                              True, workers=2)
    assert result["correct"], nums
    assert result["device"]["platform"] == "gpu"
    assert result["device"]["busy_s"] > 0


# -- the reference a configuration names -------------------------------------

def naming(monkeypatch, reference):
    """Cells load their configuration with `reference` as its key."""
    load = runner.load_json

    def with_key(path):
        data = load(path)
        if path.startswith(os.path.join(runner.BENCH_DIR, "configs")):
            data = dict(data, reference=reference)
        return data

    monkeypatch.setattr(runner, "load_json", with_key)


def references(monkeypatch) -> list:
    """The results of every check.reference call from here on."""
    out = []
    ref = check.reference

    def kept(*a, **k):
        out.append(ref(*a, **k))
        return out[-1]

    monkeypatch.setattr(check, "reference", kept)
    return out


def same(a, b) -> bool:
    if isinstance(a, dict):
        return a.keys() == b.keys() and all(same(a[k], b[k]) for k in a)
    if isinstance(a, np.ndarray):
        return np.array_equal(a, b)
    return a == b


@pytest.mark.parametrize("name", sorted(TINY))
def test_a_reference_named_explicitly_checks_as_the_default(monkeypatch,
                                                             name):
    got = references(monkeypatch)
    result, nums = run(name)
    naming(monkeypatch, {"encoder": "encode", "decoder": "decode"})
    assert tiny_cell(name).reference == check.REFERENCE
    result2, nums2 = run(name)
    assert result["correct"] and result2["correct"]
    assert nums == nums2
    assert len(got) == 2 and same(got[0], got[1])


def test_the_jobs_run_the_modules_the_configuration_names(monkeypatch):
    calls = []
    enc = types.ModuleType("benchmark.reference.other_encode")
    enc.encode_file = lambda rgb, options: (b"encode_file", None)
    enc.stream_frame = lambda rgb, options: (b"stream_frame", None)
    dec = types.ModuleType("benchmark.reference.other_decode")
    dec.decode_rgb = lambda data, loop_filter: calls.append(loop_filter)
    for m in (enc, dec):
        monkeypatch.setitem(sys.modules, m.__name__, m)
    names = {"encoder": "other_encode", "decoder": "other_decode"}
    img = np.zeros((16, 16, 3), np.uint8)
    assert check._encode_job(names, "encode", img, {}, b"x") == (
        b"encode_file", 0, False)
    assert check._encode_job(names, "encode_lossy_stream", img, {},
                             None)[0] == b"stream_frame"
    assert check._pool_job("other_encode", img, {}, b"encode_file") == 0
    assert check._pool_job("other_encode", img, {}, b"other") == 1
    check._decode_job("other_decode", b"x", False)
    assert calls == [False]


# -- the package's spans and counters in a run -------------------------------

def kept_readings(monkeypatch) -> list:
    out = []

    def kept(*a, **k):
        out.append(readings.Readings(*a, **k))
        return out[-1]

    monkeypatch.setattr(runner, "Readings", kept)
    return out


@pytest.mark.parametrize("name", sorted(TINY))
def test_a_traced_run_reads_the_packages_spans_and_counters(monkeypatch,
                                                           name):
    import torch

    from webp_tpu_torch import trace

    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    got = kept_readings(monkeypatch)
    result, nums = run(name, trace=True)
    assert result["correct"], nums
    (r,) = got
    assert r.program and {"programs", "bytes"} <= set(r.counters)
    assert trace.span("after") is trace.NOOP
    spans = {m["name"] for m in runner.Cell(name).metrics(True)
             if m["source"] == "program_span"}
    assert spans and spans <= set(result["metrics"])
    gaps = result["breakdown"]["idle_gaps"]
    assert gaps and all(isinstance(g, float) for _, g in gaps)


def test_a_decode_run_drops_the_outputs_it_does_not_check(monkeypatch):
    got = kept_readings(monkeypatch)
    result, nums = run("default.decode_1536x1024", seconds=1.0)
    (r,) = got
    outs = [o for q in r.requests for o in q.outputs]
    dropped = sum(1 for o in outs if o is check.DROPPED)
    assert result["correct"], nums
    assert len(outs) == r.items() and 0 < dropped < len(outs)


def test_an_untraced_run_counts_with_the_tracer_off(monkeypatch):
    got = kept_readings(monkeypatch)
    result, nums = run("default.single_mixed")
    (r,) = got
    assert r.program is None
    assert r.counters["bytes"] == {"h2d": 0, "d2h": 0}
    assert r.counters["programs"]["built"] == 0
    assert result["correct"] and "breakdown" not in result
