"""The harness on the CPU: discovery by name, the traffic generator, the
window arithmetic and the readers' arithmetic on synthetic data."""

import json
import os
import sys
import types

import pytest

from benchmark.harness import (check, entries, program, readings, roofline,
                               runner, traffic)
from benchmark.harness import window as W
from benchmark.harness.trace import TraceData, short_name
from benchmark.harness.window import Request

ROOT = runner.ROOT
BENCH = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
CELLS = [w["name"] for w in BENCH["workloads"]]
METRICS = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]


# -- discovery ----------------------------------------------------------------

@pytest.mark.parametrize("name", CELLS)
def test_each_cell_finds_its_configuration_and_mix(name):
    cell = runner.Cell(name)
    assert cell.config["name"] == cell.spec["config"]
    assert cell.mix["entry"] in traffic.ENTRIES
    assert cell.options and set(cell.options) <= set(entries.ENCODE_DEFAULTS)
    assert cell.control.get("breaks")


@pytest.mark.parametrize("name", METRICS)
def test_each_metric_has_a_reader(name):
    assert callable(runner.load_reader(name))


@pytest.mark.parametrize("name", CELLS)
def test_each_cell_reports_setup_another_e2e_and_a_layer_metric(name):
    cell = runner.Cell(name)
    e2e = {m["name"] for m in cell.metrics(False)}
    assert "setup_s" in e2e and len(e2e) >= 2
    layer = cell.metrics(True)
    assert layer and all(m["moves"] in e2e for m in layer)


def test_configuration_files_hold_their_names_and_cuts():
    for c in BENCH["configs"]:
        cfg = json.load(open(os.path.join(ROOT, c["file"])))
        assert cfg["name"] == c["name"]
        assert cfg["reduced"] == c["reduced"]
        assert cfg["source"] and cfg["assumed"]


def test_an_unknown_cell_is_refused():
    with pytest.raises(KeyError):
        runner.Cell("no.such_cell")


def test_a_configuration_without_the_key_takes_the_default_reference():
    assert check.reference_modules({}) == {"encoder": "encode",
                                           "decoder": "decode"}
    assert check.reference_modules({"reference": {"decoder": "decode"}}) \
        == check.REFERENCE
    for name in CELLS:
        assert runner.Cell(name).reference == check.REFERENCE


@pytest.mark.parametrize("reference", [
    {"encoder": "no_such_encoder"}, {"decoder": "no_such_decoder"},
    {"decoder": "vp8ref"}, {"encoder": "../reference/encode"},
    {"encoder": "encode.py"}, {"decoder": 7}, {"checker": "encode"},
    {"decoder": "vp8dec"}, {"encoder": "decode"}, {"decoder": "encode"}])
def test_an_unknown_reference_is_refused_when_the_cell_loads(monkeypatch,
                                                             reference):
    """A name that is no module, or a module without its role's
    functions."""
    load = runner.load_json

    def with_key(path):
        data = load(path)
        return dict(data, reference=reference) if "configs" in path \
            else data

    monkeypatch.setattr(runner, "load_json", with_key)
    with pytest.raises(ValueError, match="reference"):
        runner.Cell(CELLS[0])


def test_forbidden_modules_are_found_by_whole_top_level_name(monkeypatch):
    monkeypatch.setitem(sys.modules, "webp_tpu_torch_like",
                        types.ModuleType("x"))
    assert "webp_tpu" not in runner.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jax.numpy", types.ModuleType("x"))
    assert "jax" in runner.forbidden_modules()


# -- the traffic generator ----------------------------------------------------

MIXED = {"entry": "encode", "sizes": [{"w": 64, "h": 48, "share": 1},
                                      {"w": 48, "h": 64, "share": 2}],
         "distinct_per_size": 2, "check_items": 3}


def test_pool_shares():
    assert traffic.pool_sizes(MIXED) == [(64, 48)] * 2 + [(48, 64)] * 4


@pytest.mark.parametrize("seed", [0, 7, 2 ** 31 + 11, 2 ** 40])
def test_every_seed_gives_the_same_work_in_another_order(seed):
    gen = traffic.request_items(MIXED, seed)
    reqs = [next(gen) for _ in range(60)]
    sizes = traffic.pool_sizes(MIXED)
    counts = {}
    for r in reqs:
        counts[sizes[r[0]]] = counts.get(sizes[r[0]], 0) + 1
    assert counts == {(64, 48): 20, (48, 64): 40}


def test_seeds_change_the_order():
    a = traffic.request_items(MIXED, 1)
    b = traffic.request_items(MIXED, 2)
    assert [next(a) for _ in range(12)] != [next(b) for _ in range(12)]


def test_stream_requests_carry_their_items():
    mix = dict(MIXED, entry="encode_lossy_stream", items_per_request=5)
    r = next(traffic.request_items(mix, 3))
    assert len(r) == 5 and len(set(r)) == 5


def test_check_order_takes_the_sizes_in_turn():
    order = traffic.check_order(MIXED, 5)
    sizes = traffic.pool_sizes(MIXED)
    assert sorted(order) == list(range(6))
    assert {sizes[i] for i in order[:2]} == {(64, 48), (48, 64)}


def test_a_check_from_the_first_request_takes_its_first_items():
    mix = dict(MIXED, check_items=3, check_from="first_request")
    reqs = [Request([4, 2, 5, 1], 0.0, error="E"),
            Request([5, 0, 5, 3], 0.0), Request([1, 2], 0.0)]
    assert check.sample(mix, 7, reqs) == [5, 0, 3]
    assert check.sample(dict(MIXED, check_items=2), 7, reqs) == \
        traffic.check_order(MIXED, 7)[:2]


def test_a_check_from_the_seed_leaves_out_items_not_served():
    order = traffic.check_order(MIXED, 7)
    reqs = [Request([order[1], order[3]], 0.0)]
    assert check.sample(dict(MIXED, check_items=3), 7, reqs) == [order[1]]


@pytest.mark.parametrize("mix", [
    {"entry": "transcode", "sizes": [{"w": 1, "h": 1}]},
    {"entry": "encode", "sizes": [{"w": 1, "h": 1}], "items_per_request": 2},
    {"entry": "decode", "sizes": [{"w": 1, "h": 1}]},
    {"entry": "encode", "sizes": [{"w": 1, "h": 1}], "check_from": "last"},
])
def test_malformed_mixes_are_refused(mix):
    with pytest.raises(ValueError):
        traffic.check_mix(mix)


# -- the window ---------------------------------------------------------------

class Clock:
    """A host clock that each call of the measured function advances."""

    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


def test_closed_loop_counts_the_request_that_straddles_the_close():
    clk = Clock()

    def call(items):
        clk.t += 0.4
        return ["out"] * len(items)

    t0, reqs = W.run_closed(call, ([i] for i in range(100)), 1.0,
                            clock=clk)
    # Requests start at 0, 0.4, 0.8; the third ends at 1.2 and counts.
    assert len(reqs) == 3 and reqs[-1].end - t0 == pytest.approx(1.2)
    assert W.rate(3.0, t0, reqs) == pytest.approx(3 / 1.2)


def test_closed_loop_latency_counts_from_the_send():
    clk = Clock()

    def call(items):
        clk.t += 0.5 if items[0] % 2 else 0.25
        return [1]

    t0, reqs = W.run_closed(call, ([i] for i in range(10)), 1.0, clock=clk)
    assert [round(r.latency, 6) for r in reqs] == [0.25, 0.5, 0.25]
    assert [round(r.due - t0, 6) for r in reqs] == [0.0, 0.25, 0.75]


def test_a_failed_request_is_recorded_not_raised():
    clk = Clock()

    def call(items):
        clk.t += 2.0
        raise RuntimeError("boom")

    t0, reqs = W.run_closed(call, ([i] for i in range(2)), 1.0, clock=clk)
    assert len(reqs) == 1 and reqs[0].error.startswith("RuntimeError")
    assert W.rate(1.0, t0, reqs) == 0.0


def test_rate_is_over_the_window_to_the_last_completion():
    reqs = [Request([0], 0.0, 0.0, 2.0), Request([1], 2.0, 2.0, 5.0)]
    assert W.rate(10.0, 0.0, reqs) == pytest.approx(2.0)


def test_p95_over_all_requests():
    vals = list(range(1, 101))
    assert W.p95(vals) == pytest.approx(95.05)
    assert W.p95([3.0]) == 3.0


def test_union_of_overlapping_intervals():
    iv = [(0, 2), (1, 3), (5, 6), (5.5, 5.7), (7, 8)]
    assert W.union(iv) == [(0, 3), (5, 6), (7, 8)]
    assert W.covered(iv) == pytest.approx(5.0)
    assert W.gaps(iv, -1, 9) == [(-1, 0), (3, 5), (6, 7), (8, 9)]


# -- the readers --------------------------------------------------------------

def trace_of(kernels, markers=((0.0, 10.0),), offset=0.0):
    device = [(n, s, e) for n, s, e in kernels]
    return TraceData(device, list(markers), offset,
                     [d for d in device if not d[0].startswith("Memcpy")])


def reading(trace=None, tail=None, mix=None, outputs=None):
    mix = mix or {"entry": "encode", "sizes": [{"w": 32, "h": 32}],
                  "distinct_per_size": 2}
    reqs = [Request([0], 0.0, 0.0, 4.0, outputs=outputs or [b""]),
            Request([1], 4.0, 4.0, 10.0, outputs=outputs or [b""])]
    return readings.Readings({}, mix, {"sns_strength": 50},
                             traffic.pool_sizes(mix), 0.0, reqs, 12.5,
                             host_tail=tail, trace=trace, traced=reqs)


def test_idle_share_of_synthetic_kernel_intervals():
    tr = trace_of([("k(int)", 1.0, 3.0), ("k(int)", 2.0, 4.0),
                   ("Memcpy HtoD", 6.0, 7.0)])
    r = reading(trace=tr)
    assert tr.busy_s() == pytest.approx(4.0)
    assert readings.device_idle_pct(r) == pytest.approx(60.0)
    assert readings.device_busy_ms_per_request(r) == pytest.approx(2000.0)
    assert readings.device_kernels_per_image(r) == pytest.approx(1.0)


def test_idle_gaps_are_labelled_by_the_host_span_over_them():
    tr = trace_of([("k", 1.0, 2.0), ("k", 8.0, 9.0)], offset=0.5)
    gaps = program.idle_gaps(tr, [], {"host tail": [(2.5, 5.0)]})
    # Host spans shift by the offset: the tail covers 3.0-5.5 in the
    # trace's clock, the middle of the 2-8 gap.
    assert gaps[0] == ["host tail", pytest.approx(6.0)]
    assert ["between requests", pytest.approx(1.0)] in gaps


def test_host_tail_counts_overlapping_threads_once():
    r = reading(tail=[(0.0, 1.0), (0.5, 1.5), (3.0, 4.0)])
    assert readings.host_tail_ms_per_image(r) == pytest.approx(1250.0)
    assert readings.host_tail_ms_per_image(reading()) is None


def test_rates_and_tails_from_readings():
    r = reading()
    assert readings.mpx_per_s(r) == pytest.approx(2 * 32 * 32 / 1e6 / 10)
    assert readings.p95_ms(r) == pytest.approx(
        1e3 * W.p95([4.0, 6.0]))


def test_roofline_share_from_counts():
    # Kernel 1 on two B=1 launches of 2x2 MBs, timed at twice its bound.
    nb, no = roofline.kernel_work("p1_alpha", 1, 2, 2, True)
    least = roofline.bound_s(nb, no)[0]
    tr = trace_of([("p1_alpha_kernel(unsigned char const*)", 1.0,
                    1.0 + 2 * least),
                   ("p1_alpha_kernel(unsigned char const*)", 5.0,
                    5.0 + 2 * least)])
    r = reading(trace=tr)
    assert readings.roofline_pct(r, ("p1_alpha",)) == pytest.approx(50.0)


def test_a_share_with_a_kernel_not_run_once_per_batch_is_not_read(capsys):
    nb, no = roofline.kernel_work("p1_alpha", 1, 2, 2, True)
    least = roofline.bound_s(nb, no)[0]
    k1 = "p1_alpha_kernel(unsigned char const*)"
    tr = trace_of([(k1, 1.0, 1.0 + 2 * least), (k1, 5.0, 5.0 + 2 * least)])
    r = reading(trace=tr)
    # A kernel that did not run, or ran twice per batch: the share names
    # it and is not read, rather than covering fewer kernels.
    assert readings.roofline_pct(r, ("p1_alpha", "p1_mode")) is None
    assert "p1_mode" in capsys.readouterr().out
    tr = trace_of([(k1, 1.0, 1.1), (k1, 2.0, 2.1), (k1, 5.0, 5.1)])
    assert readings.roofline_pct(reading(trace=tr), ("p1_alpha",)) is None
    assert "'p1_alpha': 3" in capsys.readouterr().out


def test_kernel_work_counts_in_once_and_out_once():
    nb, no = roofline.kernel_work("p1_alpha", 2, 3, 4, True)
    assert nb == (384 + 8) * 24
    assert no == roofline.ops_alpha_per_mb() * 24
    nb, _ = roofline.kernel_work("p2_wavefront", 1, 6, 4, True, n_i4=3)
    assert nb == 96 * 64 * 3 // 2 + 23 * 24 + 3072 + 24 * (
        24 * 8 + 24 * 16 * 2 + 16 * 2 + 4 + 1)
    assert roofline.bound_s(3.35e12, 0)[1] == "bytes"
    assert roofline.kernel_of("p2_escape_kernel(int const*)") == \
        "p2_wavefront"
    assert roofline.kernel_of("void at::native::foo") is None
    assert roofline.kernel_of("(anonymous namespace)::p2_wavefront_kernel("
                              "(anonymous namespace)::Args)") == \
        "p2_wavefront"
    assert roofline.kernel_name("(anonymous namespace)::p2_wavefront_kernel("
                                "(anonymous namespace)::Args)") == \
        "p2_wavefront_kernel"
    assert short_name("p1_mode_kernel(unsigned char const*, int)") == \
        "p1_mode_kernel"


# -- the comparison's numbers -------------------------------------------------

def test_numbers_count_missing_and_differing_outputs():
    mix = {"entry": "encode"}
    reqs = [Request([0], 0.0, outputs=[b"a"]), Request([1], 0.0,
                                                        outputs=[b"x"]),
            Request([0], 0.0, outputs=[]), Request([1], 0.0, error="E")]
    nums = check.numbers(mix, reqs, {"ref": {0: b"a", 1: b"b"},
                                     "recon": {0: (0, True), 1: (1, True)}})
    assert nums == {"outputs_missing": [2, 0], "files_differing": [1, 0],
                    "files_unlike_recon": [1, 0]}
    assert not check.correct(nums)


def test_pixel_numbers_count_samples():
    import numpy as np

    want = np.zeros((2, 2, 3), np.uint8)
    got = want.copy()
    got[0, 0, 1] = 9
    reqs = [Request([0], 0.0, outputs=[got]),
            Request([0], 0.0, outputs=[np.zeros((1, 2, 3), np.uint8)])]
    nums = check.numbers({"entry": "decode"}, reqs,
                         {"ref": {0: want}, "pool": {0: 0, 1: 1, 2: 1}})
    assert nums["pixels_differing"] == [1 + 12, 0]
    assert nums["pool_files_differing"] == [2, 0]


# -- what the window keeps for the check --------------------------------------

def kept_window(mix, seed, items):
    keep = check.Keeper(mix, seed)
    reqs = []
    for k, r in enumerate(items):
        reqs.append(Request(r, 0.0, outputs=[(k, i) for i in r]))
        keep(reqs[-1])
    return reqs


@pytest.mark.parametrize("seed", [3, 2 ** 31 + 17])
def test_the_window_keeps_only_what_the_check_reads(seed):
    mix = dict(MIXED, check_items=2, trace_requests=2)
    gen = traffic.request_items(mix, seed)
    items = [next(gen) for _ in range(600)]
    reqs = kept_window(mix, seed, items)
    assert [len(r.outputs) for r in reqs] == [1] * 600
    assert all(r.outputs[0] == (k, r.items[0])
               for k, r in enumerate(reqs[:2]))
    sample = check.sample(mix, seed, reqs)
    assert sample == traffic.check_order(mix, seed)[:2]
    kept = [(k, r.items[0]) for k, r in enumerate(reqs[2:], 2)
            if r.outputs[0] is not check.DROPPED]
    assert {i for _, i in kept} == set(sample)
    for i in sample:                 # each checked item's first output
        first = next(k for k, r in enumerate(reqs) if r.items[0] == i)
        assert reqs[first].outputs[0] == (first, i)
    # One request in KEEP_EVERY, drawn from the seed, keeps its outputs
    # of checked items; the same seed draws the same requests.
    n_checked = sum(1 for r in reqs if r.items[0] in sample)
    assert 0 < len(kept) < n_checked / 4
    again = kept_window(mix, seed, items)
    assert [r.outputs for r in again] == [r.outputs for r in reqs]
    assert check.kept(reqs, set(sample)) == len(kept) + sum(
        1 for r in reqs[:2] if r.items[0] in sample)


def test_a_stream_keeps_the_first_requests_checked_slots():
    mix = dict(MIXED, check_items=2, check_from="first_request",
               trace_requests=0)
    items = [[4, 2, 5], [2, 4, 1], [5, 4, 2]]
    reqs = kept_window(mix, 1, items)
    assert reqs[0].outputs[:2] == [(0, 4), (0, 2)]
    assert reqs[0].outputs[2] is check.DROPPED
    assert reqs[1].outputs[2] is check.DROPPED
    assert check.sample(mix, 1, reqs) == [4, 2]


def test_numbers_skip_dropped_outputs_and_count_them_as_given():
    reqs = [Request([0, 1], 0.0, outputs=[b"a", check.DROPPED]),
            Request([0], 0.0, outputs=[check.DROPPED])]
    nums = check.numbers({"entry": "encode"}, reqs,
                         {"ref": {0: b"a", 1: b"b"},
                          "recon": {0: (0, True), 1: (0, False)}})
    assert nums["outputs_missing"] == [0, 0]
    assert nums["files_differing"] == [0, 0]
    assert check.first_outputs(reqs, {0, 1}) == {0: b"a"}
