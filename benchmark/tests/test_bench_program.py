"""The readers of the package's own spans (harness/program.py) on
synthetic spans: self times, wall less CPU, the per-request and
per-batch means, nothing to read without spans, and the idle gaps
labelled by the deepest program span over them."""

import pytest

from benchmark.harness import program as PG
from benchmark.harness import readings, runner, traffic
from benchmark.harness.trace import TraceData
from benchmark.harness.window import Request

S = PG.Span
READERS = ["host_tail_cpu_ms_per_image.encode",
           "host_tail_wait_ms_per_image.encode",
           "device_enqueue_ms_per_batch.encode",
           "stream_upload_ms_per_batch.encode",
           "host_glue_ms_per_request.latency",
           "device_wait_ms_per_request.latency",
           "host_parse_ms_per_image.decode"]

# Two encode() requests; the first falls into its parts on one thread.
ENCODE = [
    S("encode", 0.0, 0.100, 0.090, 1, -1),
    S("encode.plan", 0.000, 0.010, 0.010, 1, 0),
    S("device.program", 0.010, 0.015, 0.005, 1, 0),
    S("encode.fetch", 0.015, 0.040, 0.001, 1, 0),
    S("tail", 0.050, 0.090, 0.038, 1, 0),
    S("tail.probas", 0.050, 0.060, 0.010, 1, 4),
    S("tail.tokens", 0.060, 0.085, 0.025, 1, 4),
    S("encode", 0.200, 0.260, 0.050, 1, -1),
    S("encode.fetch", 0.210, 0.230, 0.001, 1, 7),
    S("tail", 0.230, 0.250, 0.019, 1, 7),
]

# One stream batch: two tails on pool threads under the drain.
STREAM = [
    S("stream", 0.0, 1.0, 0.5, 1, -1),
    S("stream.upload", 0.0, 0.2, 0.1, 2, 0),
    S("device.program", 0.2, 0.21, 0.01, 1, 0),
    S("stream.upload", 0.3, 0.4, 0.05, 2, 0),
    S("device.program", 0.4, 0.43, 0.02, 1, 0),
    S("stream.drain", 0.5, 1.0, 0.05, 1, 0),
    S("tail", 0.5, 0.8, 0.1, 3, 5),
    S("tail", 0.6, 0.9, 0.2, 4, 5),
]


def reading(spans, n=2, entry="encode"):
    mix = {"entry": entry, "sizes": [{"w": 32, "h": 32}],
           "distinct_per_size": n}
    reqs = [Request([k], 0.0, 0.0, 1.0, outputs=[b""]) for k in range(n)]
    r = readings.Readings({}, mix, {}, traffic.pool_sizes(mix), 0.0, reqs,
                          1.0, traced=reqs)
    r.program = spans
    return r


@pytest.mark.parametrize("name", READERS)
def test_each_reader_reads_nothing_without_program_spans(name):
    read = runner.load_reader(name)
    assert read(reading(None)) is None
    assert read(reading([])) is None


def test_self_time_is_wall_less_what_children_cover():
    own = PG.self_s(STREAM)
    # The drain's two tails overlap (0.5-0.9 covered): 0.1 s is its own.
    assert own[5] == pytest.approx(0.1)
    # The stream's children cover 0-0.21, 0.3-0.43 and 0.5-1.0.
    assert own[0] == pytest.approx(0.16)
    assert own[6] == pytest.approx(0.3)
    sums = PG.per_name(ENCODE)
    assert sums["tail"][3] == pytest.approx(0.005 + 0.020)
    lines = PG.summary_lines(ENCODE, 2)
    assert lines[0].startswith("program span tail.probas: 1 spans")
    assert "self 5.000 ms" in lines[0]


def test_tail_cpu_and_wall_less_cpu_per_image():
    r = reading(STREAM)
    assert runner.load_reader(READERS[0])(r) == pytest.approx(150.0)
    # (0.3 - 0.1) + (0.3 - 0.2) over 2 images.
    assert runner.load_reader(READERS[1])(r) == pytest.approx(150.0)


def test_means_per_batch():
    r = reading(STREAM)
    assert runner.load_reader(READERS[2])(r) == pytest.approx(20.0)
    assert runner.load_reader(READERS[3])(r) == pytest.approx(150.0)


def test_glue_and_device_wait_per_request():
    r = reading(ENCODE)
    # Request 1: 100 - fetch 25 - tail 40; request 2: 60 - 20 - 20.
    assert runner.load_reader(READERS[4])(r) == pytest.approx(
        (35.0 + 20.0) / 2)
    assert runner.load_reader(READERS[5])(r) == pytest.approx(
        (25.0 + 20.0) / 2)


def test_parse_per_decode_request():
    spans = [S("decode", 0.0, 1.0, 0.9, 1, -1),
             S("decode.parse", 0.0, 0.012, 0.012, 1, 0),
             S("decode", 1.0, 2.0, 0.9, 1, -1),
             S("decode.parse", 1.0, 1.008, 0.008, 1, 2)]
    r = reading(spans, entry="decode")
    assert runner.load_reader(READERS[6])(r) == pytest.approx(10.0)


def trace_of(kernels, offset=0.0):
    device = [("k", s, e) for s, e in kernels]
    return TraceData(device, [(0.0, 10.0)], offset, device)


def test_the_deepest_covering_program_span_labels_a_gap():
    spans = [S("stream", 0.0, 10.0, 1.0, 1, -1),
             S("stream.drain", 2.0, 6.0, 0.5, 1, 0),
             S("tail", 2.5, 5.5, 0.5, 3, 1),
             S("stream.upload", 1.0, 9.0, 0.5, 2, 0)]
    tr = trace_of([(1.0, 2.0), (8.0, 9.0)], offset=0.5)
    gaps = PG.idle_gaps(tr, spans, {"host tail": [(2.5, 5.0)]})
    # Spans shift by the offset: the tail covers 3.0-6.0, the middle of
    # the 2-8 gap, under the drain and the stream; the upload is shallower.
    assert gaps[0] == ["tail", pytest.approx(6.0)]
    # 0-1 (middle 0.5): only the stream (from 0.5) covers it.
    assert ["stream", pytest.approx(1.0)] in gaps
    assert PG.labelled_share(gaps, spans) == pytest.approx(1.0)


def test_a_gap_no_program_span_covers_keeps_its_old_label():
    spans = [S("decode", 3.0, 5.0, 1.0, 1, -1)]
    tr = trace_of([(1.0, 2.0), (7.0, 9.0)])
    gaps = PG.idle_gaps(tr, spans, {"host tail": [(0.0, 0.8)]})
    assert gaps == [["decode", pytest.approx(5.0)],
                    ["host tail", pytest.approx(1.0)],
                    ["between requests", pytest.approx(1.0)]]
    assert PG.labelled_share(gaps, spans) == pytest.approx(5.0 / 7.0)


def test_start_and_stop_take_the_packages_spans():
    from webp_tpu_torch import trace

    PG.start()
    try:
        with trace.span("decode"):
            with trace.span("decode.parse"):
                pass
    finally:
        spans = PG.stop()
    assert [(s.name, s.parent) for s in spans] == [("decode", -1),
                                                   ("decode.parse", 0)]
    assert 0 <= spans[1].cpu <= spans[1].wall <= spans[0].wall
    assert trace.span("x") is trace.NOOP
    assert {"programs", "bytes"} <= set(PG.counters())
