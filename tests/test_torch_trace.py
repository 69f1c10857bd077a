"""webp_tpu_torch.trace on the CPU: the spans each entry point records,
their nesting, the counters' registry, and that tracing leaves the bytes
alone."""

import sys
import threading

import numpy as np
import pytest

import webp_tpu_torch as W
from webp_tpu_torch import trace
from webp_tpu_torch.lossy import device_encode as DE
from webp_tpu_torch.ops import cuda, decode as D, fastpath

TAIL_STAGES = ["tail.unpack", "tail.plan", "tail.probas", "tail.tokens",
               "tail.partition0", "tail.assemble"]


def _image(h, w, seed):
    """A smooth gradient with mild noise: natural enough that no escape
    list overflows."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    base = np.stack([x * 3, y * 4, (x + y) * 2], axis=-1)
    return (base + rng.integers(0, 12, (h, w, 3))).clip(0, 255).astype(
        np.uint8)


def _traced(fn):
    """(fn()'s result, the spans it recorded) with tracing on."""
    trace.take()
    trace.enable()
    try:
        out = fn()
    finally:
        trace.disable()
    return out, trace.take()


@pytest.fixture(scope="module")
def images():
    return [_image(48, 64, 0), _image(48, 64, 1)]


@pytest.fixture(scope="module")
def runs(images):
    """Each entry point once with tracing off and once with it on:
    {entry: (output off, spans off, output on, spans on)}."""
    trace.disable()
    calls = {
        "encode": lambda: W.encode(images[0], device="cpu"),
        "stream": lambda: DE.encode_lossy_stream(images, batch=1,
                                                 device="cpu"),
    }
    out = {}
    for name, call in calls.items():
        trace.take()
        off = call()
        out[name] = (off, trace.take()) + _traced(call)
    data = out["encode"][0]
    call = lambda: W.decode(data, device="cpu")  # noqa: E731
    trace.take()
    off = call()
    out["decode"] = (off, trace.take()) + _traced(call)
    return out


def _children(spans, i):
    return [s for s in spans if s.parent == i]


def test_tracing_off_records_nothing(runs):
    assert trace.span("x") is trace.NOOP
    for name, (_, spans_off, _, spans_on) in runs.items():
        assert spans_off == [], name
        assert spans_on, name


def test_tracing_leaves_the_outputs_alone(runs):
    for name, (off, _, on, _) in runs.items():
        if isinstance(off, np.ndarray):
            assert np.array_equal(off, on), name
        else:
            assert off == on, name


def test_encode_records_its_tree(runs):
    spans = runs["encode"][3]
    assert spans[0].name == "encode" and spans[0].parent == -1
    top = [s.name for s in _children(spans, 0)]
    assert top == ["encode.plan", "encode.upload", "device.program",
                   "encode.fetch", "encode.unpack", "tail", "encode.wrap"]
    tail = next(i for i, s in enumerate(spans) if s.name == "tail")
    assert [s.name for s in _children(spans, tail)] == TAIL_STAGES
    for s in spans:
        assert s.start <= s.end and 0 <= s.cpu <= s.end - s.start, s.name
        if s.parent >= 0:
            p = spans[s.parent]
            assert p.start <= s.start and s.end <= p.end, (p.name, s.name)
            assert p.thread == s.thread


def test_stream_hangs_each_tail_under_its_batchs_drain(runs):
    spans = runs["stream"][3]
    assert spans[0].name == "stream" and spans[0].parent == -1
    names = [s.name for s in spans]
    assert names.count("stream.upload") == names.count("stream.drain") == 2
    assert names.count("device.program") == 2
    tails = [s for s in spans if s.name == "tail"]
    assert len(tails) == 2
    drains = {spans[t.parent].name for t in tails}
    assert drains == {"stream.drain"}
    assert len({t.parent for t in tails}) == 2, "one tail per batch"
    for t in tails:
        d = spans[t.parent]
        assert d.start <= t.start and t.end <= d.end
    for s in spans:
        if s.name == "stream.prep":
            assert spans[s.parent].name == "stream.upload"
        if s.name in ("stream.upload", "stream.drain", "device.program"):
            assert s.parent == 0, s.name


def test_decode_records_its_parse(runs):
    spans = runs["decode"][3]
    assert spans[0].name == "decode" and spans[0].parent == -1
    assert [s.name for s in _children(spans, 0)] == [
        "decode.parse", "decode.upload", "device.program", "decode.fetch"]


def test_programs_built_rises_on_a_new_geometry_and_not_on_a_repeat():
    img = _image(32, 48, 2)
    data = W.encode(img, device="cpu")
    fastpath._fast_encode_fn.cache_clear()
    D.decode_fn.cache_clear()
    built = []
    for call in (lambda: W.encode(img, device="cpu"),
                 lambda: W.decode(data, device="cpu")):
        for _ in range(2):
            before = trace.PROGRAMS["built"]
            call()
            built.append(trace.PROGRAMS["built"] - before)
    # The encoder for the geometry, then the decode's step loop (no CUDA
    # graph on the CPU); nothing on a repeat.
    assert built == [1, 0, 1, 0]


def test_launches_and_fallbacks_are_entries_of_the_registry():
    assert trace.COUNTERS["launches"] is cuda.LAUNCHES
    assert trace.COUNTERS["fallbacks"] is DE.FALLBACKS
    assert set(trace.counters()) >= {"launches", "fallbacks", "programs",
                                     "bytes"}
    saved = trace.counters()
    try:
        trace.count(cuda.LAUNCHES, "p1_alpha", 3)
        assert trace.counters()["launches"]["p1_alpha"] == \
            saved["launches"]["p1_alpha"] + 3
        trace.reset_counters()
        assert not any(v for g in trace.counters().values()
                       for v in g.values())
        assert trace.COUNTERS["launches"] is cuda.LAUNCHES
    finally:
        for name, g in saved.items():
            trace.COUNTERS[name].update(g)


def test_counts_from_many_threads_are_not_lost():
    group = {"n": 0}
    n_threads, n_each = 16, 2000
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(
            target=lambda: [trace.count(group, "n") for _ in range(n_each)])
            for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=30)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert group["n"] == n_threads * n_each


def test_carry_gives_a_pool_thread_its_parent():
    def work():
        with trace.span("child"):
            pass

    def run():
        with trace.span("root"):
            t = threading.Thread(target=trace.carry(work))
            t.start()
            t.join(timeout=30)
        t = threading.Thread(target=work)
        t.start()
        t.join(timeout=30)

    _, spans = _traced(run)
    assert [(s.name, s.parent) for s in spans] == [
        ("root", -1), ("child", 0), ("child", -1)]
    assert trace.carry(work) is work
