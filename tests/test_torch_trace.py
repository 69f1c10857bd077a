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

TAIL_STAGES = ["tail.plan", "tail.code", "tail.partition0", "tail.assemble"]


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


# -- the lossless coder --------------------------------------------------------

LOSSLESS_SPANS = ("lossless.prep", "lossless.predict",
                  "lossless.cross_color", "lossless.entropy")


@pytest.fixture(scope="module")
def lossless_runs(images):
    """encode(lossless=True) and an RGBA encode() whose ALPH plane the
    lossless coder writes, each with tracing off and on: {name: (output
    off, output on, spans on, the lossless counters' change on, the
    native entropy coder's (pixels, is_level0) calls on)}."""
    from webp_tpu_torch.lossless import encode as LE
    from webp_tpu_torch.native import api

    rgba = np.concatenate([images[1], np.full((48, 64, 1), 255, np.uint8)],
                          axis=-1)
    rgba[8:24, 10:40, 3] = np.arange(30, dtype=np.uint8) * 8
    calls = {
        "lossless": lambda: W.encode(images[0], lossless=True, device="cpu"),
        "alpha": lambda: W.encode(rgba, device="cpu"),
    }
    coder = api.vp8l_encode_entropy_image
    seen: list = []

    def recorded(argb, xsize, quality, is_level0, method=4):
        seen.append((np.asarray(argb).size, bool(is_level0)))
        return coder(argb, xsize, quality, is_level0, method)

    trace.disable()
    out = {}
    api.vp8l_encode_entropy_image = recorded
    try:
        for name, call in calls.items():
            off = call()
            seen.clear()
            before = dict(LE.LOSSLESS)
            on, spans = _traced(call)
            delta = {k: LE.LOSSLESS[k] - before[k] for k in before}
            out[name] = (off, on, spans, delta, list(seen))
    finally:
        api.vp8l_encode_entropy_image = coder
    return out


def test_lossless_tracing_leaves_the_files_alone(lossless_runs):
    for name, (off, on, *_) in lossless_runs.items():
        assert off == on, name
    assert lossless_runs["lossless"][0][12:16] == b"VP8L"
    assert b"ALPH" in lossless_runs["alpha"][0]


def test_the_lossless_tree_records_under_encode(lossless_runs):
    spans = lossless_runs["lossless"][2]
    assert spans[0].name == "encode" and spans[0].parent == -1
    (i,) = [k for k, s in enumerate(spans) if s.name == "lossless"]
    assert spans[i].parent == 0
    kids = {s.name for s in _children(spans, i)}
    assert kids == set(LOSSLESS_SPANS)
    for s in spans:
        if s.name.startswith("lossless."):
            assert s.parent == i, s.name
        if s.parent >= 0:
            p = spans[s.parent]
            assert p.start <= s.start and s.end <= p.end, (p.name, s.name)


def test_alphs_coder_spans_hang_under_the_carried_parent(lossless_runs):
    spans = lossless_runs["alpha"][2]
    assert spans[0].name == "encode"
    coders = [s for s in spans if s.name == "lossless"]
    assert coders and all(s.parent == 0 for s in coders)
    assert all(s.thread != spans[0].thread for s in coders)
    heads = {spans.index(s) for s in coders}
    entropy = [s for s in spans if s.name == "lossless.entropy"]
    assert entropy and all(s.parent in heads for s in entropy)


@pytest.mark.parametrize("name", ["lossless", "alpha"])
def test_the_lossless_counters_add_up(lossless_runs, name):
    spans, delta, seen = lossless_runs[name][2:]
    entropy = [s for s in spans if s.name == "lossless.entropy"]
    assert delta["entropy_calls"] == len(seen) == len(entropy) > 0
    assert delta["entropy_pixels"] == sum(n for n, _ in seen)
    # Each candidate's main image is its one level-0 stream.
    assert delta["candidates"] == sum(lv for _, lv in seen) > 0
    assert delta["images"] == sum(s.name == "lossless" for s in spans) > 0
    if name == "lossless":
        assert delta["images"] == 1 and delta["candidates"] > 1


def test_the_predictor_searchs_copies_go_through_the_counted_helpers(
        monkeypatch, images):
    """The upload and the fetch are device_encode's _upload and _fetch,
    which count the bytes a copy to or from a CUDA device moves."""
    from webp_tpu_torch.lossless import encode as LE

    argb = LE.subtract_green(LE.rgba_to_argb(images[0]))
    bits, (h, w) = 4, argb.shape
    want = LE.predictor_transform(argb, bits, 75)
    seen = []
    upload, fetch = DE._upload, DE._fetch

    def uploaded(t, dev):
        seen.append(("h2d", t.nbytes))
        return upload(t, dev)

    def fetched(tensors):
        out = fetch(tensors)
        seen.append(("d2h", sum(a.nbytes for a in out)))
        return out

    monkeypatch.setattr(DE, "_upload", uploaded)
    monkeypatch.setattr(DE, "_fetch", fetched)
    before = dict(trace.BYTES)
    got = LE.predictor_transform(argb, bits, 75, search="cpu")
    assert all(np.array_equal(a, b) for a, b in zip(got, want))
    tiles = ((h + 15) >> 4) * ((w + 15) >> 4)
    assert seen == [("h2d", h * w * 4), ("d2h", h * w * 8 + tiles * 4)]
    assert trace.BYTES == before          # CPU copies are not counted
