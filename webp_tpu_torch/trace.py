"""Spans and counters at the package's layer boundaries, kept in memory.

Spans are off until enable(). With tracing on, `with span(name):` records
one Span: its name, its start and end on time.perf_counter_ns's clock
(time.perf_counter's, in nanoseconds), the CPU time its thread spent
inside it (time.thread_time_ns), the thread's native id and the index of
its parent span in the same take() list (-1 for a root). The parent is
the innermost span open on the same thread; a function handed to a pool
thread through carry(fn) takes as parent the span that was open where
carry was called. take() returns the records and clears them; call it
between requests, with no span open. With tracing off, span() returns one
shared no-op context manager, and carry() returns its function.

The span names (fixed, so that metrics can cite them):

    encode                 encoder.encode, every backend
      encode.plan          MB padding, the host planes autofilter reads
      encode.upload        the image to the device
      device.program       the host's enqueue of the device program
      encode.fetch         the blocking copy of the blob to the host
      encode.unpack        unpack_output_blob
      tail                 DeviceVP8Encoder.finish, the host tail:
        tail.plan, tail.code (the probabilities and token partitions,
        one native call), tail.partition0, tail.assemble
        (lossy/frame.py's writer)
      fallback             the exact host re-encode of an escape overflow
      encode.wrap          PSNR, LAST_STATS, the container
      lossless             lossless/encode.py encode_vp8l, encode_vp8l_argb:
                           one VP8L image (also under the ALPH thread's
                           carried parent, the lossy `encode`)
        lossless.prep      RGBA->ARGB, the transparent cleanup,
                           near-lossless, build_palette, apply_palette,
                           subtract-green
        lossless.predict   predictor_transform whole: the upload, the
                           search (on the device or native), the fetch
        lossless.cross_color  the native cross-color search
        lossless.entropy   each call of the native entropy coder
    stream                 encode_lossy_stream
      stream.upload        one batch's upload (the upload thread)
        stream.prep        one image's padding and YUV import (a pool thread)
        stream.pin         stacking, pinned staging, the side-stream copy
      device.program
      stream.drain         one batch's drain
        stream.fetch_wait  the wait on the batch's copy-back event
        encode.unpack
        tail, fallback     each image's host tail (pool threads)
    decode                 decode and decode_rgba, every backend
      decode.parse         the native token parse, the per-MB filter inputs
      decode.upload        the input arrays to the device
      device.program
      decode.fetch         the blocking copy of the pixels to the host

Counters are always on: COUNTERS maps a group's name to its dict of
counts, and count() adds to one under a lock. The groups: "launches"
(kernel launches by kernel, ops/cuda.py LAUNCHES), "fallbacks" (images
re-encoded on the host, lossy/device_encode.py FALLBACKS), "programs"
({"built": FastEncoder constructions, decode step loops and CUDA graph
captures}), "bytes" ({"h2d", "d2h": bytes the entry points and the
lossless predictor search copy to and from a CUDA device}),
"lossless" (lossless/encode.py LOSSLESS: {"images": VP8L images encoded,
"candidates": transform configurations encoded in full, "entropy_calls",
"entropy_pixels": the native entropy coder's calls and their pixels}) and
"native" ({"calls": calls into the native encoder library through
native/api.py's wrappers, each a GIL hand-off: partition 0, a frame's
tokens, the host MB loop, the analysis alphas, the YUV importer, powf})
and "frames" (lossy/frame.py code_tokens: {"packed": frames coded
straight from the device's packed levels, "dense": from dense levels}).
"""

from __future__ import annotations

import functools
import threading
import time

_on = False
_lock = threading.Lock()
_records: list = []
_local = threading.local()


class _NoSpan:
    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NOOP = _NoSpan()


def _stack() -> list:
    """The indices of the spans open on this thread, innermost last."""
    try:
        return _local.stack
    except AttributeError:
        _local.stack = []
        return _local.stack


class Span:
    """One recorded span (see the module's docstring); times in ns."""

    __slots__ = ("name", "start", "end", "cpu", "thread", "parent",
                 "_index", "_cpu0")

    def __init__(self, name: str):
        self.name = name
        self.start = self.end = self.cpu = self.thread = 0

    def __enter__(self):
        stack = _stack()
        self.parent = stack[-1] if stack else -1
        with _lock:
            self._index = len(_records)
            _records.append(self)
        stack.append(self._index)
        self.thread = threading.get_native_id()
        # The CPU clock is read inside the wall interval: cpu <= wall.
        self.start = time.perf_counter_ns()
        self._cpu0 = time.thread_time_ns()
        return self

    def __exit__(self, *exc):
        self.cpu = time.thread_time_ns() - self._cpu0
        self.end = time.perf_counter_ns()
        _stack().pop()
        return False


def span(name: str):
    """A context manager that records a span named `name` while tracing
    is on; the shared no-op one while it is off."""
    if not _on:
        return NOOP
    return Span(name)


def traced(name: str):
    """Decorator: each call of the function runs inside span(name)."""
    def wrap(fn):
        @functools.wraps(fn)
        def run(*args, **kwargs):
            with span(name):
                return fn(*args, **kwargs)
        return run
    return wrap


def carry(fn):
    """fn, to be run on another thread under the span open here (its
    parent there); fn itself while tracing is off."""
    if not _on:
        return fn
    stack = _stack()
    parent = stack[-1] if stack else -1

    @functools.wraps(fn)
    def run(*args, **kwargs):
        s = _stack()
        s.append(parent)
        try:
            return fn(*args, **kwargs)
        finally:
            s.pop()
    return run


def enable() -> None:
    global _on
    _on = True


def disable() -> None:
    global _on
    _on = False


def take() -> list:
    """The spans recorded since the last take(), in the order they were
    opened (a parent before its children); clears them."""
    global _records
    with _lock:
        out, _records = _records, []
    return out


COUNTERS: dict = {}


def register(name: str, counts: dict) -> dict:
    """Adds the group `counts` under `name` and returns it (the same dict:
    its owner keeps reading and resetting it)."""
    COUNTERS[name] = counts
    return counts


def count(group: dict, key, n: int = 1) -> None:
    with _lock:
        group[key] += n


def counters() -> dict:
    """A copy of every group's counts."""
    with _lock:
        return {name: dict(g) for name, g in COUNTERS.items()}


def reset_counters() -> None:
    with _lock:
        for g in COUNTERS.values():
            for k in g:
                g[k] = 0


PROGRAMS = register("programs", {"built": 0})
BYTES = register("bytes", {"h2d": 0, "d2h": 0})
NATIVE = register("native", {"calls": 0})
FRAMES = register("frames", {"packed": 0, "dense": 0})
