"""The benchmark's own spans around layer boundaries of the measured
package. They wrap a class attribute for the length of a traced run and
record host-clock intervals; the package itself is not changed."""

from __future__ import annotations

import threading
import time


class Span:
    """Records the host-clock interval of every call of `owner.attr`, on
    every thread, while the span is entered."""

    def __init__(self, owner, attr: str, clock=time.perf_counter):
        self.owner, self.attr, self.clock = owner, attr, clock
        self.intervals: list = []
        self._lock = threading.Lock()
        self._orig = None

    def __enter__(self):
        orig = self._orig = getattr(self.owner, self.attr)
        span = self

        def timed(*args, **kwargs):
            t = span.clock()
            try:
                return orig(*args, **kwargs)
            finally:
                end = span.clock()
                with span._lock:
                    span.intervals.append((t, end))

        setattr(self.owner, self.attr, timed)
        return self

    def __exit__(self, *exc):
        setattr(self.owner, self.attr, self._orig)
        return False


def host_tail():
    """The host tail's boundary: DeviceVP8Encoder.finish, which unpacks
    one image's device fields, entropy-codes them and assembles the
    frame. The stream's pool and encode() both call it."""
    from webp_tpu_torch.lossy.device_encode import DeviceVP8Encoder

    return Span(DeviceVP8Encoder, "finish")
