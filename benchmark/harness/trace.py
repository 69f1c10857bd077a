"""The device trace of a traced run: torch.profiler over the first
requests of the window, read in memory (no trace file is written).

From the profiler's raw events it keeps the device activities (kernels,
copies and sets, with their start and end) and the benchmark's own
request ranges (record_function "bench.request" on the calling thread),
which place the traced window and tie the host clock to the trace's.
"""

from __future__ import annotations

import statistics
from dataclasses import dataclass, field

import torch

from . import window as W

MARKER = "bench.request"


@dataclass
class TraceData:
    device: list                # [(name, start_s, end_s)] device activities
    markers: list               # [(start_s, end_s)] request ranges
    offset: float = 0.0         # trace time = host clock + offset
    kernels: list = field(default_factory=list)   # device minus copies/sets

    @property
    def lo(self) -> float:
        return min(s for s, _ in self.markers)

    @property
    def hi(self) -> float:
        return max(e for _, e in self.markers)

    @property
    def window_s(self) -> float:
        return self.hi - self.lo

    def busy_s(self) -> float:
        return W.covered(W.clip([(s, e) for _, s, e in self.device],
                                self.lo, self.hi))

    def kernels_in_window(self) -> list:
        return [(n, s, e) for n, s, e in self.kernels
                if s >= self.lo and e <= self.hi]


def is_copy(name: str) -> bool:
    return name.startswith(("Memcpy", "Memset", "memcpy", "memset"))


class DeviceTrace:
    """Profiles the card from start() to stop(); read() returns the
    TraceData. host_starts: the host-clock starts of the traced requests,
    in order, to align the two clocks. Starting takes seconds (CUPTI's
    set-up) and stopping seconds per million device activities, so a run
    starts it before its window and stops it between requests."""

    def __init__(self):
        self._prof = None
        self.on = False

    def start(self) -> None:
        acts = [torch.profiler.ProfilerActivity.CPU,
                torch.profiler.ProfilerActivity.CUDA]
        self._prof = torch.profiler.profile(activities=acts)
        self._prof.__enter__()
        self.on = True

    @staticmethod
    def request_range():
        return torch.profiler.record_function(MARKER)

    def stop(self) -> None:
        torch.cuda.synchronize()
        self._prof.__exit__(None, None, None)
        self.on = False

    def read(self, host_starts) -> TraceData:
        device, markers = [], []
        for e in self._prof.profiler.kineto_results.events():
            s = e.start_ns() * 1e-9
            end = s + e.duration_ns() * 1e-9
            on_card = e.device_type() == torch.autograd.DeviceType.CUDA
            if e.name() == MARKER or e.is_user_annotation():
                # A range also shows on the device's timeline as an
                # annotation: it is no device work.
                if e.name() == MARKER and not on_card:
                    markers.append((s, end))
            elif on_card:
                device.append((e.name(), s, end))
        markers.sort()
        offset = 0.0
        if markers and host_starts:
            offset = statistics.median(
                m[0] - h for m, h in zip(markers, host_starts))
        device.sort(key=lambda d: d[1])
        kernels = [d for d in device if not is_copy(d[0])]
        self._prof = None
        return TraceData(device, markers, offset, kernels)


def short_name(name: str, limit: int = 96) -> str:
    """A kernel's name without its argument list and without an anonymous
    namespace's prefix, at most `limit` long."""
    base = name.replace("(anonymous namespace)::", "")
    base = base.split("(", 1)[0].strip() or base
    return base[:limit]


def device_ops(t: TraceData, top: int = 10) -> list:
    """[[name, seconds]] of the device operations that took most time in
    the traced window."""
    sums: dict = {}
    for n, s, e in t.device:
        if e > t.lo and s < t.hi:
            key = short_name(n)
            sums[key] = sums.get(key, 0.0) + min(e, t.hi) - max(s, t.lo)
    return [[n, v] for n, v in sorted(sums.items(), key=lambda kv: -kv[1])
            [:top]]
