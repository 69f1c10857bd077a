"""The measured window and the arithmetic on it.

A request that starts before the window closes runs to completion and
counts. A rate is all the work completed over the time from the window's
start to the last completion; a tail is taken over every request of the
window.
"""

from __future__ import annotations

import statistics
import time
from dataclasses import dataclass, field


@dataclass
class Request:
    items: list                 # pool indices
    due: float                  # when it was sent (host clock)
    start: float = 0.0
    end: float = 0.0
    outputs: list = field(default_factory=list)
    error: str = ""

    @property
    def latency(self) -> float:
        return self.end - self.due


def run_closed(call, requests, seconds: float, after=None,
               clock=time.perf_counter):
    """One caller: sends each request when the previous reply is in,
    while the window is open. after(request), if given, runs once a
    request is timed. Returns (t0, [Request])."""
    done = []
    t0 = clock()
    for items in requests:
        now = clock()
        if now - t0 >= seconds:
            break
        done.append(_serve(call, Request(items, now), after, clock))
    return t0, done


def _serve(call, req: Request, after, clock) -> Request:
    req.start = clock()
    try:
        req.outputs = call(req.items)
    except Exception as e:  # a failed request counts as failed, not fatal
        req.error = f"{type(e).__name__}: {e}"
    req.end = clock()
    if after is not None:
        after(req)
    return req


def rate(work: float, t0: float, requests) -> float:
    """Work per second from the window's start to the last completion."""
    ends = [r.end for r in requests if not r.error]
    if not ends or max(ends) <= t0:
        return 0.0
    return work / (max(ends) - t0)


def p95(values) -> float:
    """The 95th percentile (statistics.quantiles, inclusive method)."""
    values = list(values)
    if len(values) == 1:
        return values[0]
    return statistics.quantiles(values, n=20, method="inclusive")[18]


def union(intervals) -> list:
    """Merged [(start, end)] of possibly overlapping intervals."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def covered(intervals) -> float:
    """Total length of the union of the intervals."""
    return sum(e - s for s, e in union(intervals))


def clip(intervals, lo: float, hi: float) -> list:
    return [(max(s, lo), min(e, hi)) for s, e in intervals
            if e > lo and s < hi]


def gaps(intervals, lo: float, hi: float) -> list:
    """[(start, end)] of [lo, hi] not covered by the intervals."""
    out, t = [], lo
    for s, e in union(clip(intervals, lo, hi)):
        if s > t:
            out.append((t, s))
        t = max(t, e)
    if hi > t:
        out.append((t, hi))
    return out
