"""The measured package's own spans (webp_tpu_torch.trace) and what the
per-layer readers compute from them.

start() turns the package's tracer on and stop() turns it off and takes
its records, as Spans on the host clock (time.perf_counter's seconds, the
clock of the run's request times). A run calls them around its window,
and only with --trace 1; an untraced run has no spans, and every span
reader then returns None. The package's counters are always on: a run
resets them after its warm-up and reads them after its window.

Readings carry the spans as `r.program` (a list of Span, None where the
run took none) and the counters as `r.counters`. A span's self time is
its wall time less the part of it that its children cover; a child may
run on another thread (the stream's tails under their batch's drain).
"""

from __future__ import annotations

from typing import NamedTuple

from . import window as W

TAIL_STAGES = ("tail.unpack", "tail.plan", "tail.probas", "tail.tokens",
               "tail.partition0", "tail.assemble")


class Span(NamedTuple):
    name: str
    start: float                # host clock, s
    end: float
    cpu: float                  # the thread's CPU time inside it, s
    thread: int
    parent: int                 # index in the same list, -1 for a root

    @property
    def wall(self) -> float:
        return self.end - self.start


def start() -> None:
    """Turns the package's tracer on, its earlier records dropped."""
    from webp_tpu_torch import trace

    trace.take()
    trace.enable()


def stop() -> list:
    """Turns the tracer off and returns its records as Spans."""
    from webp_tpu_torch import trace

    trace.disable()
    return [Span(s.name, s.start * 1e-9, s.end * 1e-9, s.cpu * 1e-9,
                 s.thread, s.parent) for s in trace.take()]


def counters() -> dict:
    """The package's counters (trace.COUNTERS)."""
    from webp_tpu_torch import trace

    return trace.counters()


def reset_counters() -> None:
    """Sets every count of the package's counters to 0."""
    from webp_tpu_torch import trace

    trace.reset_counters()


def spans_of(r) -> list:
    return r.program or []


def named(spans, name: str) -> list:
    return [s for s in spans if s.name == name]


def depths(spans) -> list:
    """Each span's number of ancestors."""
    out = []
    for s in spans:
        out.append(0 if s.parent < 0 else out[s.parent] + 1)
    return out


def descendants(spans, i: int) -> list:
    """Indices of the spans under span i (a parent precedes its
    children in the list)."""
    under = {i}
    out = []
    for j in range(i + 1, len(spans)):
        if spans[j].parent in under:
            under.add(j)
            out.append(j)
    return out


def covered_within(s: Span, others) -> float:
    """The part of s's interval that the spans `others` cover."""
    return W.covered(W.clip([(o.start, o.end) for o in others],
                            s.start, s.end))


def self_s(spans) -> list:
    """Each span's self time: its wall time less what its children
    cover."""
    kids: dict = {}
    for s in spans:
        if s.parent >= 0:
            kids.setdefault(s.parent, []).append(s)
    return [s.wall - covered_within(s, kids.get(i, ()))
            for i, s in enumerate(spans)]


def per_name(spans) -> dict:
    """{name: (count, wall s, cpu s, self s)}, summed over the spans of
    that name."""
    out: dict = {}
    for s, own in zip(spans, self_s(spans)):
        n, w, c, o = out.get(s.name, (0, 0.0, 0.0, 0.0))
        out[s.name] = (n + 1, w + s.wall, c + s.cpu, o + own)
    return out


def summary_lines(spans, n_images: int) -> list:
    """One line per span name (the tail's stages first): count, and
    wall, CPU and self time per image."""
    if not spans or n_images <= 0:
        return []
    sums = per_name(spans)
    order = [n for n in TAIL_STAGES if n in sums] + sorted(
        n for n in sums if n not in TAIL_STAGES)
    return [f"program span {n}: {sums[n][0]} spans; per image wall "
            f"{sums[n][1] / n_images * 1e3:.3f} ms, cpu "
            f"{sums[n][2] / n_images * 1e3:.3f} ms, self "
            f"{sums[n][3] / n_images * 1e3:.3f} ms" for n in order]


# -- the readers' arithmetic ---------------------------------------------

def tail_cpu_ms_per_image(r):
    """The summed thread CPU time of the tail spans per image of the
    window."""
    tails = named(spans_of(r), "tail")
    if not tails or not r.items():
        return None
    return sum(s.cpu for s in tails) / r.items() * 1e3


def tail_wait_ms_per_image(r):
    """The summed wall time less thread CPU time of the tail spans per
    image of the window: the time a tail's thread was runnable or
    blocked but not running (the GIL, the cores)."""
    tails = named(spans_of(r), "tail")
    if not tails or not r.items():
        return None
    return sum(s.wall - s.cpu for s in tails) / r.items() * 1e3


def mean_wall_ms(r, name: str):
    """The mean wall time of the spans named `name` (one per device batch
    for device.program, one per batch for stream.upload)."""
    spans = named(spans_of(r), name)
    if not spans:
        return None
    return sum(s.wall for s in spans) / len(spans) * 1e3


def _roots(spans, name: str) -> list:
    return [i for i, s in enumerate(spans) if s.name == name and s.parent < 0]


def glue_ms_per_request(r):
    """Per encode request: the wall time of its encode span less the part
    its tail and encode.fetch spans cover."""
    spans = spans_of(r)
    roots = _roots(spans, "encode")
    if not roots:
        return None
    total = 0.0
    for i in roots:
        out = [spans[j] for j in descendants(spans, i)
               if spans[j].name in ("tail", "encode.fetch")]
        total += spans[i].wall - covered_within(spans[i], out)
    return total / len(roots) * 1e3


def per_root_ms(r, root: str, name: str):
    """The summed wall time of the spans named `name` per root span
    `root` (one per request)."""
    spans = spans_of(r)
    roots = _roots(spans, root)
    inner = named(spans, name)
    if not roots or not inner:
        return None
    return sum(s.wall for s in inner) / len(roots) * 1e3


# -- the idle gaps ----------------------------------------------------------

def idle_gaps(t, spans, host_spans: dict) -> list:
    """[[label, seconds]] of every stretch of the traced window in which
    the device ran nothing, longest first. Each is labelled by the
    deepest program span, on any thread, that covers its middle (the
    latest started among equals); a gap no program span covers takes the
    name of the first of host_spans (name -> host-clock intervals) that
    covers its middle, else "between requests". Host times move to the
    trace's clock by the offset the request ranges give (t.offset)."""
    d = depths(spans)
    live = sorted(((s.start + t.offset, s.end + t.offset, k, s.name)
                   for s, k in zip(spans, d)
                   if s.end + t.offset > t.lo and s.start + t.offset < t.hi),
                  key=lambda x: x[0])
    old = {k: W.union([(s + t.offset, e + t.offset) for s, e in v])
           for k, v in host_spans.items()}
    out = []
    for s, e in W.gaps([(a, b) for _, a, b in t.device], t.lo, t.hi):
        mid = (s + e) / 2
        best = None
        for a, b, k, name in live:
            if a > mid:
                break
            if b >= mid and (best is None or k >= best[0]):
                best = (k, name)
        if best is not None:
            label = best[1]
        else:
            label = next((k for k, v in old.items()
                          if any(a <= mid <= b for a, b in v)),
                         "between requests")
        out.append([label, e - s])
    return sorted(out, key=lambda g: -g[1])


def labelled_share(gaps, spans) -> float:
    """The share of the idle time whose label is a program span's name."""
    names = {s.name for s in spans}
    total = sum(g for _, g in gaps)
    if total <= 0:
        return 0.0
    return sum(g for n, g in gaps if n in names) / total
