"""What a run hands to the metric readers (benchmark/metrics/<name>.py),
and the arithmetic they share. A reader's read(r) returns a number, or
None where the run has nothing for it to read."""

from __future__ import annotations

from dataclasses import dataclass, field

from . import roofline as RF
from . import window as W


@dataclass
class Readings:
    cell: dict
    mix: dict
    options: dict
    sizes: list                 # (w, h) of each pool item
    t0: float                   # the window's start (host clock)
    requests: list              # every request of the window
    setup_s: float
    host_tail: list = None      # host-clock intervals of the host tail
    trace: object = None        # trace.TraceData of the traced requests
    traced: list = field(default_factory=list)
    program: list = None        # program.Span of a traced window
    counters: dict = field(default_factory=dict)  # the package's, window

    def served(self, reqs=None) -> list:
        return [r for r in (self.requests if reqs is None else reqs)
                if not r.error]

    def items(self, reqs=None) -> int:
        return sum(len(r.items) for r in self.served(reqs))

    def pixels(self, reqs=None) -> int:
        return sum(self.sizes[i][0] * self.sizes[i][1]
                   for r in self.served(reqs) for i in r.items)


def mpx_per_s(r: Readings):
    if not r.served():
        return None
    return W.rate(r.pixels() / 1e6, r.t0, r.requests)


def p95_ms(r: Readings):
    lat = [q.latency for q in r.served()]
    return W.p95(lat) * 1e3 if lat else None


def host_tail_ms_per_image(r: Readings):
    """The union of the intervals in which any host tail ran, per image
    of the window: threads that overlap are counted once."""
    if not r.host_tail or not r.items():
        return None
    return W.covered(r.host_tail) / r.items() * 1e3


def device_kernels_per_image(r: Readings):
    if r.trace is None or not r.items(r.traced):
        return None
    n = len(r.trace.kernels_in_window())
    return n / r.items(r.traced) if n else None


def device_busy_ms_per_request(r: Readings):
    if r.trace is None or not r.served(r.traced):
        return None
    busy = r.trace.busy_s()
    return busy / len(r.served(r.traced)) * 1e3 if busy > 0 else None


def device_idle_pct(r: Readings):
    if r.trace is None or r.trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - r.trace.busy_s() / r.trace.window_s)


def _batches(r: Readings) -> list:
    """[(pool items, outputs)] of each device batch of the traced
    requests: the stream's batches of call_options["batch"], or one
    image per encode()."""
    per = int(r.mix.get("call_options", {}).get("batch", 8)) \
        if r.mix["entry"] == "encode_lossy_stream" else 1
    out = []
    for q in r.served(r.traced):
        for k in range(0, len(q.items), per):
            out.append((q.items[k:k + per], q.outputs[k:k + per]))
    return out


def kernel_shares(r: Readings, kernels):
    """(summed bounds, summed profiler time) in seconds of the traced
    launches of `kernels` (names of roofline.KERNEL_NAMES), each launch's
    bound at its device batch's shape. The program launches each kernel
    once per device batch; where the trace holds another number of
    launches of any of them, the launches cannot be matched to their
    shapes: it says which kernel and returns None, so that the share
    never covers fewer kernels than it names."""
    if r.trace is None:
        return None
    from benchmark.reference.decode import partition0_modes

    times: dict = {}
    launches: dict = {}
    for name, s, e in r.trace.kernels_in_window():
        k = RF.kernel_of(name)
        if k in kernels:
            times[k] = times.get(k, 0.0) + (e - s)
            if RF.kernel_name(name) == RF.KERNEL_NAMES[k][0]:
                launches[k] = launches.get(k, 0) + 1
    batches = _batches(r)
    unmatched = [k for k in kernels if launches.get(k, 0) != len(batches)]
    if unmatched or not batches:
        print(f"# roofline of {list(kernels)}: not read; launches "
              f"{ {k: launches.get(k, 0) for k in unmatched} } against "
              f"{len(batches)} device batches", flush=True)
        return None
    use_td = int(r.options.get("sns_strength", 50)) > 0
    bound = spent = 0.0
    for k in kernels:
        for items, outs in batches:
            w, h = r.sizes[items[0]]
            n_i4 = sum(partition0_modes(o)["i4"] for o in outs) \
                if k == "p2_wavefront" else 0
            nb, no = RF.kernel_work(k, len(items), (w + 15) // 16,
                                    (h + 15) // 16, use_td, n_i4)
            bound += RF.bound_s(nb, no)[0]
        spent += times[k]
    return bound, spent


def roofline_pct(r: Readings, kernels):
    shares = kernel_shares(r, kernels)
    if shares is None or shares[1] <= 0:
        return None
    return 100.0 * shares[0] / shares[1]
