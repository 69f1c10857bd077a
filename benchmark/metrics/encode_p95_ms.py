"""encode_p95_ms: the 95th percentile of one encode() request's
latency, over every request of the window."""

from benchmark.harness.readings import p95_ms


def read(r):
    if r.mix["entry"] != "encode":
        return None
    return p95_ms(r)
