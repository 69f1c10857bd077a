"""device_busy_ms_per_request: time in which the device ran anything
(the union of the profiler's device activities), per traced request."""

from benchmark.harness.readings import device_busy_ms_per_request


def read(r):
    return device_busy_ms_per_request(r)
