"""device_idle_pct.lossless: the share of the traced window in which the
device ran nothing."""

from benchmark.harness.readings import device_idle_pct


def read(r):
    return device_idle_pct(r)
