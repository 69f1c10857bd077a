"""host_tail_ms_per_image: the union of the intervals in which any
host tail (DeviceVP8Encoder.finish) ran, per image of the window."""

from benchmark.harness.readings import host_tail_ms_per_image


def read(r):
    return host_tail_ms_per_image(r)
