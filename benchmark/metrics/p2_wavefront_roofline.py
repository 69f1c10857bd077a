"""p2_wavefront_roofline: kernel 4 (the phase-2 wavefront and its
escape-list pass): its least time at the traced batches' shapes, with the
I4 macroblocks the files' partition 0 holds, over its profiler time."""

from benchmark.harness.readings import roofline_pct


def read(r):
    return roofline_pct(r, ("p2_wavefront",))
