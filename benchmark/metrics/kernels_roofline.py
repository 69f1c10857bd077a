"""kernels_roofline: the four hand-written kernels' summed least
times (benchmark/harness/roofline.py, at the traced batches' shapes)
over their summed profiler times; nothing where any of them did not run
once per device batch."""

from benchmark.harness.readings import roofline_pct


def read(r):
    return roofline_pct(r, ("p1_alpha", "p1_mode", "i4_search",
                            "p2_wavefront"))
