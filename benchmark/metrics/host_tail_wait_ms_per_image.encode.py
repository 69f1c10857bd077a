"""host_tail_wait_ms_per_image: the wall time less the thread CPU time
of the package's `tail` spans, summed over the window and divided by its
images: the pool's wait for the GIL and for cores."""

from benchmark.harness.program import tail_wait_ms_per_image


def read(r):
    return tail_wait_ms_per_image(r)
