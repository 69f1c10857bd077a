"""host_tail_cpu_ms_per_image: the thread CPU time of the package's
`tail` spans (DeviceVP8Encoder.finish), summed over the window and
divided by its images."""

from benchmark.harness.program import tail_cpu_ms_per_image


def read(r):
    return tail_cpu_ms_per_image(r)
