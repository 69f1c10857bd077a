"""host_parse_ms_per_image: the wall time of the package's
`decode.parse` spans (the native token parse and the per-MB filter
inputs) per `decode` request of the window, one image each."""

from benchmark.harness.program import per_root_ms


def read(r):
    return per_root_ms(r, "decode", "decode.parse")
