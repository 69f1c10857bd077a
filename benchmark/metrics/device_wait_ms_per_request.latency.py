"""device_wait_ms_per_request: the wall time of the package's
`encode.fetch` spans (the blocking copy of the blob, which waits for the
device program to end) per `encode` request of the window."""

from benchmark.harness.program import per_root_ms


def read(r):
    return per_root_ms(r, "encode", "encode.fetch")
