"""host_glue_ms_per_request: the wall time of each request's `encode`
span less the part its `tail` and `encode.fetch` spans cover, averaged
over the window's requests: the host plan, the upload, the enqueue, the
unpacking and the container."""

from benchmark.harness.program import glue_ms_per_request


def read(r):
    return glue_ms_per_request(r)
