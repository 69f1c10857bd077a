"""stream_upload_ms_per_batch: the mean wall time of the package's
`stream.upload` spans, one per batch: padding and YUV import on the
pool, stacking, pinned staging and the side-stream copy."""

from benchmark.harness.program import mean_wall_ms


def read(r):
    return mean_wall_ms(r, "stream.upload")
