"""encode_mpx_s: megapixels of finished WebP files per second, over
the window to the last completion."""

from benchmark.harness.readings import mpx_per_s


def read(r):
    if r.mix["entry"] not in ("encode", "encode_lossy_stream"):
        return None
    return mpx_per_s(r)
