"""decode_mpx_s: megapixels decoded per second, over the window to
the last completion."""

from benchmark.harness.readings import mpx_per_s


def read(r):
    if r.mix["entry"] != "decode":
        return None
    return mpx_per_s(r)
