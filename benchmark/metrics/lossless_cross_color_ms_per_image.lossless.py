"""lossless_cross_color_ms_per_image.lossless: the wall time of the
package's `lossless.cross_color` spans (the native cross-color search and
its application) per `encode` request of the window, one image each."""

from benchmark.harness.program import per_root_ms


def read(r):
    return per_root_ms(r, "encode", "lossless.cross_color")
