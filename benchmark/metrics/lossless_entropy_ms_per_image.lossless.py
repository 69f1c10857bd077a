"""lossless_entropy_ms_per_image.lossless: the wall time of the package's
`lossless.entropy` spans (the native entropy coder: LZ77, colour cache,
Huffman codes, emission) per `encode` request of the window, one image
each."""

from benchmark.harness.program import per_root_ms


def read(r):
    return per_root_ms(r, "encode", "lossless.entropy")
