"""lossless_predict_ms_per_image.lossless: the wall time of the package's
`lossless.predict` spans (the predictor search whole: the upload, the
search on the card, the copy back and the host's conversion) per
`encode` request of the window, one image each."""

from benchmark.harness.program import per_root_ms


def read(r):
    return per_root_ms(r, "encode", "lossless.predict")
