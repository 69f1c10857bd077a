"""device_kernels_per_image.lossless: kernels the device ran per image of
the traced requests (the predictor search's PyTorch kernels; copies and
sets left out)."""

from benchmark.harness.readings import device_kernels_per_image


def read(r):
    return device_kernels_per_image(r)
