"""No native library in the reference: every caller takes its Python
path."""


def get():
    return None


def available() -> bool:
    return False


def vp8_compute_alphas(*args):
    return None


def vp8_encode_mbs(*args):
    return None
