"""The port on the card: each kernel against its plain version on the
slice's inputs, and the card's files against the CPU run's, byte for
byte. These tests import neither JAX nor the reference package, so they
also run on a machine with a card and no JAX:

    python -m pytest --noconftest -m cuda -p no:cacheprovider tests/test_torch_cuda.py

Without a card they skip, except the check that the default device
never falls back to the CPU."""

import os

import numpy as np
import pytest

import torch

import webp_tpu_torch


def _images(n, h, w, seed):
    """Smooth gradients, a textured patch, hard edges and stripes."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    out = []
    for i in range(n):
        img = np.stack([x * 255 // (w - 1), y * 255 // (h - 1),
                        ((x + 2 * y) * (3 + i)) % 256], -1).astype(np.int32)
        img[: h // 2, w // 2:] += rng.integers(-60, 60, (h // 2, w - w // 2,
                                                         3))
        img[h // 2:, : w // 3] = rng.integers(0, 256, 3)
        img[:, (5 + 7 * i) % w::11] = 255 * (i % 2)
        out.append(np.clip(img, 0, 255).astype(np.uint8))
    return out


def test_default_device_is_the_card_and_never_falls_back():
    """device=None asks for the card: without one it raises rather than
    running the plain versions on the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    with pytest.raises((RuntimeError, AssertionError)):
        webp_tpu_torch.encode_batch(_images(1, 32, 32, 0), 75)


@pytest.mark.cuda
def test_kernels_and_files_on_the_card_equal_plain_versions():
    """On the card: each kernel equals its plain version on the slice's
    inputs, and the files equal the CPU run's byte for byte."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from webp_tpu_torch.ops import cuda
    from webp_tpu_torch.ops import i4_kernel as I4K
    from webp_tpu_torch.ops import p1_kernels as P1K

    calls = {}
    wrappers = {(P1K, "alphas"): P1K.alphas_plain,
                (P1K, "mode_search"): P1K.mode_search_plain,
                (I4K, "i4_scores"): I4K.i4_scores_plain}
    saved = {k: getattr(*k) for k in wrappers}

    def recorder(key):
        def rec(*args):
            calls[key] = args
            return saved[key](*args)
        return rec

    imgs = _images(3, 40, 72, seed=1)
    try:
        for k in wrappers:
            setattr(k[0], k[1], recorder(k))
        cuda.reset_launches()
        on_card = webp_tpu_torch.encode_batch(imgs, 75, device="cuda")
        assert all(n > 0 for n in cuda.LAUNCHES.values()), cuda.LAUNCHES
    finally:
        for k, f in saved.items():
            setattr(k[0], k[1], f)
    assert on_card == webp_tpu_torch.encode_batch(imgs, 75, device="cpu")
    for key, plain in wrappers.items():
        args = calls[key]
        for got, ref in zip(saved[key](*args), plain(*args)):
            if got.is_floating_point():     # scores
                torch.testing.assert_close(got, ref, rtol=3e-7, atol=0)
            else:                           # modes and alphas
                assert torch.equal(got, ref), key


def test_launch_signatures_match_the_cuda_sources():
    """Each kernel's ctypes signature names the same parameters, pointer
    or int, as its `extern "C"` launcher in csrc/ (plus the stream)."""
    import os
    import re

    from webp_tpu_torch import _build
    from webp_tpu_torch.ops import cuda

    assert set(cuda.SIGNATURES) == set(_build.KERNEL_LIBS) == set(
        cuda.LAUNCHES)
    for name in _build.KERNEL_LIBS:
        (src,) = _build.LIBS[name][1]
        with open(os.path.join(_build.HERE, src)) as f:
            text = f.read()
        m = re.search(r'extern "C" int ' + name + r"_launch\(([^)]*)\)", text)
        params = [p.strip() for p in m.group(1).split(",")]
        kinds = ["p" if "*" in p else "i" for p in params]
        assert kinds[-1] == "p" and params[-1].endswith("stream")
        want = ["p" if t is cuda._P else "i" for t in cuda.SIGNATURES[name]]
        assert kinds[:-1] == want, name


def test_kernel_build_without_nvcc_raises_and_can_retry():
    """Where no CUDA toolkit is installed, building a kernel raises a
    clear error, and leaves no lock behind that a retry would wait on."""
    import shutil

    from webp_tpu_torch import _build

    if shutil.which("nvcc") or os.path.exists("/usr/local/cuda/bin/nvcc"):
        pytest.skip("a CUDA toolkit is installed here")
    for _ in range(2):
        with pytest.raises(RuntimeError, match="nvcc"):
            _build.build(["p1_alpha"])
