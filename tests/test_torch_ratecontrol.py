"""What the decoder unblocks in encode(), on the CPU, byte for byte
against webp_tpu: backend="host" (the exact host encoder) at methods 0,
4 and 6 and with sharp YUV; autofilter on both backends (the device
path's probe-decodes its bitstream with the native decoder); target_size
and target_psnr on the host backend; and the default backends: the
port's encode(img) is webp_tpu.encode(img, backend="device") and the
port's encode(img, backend="host") is webp_tpu.encode(img) (whose
default backend is "host"); "auto" runs the device program, as the
reference's does whenever a device exists. LAST_STATS is compared field
by field.

The reference's device program compiles once per geometry and quality
(~30 s cold here), so the device cases share one geometry at the
default quality; rate control on the device backend moves the quality
every pass, so there the reference's controller (its
_encode_lossy_rate_controlled) is driven with the port's device encode
as its per-pass encoder, and must pick the same passes and file as the
port's own controller."""

import dataclasses

import numpy as np
import pytest

import webp_tpu
import webp_tpu_torch
from test_torch_encode import _images
from webp_tpu import encoder as ENC_ref
from webp_tpu_torch import encoder as ENC

IMG = _images(1, 48, 64, 21)[0]


def _stats():
    return dataclasses.astuple(ENC.LAST_STATS)


def _ref_stats():
    return dataclasses.astuple(ENC_ref.LAST_STATS)


@pytest.mark.parametrize("opts", [
    dict(method=0), dict(method=4), dict(method=6),
    dict(use_sharp_yuv=True), dict(autofilter=True),
    dict(autofilter=True, filter_type=0, method=6),
    dict(preprocessing=2, filter_sharpness=3)], ids=str)
def test_host_backend_equals_reference_default(opts):
    """backend="host" writes the file of the reference's default backend,
    with its PSNR from the host reconstruction."""
    got = webp_tpu_torch.encode(IMG, backend="host", **opts)
    stats = _stats()
    assert got == webp_tpu.encode(IMG, **opts)
    assert stats == _ref_stats()
    assert stats[0] > 20.0


@pytest.mark.parametrize("opts", [
    dict(target_size=1500), dict(target_size=600),
    dict(target_size=1500, method=6), dict(target_psnr=30.0),
    dict(target_psnr=38.0, method=4), dict(target_psnr=60.0)], ids=str)
def test_host_rate_control_equals_reference(opts):
    """Rate control on the host backend: the probes, the landing pass and
    the corrective passes pick the reference's quality and file, with
    its pass count and the decoded file's PSNR in LAST_STATS."""
    got = webp_tpu_torch.encode(IMG, backend="host", **opts)
    stats = _stats()
    assert got == webp_tpu.encode(IMG, **opts)
    assert stats == _ref_stats()
    assert stats[3] >= 2                    # passes


@pytest.fixture(scope="module")
def reference_device():
    """The reference's device files (one compiled program: the default
    options at 64x48), with their LAST_STATS."""
    out = {}
    for name, opts in (("default", {}), ("autofilter", dict(autofilter=True)),
                       ("auto", dict(backend="auto"))):
        opts = dict(dict(backend="device"), **opts)
        out[name] = (webp_tpu.encode(IMG, **opts), _ref_stats())
    return out


@pytest.mark.parametrize("name,opts", [
    ("default", {}), ("autofilter", dict(autofilter=True)),
    ("auto", dict(backend="auto"))], ids=str)
def test_device_backends_equal_reference(reference_device, name, opts):
    """The port's default backend is the device program: encode(img)
    (here on the CPU's plain versions) equals webp_tpu.encode(img,
    backend="device"); so does "auto"; and autofilter on the device path
    (probe decode with the filter off, the host's strength search, PSNR
    from the probe's reconstruction) equals the reference's."""
    assert ENC.EncoderOptions().backend == "device"
    got = webp_tpu_torch.encode(IMG, device="cpu", **opts)
    want, want_stats = reference_device[name]
    assert got == want
    assert _stats() == want_stats
    if name == "autofilter":
        assert want_stats[0] > 20.0
        assert got != reference_device["default"][0]


@pytest.mark.parametrize("opts", [
    dict(target_size=1500), dict(target_size=600, method=6),
    dict(target_psnr=32.0)], ids=str)
def test_device_rate_control_follows_the_reference_controller(
        monkeypatch, opts):
    """The port's controller on the device backend (device="cpu") picks
    the passes and the file that the reference's controller picks when
    each of its passes is the port's device encode."""
    passes = []

    def port_pass(a, o, _yuv_cache=None):
        fields = {f.name: getattr(o, f.name)
                  for f in dataclasses.fields(ENC.EncoderOptions)}
        passes.append((fields["quality"], fields["method"]))
        return webp_tpu_torch.encode(a, device="cpu", **fields)

    got = webp_tpu_torch.encode(IMG, device="cpu", **opts)
    stats = _stats()
    monkeypatch.setattr(ENC_ref, "_encode_lossy", port_pass)
    want = ENC_ref._encode_lossy_rate_controlled(
        IMG, ENC_ref.EncoderOptions(backend="device", **opts))
    assert got == want
    assert stats == _ref_stats()
    assert len(passes) == stats[3] >= 2
    if opts.get("method", 4) > 2:
        assert passes[0][1] == 2 and passes[-1][1] == opts.get("method", 4)
