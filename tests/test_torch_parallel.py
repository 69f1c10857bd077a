"""The port's band encoders (webp_tpu_torch/parallel: the row-band
sharded encoder, the exact band pipeline and encode_lossy_mesh) on a
list of CPU devices against the JAX package on a 2-device mesh of its
virtual CPU devices (tests/conftest.py gives JAX 8), every output exact,
and the exact pipeline at 4 bands against the port's single-device
files. Inputs are made from seeds with numpy; the two reference programs
are compiled once, in a module fixture."""

import numpy as np
import pytest

import jax
import torch

import webp_tpu_torch
from webp_tpu.parallel import exact as E_ref
from webp_tpu.parallel import mesh as M_ref
from webp_tpu_torch.lossy import device_encode as DE
from webp_tpu_torch.ops import fastpath as FP
from webp_tpu_torch.parallel import exact as E
from webp_tpu_torch.parallel import mesh as M

B, H, W = 2, 64, 64


def rgbs(n, h, w, seed):
    """A waved colour ramp under noise, with a flat patch and stripes."""
    rng = np.random.default_rng(seed)
    y = np.linspace(0, 1, h)[:, None]
    x = np.linspace(0, 1, w)[None, :]
    base = np.stack([200 * x + 30 * np.sin(9 * y), 180 * y + 20 * np.cos(7 * x),
                     100 + 80 * x * y], -1)
    out = base + rng.normal(0, 14, (n, h, w, 3))
    out[:, h // 4: h // 2, : w // 3] = 90
    out[:, :, 5::13] = 230
    return np.clip(out, 0, 255).astype(np.uint8)


@pytest.fixture(scope="module")
def ref():
    """The reference's sharded encoder on make_mesh(2, dp=1) and its
    exact encoder through encode_lossy_mesh (which caches the compiled
    step in _STEP_CACHE), at B=2 of 64x64, q75, 4 segments, SNS 50."""
    if len(jax.devices()) < 2:
        pytest.skip("needs 2 JAX devices")
    x = rgbs(B, H, W, 30)
    sharded = M_ref.make_sharded_encode_fn(M_ref.make_mesh(2, dp=1))(x)
    files = E_ref.encode_lossy_mesh(list(x), n_devices=2)
    exact = E_ref._STEP_CACHE[(2, B, H, W, 75, 4, 50)](x)
    return dict(x=x, sharded=sharded, files=files, exact=exact)


def _assert_outputs_equal(got, ref):
    names = ("packed", "esc_idx", "esc_val", "esc_cnt", "y2", "modes",
             "uvmodes", "skip", "is_i4", "imodes", "seg_map", "seg_q",
             "seg_beta", "dq_uv", "hist")
    assert len(got) == len(ref) == len(names)
    for name, g, r in zip(names, got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r),
                                      err_msg=name)


def test_sharded_encoder_equals_reference(ref):
    """Two bands of the row-band sharded encoder on ["cpu"] * 2: the
    band-boundary approximation included (source halo, boundary row
    I16), every output and the mesh-wide histogram exact."""
    mesh = M.make_mesh(devices=["cpu"] * 2, dp=1)
    got = M.make_sharded_encode_fn(mesh)(ref["x"])
    _assert_outputs_equal(got, ref["sharded"])
    is_i4 = got[8].numpy()
    assert is_i4.any() and not is_i4.all()
    assert not is_i4[:, 16:20].any(), "band 1's first MB row stays I16"
    per = M.assemble_from_sharded(got, 2, W // 16, H // 16)
    per_ref = M_ref.assemble_from_sharded(ref["sharded"], 2, W // 16,
                                          H // 16)
    for d, r in zip(per, per_ref):
        for k in r:
            np.testing.assert_array_equal(d[k], np.asarray(r[k]),
                                          err_msg=k)


def test_exact_encoder_equals_reference(ref):
    """The exact band pipeline on ["cpu"] * 2 (phase A with the 2-MB-row
    extension through kernel 3's plain version, phase B over T = B + 1
    steps): every output exact against the reference's."""
    mesh = E.make_pipeline_mesh(devices=["cpu"] * 2)
    got = E.make_exact_encode_fn(mesh, B)(ref["x"])
    _assert_outputs_equal(got, ref["exact"])


def test_encode_lossy_mesh_bytes_equal_reference(ref):
    files = E.encode_lossy_mesh(list(ref["x"]), devices=["cpu"] * 2)
    assert files == ref["files"]


def test_exact_encoder_at_four_bands_equals_single_device_files():
    """At 4 bands of one MB row each (the first three extended by the
    band above's last MB row), the pipeline's files equal encode_batch's
    on the same device, byte for byte: the reference's claim that only
    the exact encoder is bit-identical to the single-device encoder."""
    x = rgbs(3, H, W, 31)
    files = E.encode_lossy_mesh(list(x), devices=["cpu"] * 4)
    assert files == DE.encode_lossy_batch(x, device="cpu")


def test_exact_encoder_unsegmented_equals_single_device_files():
    """segments=1 (no phase 0; the static plan) at 2 bands."""
    x = rgbs(2, 32, 48, 32)
    files = E.encode_lossy_mesh(list(x), segments=1, devices=["cpu"] * 2)
    assert files == DE.encode_lossy_batch(x, segments=1, device="cpu")


def test_sharded_encoder_over_dp_equals_single_device_fields():
    """dp=2, sp=1: each image group on its own device, one band each, so
    every field equals the single-device non-planar program's."""
    x = rgbs(2, H, W, 33)
    got = M.make_sharded_encode_fn(M.make_mesh(devices=["cpu"] * 2))(x)
    fn = FP.fast_encode_fn(W // 16, H // 16, 75, 4, 50, True, planar=False)
    want = fn(*fn.to_yuv(torch.as_tensor(x)))
    for name, g in zip(("packed", "esc_idx", "esc_val"), got[:3]):
        assert torch.equal(g, want[name]), name
    assert torch.equal(got[3][:, 0], want["esc_cnt"])
    for i, name in enumerate(("y2", "modes", "uvmodes", "skip", "is_i4",
                              "imodes", "seg_map", "seg_q", "seg_beta",
                              "dq_uv"), start=4):
        assert torch.equal(got[i], want[name]), name


def test_assemble_from_sharded_raises_on_escape_overflow():
    """A band whose escape list overflowed raises OverflowError (the
    reference has no host fallback there)."""
    mesh = M.make_mesh(devices=["cpu"] * 2, dp=1)
    out = list(M.make_sharded_encode_fn(mesh)(rgbs(2, H, W, 34)))
    cap = out[1].shape[1] // 2
    out[3] = out[3].clone()
    out[3][1, 1] = cap + 1
    with pytest.raises(OverflowError, match="band 1 of image 1"):
        M.assemble_from_sharded(out, 2, W // 16, H // 16)


def test_mesh_constructors_and_collectives(monkeypatch):
    """Explicit device lists (repeats allowed), the reference's dp
    default, pass_down (band 0 gets zeros) and psum (every band the
    total); without a visible card the constructors raise."""
    m = M.make_mesh(devices=["cpu"] * 4)
    assert m.shape == {"dp": 4, "sp": 1}
    m = M.make_mesh(devices=["cpu"] * 6)
    assert m.shape == {"dp": 2, "sp": 3}
    assert M.make_mesh(2, devices=["cpu"] * 6).shape == {"dp": 2, "sp": 1}
    p = E.make_pipeline_mesh(3, devices=["cpu"] * 4)
    assert p.shape == {"dp": 1, "sp": 3} and p.devices[0][2].type == "cpu"
    with pytest.raises(ValueError):
        M.Mesh(["cpu"] * 3, dp=2)
    devs = [torch.device("cpu")] * 3
    rows = [torch.full((2, 4), s + 1) for s in range(3)]
    down = M.pass_down(rows, devs)
    assert not down[0].any() and torch.equal(down[2], rows[1])
    assert all(torch.equal(t, torch.full((2, 4), 6))
               for t in M.psum(rows, devs))
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 0)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        M.make_mesh()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        E.make_pipeline_mesh()


def test_stream_takes_the_multi_device_branch():
    """The decision: only when the caller names two or more devices, the
    images are not sharp-YUV and their MB rows (after padding) divide
    over the devices; otherwise the single-device stream on `device`."""
    imgs = list(rgbs(1, H, W, 35))
    two = [torch.device("cuda:0"), torch.device("cuda:1")]
    assert DE._mesh_devices(imgs, ["cuda:0", "cuda:1"], False) == two
    assert DE._mesh_devices(imgs, None, False) is None
    assert DE._mesh_devices(imgs, ["cuda:0"], False) is None
    assert DE._mesh_devices(imgs, two, True) is None
    assert DE._mesh_devices(list(rgbs(1, 48, W, 35)), two, False) is None
    assert DE._mesh_devices(list(rgbs(1, 57, 50, 35)), two, False) == two


def test_stream_multi_device_branch_writes_encode_batchs_files():
    """Given two CPU devices, the stream sends each batch through
    encode_lossy_mesh: the files are encode_batch's (device YUV import),
    whatever host_yuv says, as the reference's branch. They differ from
    the single-device stream's at its host-YUV default on this image
    (the host importer's chroma differs by 1 on some samples; ROADMAP
    queue 3)."""
    imgs = list(rgbs(3, H, W, 36))
    single = DE.encode_lossy_stream(imgs, batch=2, device="cpu")
    files = DE.encode_lossy_stream(imgs, batch=2, host_yuv=True,
                                   device="cpu", devices=["cpu"] * 2)
    assert files == DE.encode_lossy_batch(np.stack(imgs), device="cpu")
    assert files != single


def test_stream_multi_device_branch_pads_a_ragged_frame():
    """A frame of 50x57 pixels is padded to 64x64 as the single-device
    stream pads it: the branch's files equal that stream's with the
    device import."""
    imgs = list(rgbs(2, 57, 50, 37))
    files = DE.encode_lossy_stream(imgs, devices=["cpu"] * 2)
    assert files == DE.encode_lossy_stream(imgs, host_yuv=False,
                                           device="cpu")


def test_encode_lossy_mesh_re_encodes_an_overflowed_image_on_the_host(
        monkeypatch):
    """An image whose escape list overflowed in a band is re-encoded by
    the exact host encoder (the single-device path's fallback); the other
    images keep the pipeline's files."""
    from webp_tpu_torch.encoder import rgb_to_yuv420
    from webp_tpu_torch.lossy.encode import LossyConfig, VP8Encoder

    x = rgbs(2, H, W, 38)
    want = E.encode_lossy_mesh(list(x), devices=["cpu"] * 2)
    make = E.make_exact_encode_fn

    def overflowing(*args, **kw):
        run = make(*args, **kw)

        def step(rgb):
            out = list(run(rgb))
            out[3] = out[3].clone()
            out[3][1, 0] = out[1].shape[1] // 2 + 1
            return tuple(out)
        return step

    monkeypatch.setattr(E, "make_exact_encode_fn", overflowing)
    before = DE.FALLBACKS["images"]
    files = E.encode_lossy_mesh(list(x), devices=["cpu"] * 2)
    assert DE.FALLBACKS["images"] == before + 1
    cfg = LossyConfig(quality=75, segments=4, sns_strength=50)
    host = VP8Encoder(*rgb_to_yuv420(x[1]), W, H, cfg).encode()
    assert files == [want[0], host] and host != want[1]
