"""The chroma AC quantizer delta (uv_ac=True) on every device encode form
of the port against the JAX package with its switch WEBPTPU_DQUV_AC set,
byte for byte on the CPU, and the SNS-30 parity of the default path.

The reference reads its switch while it traces a program and leaves it
out of _fast_encode_fn's cache key, so each reference program here is
built at a geometry no other test compiles, with the cache cleared
before and after and the switch set (monkeypatch) around the reference
calls only. Four reference programs: the planar program at 80x32 (SNS
30; encode_batch and encode() share it, both at B=1), the non-planar
program at 112x32, the 2-band sharded encoder at 112x64 (SNS 50, the
main path's) with the switch, and the planar program at 96x32 (SNS 30)
without it. Inputs are made from seeds with numpy.

SNS 30 pins the port to the reference's floor divisions where libwebp
truncates: -4 * 30 // 100 = -2 (libwebp -1) for the DC delta, and every
mean UV alpha below 94 gives a negative AC delta (libwebp's truncation
gives 0 down to 88)."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import webp_tpu
from webp_tpu.ops import fastpath as FP_ref
from webp_tpu.parallel import mesh as M_ref

import webp_tpu_torch
from webp_tpu_torch.animation import animation as A
from webp_tpu_torch.container.parser import Parser
from webp_tpu_torch.lossy import device_encode as DE
from webp_tpu_torch.lossy.decode import VP8Decoder
from webp_tpu_torch.ops import fastpath as FP
from webp_tpu_torch.parallel import exact as E
from webp_tpu_torch.parallel import mesh as M

SWITCH = "WEBPTPU_DQUV_AC"


def image(h, w, seed, chroma):
    """A luma ramp with texture; `chroma` sets the colour gradient and the
    chroma noise: 60 gives a low mean UV alpha (a negative AC delta),
    120 a high one (positive)."""
    rng = np.random.default_rng(seed)
    y = np.linspace(0, 1, h)[:, None]
    x = np.linspace(0, 1, w)[None, :]
    luma = 60 + 120 * x + 40 * np.sin(9 * y) + rng.normal(0, 10, (h, w))
    out = (luma[..., None]
           + np.array([1.0, 0.2, -0.6]) * chroma * (x - 0.5)[..., None]
           + rng.normal(0, chroma / 4, (h, w, 3)))
    return np.clip(out, 0, 255).astype(np.uint8)


def pair(h, w, seed):
    """[negative, positive]: two images whose AC deltas differ in sign."""
    return np.stack([image(h, w, seed, 60), image(h, w, seed + 1, 120)])


def deltas(data: bytes):
    """The (dq_uv_dc, dq_uv_ac) a WebP file's VP8 frame header signals."""
    return VP8Decoder(Parser(data).frames()[0].bitstream).dq_uv


def both_signs(dq_ac):
    dq_ac = [int(v) for v in dq_ac]
    assert min(dq_ac) < 0 < max(dq_ac), dq_ac


@pytest.fixture(scope="module")
def ref():
    """Every reference output that needs the switch, computed with it set
    and the program cache cleared around it."""
    if len(jax.devices()) < 2:
        pytest.skip("needs 2 JAX devices")
    out = {"planar": pair(32, 80, 40), "nonplanar": pair(32, 112, 42),
           "sharded": pair(64, 112, 44)}
    mp = pytest.MonkeyPatch()
    FP_ref._fast_encode_fn.cache_clear()
    mp.setenv(SWITCH, "1")
    try:
        out["planar_files"] = [webp_tpu.encode_batch([x], 75,
                                                     sns_strength=30)[0]
                               for x in out["planar"]]
        out["encode_files"] = [webp_tpu.encode(x, backend="device",
                                               sns_strength=30)
                               for x in out["planar"]]
        out["sharded_out"] = M_ref.make_sharded_encode_fn(
            M_ref.make_mesh(2, dp=1))(out["sharded"])
        mp.setenv("WEBPTPU_NO_PLANAR", "1")
        FP_ref._fast_encode_fn.cache_clear()
        fn = FP_ref.fast_encode_fn(7, 2, 75, 4, 30, True, rd_drop=1024.0)
        out["nonplanar_blob"] = [np.asarray(c)
                                 for c in fn.rgb_blob(out["nonplanar"])]
        out["nonplanar_spec"] = fn.blob_spec
    finally:
        mp.undo()
        FP_ref._fast_encode_fn.cache_clear()
    return out


@pytest.mark.parametrize("uv_ac", [False, True])
@pytest.mark.parametrize("sns", [0, 25, 30, 50, 75, 100])
def test_uv_deltas_equal_reference_on_every_guv(sns, uv_ac, monkeypatch):
    """_uv_deltas over every mean UV alpha 0..255, with the reference's
    switch set for uv_ac and unset without it."""
    if uv_ac:
        monkeypatch.setenv(SWITCH, "1")
    else:
        monkeypatch.delenv(SWITCH, raising=False)
    guv = np.arange(256, dtype=np.int32)
    dc, ac = FP._uv_deltas(torch.as_tensor(guv), sns, uv_ac)
    dc_r, ac_r = FP_ref._uv_deltas(jnp.asarray(guv), sns)
    assert dc == dc_r
    assert ac.dtype == torch.int32
    np.testing.assert_array_equal(ac.numpy(), np.asarray(ac_r))
    if uv_ac and sns == 30:
        # The floor: guv 90 gives (-40 // 70) * 30 // 100 = -1 (libwebp's
        # truncation gives 0); 255 is clipped to 6.
        assert (dc, int(ac[90]), int(ac[93]), int(ac[94]),
                int(ac[255])) == (-2, -1, -1, 0, 6)


def test_planar_encode_batch_equals_reference(ref):
    """encode_batch(uv_ac=True) at SNS 30 (B=2) writes the reference's
    files (B=1 each, the switch set), and they signal AC deltas of both
    signs beside the floored DC delta -2."""
    got = webp_tpu_torch.encode_batch(list(ref["planar"]), 75, device="cpu",
                                      sns_strength=30, uv_ac=True)
    assert got == ref["planar_files"]
    dq = [deltas(f) for f in got]
    assert {d[0] for d in dq} == {-2}
    both_signs([d[1] for d in dq])


def test_encode_equals_reference_device_encode(ref):
    """encode(img, uv_ac=True) equals the reference's encode(img,
    backend="device") with the switch set, and the files equal
    encode_batch's."""
    got = [webp_tpu_torch.encode(x, device="cpu", sns_strength=30,
                                 uv_ac=True) for x in ref["planar"]]
    assert got == ref["encode_files"] == ref["planar_files"]


def test_nonplanar_program_equals_reference(ref):
    """fast_encode_fn(planar=False, uv_ac=True)'s blob equals the
    reference's non-planar program's with the switch set, and the planar
    program's."""
    x = torch.as_tensor(ref["nonplanar"])
    fn = FP.fast_encode_fn(7, 2, 75, 4, 30, True, planar=False, uv_ac=True)
    got = fn.rgb_blob(x)
    planar = FP.fast_encode_fn(7, 2, 75, 4, 30, True, uv_ac=True).rgb_blob(x)
    assert fn.blob_spec == ref["nonplanar_spec"]
    for g, p, r in zip(got, planar, ref["nonplanar_blob"]):
        np.testing.assert_array_equal(g.numpy(), r)
        assert torch.equal(g, p)
    fields = FP.unpack_output_blob([c.numpy() for c in got], fn.blob_spec)
    both_signs(fields["dq_uv"][:, 1])


def test_sharded_encoder_equals_reference(ref):
    """Two bands of the sharded encoder (uv_ac=True, the main path's SNS
    50) on ["cpu"] * 2: every output equals the reference's with the
    switch set; the delta comes from the UV alpha summed over the
    bands."""
    mesh = M.make_mesh(devices=["cpu"] * 2, dp=1)
    got = M.make_sharded_encode_fn(mesh, uv_ac=True)(ref["sharded"])
    assert len(got) == len(ref["sharded_out"])
    for g, r in zip(got, ref["sharded_out"]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    both_signs(got[13][:, 1])


def test_exact_pipeline_and_stream_mesh_branch_equal_encode_batch():
    """The exact band pipeline with uv_ac=True (2 bands) writes
    encode_batch(uv_ac=True)'s files, and so does the stream's
    multi-device branch; the deltas differ from those without uv_ac."""
    x = pair(64, 64, 46)
    want = DE.encode_lossy_batch(x, device="cpu", uv_ac=True)
    assert E.encode_lossy_mesh(list(x), devices=["cpu"] * 2,
                               uv_ac=True) == want
    assert DE.encode_lossy_stream(list(x), devices=["cpu"] * 2,
                                  uv_ac=True) == want
    on = [VP8Decoder(f).dq_uv[1] for f in want]
    both_signs(on)
    off = [VP8Decoder(f).dq_uv[1] for f in E.encode_lossy_mesh(
        list(x), devices=["cpu"] * 2)]
    assert off == [0, 0]


def test_encode_animation_device_payloads_equal_the_stream():
    """encode_animation_device(uv_ac=True): its ANMF payloads are the
    stream's bitstreams with uv_ac=True, AC deltas of both signs."""
    frames = list(pair(32, 48, 48)) + [image(32, 48, 50, 90)]
    data = A.encode_animation_device(frames, 40, batch=2, device="cpu",
                                     uv_ac=True)
    payloads = [f.bitstream for f in Parser(data).frames()]
    assert payloads == DE.encode_lossy_stream(frames, batch=2, device="cpu",
                                              uv_ac=True)
    both_signs([VP8Decoder(p).dq_uv[1] for p in payloads])


def test_uv_ac_is_part_of_the_program_cache_key():
    """Toggling uv_ac at one geometry returns another program and changes
    the signalled delta (the reference's cache returns the program of the
    first setting)."""
    x = pair(32, 48, 52)
    off = FP.fast_encode_fn(3, 2, 75, 4, 50, True)
    on = FP.fast_encode_fn(3, 2, 75, 4, 50, True, uv_ac=True)
    assert off is not on and on.uv_ac and not off.uv_ac
    assert on is FP.fast_encode_fn(3, 2, 75, 4, 50, True, uv_ac=True)
    files = {v: webp_tpu_torch.encode_batch(list(x), device="cpu", uv_ac=v)
             for v in (True, False)}
    assert [deltas(f)[1] for f in files[False]] == [0, 0]
    both_signs([deltas(f)[1] for f in files[True]])
    assert files[True] != files[False]


def test_unsegmented_plan_has_no_ac_delta():
    """segments=1 (the static plan) ignores uv_ac, as the reference's
    unsegmented program does."""
    x = list(pair(32, 48, 54))
    assert webp_tpu_torch.encode_batch(x, device="cpu", segments=1,
                                       uv_ac=True) == \
        webp_tpu_torch.encode_batch(x, device="cpu", segments=1)


def test_host_backend_ignores_uv_ac_and_floors_at_sns_30():
    """backend="host" at SNS 30 writes the reference host encoder's file
    (no compile) with dq_uv_dc -2, the reference's floor (libwebp: -1),
    whether or not uv_ac is given: the host analysis derives its own AC
    delta (midpoint 64) in both."""
    for x in pair(32, 80, 56):
        want = webp_tpu.encode(x, sns_strength=30)
        got = webp_tpu_torch.encode(x, backend="host", sns_strength=30)
        assert got == want
        assert webp_tpu_torch.encode(x, backend="host", sns_strength=30,
                                     uv_ac=True) == want
        assert deltas(got)[0] == -2


def test_device_encode_at_sns_30_equals_reference():
    """The default path (uv_ac=False) at SNS 30: encode() equals the
    reference's device encode with its switch unset; the header signals
    dq_uv_dc -2 (the floor) and dq_uv_ac 0."""
    x = image(32, 96, 58, 90)
    want = webp_tpu.encode(x, backend="device", sns_strength=30)
    got = webp_tpu_torch.encode(x, device="cpu", sns_strength=30)
    assert got == want
    assert deltas(got) == (-2, 0)
