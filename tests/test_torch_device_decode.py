"""The device decode on the CPU (ops/decode.py, lossy/device_decode.py;
device="cpu", the step loop that is the plain version of the card's
decode kernel, csrc/decode_wavefront.cu): its planes
and RGB against the reference's jitted decode_fn at two shapes (each
reference compile costs ~12 s, so the cases share them through a module
fixture), and against the host decoder on all three filter branches
(none, simple, normal), at ragged sizes, on I4-rich files and through
the pipelined stream. The lanes-first helpers (_preds4, _unblock,
pred4_all), the skew and the device upsample are held against the
reference's jnp versions on random inputs. Every comparison is exact.
The wrapper's dispatch is checked too: CPU tensors take the plain
version and launch nothing, card tensors reach the kernel's launch (a
stand-in here) and never the step loop.

The reference's own device decode is wrong on simple-filtered bitstreams
(its simple filter reads the left neighbour's columns 14 and 15 out of
a 4-column patch, which JAX clamps to column 3, and drops the write
back): there the port is held against the host decoder, which both
packages agree on."""

import numpy as np
import pytest
import torch

import webp_tpu_torch
from test_torch_encode import _images
from webp_tpu.lossy import device_decode as dd_ref
from webp_tpu.ops import decode as od_ref
from webp_tpu.ops import fastpath as fp_ref
from webp_tpu.ops import i4 as i4_ref
from webp_tpu.ops import yuv as yuv_ref
from webp_tpu_torch.container.parser import Parser
from webp_tpu_torch.lossy import decode as dec
from webp_tpu_torch.lossy import device_decode as dd
from webp_tpu_torch.ops import cuda
from webp_tpu_torch.ops import decode as od
from webp_tpu_torch.ops import fastpath as fp
from webp_tpu_torch.ops import i4 as i4p
from webp_tpu_torch.ops import yuv as yuvp


def _bitstream(w, h, seed, **opts):
    img = _images(1, h, w, seed)[0]
    data = webp_tpu_torch.encode(img, backend="host", **opts)
    return Parser(data).frames()[0].bitstream


# name -> (bitstream, filter type as vp8_parse reports it).
STREAMS = {
    "normal_64x48": (_bitstream(64, 48, 1, quality=30), 2),
    "normal_m6_120x90": (_bitstream(120, 90, 2, quality=60, method=6), 2),
    "simple_64x48": (_bitstream(64, 48, 3, quality=30, filter_type=0), 1),
    "simple_33x17": (_bitstream(33, 17, 4, quality=50, filter_type=0), 1),
    "nofilter_33x17": (_bitstream(33, 17, 5, quality=50,
                                  filter_strength=0), 0),
    "nofilter_72x40": (_bitstream(72, 40, 6, quality=80, method=6,
                                  filter_strength=0), 0),
}


@pytest.mark.parametrize("name", list(STREAMS))
def test_device_decode_equals_host_decoder(name):
    """Planes and RGB of the device decode (device="cpu") equal the native
    decoder's; the premise (filter type, I4 macroblocks) is checked."""
    bs, ftype = STREAMS[name]
    P = dd._parse_inputs(bs)[0]
    assert int(P["finfo"][0]) == ftype
    if "m6" in name or "72x40" in name:
        assert P["is_i4"].any(), "premise: I4 macroblocks"
    for got, want in zip(dd.decode_vp8_yuv_device(bs, device="cpu"),
                         dec.decode_vp8_yuv(bs)):
        assert np.array_equal(got, want)
    rgb = dd.decode_vp8_rgb_device(bs, device="cpu")
    assert np.array_equal(rgb, dec.decode_vp8_rgba(bs)[..., :3])


@pytest.fixture(scope="module")
def reference():
    """The reference's decode_fn outputs (planes, and RGB for the first)
    for the two shapes held against it: 64x48 with the normal filter and
    33x17 without one."""
    out = {}
    for name, ups in (("normal_64x48", (False, True)),
                      ("nofilter_33x17", (False,))):
        bs = STREAMS[name][0]
        parsed = dd_ref._parse_inputs(bs)
        for u in ups:
            res = dd_ref._run_device(parsed, upsample=u)
            out[name, u] = [np.asarray(o) for o in (
                [res] if u else res)]
    return out


@pytest.mark.parametrize("key", [("normal_64x48", False),
                                 ("normal_64x48", True),
                                 ("nofilter_33x17", False)], ids=str)
def test_device_decode_equals_reference_decode_fn(reference, key):
    """decode_fn's MB-padded planes (and, upsampled, its RGB) equal the
    reference decode_fn's on the same native parse."""
    name, upsample = key
    parsed = dd._parse_inputs(STREAMS[name][0])
    got = dd._run_device(parsed, upsample, torch.device("cpu"))
    got = [got] if upsample else list(got)
    for g, r in zip(got, reference[key]):
        assert np.array_equal(g.numpy(), r)


def test_stream_equals_single_decodes():
    """decode_lossy_stream_device over five bitstreams of mixed sizes and
    filter types equals the single decodes, RGB and planes."""
    names = ["normal_64x48", "simple_33x17", "nofilter_72x40",
             "simple_64x48", "nofilter_33x17"]
    datas = [STREAMS[n][0] for n in names]
    rgbs = dd.decode_lossy_stream_device(datas, device="cpu")
    for bs, rgb in zip(datas, rgbs):
        assert np.array_equal(rgb, dec.decode_vp8_rgba(bs)[..., :3])
    planes = dd.decode_lossy_stream_device(datas[:2], upsample=False,
                                           device="cpu")
    for bs, pl in zip(datas, planes):
        for g, w in zip(pl, dec.decode_vp8_yuv(bs)):
            assert np.array_equal(g, w)


def test_decode_fn_reuses_its_step_loop():
    """A second decode of the same geometry and filter type runs the same
    step loop (static buffers reset) and gives the same pixels."""
    bs1 = STREAMS["normal_64x48"][0]
    bs2 = _bitstream(64, 48, 9, quality=70)
    first = dd.decode_vp8_yuv_device(bs1, device="cpu")
    fn = dd._fn(dd._parse_inputs(bs1), False)
    loop = fn.loop(1, torch.device("cpu"))
    second = dd.decode_vp8_yuv_device(bs2, device="cpu")
    assert fn.loop(1, torch.device("cpu")) is loop
    for g, w in zip(second, dec.decode_vp8_yuv(bs2)):
        assert np.array_equal(g, w)
    for g, w in zip(dd.decode_vp8_yuv_device(bs1, device="cpu"), first):
        assert np.array_equal(g, w)


def test_batched_decode_fn_equals_single_images():
    """Two images in one call (lanes fuse batch x rows) equal each
    image decoded alone."""
    bss = [STREAMS["simple_64x48"][0], _bitstream(64, 48, 8, quality=30,
                                                  filter_type=0)]
    ins = [dd._host_inputs(dd._parse_inputs(b)) for b in bss]
    fn = dd._fn(dd._parse_inputs(bss[0]), True)
    both = fn(*[torch.cat(ts) for ts in zip(*ins)])
    for i, bs in enumerate(bss):
        assert np.array_equal(both[i].numpy(),
                              dec.decode_vp8_rgba(bs)[..., :3])


def test_cpu_tensors_take_the_plain_version_and_launch_nothing(monkeypatch):
    """On CPU tensors DecodeFn runs its plain version (the step loop) once
    a call and counts no kernel launch."""
    ran = []
    plain = od.DecodeFn.plain

    def counted(self, *a):
        ran.append(self.filter_type)
        return plain(self, *a)

    monkeypatch.setattr(od.DecodeFn, "plain", counted)
    cuda.reset_launches()
    for name in ("normal_64x48", "simple_33x17", "nofilter_33x17"):
        bs, ftype = STREAMS[name]
        assert np.array_equal(dd.decode_vp8_rgb_device(bs, device="cpu"),
                              dec.decode_vp8_rgba(bs)[..., :3])
        assert ran[-1] == ftype
    assert len(ran) == 3
    assert not any(cuda.LAUNCHES.values())


@pytest.mark.parametrize("name", ["normal_m6_120x90", "simple_33x17",
                                  "nofilter_72x40"])
def test_card_tensors_reach_the_kernel_never_the_step_loop(monkeypatch, name):
    """For tensors on a card DecodeFn launches the decode kernel once (here
    a stand-in that records its arguments) with the geometry, the filter
    type and cluster_size's blocks per image, and never runs the step
    loop; the launch is counted."""
    calls = []

    def loop(*a, **k):
        raise AssertionError("the step loop ran for card tensors")

    def launch(name, *a):
        calls.append((name, a[8:13], tuple(a[13].shape), tuple(a[14].shape)))
        cuda.LAUNCHES[name] += 1

    monkeypatch.setattr(od.DecodeFn, "plain", loop)
    monkeypatch.setattr(od._StepLoop, "run", loop)
    monkeypatch.setattr(od, "sm_count", lambda dev: 132)
    monkeypatch.setattr(cuda, "on_cpu", lambda *t: False)
    monkeypatch.setattr(cuda, "launch", launch)
    bs, ftype = STREAMS[name]
    parsed = dd._parse_inputs(bs)
    mbw, mbh = (int(v) for v in parsed[0]["dims"][:2])
    ins = [torch.cat([t, t]) for t in dd._host_inputs(parsed)]
    cuda.reset_launches()
    Y, U, V = dd._fn(parsed, False)(*ins)
    C = od.cluster_size(2, mbh, 132)
    assert calls == [("decode_wavefront", (2, mbw, mbh, C, ftype),
                      (2, mbh * 16, mbw * 16), (2, mbh * 8, mbw * 8))]
    assert cuda.LAUNCHES["decode_wavefront"] == 1
    assert tuple(V.shape) == tuple(U.shape) == (2, mbh * 8, mbw * 8)


def test_decode_fn_refuses_inputs_the_kernel_does_not_take():
    """DecodeFn checks each input's dtype, shape and layout before either
    version runs."""
    bs = STREAMS["normal_64x48"][0]
    parsed = dd._parse_inputs(bs)
    ins = dd._host_inputs(parsed)
    fn = dd._fn(parsed, False)
    bad = list(ins)
    bad[0] = ins[0].to(torch.int32)                  # coeffs are int16
    with pytest.raises(TypeError):
        fn(*bad)
    bad = list(ins)
    bad[4] = ins[4][:, :-1]                          # one MB short
    with pytest.raises(ValueError):
        fn(*bad)
    bad = list(ins)
    bad[2] = ins[2].transpose(1, 2).contiguous().transpose(1, 2)
    with pytest.raises(ValueError):
        fn(*bad)
    bad = list(ins)
    bad[1] = ins[1].to(torch.uint8)                  # is_i4 is bool
    with pytest.raises(TypeError):
        fn(*bad)


def _rand(rng, shape, lo=0, hi=256):
    return rng.integers(lo, hi, shape).astype(np.int32)


def test_lanes_first_helpers_equal_reference():
    """_preds4 at sizes 16 and 8 with every edge combination, _unblock,
    pred4_all, and the skew and its inverse, against the reference's jnp
    versions."""
    rng = np.random.default_rng(0)
    L = 12
    for size in (16, 8):
        top, left = _rand(rng, (L, size)), _rand(rng, (L, size))
        tl = _rand(rng, (L,))
        ht = np.arange(L) % 2 == 0
        hl = np.arange(L) % 4 < 2
        got = fp._preds4(size, *map(torch.as_tensor, (top, left, tl, ht, hl)))
        ref = fp_ref._preds4(size, top, left, tl, ht, hl)
        assert np.array_equal(got.numpy(), np.asarray(ref))
        blocks = _rand(rng, (L, (size // 4) ** 2, 4, 4))
        assert np.array_equal(fp._unblock(torch.as_tensor(blocks), size),
                              np.asarray(fp_ref._unblock(blocks, size)))
    t, lf, tr = (_rand(rng, (L, 4)) for _ in range(3))
    tl = _rand(rng, (L,))
    for g, r in zip(i4p.pred4_all(*map(torch.as_tensor, (t, lf, tl, tr))),
                    i4_ref.pred4_all(t, lf, tl, tr)):
        assert np.array_equal(g.numpy(), np.asarray(r))
    mb_w, mb_h = 5, 3
    a = _rand(rng, (mb_w * mb_h, 2, 3))
    sh = od._shear(torch.as_tensor(a)[None], mb_w, mb_h)
    assert np.array_equal(sh.numpy(),
                          np.asarray(od_ref._shear(a, mb_w, mb_h, 2)))
    assert np.array_equal(od._unshear(sh, 1, mb_w, mb_h)[0].numpy(), a)


def test_device_upsample_equals_reference():
    rng = np.random.default_rng(1)
    for h, w in ((1, 1), (2, 3), (17, 33), (16, 16)):
        y = rng.integers(0, 256, (h, w), np.uint8)
        u = rng.integers(0, 256, ((h + 1) // 2, (w + 1) // 2), np.uint8)
        v = rng.integers(0, 256, u.shape, np.uint8)
        got = yuvp.yuv420_to_rgb_fancy(*map(torch.as_tensor, (y, u, v)))
        assert np.array_equal(got.numpy(),
                              np.asarray(yuv_ref.yuv420_to_rgb_fancy(y, u, v)))
