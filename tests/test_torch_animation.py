"""The port's mux/demux and animation (webp_tpu_torch.mux.mux,
webp_tpu_torch.animation.animation) against the reference's, on the CPU:
Muxer files byte for byte, Demuxer accessors, decode_animation frame
tables and AnimDecoder canvases on both decode backends (the device
decode with device="cpu"), alpha_blend, and AnimEncoder/encode_animation
files byte for byte on device="cpu" and backend="host".

Every input is made here from a numpy seed. The canvases are 96x64 or
smaller (at most 6,144 pixels): the native LZ77's greedy path (method < 3
or quality < 50, and most ALPH planes) splits an image of more than
65,536 pixels into one row chunk per hardware thread, which would make
the bytes depend on the machine. Nothing here compiles a reference device
program: the reference's animation, mux and compositor are host code.
(encode_animation_device's parity case lives in test_torch_stream.py,
which already compiles the reference stream's program.)"""

import io
from enum import IntEnum

import numpy as np
import pytest
import torch
from PIL import Image

import webp_tpu.animation.animation as ra
import webp_tpu.container.riff as rr
import webp_tpu.mux.mux as rm
import webp_tpu_torch
from webp_tpu_torch.animation import animation as pa
from webp_tpu_torch.container import riff as pr
from webp_tpu_torch.container.parser import Parser
from webp_tpu_torch.lossless.encode import HOST, encode_vp8l
from webp_tpu_torch.lossy.alpha_enc import encode_alpha
from webp_tpu_torch.mux import mux as pm


# ---------------------------------------------------------------------------
# Inputs.
# ---------------------------------------------------------------------------

def _background(rng, h, w):
    """A gradient with a noisy patch and a flat band, RGB."""
    y, x = np.mgrid[0:h, 0:w]
    img = np.stack([x * 255 // (w - 1), y * 255 // (h - 1),
                    ((x + 2 * y) * 3) % 256], -1).astype(np.int32)
    img[h // 4: h // 2, w // 3:] += rng.integers(-40, 40,
                                                 (h // 2 - h // 4,
                                                  w - w // 3, 3))
    img[3 * h // 4:, : w // 2] = rng.integers(0, 256, 3)
    return np.clip(img, 0, 255).astype(np.uint8)


def _scene(seed, h=48, w=64, n=6, banner=False, cut=None):
    """RGBA frames: an opaque background, a textured 12x12 sprite moving
    6 px per frame (wrapping at the edges), frame 2 repeated (n > 2), optionally a semi-transparent
    banner (alpha 128) on frames 3 and 4 and a cut to a new background at
    frame `cut`."""
    rng = np.random.default_rng(seed)
    bg = _background(rng, h, w)
    sprite = rng.integers(0, 256, (12, 12, 3), np.uint8)
    frames = []
    for i in range(n):
        if cut is not None and i == cut:
            bg = _background(rng, h, w)[::-1].copy()
        f = np.dstack([bg, np.full((h, w), 255, np.uint8)])
        x0, y0 = (2 + 6 * i) % (w - 12), (4 + 3 * i) % (h - 12)
        f[y0:y0 + 12, x0:x0 + 12, :3] = sprite
        if banner and i in (3, 4):
            f[h - 12: h - 4, 4: w - 4] = (250, 240, 20, 128)
        frames.append(f)
    if n > 2:
        frames.insert(3, frames[2].copy())
    return frames


def _sprite_on_transparent(n=6, size=64):
    """A sprite moving across a transparent canvas (the dispose-background
    candidate's case)."""
    frames = []
    for i in range(n):
        f = np.zeros((size, size, 4), np.uint8)
        f[i * 9:i * 9 + 12, 10:22] = (255, 0, 0, 255)
        frames.append(f)
    return frames


def _two_sprites(n=5):
    """Two opaque sprites at opposite edges over a textured background:
    the changed rect spans the width but most of it is unchanged (the
    transparent-blend candidate's case)."""
    bg = _background(np.random.default_rng(11), 64, 96)
    frames = []
    for i in range(n):
        f = np.dstack([bg, np.full((64, 96), 255, np.uint8)]).copy()
        f[6 + 8 * i:18 + 8 * i, 2:14, :3] = (255, 0, 0)
        f[6 + 8 * i:18 + 8 * i, 82:94, :3] = (0, 255, 0)
        frames.append(f)
    return frames


def _vp8l(img):
    return encode_vp8l(img, search=HOST)


def _vp8(img):
    """A lossy VP8 bitstream of img's RGB (the port's host encoder)."""
    data = webp_tpu_torch.encode(np.ascontiguousarray(img[..., :3]),
                                 backend="host", quality=70)
    return Parser(data).frames()[0].bitstream


def _fields(obj):
    """A dataclass's fields, enums as ints (to compare across packages)."""
    return {k: (int(v) if isinstance(v, IntEnum) else v)
            for k, v in vars(obj).items()}


def _pillow_animation(frames, durations, **save):
    ims = [Image.fromarray(f) for f in frames]
    buf = io.BytesIO()
    ims[0].save(buf, format="WEBP", save_all=True, append_images=ims[1:],
                duration=durations, **save)
    return buf.getvalue()


# ---------------------------------------------------------------------------
# Mux and demux.
# ---------------------------------------------------------------------------

def _both_muxers(frames, loop_count=None, bgcolor=0, canvas=None, meta=()):
    """The same frames and settings in the reference's Muxer and the
    port's. frames: dicts of MuxFrame fields (dispose, blend as ints)."""
    out = []
    for M, R in ((rm, rr), (pm, pr)):
        m = M.Muxer()
        if loop_count is not None:
            m.set_loop_count(loop_count)
        m.bgcolor = bgcolor
        if canvas is not None:
            m.set_canvas_size(*canvas)
        for fourcc, data in meta:
            m.add_chunk(fourcc, data)
        for f in frames:
            f = dict(f)
            f["dispose"] = R.DisposeMethod(f.get("dispose", 0))
            f["blend"] = R.BlendMethod(f.get("blend", 0))
            m.add_frame(M.MuxFrame(**f))
        out.append(m)
    return out


def _assemble_both(*args, **kw):
    ref, port = _both_muxers(*args, **kw)
    return ref.assemble(), port.assemble()


@pytest.fixture(scope="module")
def bits():
    """Frame payloads: lossless opaque and with alpha, lossy, lossy with
    an ALPH plane (the port's encoders; both muxers get the same bytes)."""
    rng = np.random.default_rng(5)
    img = _background(rng, 32, 48)
    rgba = np.dstack([img, rng.integers(0, 256, (32, 48), np.uint8)])
    small = _background(rng, 16, 20)
    return dict(
        vp8l=_vp8l(img), vp8l_alpha=_vp8l(rgba), vp8=_vp8(img),
        vp8_small=_vp8(small), alph=encode_alpha(rgba[..., 3]),
        vp8l_small=_vp8l(np.dstack([small, np.full((16, 20), 90,
                                                   np.uint8)])))


META = ((b"ICCP", b"icc profile bytes"), (b"EXIF", b"Exif\0\0II*\0"),
        (b"XMP ", b"<x:xmpmeta/>"))


@pytest.mark.parametrize("kind", ["vp8", "vp8l", "vp8l_alpha", "vp8_alph"])
@pytest.mark.parametrize("meta", [(), META, META[1:2]],
                         ids=["plain", "icc_exif_xmp", "exif"])
def test_muxer_still_files_equal_reference(bits, kind, meta):
    """A single frame assembles as a simple file, or VP8X with its
    metadata and alpha flag, byte for byte as the reference's."""
    f = dict(bitstream=bits["vp8l" if kind.startswith("vp8l") else "vp8"],
             is_lossless=kind.startswith("vp8l"))
    if kind == "vp8l_alpha":
        f["bitstream"] = bits["vp8l_alpha"]
    if kind == "vp8_alph":
        f["alpha"] = bits["alph"]
    ref, port = _assemble_both([f], meta=meta)
    assert port == ref
    d = pm.Demuxer(port)
    assert (d.iccp, d.exif, d.xmp) == tuple(
        dict(meta).get(k, b"") for k in (b"ICCP", b"EXIF", b"XMP "))


@pytest.mark.parametrize("loop,bgcolor", [(0, 0), (3, 0xFF00FF00),
                                          (70000, 0x80402010)])
def test_muxer_animation_files_equal_reference(bits, loop, bgcolor):
    """Animations with a loop count (clamped to 16 bits), a background
    colour, even offsets, dispose and blend flags, lossless and lossy
    frames, with and without alpha, and metadata."""
    frames = [
        dict(bitstream=bits["vp8"], duration_ms=40),
        dict(bitstream=bits["vp8l_small"], is_lossless=True, x_offset=8,
             y_offset=6, duration_ms=50, dispose=1, blend=0),
        dict(bitstream=bits["vp8_small"], x_offset=26, y_offset=14,
             duration_ms=(1 << 24) - 1, blend=1),
        dict(bitstream=bits["vp8"], alpha=bits["alph"], duration_ms=0),
    ]
    ref, port = _assemble_both(frames, loop_count=loop, bgcolor=bgcolor,
                               meta=META)
    assert port == ref
    d = pm.Demuxer(port)
    assert d.loop_count() == min(loop, 65535)
    assert d.background_color() == bgcolor
    assert d.features.has_anim and d.features.has_alpha


@pytest.mark.parametrize("canvas", [None, (64, 40), (28, 18)])
def test_muxer_canvas_inference_equals_reference(bits, canvas):
    """The canvas is the frames' extent unless both sides are set; a
    canvas set smaller than a frame is refused with the reference's
    error."""
    frames = [dict(bitstream=bits["vp8_small"], duration_ms=40),
              dict(bitstream=bits["vp8_small"], x_offset=10, y_offset=4,
                   duration_ms=40)]
    ref, port = _both_muxers(frames, canvas=canvas)
    assert port._infer_canvas() == ref._infer_canvas()
    if canvas == (28, 18):
        with pytest.raises(rr.WebPError) as e_ref:
            ref.assemble()
        with pytest.raises(pr.WebPError) as e_port:
            port.assemble()
        assert str(e_port.value) == str(e_ref.value)
        assert "exceeds canvas (28x18)" in str(e_port.value)
        return
    data = port.assemble()
    assert data == ref.assemble()
    f = webp_tpu_torch.get_features(data)
    assert (f.width, f.height) == (canvas or (30, 20))


def test_muxer_errors_equal_reference(bits):
    """Odd offsets, an empty muxer, an unknown chunk and oversized
    metadata raise the reference's errors, word for word; durations and
    loop counts clamp as the reference's."""
    msgs = []
    for M, R in ((rm, rr), (pm, pr)):
        got = []
        m = M.Muxer()
        for call in (lambda: m.assemble(),
                     lambda: m.add_frame(M.MuxFrame(bitstream=bits["vp8"],
                                                    x_offset=3)),
                     lambda: m.add_frame(M.MuxFrame(bitstream=bits["vp8"],
                                                    y_offset=1)),
                     lambda: m.add_chunk(b"ABCD", b"x"),
                     lambda: m.add_chunk(b"EXIF", b"\0" * ((1 << 24) + 1))):
            with pytest.raises(R.WebPError) as e:
                call()
            got.append(str(e.value))
        m.add_frame(M.MuxFrame(bitstream=bits["vp8"]))
        m.set_frame_duration(0, 1 << 30)
        got.append(m.frame_duration(0))
        m.set_frame_duration(0, -5)
        got.append(m.frame_duration(0))
        m.set_loop_count(1 << 20)
        got.append(m.loop_count)
        m.set_frame_dispose(0, R.DisposeMethod.BACKGROUND)
        got.append((m.num_frames(), int(m.frame_blend_mode(0)),
                    int(m.frames[0].dispose)))
        msgs.append(got)
    assert msgs[1] == msgs[0]
    assert msgs[1][0] == "webp: no frames to assemble"
    assert msgs[1][1] == "webp: frame offsets must be even"


def _demux_view(d):
    return dict(
        features=_fields(d.features), n=d.num_frames(),
        frames=[_fields(f) for f in d.frames()],
        first=_fields(d.frame(0)), loop=d.loop_count(),
        bg=d.background_color(), meta=(d.iccp, d.exif, d.xmp),
        chunks={c: d.get_chunk(c) for c in (b"VP8X", b"ANIM", b"ICCP",
                                            b"VP8 ", b"ALPH", b"NONE")})


@pytest.mark.parametrize("src", ["reference", "port", "pillow_lossless",
                                 "pillow_lossy"])
def test_demuxer_accessors_equal_reference(bits, src):
    """Demuxer features, frame table, iterator, chunks, loop count,
    background colour and metadata on files of both packages and of
    Pillow (libwebp's animation encoder)."""
    frames = _scene(1, n=4)
    if src == "reference":
        data = ra.encode_animation(frames, 60, lossless=True, loop_count=2)
    elif src == "port":
        data = _assemble_both(
            [dict(bitstream=bits["vp8"], duration_ms=30),
             dict(bitstream=bits["vp8_small"], alpha=b"", x_offset=4,
                  y_offset=2, duration_ms=20, dispose=1)],
            loop_count=5, bgcolor=0x11223344, meta=META)[1]
    else:
        data = _pillow_animation(frames, [40, 50, 60, 70, 80], loop=4,
                                 lossless=src == "pillow_lossless",
                                 quality=70)
    ref, port = rm.Demuxer(data), pm.Demuxer(data)
    assert _demux_view(port) == _demux_view(ref)
    it = port.frames()
    seen = [it.next() for _ in range(port.num_frames())]
    assert it.next() is None
    assert [_fields(f) for f in seen] == [_fields(f) for f in ref.frames()]


# ---------------------------------------------------------------------------
# Decode and the compositor.
# ---------------------------------------------------------------------------

def _frame_table(anim):
    return (anim.canvas_width, anim.canvas_height, anim.loop_count,
            anim.bgcolor,
            [(f.x_offset, f.y_offset, f.duration_ms, int(f.dispose),
              int(f.blend), f.has_alpha, f.rgba.shape) for f in anim.frames])


def _check_decode(data, pillow=False):
    """decode_animation's frames and table, then AnimDecoder's canvases
    and durations, equal the reference's on both backends (the device
    decode and the compositor with device="cpu"); with pillow, the
    canvases also equal Pillow's."""
    ref = ra.decode_animation(data)
    want = list(ra.AnimDecoder(ref))
    for kw in (dict(backend="host"), dict(device="cpu")):
        anim = pa.decode_animation(data, **kw)
        assert _frame_table(anim) == _frame_table(ref), kw
        for f, g in zip(anim.frames, ref.frames):
            assert np.array_equal(f.rgba, g.rgba), kw
        got = list(pa.AnimDecoder(anim, device="cpu"))
        assert len(got) == len(want)
        for (c, d), (c_ref, d_ref) in zip(got, want):
            assert d == d_ref and np.array_equal(c, c_ref), kw
    if pillow:
        # libwebp keeps the RGB of a fully transparent pixel that blends
        # into a rect disposed to background; the reference's compositor
        # (and so the port's) makes it transparent black. The two differ
        # only under alpha 0, which lossy frames with ALPH show.
        im = Image.open(io.BytesIO(data))
        for i, (c, _) in enumerate(want):
            im.seek(i)
            p = np.array(im.convert("RGBA"))
            p[p[..., 3] == 0] = 0
            assert np.array_equal(np.where(c[..., 3:] == 0, 0, c), p), i
    return want


@pytest.mark.parametrize("dispose", ["none", "background"])
@pytest.mark.parametrize("blend", ["alpha", "overwrite"])
@pytest.mark.parametrize("codec", ["lossless", "lossy"])
def test_dispose_blend_matrix_equals_reference(dispose, blend, codec):
    """The reference's dispose x blend matrix (its test_animation.py:41):
    a keyframe and two offset sub-frames with alphas 0 / 128 / 255, a
    non-black background colour; lossless frames, or lossy frames with
    ALPH planes. Frames, canvases and durations equal the reference's on
    both backends, and Pillow's canvases."""
    rng = np.random.default_rng(3)
    W, H = 40, 26
    base = rng.integers(0, 256, (H, W, 4)).astype(np.uint8)
    base[..., 3] = 255
    sub = rng.integers(0, 256, (12, 16, 4)).astype(np.uint8)
    sub[..., 3] = np.where(sub[..., 3] < 85, 0,
                           np.where(sub[..., 3] < 170, 128, 255))
    sub2 = rng.integers(0, 256, (12, 16, 4)).astype(np.uint8)
    sub2[..., 3] = 255
    d = 0 if dispose == "none" else 1
    b = 0 if blend == "alpha" else 1

    def frame(img, **kw):
        if codec == "lossless":
            return dict(bitstream=_vp8l(img), is_lossless=True, **kw)
        alpha = (b"" if (img[..., 3] == 255).all()
                 else encode_alpha(img[..., 3]))
        return dict(bitstream=_vp8(img), alpha=alpha, **kw)

    data = _assemble_both(
        [frame(base, duration_ms=50, dispose=d),
         frame(sub, x_offset=8, y_offset=6, duration_ms=50, dispose=d,
               blend=b),
         frame(sub2, x_offset=16, y_offset=10, duration_ms=50, dispose=d,
               blend=b)], loop_count=1, bgcolor=0xFF00FF00)[1]
    _check_decode(data, pillow=True)


@pytest.mark.parametrize("lossless", [True, False])
def test_pillow_animations_decode_as_reference(lossless):
    """Animations written by Pillow (libwebp's encoder: sub-frames,
    blend and dispose of its choice, ALPH planes when lossy)."""
    frames = _scene(2, h=40, w=56, n=5, banner=True)
    data = _pillow_animation(frames, [40, 50, 60, 70, 80, 90], loop=3,
                             lossless=lossless, quality=80)
    _check_decode(data, pillow=True)


def test_anim_frame_exceeding_canvas_rejected():
    """A sub-frame whose rect exceeds the declared canvas is refused at
    decode on both backends, with the reference's error (its
    test_animation.py:371)."""
    img = np.full((20, 20, 3), 128, np.uint8)
    data = bytearray(_assemble_both(
        [dict(bitstream=_vp8l(img), is_lossless=True, duration_ms=40),
         dict(bitstream=_vp8l(img), is_lossless=True, x_offset=12,
              y_offset=12, duration_ms=40)])[1])
    idx = data.find(b"VP8X") + 8 + 4
    data[idx:idx + 3] = (19).to_bytes(3, "little")
    data[idx + 3:idx + 6] = (19).to_bytes(3, "little")
    with pytest.raises(rr.WebPError) as e_ref:
        ra.decode_animation(bytes(data))
    for kw in (dict(backend="host"), dict(device="cpu")):
        with pytest.raises(pr.WebPError) as e:
            pa.decode_animation(bytes(data), **kw)
        assert str(e.value) == str(e_ref.value) \
            == "webp: animation frame 1 exceeds canvas"


@pytest.mark.parametrize("lossless", [True, False])
def test_truncated_animation_behaves_as_reference(lossless):
    """Cutting an animated file raises where the reference's decode
    raises (a WebPError) and otherwise decodes to the reference's frames
    (its test_animation.py:354)."""
    frames = _scene(4, n=4)
    data = ra.encode_animation(frames, 50, lossless=lossless)
    for frac in (0.1, 0.3, 0.6, 0.9, 0.99):
        cut = data[: int(len(data) * frac)]
        try:
            ref = ra.decode_animation(cut)
        except rr.WebPError as e:
            for kw in (dict(backend="host"), dict(device="cpu")):
                with pytest.raises(pr.WebPError):
                    pa.decode_animation(cut, **kw)
            continue
        _check_decode(cut)


def test_decode_animation_rejects_an_unknown_backend():
    data = ra.encode_animation(_scene(0, n=2), 50, lossless=True)
    with pytest.raises(ValueError):
        pa.decode_animation(data, backend="tpu")


def test_still_file_decodes_as_one_frame():
    """A simple still file is a one-frame animation with the image's
    canvas (the canvas comes from the frame), on both backends."""
    img = _background(np.random.default_rng(8), 24, 40)
    for data in (webp_tpu_torch.encode(img, backend="host"),
                 webp_tpu_torch.encode(img, lossless=True, backend="host")):
        _check_decode(data)


def test_alpha_blend_equals_reference():
    """alpha_blend on random RGBA, alphas 0 and 255 included on either
    side, equals the reference's numpy blend exactly."""
    rng = np.random.default_rng(12)
    src = rng.integers(0, 256, (64, 96, 4), np.uint8)
    dst = rng.integers(0, 256, (64, 96, 4), np.uint8)
    pick = rng.integers(0, 4, (2, 64, 96))
    for a, p in ((src, pick[0]), (dst, pick[1])):
        a[..., 3] = np.where(p == 0, 0, np.where(p == 1, 255, a[..., 3]))
    got = pa.alpha_blend(torch.from_numpy(src), torch.from_numpy(dst))
    assert got.dtype == torch.uint8
    assert np.array_equal(got.numpy(), ra.alpha_blend(src, dst))


def test_anim_decoder_iterates_resets_and_refuses_bad_canvases():
    data = ra.encode_animation(_scene(6, n=3), [10, 20, 30, 40],
                               lossless=True)
    dec = pa.AnimDecoder(pa.decode_animation(data, backend="host"),
                         device="cpu")
    first = [d for _, d in dec]
    assert first == [d for _, d in dec] == [10, 20, 70]
    assert not dec.has_more()
    with pytest.raises(pr.WebPError):
        dec.next()
    for w, h in ((0, 10), (1 << 16, 1 << 15)):
        with pytest.raises(pr.WebPError) as e:
            pa.AnimDecoder(pa.Animation(canvas_width=w, canvas_height=h),
                           device="cpu")
        with pytest.raises(rr.WebPError) as e_ref:
            ra.AnimDecoder(ra.Animation(canvas_width=w, canvas_height=h))
        assert str(e.value) == str(e_ref.value)


# ---------------------------------------------------------------------------
# Encode: the port's files equal the reference's.
# ---------------------------------------------------------------------------

def _encode_both(frames, durations, **opts):
    """The reference's file; the port's on device="cpu" and with
    backend="host" must equal it."""
    want = ra.encode_animation(frames, durations, **opts)
    for kw in (dict(device="cpu"), dict(backend="host")):
        assert pa.encode_animation(frames, durations, **kw, **opts) == want, kw
    return want


@pytest.mark.parametrize("opts", [
    dict(), dict(lossless=True), dict(allow_mixed=True),
    dict(quality=40, method=2), dict(lossless=True, quality=30, method=1),
    dict(allow_mixed=True, method=6, quality=90, loop_count=7,
         bgcolor=0xFFFFFFFF),
], ids=["lossy", "lossless", "mixed", "lossy_q40_m2", "lossless_q30_m1",
        "mixed_m6_q90"])
def test_encode_animation_equals_reference(opts):
    """A moving sprite with a repeated frame, a semi-transparent banner
    and a cut to a new background: lossy, lossless and mixed at several
    qualities and methods. The file decodes as the reference's does."""
    frames = _scene(7, n=8, banner=True, cut=6)
    data = _encode_both(frames, [40, 50, 60, 70, 80, 90, 100, 110, 120],
                        **opts)
    _check_decode(data)


@pytest.mark.parametrize("k", [dict(kmax=1), dict(kmax=3),
                               dict(kmin=2, kmax=4), dict(kmin=5, kmax=4),
                               dict(kmin=1, kmax=40), dict(kmax=-1),
                               dict(minimize_size=True)], ids=str)
@pytest.mark.parametrize("lossless", [True, False])
def test_keyframe_policy_equals_reference(k, lossless):
    """kmin/kmax sanitation and placement, kmax=1 (all keyframes),
    minimize_size (none forced)."""
    frames = _scene(9, h=32, w=48, n=7)
    data = _encode_both(frames, 30, lossless=lossless, **k)
    infos = Parser(data).frames()
    if k == dict(kmax=1):
        assert all(f.x_offset == 0 and f.y_offset == 0
                   and (f.width, f.height) == (48, 32) for f in infos)


def test_identical_frames_merge_and_duration_overflow_filler():
    """Identical frames merge into the previous duration; past the 24-bit
    cap the rest spills into a transparent 2x2 filler (the reference's
    test_animation.py:394), lossless and lossy."""
    f = np.full((16, 16, 3), 99, np.uint8)
    g = f.copy()
    g[4:8, 6:10] = 7
    for lossless in (True, False):
        for frames, durs in (([f, f, f], [(1 << 24) - 10, 1000, 5]),
                             ([f, f, g], [40, 50, 60])):
            data = _encode_both(frames, durs, lossless=lossless)
            want = _check_decode(data)
            assert sum(d for _, d in want) == sum(durs)
    anim = pa.decode_animation(data, device="cpu")
    assert [fr.duration_ms for fr in anim.frames] == [90, 60]


def test_dispose_background_candidate_equals_reference():
    """A sprite on a transparent canvas: the dispose-background candidate
    wins and retroactively sets the previous frame's dispose (the
    reference's test_animation.py:284); the canvases equal the source."""
    frames = _sprite_on_transparent()
    data = _encode_both(frames, 50, lossless=True)
    assert 1 in [int(f.dispose) for f in Parser(data).frames()]
    for (c, _), src in zip(_check_decode(data), frames):
        assert np.array_equal(c, src)
    _encode_both(frames, 50)


def test_transparent_blend_subframes_equal_reference():
    """Two sprites at opposite edges: the transparent-blend candidate
    (unchanged pixels transparent, alpha-blended) is chosen (the
    reference's test_animation.py:239); lossless canvases equal the
    source; allow_mixed takes it too."""
    frames = _two_sprites()
    data = _encode_both(frames, 50, lossless=True)
    anim = pa.decode_animation(data, device="cpu")
    assert any(int(f.blend) == 0 for f in anim.frames[1:])
    for (c, _), src in zip(_check_decode(data), frames):
        assert np.array_equal(c, src)
    _encode_both(frames, 50, allow_mixed=True)


@pytest.mark.parametrize("kind", ["lossless", "lossy", "lossy_alpha"])
def test_single_frame_fallback_equals_reference(kind):
    """One frame falls back to a simple file (VP8 or VP8L), or VP8X with
    ALPH when the lossy frame has alpha; AnimEncoder.close is assemble."""
    img = _scene(10, h=24, w=32, n=1)[0]
    if kind == "lossy_alpha":
        img[4:12, 4:20, 3] = 100
    opts = dict(lossless=kind == "lossless")
    want = ra.encode_animation([img], 70, **opts)
    enc = pa.AnimEncoder(32, 24, pa.AnimEncodeOptions(**opts), device="cpu")
    enc.add_frame(img, 70)
    got = enc.close()
    assert got == want
    f = webp_tpu_torch.get_features(got)
    assert not f.has_anim and f.has_alpha == (kind == "lossy_alpha")


def test_anim_encoder_errors_equal_reference():
    for A, R in ((ra, rr), (pa, pr)):
        enc = A.AnimEncoder(32, 24)
        with pytest.raises(R.WebPError, match="no frames added"):
            enc.assemble()
        with pytest.raises(R.WebPError, match="must match canvas size"):
            enc.add_frame(np.zeros((24, 30, 3), np.uint8), 10)
        with pytest.raises(R.WebPError, match="no frames"):
            A.encode_animation([], 10)
    with pytest.raises(ValueError):
        pa.AnimEncoder(32, 24, backend="tpu")


def test_changed_rect_equals_reference():
    rng = np.random.default_rng(13)
    a = rng.integers(0, 256, (20, 30, 4), np.uint8)
    for y0, y1, x0, x1 in ((3, 4, 5, 6), (0, 20, 0, 30), (7, 19, 9, 28)):
        b = a.copy()
        b[y0:y1, x0:x1, 1] ^= 1
        assert pa._changed_rect(a, b) == ra._changed_rect(a, b)
    assert pa._changed_rect(a, a) is None

