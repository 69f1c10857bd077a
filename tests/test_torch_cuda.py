"""The port on the card: each kernel against its plain version on the
slice's inputs (kernel 4 also on random modes), the card's files against
the CPU run's, byte for byte, and the device decode on the card against
the host decoder. These tests import neither JAX nor the reference package, so they
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


def encode_launches():
    """The launch counts of the four encode kernels (every kernel but the
    decode's)."""
    from webp_tpu_torch.ops import cuda

    return {k: v for k, v in cuda.LAUNCHES.items() if k != "decode_wavefront"}


def p2_inputs(B, W, H, seed):
    """Phase-2 inputs (numpy, the port's quant tables): source planes (a
    ramp, a noisy half, flat and striped chroma), random modes, I4 split
    and modes, segments and per-image quant rows."""
    from webp_tpu_torch.ops import fastpath as FP

    rng = np.random.default_rng(seed)
    mb_w, mb_h = W // 16, H // 16
    n_mb = mb_w * mb_h
    y, x = np.mgrid[0:H, 0:W]
    Y = np.broadcast_to((x * 3 + y * 2) % 256, (B, H, W)).copy()
    Y[:, :, W // 2:] = rng.integers(0, 256, (B, H, W - W // 2))
    U = rng.integers(100, 160, (B, H // 2, W // 2))
    V = np.broadcast_to((x[::2, ::2] * 5) % 256, (B, H // 2, W // 2)).copy()
    V[:, ::3] = rng.integers(0, 256, V[:, ::3].shape)
    seg_q = rng.integers(10, 120, (B, 4))
    tabs = FP.all_q_tables()[0]
    seg_rows = {k: tabs[k][seg_q].astype(np.int32) for k in ("y1", "y2",
                                                              "uv")}
    return dict(
        Y=Y.astype(np.uint8), U=U.astype(np.uint8), V=V.astype(np.uint8),
        modes=rng.integers(0, 4, (B, n_mb)).astype(np.uint8),
        uvmodes=rng.integers(0, 4, (B, n_mb)).astype(np.uint8),
        is_i4=rng.random((B, n_mb)) < 0.5,
        i4_modes=rng.integers(0, 10, (B, n_mb, 16)).astype(np.uint8),
        seg_map=rng.integers(0, 4, (B, n_mb)).astype(np.int32),
        seg_rows=seg_rows,
        qtab=np.stack([seg_rows[k] for k in ("y1", "y2", "uv")],
                      axis=1).reshape(B, 48, 16))


def broadcast_qtab(B, qp):
    """qtab [B, 48, 16] (numpy) holding one set of quant rows (qp:
    {y1/y2/uv: 4 x [16]}) for every segment and image: the unsegmented
    configuration's."""
    one = np.stack([np.stack([np.asarray(a) for a in qp[k]])
                    for k in ("y1", "y2", "uv")])               # [3, 4, 16]
    return np.broadcast_to(one[:, None], (B, 3, 4, 4, 16)).reshape(
        B, 48, 16).astype(np.int32)


def p2_args(d, device="cpu"):
    """phase2_pack's tensor arguments from p2_inputs' dict."""
    return tuple(torch.as_tensor(d[k]).to(device) for k in (
        "Y", "U", "V", "modes", "uvmodes", "is_i4", "i4_modes", "seg_map",
        "qtab"))


def alpha_edge_inputs(L, seed):
    """Segment-alpha inputs u8 [384, L] (numpy): random rows, with a flat
    MB in lane 0 (all 256 luma coefficients in bin 0, a count no 8-bit
    counter holds) and, where L > 1, a checkerboard MB in lane 1 (counts
    in bin 31)."""
    rng = np.random.default_rng(seed)
    src = rng.integers(0, 256, (384, L)).astype(np.uint8)
    src[:, 0] = 77
    if L > 1:
        r, c = np.mgrid[0:4, 0:4]
        src[:, 1] = np.tile((((r + c) % 2) * 255).reshape(16), 24)
    return src


# Lane counts for the alpha kernel's edges: one MB, fewer than one 16-lane
# load group, not a multiple of its 64-MB tile, and whole tiles (the
# 16-byte vector loads).
ALPHA_EDGE_L = (1, 2, 17, 100, 192)


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
    from webp_tpu_torch.ops import p2_kernel as P2K

    calls = {}
    wrappers = {(P1K, "alphas"): P1K.alphas_plain,
                (P1K, "mode_search"): P1K.mode_search_plain,
                (I4K, "i4_scores"): I4K.i4_scores_plain,
                (P2K, "phase2_pack"): P2K.phase2_pack_plain}
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
        assert all(n > 0 for n in encode_launches().values()), \
            cuda.LAUNCHES
        assert cuda.LAUNCHES["p2_wavefront"] == 1
        assert cuda.LAUNCHES["decode_wavefront"] == 0
    finally:
        for k, f in saved.items():
            setattr(k[0], k[1], f)
    assert on_card == webp_tpu_torch.encode_batch(imgs, 75, device="cpu")
    for key, plain in wrappers.items():
        args = calls[key]
        for got, ref in zip(_outputs(saved[key](*args)),
                            _outputs(plain(*args))):
            if got.is_floating_point():     # scores
                torch.testing.assert_close(got, ref, rtol=3e-7, atol=0)
            else:                           # modes, alphas and levels
                assert torch.equal(got, ref), key


def _outputs(x):
    return list(x.values()) if isinstance(x, dict) else list(x)


def _hold_phase2(W, H, B, split=None):
    from webp_tpu_torch.ops import cuda
    from webp_tpu_torch.ops import p2_kernel as P2K

    d = p2_inputs(B, W, H, W + H + B)
    if split is not None:
        d["is_i4"][:] = split == "i4"
    args = p2_args(d, "cuda")
    cuda.reset_launches()
    got = P2K.phase2_pack(*args, 1024.0, 1024)
    assert cuda.LAUNCHES["p2_wavefront"] == 1
    ref = P2K.phase2_pack_plain(*args, 1024.0, 1024)
    assert list(got) == list(ref)
    for k in ref:
        assert torch.equal(got[k], ref[k]), k


@pytest.mark.cuda
@pytest.mark.parametrize("geom", [(64, 48, 2), (16, 64, 2), (64, 16, 2),
                                  (1536, 1024, 16), (64, 48, 3),
                                  (48, 144, 2), (48, 144, 1), (48, 144, 3)])
def test_phase2_kernel_on_random_modes_equals_plain_version(geom):
    """Kernel 4 against its plain version on modes, I4 splits, I4 modes and
    segments drawn at random (every predictor on every edge), at a one-MB
    column, a one-MB row, the main path's size, and 9 MB rows (not a
    multiple of the cluster size) at B = 1, 2 and 3; the cluster sizes are
    1 (64x16), 2 (64x48), 4 (16x64) and 8 (the rest): every output
    equal."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    _hold_phase2(*geom)


@pytest.mark.cuda
@pytest.mark.parametrize("split", ["i4", "i16"])
@pytest.mark.parametrize("geom", [(64, 48, 3), (48, 144, 1),
                                  (1536, 1024, 16)])
def test_phase2_kernel_all_i4_or_all_i16_equals_plain_version(geom, split):
    """Kernel 4 with every MB I4 (the walk on every MB of every step) or
    every MB I16: every output equal to its plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    _hold_phase2(*geom, split=split)


@pytest.mark.cuda
@pytest.mark.parametrize("config", ["unsegmented", "i4_off", "both"])
@pytest.mark.parametrize("geom", [(64, 48, 2), (48, 144, 1), (1536, 1024, 1)])
def test_phase2_kernel_without_segments_or_i4_equals_plain_version(geom,
                                                                   config):
    """Kernel 4 with a zero segment map and one set of quant rows and/or a
    zero I4 split (the unsegmented and I4-off configurations) against its
    plain version, at B = 2 and at B = 1, whose one image runs on a cluster
    of 8 blocks: every output equal."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from webp_tpu_torch.ops import cuda
    from webp_tpu_torch.ops import p2_kernel as P2K
    from webp_tpu_torch.ops.pipeline import quant_params

    W, H, B = geom
    d = p2_inputs(B, W, H, W + H + B + 1)
    if config != "i4_off":
        d["qtab"] = broadcast_qtab(B, quant_params(75))
    args = list(p2_args(d, "cuda"))
    if config != "unsegmented":
        args[5], args[6] = torch.zeros_like(args[5]), torch.zeros_like(args[6])
    if config != "i4_off":
        args[7] = torch.zeros_like(args[7])
    cuda.reset_launches()
    got = P2K.phase2_pack(*args, 1024.0, 1024)
    assert cuda.LAUNCHES["p2_wavefront"] == 1
    ref = P2K.phase2_pack_plain(*args, 1024.0, 1024)
    for k in ref:
        assert torch.equal(got[k], ref[k]), k


@pytest.mark.cuda
@pytest.mark.parametrize("opts", [dict(method=2), dict(segments=1),
                                  dict(sns_strength=0, filter_strength=0,
                                       segments=2),
                                  dict(preprocessing=2)], ids=str)
@pytest.mark.parametrize("geom", [(72, 40), (32, 16)])
def test_encode_on_the_card_equals_the_cpu(geom, opts):
    """The single-image entry on the card writes the CPU run's file (I4
    off, unsegmented, the text preset, dithered import; 32x16 has fewer
    than 4 MBs and runs unsegmented at any setting)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    w, h = geom
    img = _images(1, h, w, seed=w + h)[0]
    assert webp_tpu_torch.encode(img, **opts) == webp_tpu_torch.encode(
        img, device="cpu", **opts)


@pytest.mark.cuda
@pytest.mark.parametrize("L", ALPHA_EDGE_L)
def test_alpha_kernel_on_edge_inputs_equals_plain_version(L):
    """Kernel 1 against its plain version on a flat MB, a checkerboard MB
    and random MBs, at lane counts below, across and at its tile: alphas
    and UV alphas equal."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from webp_tpu_torch.ops import cuda
    from webp_tpu_torch.ops import p1_kernels as P1K

    src = torch.as_tensor(alpha_edge_inputs(L, L)).to("cuda")
    cuda.reset_launches()
    got = P1K.alphas(src)
    assert cuda.LAUNCHES["p1_alpha"] == 1
    ref = P1K.alphas_plain(src)
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])


@pytest.mark.cuda
@pytest.mark.parametrize("use_td", [False, True])
def test_mode_search_kernel_at_a_ragged_lane_count(use_td):
    """Kernel 2 against its plain version at L = 21 lanes (3 images of 7
    MBs; not a multiple of its 16 MBs per block) on random sources and
    contexts: modes equal, scores within rtol 3e-7."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from webp_tpu_torch.ops import cuda
    from webp_tpu_torch.ops import fastpath as FP
    from webp_tpu_torch.ops import p1_kernels as P1K

    rng = np.random.default_rng(5)
    B, n_mb = 3, 7
    L = B * n_mb
    src = rng.integers(0, 256, (P1K.N_SRC, L))
    ctx = rng.integers(0, 256, (P1K.N_CTX, L))
    ctx[P1K.C_HT] = rng.integers(0, 2, L)
    ctx[P1K.C_HL] = rng.integers(0, 2, L)
    ctx[P1K.C_SEG] = rng.integers(0, 4, L)
    tabs = FP.all_q_tables()[0]
    seg_q = rng.integers(10, 120, (B, 4))
    qtab = np.stack([tabs[k][seg_q] for k in ("y1", "y2", "uv")],
                    axis=1).reshape(B, 48, 16)
    lams = rng.uniform(1.0, 400.0, (B, 16))
    dev = torch.device("cuda")
    args = (torch.as_tensor(src.astype(np.uint8)).to(dev),
            torch.as_tensor(ctx.astype(np.uint8)).to(dev),
            torch.as_tensor(qtab.astype(np.int32)).to(dev),
            torch.as_tensor(lams.astype(np.float32)).to(dev),
            FP.device_tables(dev).rate_consts, n_mb, use_td)
    cuda.reset_launches()
    got = P1K.mode_search(*args)
    assert cuda.LAUNCHES["p1_mode"] == 1
    ref = P1K.mode_search_plain(*args)
    assert torch.equal(got[0], ref[0]) and torch.equal(got[1], ref[1])
    torch.testing.assert_close(got[2], ref[2], rtol=3e-7, atol=0)


@pytest.mark.cuda
def test_i4_kernel_with_the_ban_lifted_at_a_ragged_lane_count():
    """Kernel 3 on the rows of the skew-2 search (row 29 zero: no mode
    banned in the rightmost subblock column) against its plain version, at
    3 images of 5x3 MBs (720 subblock lanes, not a multiple of its block):
    modes equal, scores within rtol 3e-7; some rightmost-column subblock
    takes a strip-reading mode."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from webp_tpu_torch.ops import cuda
    from webp_tpu_torch.ops import fastpath as FP
    from webp_tpu_torch.ops import i4 as I4
    from webp_tpu_torch.ops import i4_kernel as I4K

    rng = np.random.default_rng(9)
    B, mb_w, mb_h = 3, 5, 3
    n_sb = 16 * mb_w * mb_h
    Y = np.stack([im[..., 1] for im in _images(B, 16 * mb_h, 16 * mb_w, 9)])
    seg_map = rng.integers(0, 4, (B, mb_w * mb_h))
    dev = torch.device("cuda")
    data = I4._planar_inputs(torch.as_tensor(Y).to(dev),
                             torch.as_tensor(seg_map).to(dev), mb_w, mb_h,
                             allow_tr=True)
    assert not data[29].any()
    tabs, _, _, lam4, qi4 = FP.all_q_tables()
    seg_q = rng.integers(10, 120, (B, 4))
    qtab = torch.as_tensor(tabs["y1"][seg_q].reshape(B, 16, 16)
                           .astype(np.int32)).to(dev)
    lams = torch.as_tensor(np.concatenate(
        [lam4[seg_q], ((50 * qi4[seg_q]) >> 5).astype(np.float32),
         FP._lam_mode_table(qi4)[seg_q]], axis=1)).to(dev)
    for use_td in (False, True):
        args = (data, qtab, lams, FP.device_tables(dev).rate_consts, n_sb,
                use_td)
        cuda.reset_launches()
        got = I4K.i4_scores(*args)
        assert cuda.LAUNCHES["i4_search"] == 1
        ref = I4K.i4_scores_plain(*args)
        assert torch.equal(got[0], ref[0])
        torch.testing.assert_close(got[1], ref[1], rtol=3e-7, atol=0)
    c3 = got[0].reshape(B, mb_h, 4, mb_w, 4)[..., 3].cpu().numpy()
    assert np.isin(c3, (2, 6, 7)).any()


@pytest.mark.cuda
@pytest.mark.parametrize("method", [5, 6])
@pytest.mark.parametrize("geom", [(72, 40), (32, 16)])
def test_quality_methods_on_the_card_equal_the_cpu(geom, method):
    """Methods 5 and 6 (the skew-2 loop with the trellis, and the in-loop
    search, its steps replayed from a CUDA graph on the card) write the
    CPU run's file; kernels 1-3 launch once each (kernel 1 only when
    segmented) and kernel 4 not at all."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from webp_tpu_torch.ops import cuda

    w, h = geom
    img = _images(1, h, w, seed=w + h + method)[0]
    cuda.reset_launches()
    got = webp_tpu_torch.encode(img, method=method)
    assert dict(cuda.LAUNCHES) == {
        "p1_alpha": int(w * h >= 4 * 256), "p1_mode": 1, "i4_search": 1,
        "p2_wavefront": 0, "decode_wavefront": 0}
    assert got == webp_tpu_torch.encode(img, device="cpu", method=method)


def sharp_planes_within_tolerance(rgb, what):
    """The sharp-YUV planes of rgb (numpy [B, H, W, 3]) on the card
    against the CPU's: every sample within 1, at most one sample in 10^4
    off (the card's powf is not the C library's). Returns the number of
    differing samples."""
    from webp_tpu_torch.ops import sharpyuv as SY

    x = torch.as_tensor(rgb)
    card = SY.sharp_yuv420(x.to("cuda"))
    cpu = SY.sharp_yuv420(x)
    n = total = 0
    for c, p in zip(card, cpu):
        d = (c.cpu().to(torch.int32) - p.to(torch.int32)).abs()
        assert int(d.max()) <= 1, what
        n += int((d != 0).sum())
        total += d.numel()
    assert n * 10_000 <= total, f"{what}: {n} of {total} samples differ"
    return n


@pytest.mark.cuda
def test_sharp_yuv_on_the_card_within_tolerance():
    """The card's sharp-YUV planes within the stated tolerance of the
    CPU's, on a batch of two images and on a smooth 512x512 gradient; the
    files of encode(use_sharp_yuv=True) equal the CPU's where the planes
    do."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from webp_tpu_torch.ops import sharpyuv as SY

    imgs = np.stack(_images(2, 48, 64, seed=12))
    sharp_planes_within_tolerance(imgs, "64x48 B=2")
    y, x = np.mgrid[0:512, 0:512]
    smooth = np.stack([x // 2, y // 2, (x + y) // 4], -1).astype(np.uint8)
    sharp_planes_within_tolerance(smooth[None], "smooth 512x512")
    for img in imgs:
        planes_equal = all(torch.equal(c.cpu(), p) for c, p in zip(
            SY.sharp_yuv420(torch.as_tensor(img[None]).cuda()),
            SY.sharp_yuv420(torch.as_tensor(img[None]))))
        if planes_equal:
            assert webp_tpu_torch.encode(img, use_sharp_yuv=True) == \
                webp_tpu_torch.encode(img, device="cpu", use_sharp_yuv=True)


@pytest.mark.cuda
def test_stream_on_the_card_equals_encode_batch():
    """The pipelined stream (side-stream uploads, pinned fetches) with
    device YUV writes encode_batch's files, a ragged last batch
    included."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from webp_tpu_torch.container import riff
    from webp_tpu_torch.lossy.device_encode import encode_lossy_stream

    imgs = _images(5, 40, 72, seed=2)
    got = encode_lossy_stream(imgs, 75, batch=2, host_yuv=False)
    assert [riff.assemble_riff([riff.Chunk(riff.VP8, b)]) for b in got] == \
        webp_tpu_torch.encode_batch(imgs, 75, device="cuda")


def _bitstream(data):
    """The VP8 bitstream of a WebP file's first frame."""
    from webp_tpu_torch.container.parser import Parser

    return Parser(data).frames()[0].bitstream


def _vp8(img, **opts):
    """The VP8 bitstream of the port's host encode of img."""
    return _bitstream(webp_tpu_torch.encode(img, backend="host", **opts))


# The three branches of the device decode: the normal filter, the simple
# filter (luma only) and no filter, at ragged sizes, I4-rich at method 6.
DECODE_CASES = {
    "normal_72x40": ((72, 40), dict(quality=40)),
    "normal_m6_33x17": ((33, 17), dict(quality=60, method=6)),
    "simple_72x40": ((72, 40), dict(quality=40, filter_type=0)),
    "simple_m6_50x30": ((50, 30), dict(quality=60, method=6,
                                        filter_type=0)),
    "nofilter_33x17": ((33, 17), dict(quality=70, filter_strength=0)),
    "nofilter_m6_64x48": ((64, 48), dict(quality=80, method=6,
                                         filter_strength=0)),
}


@pytest.mark.cuda
@pytest.mark.parametrize("name", list(DECODE_CASES))
def test_device_decode_on_the_card_equals_host_decoder(name):
    """The device decode on the card (the decode kernel, launched once per
    decode) gives the native decoder's planes and RGB and the plain
    version's planes on the CPU, launches none of the encode kernels, and
    gives a second bitstream of the geometry its own pixels."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from webp_tpu_torch.lossy import decode as dec
    from webp_tpu_torch.lossy import device_decode as dd
    from webp_tpu_torch.ops import cuda

    (w, h), opts = DECODE_CASES[name]
    bs = _vp8(_images(1, h, w, seed=w * h)[0], **opts)
    cuda.reset_launches()
    planes = dd.decode_vp8_yuv_device(bs)
    rgb = dd.decode_vp8_rgb_device(bs)
    assert dict(cuda.LAUNCHES) == dict(
        {k: 0 for k in cuda.LAUNCHES}, decode_wavefront=2), cuda.LAUNCHES
    for got, want in zip(planes, dec.decode_vp8_yuv(bs)):
        assert np.array_equal(got, want)
    assert np.array_equal(rgb, dec.decode_vp8_rgba(bs)[..., :3])
    assert np.array_equal(rgb, dd.decode_vp8_rgb_device(bs, device="cpu"))
    for got, want in zip(planes, dd.decode_vp8_yuv_device(bs, device="cpu")):
        assert np.array_equal(got, want)
    bs2 = _vp8(_images(1, h, w, seed=w * h + 1)[0], **opts)
    assert np.array_equal(dd.decode_vp8_rgb_device(bs2),
                          dec.decode_vp8_rgba(bs2)[..., :3])


# The decode kernel's geometries: the benchmark's, ragged, one MB, one MB
# row; its filter types: (encode options, vp8_parse's filter type).
KERNEL_GEOMS = [(1536, 1024), (33, 17), (16, 16), (200, 16)]
FILTERS = {"none": (dict(filter_strength=0), 0),
           "simple": (dict(filter_type=0), 1),
           "normal": ({}, 2)}


def _decode_inputs(bss, dev):
    """DecodeFn and its inputs (on dev, the bitstreams stacked on the batch
    axis) for bitstreams of one geometry and filter type."""
    from webp_tpu_torch.lossy import device_decode as dd

    parsed = [dd._parse_inputs(b) for b in bss]
    ins = [torch.cat(ts).to(dev) for ts in zip(
        *[dd._host_inputs(p) for p in parsed])]
    return dd._fn(parsed[0], False), ins, parsed[0][0]


@pytest.mark.cuda
@pytest.mark.parametrize("ftype", list(FILTERS))
@pytest.mark.parametrize("geom", KERNEL_GEOMS, ids=str)
def test_decode_kernel_equals_plain_version_and_host_decoder(geom, ftype):
    """On every filter type and geometry, the kernel's MB-padded planes
    equal the plain version's (the step loop on the CPU), and the planes
    and RGB of the device decode equal the native decoder's, byte for
    byte; one launch a decode."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from webp_tpu_torch.lossy import decode as dec
    from webp_tpu_torch.lossy import device_decode as dd
    from webp_tpu_torch.ops import cuda

    (w, h), (opts, want_ft) = geom, FILTERS[ftype]
    img = _images(1, h, w, seed=w + h)[0]
    # The full-size file from the card's encoder, the small ones I4-rich
    # from the host's at method 6.
    bs = _vp8(img, method=6, quality=40, **opts) if w * h < 65536 else \
        _bitstream(webp_tpu_torch.encode(img, quality=40, **opts))
    fn, ins, P = _decode_inputs([bs], "cuda")
    assert int(P["finfo"][0]) == want_ft, "premise: the filter type"
    cuda.reset_launches()
    got = fn(*ins)
    assert cuda.LAUNCHES["decode_wavefront"] == 1
    want = fn.plain(*[t.cpu() for t in ins])
    for g, r in zip(got, want):
        assert torch.equal(g.cpu(), r)
    cw, ch = (w + 1) >> 1, (h + 1) >> 1
    host = dec.decode_vp8_yuv(bs)
    for g, r, (pw, ph) in zip(got, host, ((w, h), (cw, ch), (cw, ch))):
        assert np.array_equal(g[0, :ph, :pw].cpu().numpy(), r)
    assert np.array_equal(dd.decode_vp8_rgb_device(bs),
                          dec.decode_vp8_rgba(bs)[..., :3])


@pytest.mark.cuda
@pytest.mark.parametrize("ftype", list(FILTERS))
def test_decode_kernel_batch_equals_its_single_images(ftype):
    """A batch of three bitstreams of one geometry in one launch equals
    each decoded alone (B = 1) and the native decoder."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from webp_tpu_torch.lossy import decode as dec
    from webp_tpu_torch.ops import cuda

    opts, _ = FILTERS[ftype]
    bss = [_vp8(im, method=6, quality=q, **opts) for im, q in zip(
        _images(3, 40, 72, seed=5), (30, 60, 90))]
    fn, ins, _ = _decode_inputs(bss, "cuda")
    cuda.reset_launches()
    both = fn(*ins)
    assert cuda.LAUNCHES["decode_wavefront"] == 1
    for i, bs in enumerate(bss):
        one = fn(*_decode_inputs([bs], "cuda")[1])
        for g, r in zip(both, one):
            assert torch.equal(g[i], r[0])
        assert np.array_equal(both[0][i, :40, :72].cpu().numpy(),
                              dec.decode_vp8_yuv(bs)[0])


@pytest.mark.cuda
def test_decode_launches_the_kernel_once_and_never_the_plain_version(
        monkeypatch):
    """decode() on the card launches the decode kernel exactly once a call
    and no encode kernel; the plain version (the step loop) is never
    reached by card tensors, and a wrong input dtype raises."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from webp_tpu_torch.ops import cuda
    from webp_tpu_torch.ops import decode as od

    def plain(*a, **k):
        raise AssertionError("the plain version ran for card tensors")

    monkeypatch.setattr(od.DecodeFn, "plain", plain)
    monkeypatch.setattr(od._StepLoop, "run", plain)
    data = webp_tpu_torch.encode(_images(1, 48, 64, seed=8)[0],
                                 backend="host")
    host = webp_tpu_torch.decode(data, backend="host")
    cuda.reset_launches()
    for n in (1, 2, 3):
        assert np.array_equal(webp_tpu_torch.decode(data), host)
        assert dict(cuda.LAUNCHES) == dict(
            {k: 0 for k in cuda.LAUNCHES}, decode_wavefront=n)
    fn, ins, _ = _decode_inputs([_bitstream(data)], "cuda")
    with pytest.raises(TypeError):
        fn(ins[0].to(torch.int32), *ins[1:])
    assert cuda.LAUNCHES["decode_wavefront"] == 3


@pytest.mark.cuda
def test_decode_api_and_stream_on_the_card():
    """decode()'s default backend runs on the card and equals the host
    backend; decode_lossy_stream_device over six bitstreams of mixed
    sizes and filter types equals the single decodes."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from webp_tpu_torch.lossy import decode as dec
    from webp_tpu_torch.lossy import device_decode as dd

    img = _images(1, 40, 72, seed=3)[0]
    data = webp_tpu_torch.encode(img, backend="host", method=6)
    assert np.array_equal(webp_tpu_torch.decode(data),
                          webp_tpu_torch.decode(data, backend="host"))
    datas = [_vp8(_images(1, h, w, seed=i)[0], **o)
             for i, ((w, h), o) in enumerate(DECODE_CASES.values())]
    for bs, rgb in zip(datas, dd.decode_lossy_stream_device(datas)):
        assert np.array_equal(rgb, dec.decode_vp8_rgba(bs)[..., :3])
    for bs, pl in zip(datas, dd.decode_lossy_stream_device(
            datas, upsample=False)):
        for got, want in zip(pl, dec.decode_vp8_yuv(bs)):
            assert np.array_equal(got, want)


@pytest.mark.cuda
@pytest.mark.parametrize("opts", [
    dict(autofilter=True), dict(autofilter=True, use_sharp_yuv=True),
    dict(target_size=1500), dict(target_psnr=32.0, method=6)], ids=str)
def test_unblocked_options_on_the_card_equal_the_cpu(opts):
    """autofilter and rate control on the device backend write the CPU
    run's file, with the same LAST_STATS."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    import dataclasses

    img = _images(1, 48, 64, seed=11)[0]
    got = webp_tpu_torch.encode(img, **opts)
    stats = dataclasses.astuple(webp_tpu_torch.LAST_STATS)
    assert got == webp_tpu_torch.encode(img, device="cpu", **opts)
    assert stats == dataclasses.astuple(webp_tpu_torch.LAST_STATS)


def test_launch_signatures_match_the_cuda_sources():
    """Each kernel's ctypes signature names the same parameters, pointer,
    float or int, as its `extern "C"` launcher in csrc/ (plus the
    stream)."""
    import os
    import re

    from webp_tpu_torch import _build
    from webp_tpu_torch.ops import cuda

    assert set(cuda.SIGNATURES) == set(_build.KERNEL_LIBS) == set(
        cuda.LAUNCHES)
    assert "decode_wavefront" in _build.KERNEL_LIBS
    for name in _build.KERNEL_LIBS:
        (src,) = _build.LIBS[name][1]
        with open(os.path.join(_build.HERE, src)) as f:
            text = f.read()
        m = re.search(r'extern "C" int ' + name + r"_launch\(([^)]*)\)", text)
        params = [p.strip() for p in m.group(1).split(",")]
        kinds = ["p" if "*" in p else "f" if p.startswith("float ") else "i"
                 for p in params]
        assert kinds[-1] == "p" and params[-1].endswith("stream")
        want = [{cuda._P: "p", cuda._F: "f", cuda._I: "i"}[t]
                for t in cuda.SIGNATURES[name]]
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


def _rgba(h, w, seed):
    """_images' content under an alpha plane with a soft edge, a fully
    transparent band and a noisy region."""
    rng = np.random.default_rng(seed)
    a = np.clip((np.arange(w)[None, :] - w // 3) * 9, 0, 255) + \
        np.zeros((h, 1), np.int64)
    a[: h // 5] = 0
    a[h // 2:, w // 2:] = rng.integers(0, 256, (h - h // 2, w - w // 2))
    return np.dstack([_images(1, h, w, seed)[0], a.astype(np.uint8)])


@pytest.mark.cuda
@pytest.mark.parametrize("geom", [(33, 17), (72, 40), (640, 480)])
def test_predictor_search_on_the_card_equals_native_predictor(geom):
    """ops/lossless.py predictor_search on the card gives the native C++
    predictor's residuals and modes at every tile size."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from webp_tpu_torch.lossless import encode as le
    from webp_tpu_torch.native import api
    from webp_tpu_torch.ops import lossless as ol

    w, h = geom
    argb = le.subtract_green(le.rgba_to_argb(_rgba(h, w, w)))
    t = torch.from_numpy(argb.view(np.int32)).cuda()
    for bits in (2, 3, 4, 5):
        res, modes = ol.predictor_search(t, bits)
        n_res, n_modes = api.vp8l_predictor_transform(argb, bits)
        assert np.array_equal(res.cpu().numpy().astype(np.uint32), n_res)
        assert np.array_equal(modes.cpu().numpy(), n_modes)


@pytest.mark.cuda
@pytest.mark.parametrize("opts", [dict(lossless=True),
                                  dict(lossless=True, near_lossless=60),
                                  dict(lossless=True, method=6, quality=90),
                                  {}, dict(alpha_filtering=2, method=6)],
                         ids=str)
@pytest.mark.parametrize("geom", [(72, 40), (33, 17)])
def test_lossless_and_alpha_on_the_card_equal_the_cpu(geom, opts):
    """encode(rgba) on the card (the predictor search there when
    lossless, kernels 1-4 beside the host ALPH encode when lossy) writes
    the CPU run's file, and both decode backends give the same pixels,
    the source's alpha where alpha_quality is 100."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from webp_tpu_torch.ops import cuda

    w, h = geom
    img = _rgba(h, w, w + h)
    cuda.reset_launches()
    on_card = webp_tpu_torch.encode(img, **opts)
    want = 0 if opts.get("lossless") else 1
    assert set(cuda.LAUNCHES.values()) <= {0, want}
    assert on_card == webp_tpu_torch.encode(img, device="cpu", **opts)
    px = webp_tpu_torch.decode_rgba(on_card)
    assert np.array_equal(px, webp_tpu_torch.decode_rgba(on_card,
                                                         backend="host"))
    if opts.get("near_lossless", 100) == 100:
        assert np.array_equal(px[..., 3], img[..., 3])


def _anim_frames(h, w, n, seed):
    """RGBA frames: _images' content under a moving opaque sprite, frame 1
    repeated, a semi-transparent banner on frames 2 and 3."""
    rng = np.random.default_rng(seed)
    bg = _images(1, h, w, seed)[0]
    sprite = rng.integers(0, 256, (12, 12, 3), np.uint8)
    out = []
    for i in range(n):
        f = np.dstack([bg, np.full((h, w), 255, np.uint8)])
        x0, y0 = (4 * i) % (w - 12), (2 * i) % (h - 12)
        f[y0:y0 + 12, x0:x0 + 12, :3] = sprite
        if i in (2, 3):
            f[h - 10: h - 4, 2: w - 2] = (240, 30, 200, 128)
        out.append(f)
    out.insert(2, out[1].copy())
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("geom", [(64, 48), (72, 40)])
def test_animation_on_the_card_equals_the_cpu(geom):
    """encode_animation_device (kernels 1-4 once per batch), the
    AnimEncoder lossless (predictor search on the card; no kernel) and
    mixed, then decode_animation on both backends and AnimDecoder on the
    card: the card's files and canvases equal the CPU's."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from webp_tpu_torch.animation import animation as A
    from webp_tpu_torch.ops import cuda

    w, h = geom
    frames = _anim_frames(h, w, 5, w)
    cuda.reset_launches()
    dev = A.encode_animation_device(frames, 40, batch=2)
    # 5 unique frames of 6 in batches of 2.
    assert set(encode_launches().values()) == {3}, cuda.LAUNCHES
    assert cuda.LAUNCHES["decode_wavefront"] == 0
    assert dev == A.encode_animation_device(frames, 40, batch=2,
                                            device="cpu")
    files = [dev]
    for opts in (dict(lossless=True), dict(allow_mixed=True), {}):
        cuda.reset_launches()
        on_card = A.encode_animation(frames, 40, **opts)
        assert not any(cuda.LAUNCHES.values())
        assert on_card == A.encode_animation(frames, 40, device="cpu",
                                             **opts)
        assert on_card == A.encode_animation(frames, 40, backend="host",
                                             **opts)
        files.append(on_card)
    for data in files:
        want = [c for c, _ in A.AnimDecoder(
            A.decode_animation(data, backend="host"), device="cpu")]
        anim = A.decode_animation(data)
        got = [c for c, _ in A.AnimDecoder(anim)]
        assert len(got) == len(want)
        assert all(np.array_equal(g, c) for g, c in zip(got, want))
    lossless = [c for c, _ in A.AnimDecoder(A.decode_animation(files[1]))]
    assert all(np.array_equal(c, f) for c, f in zip(lossless, [
        frames[i] for i in (0, 1, 3, 4, 5)]))


@pytest.mark.cuda
def test_alpha_blend_and_metrics_on_the_card_equal_the_cpu():
    """alpha_blend, sse, tdisto4x4 exactly; psnr_from_sse and ssim_plane
    within rtol 1e-5, at 1280x720."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from webp_tpu_torch.animation.animation import alpha_blend
    from webp_tpu_torch.ops import metrics as M

    rng = np.random.default_rng(21)
    src = torch.from_numpy(rng.integers(0, 256, (720, 1280, 4), np.uint8))
    dst = torch.from_numpy(rng.integers(0, 256, (720, 1280, 4), np.uint8))
    src[::3, :, 3] = 0
    src[1::3, :, 3] = 255
    assert torch.equal(alpha_blend(src.cuda(), dst.cuda()).cpu(),
                       alpha_blend(src, dst))
    a, b = src[..., 0], dst[..., 0]
    s = M.sse(a.cuda(), b.cuda())
    assert int(s) == int(M.sse(a, b))
    assert float(M.psnr_from_sse(s, a.numel())) == pytest.approx(
        float(M.psnr_from_sse(M.sse(a, b), a.numel())), rel=1e-5)
    blk = (a.reshape(-1, 4, 4), b.reshape(-1, 4, 4))
    assert torch.equal(M.tdisto4x4(*[t.cuda() for t in blk]).cpu(),
                       M.tdisto4x4(*blk))
    assert float(M.ssim_plane(a.cuda(), b.cuda())) == pytest.approx(
        float(M.ssim_plane(a, b)), rel=1e-5)


@pytest.mark.cuda
def test_band_encoders_on_the_card_equal_the_cpu():
    """The non-planar program's blob, the exact band pipeline's files and
    the sharded encoder's outputs (2 bands, both on the card) and the
    wavefront oracle's outputs equal the CPU's at 64x64."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from webp_tpu_torch.ops import fastpath as FP
    from webp_tpu_torch.ops import wavefront as WF
    from webp_tpu_torch.parallel import exact as EX
    from webp_tpu_torch.parallel import mesh as ME

    imgs = np.stack(_images(2, 64, 64, 50))
    fn = FP.fast_encode_fn(4, 4, 75, 4, 50, True, planar=False)
    for a, b in zip(fn.rgb_blob(torch.as_tensor(imgs).cuda()),
                    fn.rgb_blob(torch.as_tensor(imgs))):
        assert torch.equal(a.cpu(), b)
    assert (EX.encode_lossy_mesh(list(imgs), devices=["cuda"] * 2)
            == EX.encode_lossy_mesh(list(imgs), devices=["cpu"] * 2))
    outs = [ME.make_sharded_encode_fn(ME.make_mesh(devices=[d] * 2, dp=1))(
        imgs) for d in ("cuda", "cpu")]
    assert all(torch.equal(a.cpu(), b) for a, b in zip(*outs))
    wf = WF.wavefront_encode_fn(4, 4, 75)
    from webp_tpu_torch.encoder import rgb_to_yuv420

    planes = [torch.as_tensor(p) for p in rgb_to_yuv420(imgs[0])]
    for a, b in zip(wf(*(p.cuda() for p in planes)), wf(*planes)):
        assert torch.equal(a.cpu(), b)
    from webp_tpu_torch.lossy import device_encode as DE

    assert (DE.encode_lossy_stream(list(imgs), devices=["cuda"] * 2)
            == DE.encode_lossy_stream(list(imgs), devices=["cpu"] * 2))


@pytest.mark.cuda
def test_kernel4_on_the_oracles_modes_equals_the_oracle():
    """Kernel 4 on the card, given the wavefront oracle's I16 and chroma
    modes (unsegmented q75, I4 off, rd_drop 0), quantizes the oracle's
    levels, y2 and skip flags."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from webp_tpu_torch.encoder import rgb_to_yuv420
    from webp_tpu_torch.ops import fastpath as FP
    from webp_tpu_torch.ops import p2_kernel as P2K
    from webp_tpu_torch.ops import wavefront as WF

    for h, w in ((48, 64), (64, 80), (48, 16)):
        mbw, mbh = w // 16, h // 16
        n = mbw * mbh
        planes = [torch.as_tensor(p).cuda() for p in rgb_to_yuv420(
            _images(1, h, w, 51)[0])]
        lv, y2, modes, uvm, skip = WF.wavefront_encode_fn(mbw, mbh, 75)(
            *planes)
        plan = FP._single_plan(75, 0, 1, n, planes[0].device)
        wire = P2K.phase2_pack(
            *(p[None] for p in planes), modes[None], uvm[None],
            torch.zeros((1, n), dtype=torch.bool, device="cuda"),
            torch.zeros((1, n, 16), dtype=torch.uint8, device="cuda"),
            plan[0], plan[3], 0.0, 1024)
        wire = {k: v[0].cpu().numpy() for k, v in wire.items()}
        got = FP.unpack_levels(wire["packed"], wire["esc_idx"],
                               wire["esc_val"], int(wire["esc_cnt"]), n)
        assert np.array_equal(got, lv.cpu().numpy())
        assert np.array_equal(wire["y2"], y2.cpu().numpy())
        assert np.array_equal(wire["skip"].astype(bool), skip.cpu().numpy())



@pytest.mark.cuda
@pytest.mark.parametrize("geom", [(64, 48), (72, 40)])
def test_cli_on_the_card_equals_encode_and_the_cpu(geom, tmp_path):
    """The CLI's defaults run on the card: `enc in.png out.webp` launches
    each encode kernel once and writes encode(img)'s bytes, which `enc
    -device cpu` also writes; `dec` launches the decode kernel once and
    gives the host decoder's pixels, as `dec -device cpu` does."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from webp_tpu_torch.cli import main
    from webp_tpu_torch.ops import cuda
    from webp_tpu_torch.utils.png import read_png, write_png

    w, h = geom
    img = _images(1, h, w, 61)[0]
    src, out = str(tmp_path / "in.png"), str(tmp_path / "out.webp")
    with open(src, "wb") as f:
        f.write(write_png(img))
    cuda.reset_launches()
    assert main(["enc", src, out]) == 0
    assert set(encode_launches().values()) == {1}, cuda.LAUNCHES
    assert cuda.LAUNCHES["decode_wavefront"] == 0
    data = open(out, "rb").read()
    assert data == webp_tpu_torch.encode(img)
    assert main(["enc", "-device", "cpu", src, out + ".cpu"]) == 0
    assert open(out + ".cpu", "rb").read() == data
    cuda.reset_launches()
    assert main(["dec", out, str(tmp_path / "back.png")]) == 0
    assert dict(cuda.LAUNCHES) == dict(
        {k: 0 for k in cuda.LAUNCHES}, decode_wavefront=1), cuda.LAUNCHES
    back = read_png(open(tmp_path / "back.png", "rb").read())
    assert np.array_equal(back, webp_tpu_torch.decode(data, backend="host"))
    assert main(["dec", "-device", "cpu", out, str(tmp_path / "c.png")]) == 0
    assert np.array_equal(read_png(open(tmp_path / "c.png", "rb").read()),
                          back)


@pytest.mark.cuda
def test_cli_and_png_at_full_size_on_the_card(tmp_path):
    """1536x1024: read_png(write_png(img)) is img (RGB and RGBA), and the
    CLI's enc and dec on the card equal encode(img) and the host
    decoder."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from webp_tpu_torch.cli import main
    from webp_tpu_torch.utils.png import read_png, write_png

    img = _images(1, 1024, 1536, 62)[0]
    rgba = np.dstack([img, img[..., 1]])
    for a in (img, rgba):
        assert np.array_equal(read_png(write_png(a)), a)
    src, out = str(tmp_path / "in.png"), str(tmp_path / "out.webp")
    with open(src, "wb") as f:
        f.write(write_png(img))
    assert main(["enc", src, out]) == 0
    data = open(out, "rb").read()
    assert data == webp_tpu_torch.encode(img)
    assert main(["dec", out, str(tmp_path / "back.png")]) == 0
    assert np.array_equal(read_png(open(tmp_path / "back.png", "rb").read()),
                          webp_tpu_torch.decode(data, backend="host"))
