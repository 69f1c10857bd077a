"""The port's lossless codec on the CPU, against webp_tpu: the bit I/O,
the Huffman tables and code writer, the numpy inverse transforms,
near-lossless, the native VP8L encoder and decoder, ops/lossless.py's
PyTorch transforms and predictor search, encode_vp8l's bytes and
encode(img, lossless=True) on both backends, and decode/decode_rgba of
VP8L files made by the port, the reference and Pillow. Every comparison
is exact. No reference JAX program is compiled: the reference's lossless
encoder and decoder are host code, and its ops/lossless.py functions run
eagerly.

One difference from the reference is intended (test_lone_symbol_*):
where a Huffman tree's code-length code has a single used symbol, the
reference writes 1 bit per run-length token and its file does not decode;
the port writes 0 bits, and its file decodes to the source."""

import io

import numpy as np
import pytest
import torch
from PIL import Image

import webp_tpu
import webp_tpu_torch
from webp_tpu.bitio import lossless as bio_ref
from webp_tpu.lossless import decode as dec_ref
from webp_tpu.lossless import encode as enc_ref
from webp_tpu.lossless import huffman as hf_ref
from webp_tpu.lossless import huffman_enc as hfe_ref
from webp_tpu.lossless import near_lossless as nl_ref
from webp_tpu.lossless import transforms as tf_ref
from webp_tpu_torch.bitio import lossless as bio
from webp_tpu_torch.container import parser, riff
from webp_tpu_torch.lossless import decode as dec
from webp_tpu_torch.lossless import encode as enc
from webp_tpu_torch.lossless import huffman as hf
from webp_tpu_torch.lossless import huffman_enc as hfe
from webp_tpu_torch.lossless import near_lossless as nl
from webp_tpu_torch.lossless import transforms as tf
from webp_tpu_torch.native import api as native
from webp_tpu_torch.ops import lossless as ops


def _u32(rng, shape):
    return rng.integers(0, 1 << 32, shape, dtype=np.uint64).astype(np.uint32)


def _t(a):
    """uint32 numpy -> the int32 bit view as a CPU tensor."""
    return torch.from_numpy(np.ascontiguousarray(a).view(np.int32))


def _n(t):
    """A packed int64 tensor -> uint32 numpy."""
    return t.numpy().astype(np.uint32)


def photo(h, w, seed, alpha=False):
    """Gradients, a noisy patch, flat areas and edges (a photo-like mix);
    with alpha: a soft ramp, a transparent band and a noisy region."""
    rng = np.random.default_rng(seed)
    y, x = np.mgrid[0:h, 0:w]
    img = np.stack([x * 255 // max(w - 1, 1), y * 255 // max(h - 1, 1),
                    ((x + 2 * y) * 3) % 256], -1).astype(np.int32)
    img[h // 4: h // 2, w // 4: w // 2] += rng.integers(
        -40, 40, (h // 2 - h // 4, w // 2 - w // 4, 3))
    img[h // 2:, : w // 3] = rng.integers(0, 256, 3)
    img[:, 5::11] = 255
    img = np.clip(img, 0, 255).astype(np.uint8)
    if not alpha:
        return img
    a = np.clip(x * 3 - 20, 0, 255).astype(np.uint8)
    a[:, : w // 5] = 0
    a[h // 3: h // 2, w // 2:] = rng.integers(0, 256, (h // 2 - h // 3,
                                                       w - w // 2))
    return np.dstack([img, a])


def palette_image(h, w, n, seed, alpha=False):
    rng = np.random.default_rng(seed)
    pal = rng.integers(0, 256, (n, 4 if alpha else 3), dtype=np.uint8)
    idx = (np.add.outer(np.arange(h) // 3, np.arange(w) // 5) % n)
    idx[h // 2:, w // 2:] = rng.integers(0, n, (h - h // 2, w - w // 2))
    return pal[idx]


def noise(h, w, seed, ch=3):
    return np.random.default_rng(seed).integers(0, 256, (h, w, ch), np.uint8)


# ---------------------------------------------------------------------------
# Bit I/O.
# ---------------------------------------------------------------------------

def test_bit_writer_and_reader_equal_reference():
    rng = np.random.default_rng(0)
    ops_ = [(int(rng.integers(0, 1 << 24)), int(rng.integers(0, 25)))
            for _ in range(3000)]
    w, w_ref = bio.LosslessBitWriter(), bio_ref.LosslessBitWriter()
    for v, n in ops_:
        w.write_bits(v, n)
        w_ref.write_bits(v, n)
        assert w.bit_position() == w_ref.bit_position()
    data = w.finish()
    assert data == w_ref.finish()
    # Read past the end too: eos latches the same way.
    r, r_ref = bio.LosslessBitReader(data), bio_ref.LosslessBitReader(data)
    for _, n in ops_ + [(0, 24)] * 4:
        assert r.read_bits(n) == r_ref.read_bits(n)
        assert r.eos == r_ref.eos and r.bit_pos == r_ref.bit_pos
    assert r.is_end_of_stream() == r_ref.is_end_of_stream()


@pytest.mark.parametrize("offset", range(17))
def test_append_bits_buffer_at_every_offset_equals_reference(offset):
    rng = np.random.default_rng(offset)
    for nbits in (1, 7, 8, 9, 63, 64, 1001):
        buf = rng.integers(0, 256, (nbits + 7) // 8, np.uint8).tobytes()
        head = int(rng.integers(0, 1 << offset)) if offset else 0
        w, w_ref = bio.LosslessBitWriter(), bio_ref.LosslessBitWriter()
        for x in (w, w_ref):
            x.write_bits(head, offset)
            x.append_bits_buffer(buf, nbits)
            x.write_bits(5, 3)
        assert w.bit_position() == w_ref.bit_position() == offset + nbits + 3
        assert w.finish() == w_ref.finish()


# ---------------------------------------------------------------------------
# Huffman codes: decoder tables, code lengths, the tree writer.
# ---------------------------------------------------------------------------

def _random_lengths(rng, n):
    counts = rng.integers(0, 1000, n) * (rng.random(n) < 0.6)
    counts[rng.integers(0, n)] += 1
    return hfe_ref.build_code_lengths(counts)


@pytest.mark.parametrize("n", [2, 19, 40, 256, 280, 2328])
def test_huffman_tables_and_code_lengths_equal_reference(n):
    rng = np.random.default_rng(n)
    for _ in range(4):
        counts = rng.integers(0, 1 << rng.integers(1, 16), n) * \
            (rng.random(n) < 0.7)
        counts[0] += 1
        lengths = hfe.build_code_lengths(counts)
        assert lengths == hfe_ref.build_code_lengths(counts)
        assert hfe.canonical_codes(lengths) == \
            hfe_ref.canonical_codes(lengths)
        if n <= 40:                 # a 7-bit limit codes <= 128 symbols
            assert hfe.build_code_lengths(counts, 7) == \
                hfe_ref.build_code_lengths(counts, 7)
        t, t_ref = hf.build_huffman_table(lengths), \
            hf_ref.build_huffman_table(lengths)
        assert (t.bits == t_ref.bits).all() and (t.value == t_ref.value).all()
        assert (t.max_length, t.num_symbols, t.single_symbol) == \
            (t_ref.max_length, t_ref.num_symbols, t_ref.single_symbol)
        c = hfe.HuffmanCode.from_counts(counts)
        c_ref = hfe_ref.HuffmanCode.from_counts(counts)
        assert (c.desc_lengths, c.lengths, c.codes) == \
            (c_ref.desc_lengths, c_ref.lengths, c_ref.codes)
    bad = [1, 1, 1]                                  # over-subscribed
    for build in (hf.build_huffman_table, hf_ref.build_huffman_table):
        with pytest.raises(ValueError):
            build(bad)


def _read_tree(data, n):
    d = dec.VP8LDecoder(b"\x2f\0\0\0\0" + data)
    d.br = bio.LosslessBitReader(data)
    return d, d._read_huffman_code(n)


@pytest.mark.parametrize("seed", range(6))
def test_write_huffman_code_equals_reference_without_a_lone_symbol(seed):
    """Trees whose code-length code has two or more used symbols: the
    port writes the reference's bits, and its decoder reads them back."""
    rng = np.random.default_rng(seed)
    n = [256, 280, 40, 256, 24, 2328][seed]
    lengths = _random_lengths(rng, n)
    w, w_ref = bio.LosslessBitWriter(), bio_ref.LosslessBitWriter()
    hfe.write_huffman_code(w, lengths)
    hfe_ref.write_huffman_code(w_ref, lengths)
    data = w.finish()
    assert data == w_ref.finish()
    _, table = _read_tree(data, n)
    probe = hf.build_huffman_table(lengths)
    assert (table.bits == probe.bits).all() and \
        (table.value == probe.value).all()


def test_lone_symbol_code_length_code_writes_zero_bits():
    """Every length 8 (a near-uniform 256-symbol histogram): the
    run-length coding emits only code 16, so the code-length code has one
    used symbol. The port's tree reads back in its decoder, and the bits
    after it stay aligned; the reference's raises."""
    lengths = [8] * 256
    for mod, ok in ((hfe, True), (hfe_ref, False)):
        w = bio.LosslessBitWriter()
        mod.write_huffman_code(w, lengths)
        w.write_bits(0x2D, 8)
        data = w.finish() + b"\0" * 8
        if ok:
            d, table = _read_tree(data, 256)
            assert (table.bits[:256] == 8).all()
            assert d.br.read_bits(8) == 0x2D
        else:
            with pytest.raises(dec.BitstreamError):
                _read_tree(data, 256)


# ---------------------------------------------------------------------------
# Inverse transforms and near-lossless (numpy), ops/lossless.py (PyTorch).
# ---------------------------------------------------------------------------

GEOMS = [(1, 1), (1, 9), (7, 1), (17, 33), (48, 64)]


@pytest.mark.parametrize("geom", GEOMS, ids=str)
def test_numpy_inverse_transforms_equal_reference(geom):
    h, w = geom
    rng = np.random.default_rng(h * 100 + w)
    px = _u32(rng, (h, w))
    assert (tf.add_green_inverse(px) == tf_ref.add_green_inverse(px)).all()
    for bits in (2, 3, 5):
        n_tiles = tf.sub_sample_size(h, bits) * tf.sub_sample_size(w, bits)
        tiles = _u32(rng, n_tiles)
        tiles_modes = (tiles & np.uint32(0xFFFF00FF)) | (
            rng.integers(0, 16, n_tiles).astype(np.uint32) << np.uint32(8))
        assert (tf.color_space_inverse(px, bits, tiles) ==
                tf_ref.color_space_inverse(px, bits, tiles)).all()
        assert (tf.predictor_inverse(px, bits, tiles_modes) ==
                tf_ref.predictor_inverse(px, bits, tiles_modes)).all()
    for nb, n in ((0, 200), (1, 16), (2, 4), (3, 2)):
        pal = _u32(rng, n)
        packed = (rng.integers(0, 256, (h, w)).astype(np.uint32) << 8) | \
            np.uint32(0xFF000000)
        ow = w << nb
        assert (tf.color_index_inverse(packed, nb, pal, ow) ==
                tf_ref.color_index_inverse(packed, nb, pal, ow)).all()


@pytest.mark.parametrize("q", [0, 20, 40, 60, 80, 100])
def test_near_lossless_equals_reference(q):
    a = enc.rgba_to_argb(photo(70, 90, q, alpha=True))
    assert (nl.apply_near_lossless(a, q) ==
            nl_ref.apply_near_lossless(a, q)).all()
    assert nl.near_lossless_bits(q) == nl_ref.near_lossless_bits(q)


@pytest.mark.parametrize("geom", [(1, 9), (17, 33)], ids=str)
def test_ops_transforms_equal_reference_jnp(geom):
    """ops/lossless.py on the CPU against the reference's jnp functions."""
    import jax.numpy as jnp

    from webp_tpu.ops import lossless as ops_ref

    h, w = geom
    rng = np.random.default_rng(h * 7 + w)
    px = _u32(rng, (h, w))
    for fn in ("add_green_inverse", "subtract_green"):
        assert (_n(getattr(ops, fn)(_t(px))) ==
                np.asarray(getattr(ops_ref, fn)(jnp.asarray(px)))).all()
    for bits in (2, 4):
        tiles = _u32(rng, tf.sub_sample_size(h, bits) *
                     tf.sub_sample_size(w, bits))
        for fn in ("color_space_inverse", "color_space_forward"):
            got = _n(getattr(ops, fn)(_t(px), bits, _t(tiles)))
            want = np.asarray(getattr(ops_ref, fn)(jnp.asarray(px), bits,
                                                   jnp.asarray(tiles)))
            assert (got == want).all(), fn
    for nb, n in ((0, 200), (1, 16), (2, 4), (3, 2)):
        pal = _u32(rng, n)
        packed = (rng.integers(0, 256, (h, w)).astype(np.uint32) << 8) | \
            np.uint32(0xFF000000)
        got = _n(ops.color_index_inverse(_t(packed), nb, _t(pal), w << nb))
        want = np.asarray(ops_ref.color_index_inverse(
            jnp.asarray(packed), nb, jnp.asarray(pal), w << nb))
        assert (got == want).all()
    # The forward cross-color then its inverse is the identity on the
    # residual bytes it can represent (the decoder's round trip).
    tiles = _u32(rng, tf.sub_sample_size(h, 3) * tf.sub_sample_size(w, 3))
    fwd = ops.color_space_forward(_t(px), 3, _t(tiles))
    assert (_n(ops.color_space_inverse(fwd, 3, _t(tiles))) == px).all()


@pytest.mark.parametrize("geom", GEOMS + [(64, 100)], ids=str)
def test_predictor_search_equals_native_numpy_and_reference(geom):
    """predictor_search (PyTorch on the CPU), the native C++ predictor,
    the numpy predictor and the reference's jnp predictor_search: equal
    residuals and modes at every tile size (the reference's eager jnp
    on two geometries: each shape costs it a compile per operation)."""
    import jax.numpy as jnp

    from webp_tpu.ops import lossless as ops_ref

    h, w = geom
    rng = np.random.default_rng(h + w)
    px = enc.subtract_green(enc.rgba_to_argb(photo(h, w, 3, alpha=True)))
    px[: h // 2] ^= _u32(rng, (h // 2, w)) & np.uint32(0x03030303)
    for bits in (2, 3, 4, 5):
        out, modes = ops.predictor_search(_t(px), bits)
        n_out, n_modes = native.vp8l_predictor_transform(px, bits)
        p_out, p_tiles = enc._predictor_transform_numpy(px, bits)
        assert (_n(out) == n_out).all() and (modes.numpy() == n_modes).all()
        assert (p_out == n_out).all()
        assert (p_tiles == enc._tile_image(n_modes)).all()
        if geom in ((7, 1), (48, 64)) and bits in (2, 4):
            r_out, r_modes = ops_ref.predictor_search(jnp.asarray(px), bits)
            assert (np.asarray(r_out) == n_out).all()
            assert (np.asarray(r_modes) == n_modes).all()


# ---------------------------------------------------------------------------
# The encoder: encode_vp8l and encode(lossless=True) against the reference.
# ---------------------------------------------------------------------------

# The three size branches of the transform search: <= 2**16 pixels
# (64x48, 33x17), <= 2**18 (272x256) and larger (520x512).
SIZES = [(48, 64), (17, 33), (256, 272), (512, 520)]


def _both(img, **kw):
    """(port with the search on the CPU, port with the native search,
    reference)."""
    return (enc.encode_vp8l(img, search="cpu", **kw),
            enc.encode_vp8l(img, search=enc.HOST, **kw),
            enc_ref.encode_vp8l(img, **kw))


@pytest.mark.parametrize("size", SIZES, ids=str)
@pytest.mark.parametrize("method", [0, 2, 4, 6])
def test_encode_vp8l_equals_reference_sizes_and_methods(size, method):
    """Each size and method against the reference, the predictor search
    on the CPU's PyTorch at methods 0 and 4 and in native C++ at 2 and 6
    (both paths meet on every case of the tests below)."""
    h, w = size
    img = photo(h, w, method)
    search = "cpu" if method in (0, 4) else enc.HOST
    assert enc.encode_vp8l(img, method=method, search=search) == \
        enc_ref.encode_vp8l(img, method=method)


@pytest.mark.parametrize("size", [(48, 64), (256, 272)], ids=str)
@pytest.mark.parametrize("quality", [25, 100])
def test_encode_vp8l_equals_reference_qualities(size, quality):
    h, w = size
    got_cpu, got_host, want = _both(photo(h, w, quality, alpha=True),
                                    quality=quality)
    assert got_cpu == got_host == want


OPTION_CASES = {
    "alpha_exact": (lambda: photo(48, 64, 1, alpha=True), dict(exact=True)),
    "alpha_not_exact": (lambda: photo(48, 64, 1, alpha=True), {}),
    "near_lossless_60": (lambda: photo(60, 80, 2), dict(near_lossless=60)),
    "near_lossless_60_alpha": (lambda: photo(64, 70, 2, alpha=True),
                               dict(near_lossless=60, method=6)),
    "palette_16": (lambda: palette_image(60, 70, 16, 0), {}),
    "palette_3_alpha": (lambda: palette_image(33, 17, 3, 1, True), {}),
    "palette_256": (lambda: palette_image(40, 50, 256, 2), {}),
    "palette_200_alpha_q100": (lambda: palette_image(64, 64, 200, 3, True),
                               dict(quality=100, method=6)),
    "noise_48": (lambda: noise(48, 48, 0), dict(exact=True)),
}


@pytest.mark.parametrize("case", list(OPTION_CASES))
def test_encode_vp8l_equals_reference_options(case):
    make, kw = OPTION_CASES[case]
    got_cpu, got_host, want = _both(make(), **kw)
    assert got_cpu == got_host == want


@pytest.mark.parametrize("kw", [
    {}, dict(exact=True, method=6, quality=90),
    dict(iccp=b"icc", exif=b"Exif\0\0", xmp=b"<x/>")], ids=str)
def test_encode_lossless_entry_equals_reference_on_both_backends(kw):
    img = photo(40, 56, 5, alpha=True)
    want = webp_tpu.encode(img, lossless=True, **kw)
    assert webp_tpu_torch.encode(img, lossless=True, device="cpu",
                                 **kw) == want
    assert webp_tpu_torch.encode(img, lossless=True, backend="host",
                                 **kw) == want
    assert webp_tpu_torch.decode(want, device="cpu").shape == (40, 56, 4)


def test_lossless_device_default_needs_a_card():
    """lossless=True on the device backend with device=None runs the
    predictor search on the card: without one it raises."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    with pytest.raises((RuntimeError, AssertionError)):
        webp_tpu_torch.encode(photo(16, 16, 0), lossless=True)


def _pillow_pixels(data):
    im = Image.open(io.BytesIO(data))
    return np.array(im.convert("RGBA"))


@pytest.mark.parametrize("n", [160])
def test_lone_symbol_files_reference_fails_port_decodes(n):
    """RGB noise at n x n: the reference's file raises in its own decoder
    (its writer spends 1 bit on each token of a lone-symbol code-length
    code); the port's file decodes to the source in the port's native and
    numpy decoders and in Pillow (libwebp)."""
    img = noise(n, n, n)
    got_host = enc.encode_vp8l(img, exact=True)
    want = enc_ref.encode_vp8l(img, exact=True)
    assert got_host != want
    with pytest.raises(dec_ref.BitstreamError):
        dec_ref.VP8LDecoder(want).decode()
    rgba = np.dstack([img, np.full((n, n), 255, np.uint8)])
    argb, _ = dec.decode_vp8l(got_host)
    assert (dec.argb_to_rgba(argb) == rgba).all()
    assert (dec.argb_to_rgba(dec.VP8LDecoder(got_host).decode()) == rgba).all()
    f = riff.assemble_riff([riff.Chunk(riff.VP8L, got_host)])
    assert (_pillow_pixels(f) == rgba).all()
    assert (webp_tpu_torch.decode(f, device="cpu") == img).all()


def test_numpy_entropy_coder_round_trips_and_fixes_the_lone_symbol(
        monkeypatch):
    """The numpy entropy coder (a plain version; no entry point reaches
    it): its streams decode to their pixels, the noise stream whose trees
    have a lone-symbol code-length code included; on an image without
    that case it writes the reference's numpy coder's bits."""
    import webp_tpu.native.api as api_ref

    # The reference's numpy coder runs where its native coder is absent.
    monkeypatch.setattr(api_ref, "vp8l_encode_entropy_image",
                        lambda *a, **k: None)
    for img, same in ((noise(160, 160, 9), False),
                      (photo(40, 50, 1, alpha=True), True)):
        h, w = img.shape[:2]
        argb = enc.rgba_to_argb(img).reshape(-1)
        streams = []
        for coder in (enc.encode_entropy_image_numpy,
                      enc_ref._encode_entropy_coded_image):
            bw = bio.LosslessBitWriter()
            for v, n in ((0x2F, 8), (w - 1, 14), (h - 1, 14), (1, 1),
                         (0, 3), (0, 1)):
                bw.write_bits(v, n)
            coder(bw, argb, w, 75, is_level0=True)
            streams.append(bw.finish())
        assert (streams[0] == streams[1]) == same
        assert (dec.VP8LDecoder(streams[0]).decode().reshape(-1) == argb).all()
        assert (native.vp8l_decode(streams[0])[0].reshape(-1) == argb).all()


# ---------------------------------------------------------------------------
# Decoding VP8L files.
# ---------------------------------------------------------------------------

def _pillow(img, **kw):
    buf = io.BytesIO()
    Image.fromarray(img).save(buf, format="WEBP", **kw)
    return buf.getvalue()


def _files():
    """name -> a function that makes the file (made in the test that
    reads it, not while every worker collects the module)."""
    out = {}
    for h, w in ((48, 64), (17, 33), (90, 120)):
        img = photo(h, w, w, alpha=True)
        out[f"pillow_{w}x{h}"] = lambda img=img: _pillow(img, lossless=True)
        out[f"pillow_m6_rgb_{w}x{h}"] = lambda img=img: _pillow(
            img[..., :3], lossless=True, method=6, quality=100)
        out[f"reference_{w}x{h}"] = lambda img=img: webp_tpu.encode(
            img, lossless=True)
        out[f"port_{w}x{h}"] = lambda img=img: webp_tpu_torch.encode(
            img, lossless=True, backend="host")
    out["pillow_palette"] = lambda: _pillow(
        palette_image(40, 40, 12, 0, True), lossless=True)
    out["port_palette_2"] = lambda: webp_tpu_torch.encode(
        palette_image(30, 45, 2, 1), lossless=True, backend="host")
    out["port_near_lossless"] = lambda: webp_tpu_torch.encode(
        photo(70, 70, 4), lossless=True, near_lossless=40, backend="host")
    return out


FILES = _files()


@pytest.mark.parametrize("name", list(FILES))
def test_decode_vp8l_files_equal_reference(name):
    """decode_rgba and decode on both backends, the native decoder and
    the numpy VP8LDecoder give the reference's pixels (and Pillow's)."""
    data = FILES[name]()
    want = webp_tpu.decode_rgba(data)
    assert (_pillow_pixels(data) == want).all()
    for kw in (dict(backend="host"), dict(backend="device", device="cpu")):
        assert (webp_tpu_torch.decode_rgba(data, **kw) == want).all()
        got = webp_tpu_torch.decode(data, **kw)
        ref = webp_tpu.decode(data)
        assert got.shape == ref.shape and (got == ref).all()
    bs = parser.Parser(data).frames()[0].bitstream
    argb, alpha_hint = dec.decode_vp8l(bs)
    assert alpha_hint == dec_ref.decode_vp8l(bs)[1]
    assert (dec.VP8LDecoder(bs).decode() == argb).all()
    assert (dec.argb_to_rgba(argb) == want).all()


def test_decode_vp8l_bad_input_raises():
    data = FILES["port_64x48"]()
    bs = parser.Parser(data).frames()[0].bitstream
    for bad in (bs[:3], b"\x2e" + bs[1:], bs[: len(bs) // 2],
                bs[:5] + bytes(len(bs) - 5)):
        with pytest.raises(webp_tpu_torch.WebPError):
            dec.decode_vp8l(bad)
        with pytest.raises(webp_tpu_torch.WebPError):
            dec.VP8LDecoder(bad).decode()
    for bad in (data[: len(data) // 2], data[:30]):
        with pytest.raises(webp_tpu_torch.WebPError):
            webp_tpu_torch.decode(bad, backend="host")
