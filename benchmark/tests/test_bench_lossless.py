"""The lossless configuration's reference on the CPU: the frozen encoder
(reference/encode_lossless.py over vp8lref/) against the measured
package on each branch of its encoder, the independent decoder
(reference/vp8ldec.py, written from RFC 9649) against the inputs, the
package's native decoder and libwebp, its refusals, and tiny CPU runs of
the cell lossless.convert_mixed: sound, with a byte altered, traced, and
its control."""

import io

import numpy as np
import pytest

from benchmark.harness import images, runner
from benchmark.reference import decode_lossless as DL
from benchmark.reference import encode_lossless as EL
from benchmark.reference import vp8ldec

CELL = "lossless.convert_mixed"
TINY = dict(sizes=[{"w": 64, "h": 48, "share": 1},
                   {"w": 48, "h": 64, "share": 1}],
            distinct_per_size=2, check_items=2, trace_requests=2)
SEED = 2 ** 31 + 77


def synth(seed, h, w):
    g = images.generator(seed, "cpu")
    return images.synth_images(g, 1, h, w, "cpu").numpy()[0]


def few_colours(h, w, n, seed=4):
    rng = np.random.default_rng(seed)
    pal = rng.integers(0, 256, (n, 3), dtype=np.uint8)
    idx = (np.arange(h)[:, None] // 5 + np.arange(w)[None, :] // 7) % n
    return pal[idx]


# One image per branch of the encoder: a palette of at most 16 colours,
# at most 2^16 pixels, 2^16 to 2^18, over 2^18.
BRANCHES = {
    "palette": lambda: few_colours(40, 56, 12),
    "small": lambda: synth(1, 48, 64),
    "medium": lambda: synth(2, 300, 400),
    "large": lambda: synth(3, 500, 600),
}


@pytest.fixture(scope="module")
def program():
    import webp_tpu_torch

    return webp_tpu_torch


@pytest.fixture(scope="module")
def files():
    """branch -> (image, the reference's file, its reconstruction)."""
    out = {}
    for name, make in BRANCHES.items():
        img = make()
        data, recon = EL.encode_file(img, {})
        out[name] = (img, data, recon)
    return out


@pytest.fixture(scope="module")
def pillow():
    pytest.importorskip("PIL.WebPImagePlugin")
    from PIL import Image, features

    if not features.check("webp"):
        pytest.skip("Pillow without WebP")
    return Image


@pytest.mark.parametrize("branch", sorted(BRANCHES))
def test_the_reference_writes_the_programs_files(program, files, branch):
    img, data, _ = files[branch]
    assert data == program.encode(img, lossless=True, device="cpu")
    assert data == program.encode(img, lossless=True, backend="host")


@pytest.mark.parametrize("opts", [
    {"quality": 100, "method": 6}, {"quality": 30, "method": 1},
    {"method": 0}, {"near_lossless": 60}, {"exact": True}])
def test_the_reference_follows_the_options(program, opts):
    img = synth(5, 48, 64)
    assert EL.encode_file(img, opts)[0] == program.encode(
        img, lossless=True, device="cpu", **opts)


@pytest.mark.parametrize("branch", sorted(BRANCHES))
def test_the_decoder_reads_each_file_back_exactly(program, files, branch):
    img, data, recon = files[branch]
    back = vp8ldec.decode_rgb(data)
    assert back.dtype == np.uint8 and np.array_equal(back, img)
    assert np.array_equal(back, program.decode(data, backend="host"))
    planes = DL.decode_unfiltered(data)
    assert all(np.array_equal(a, b) for a, b in zip(planes, recon))
    assert np.array_equal(DL.decode_rgb(data, False), img)


def test_near_lossless_gives_its_own_reconstruction():
    img = synth(6, 64, 80)
    data, recon = EL.encode_file(img, {"near_lossless": 60})
    got = np.stack(recon, axis=-1)
    assert not np.array_equal(got, img)
    assert np.array_equal(vp8ldec.decode_rgb(data), got)


@pytest.mark.parametrize("h,w,kw", [
    (48, 64, {}), (37, 53, dict(quality=100, method=6)),
    (64, 96, dict(quality=0, method=0)), (120, 90, dict(quality=90)),
    (1, 1, {}), (33, 17, dict(method=2))])
def test_the_decoder_reads_libwebps_files(pillow, h, w, kw):
    """libwebp's own streams: its colour caches, entropy images, bundled
    palettes and transform orders, not the package's."""
    img = synth(h * 7 + w, max(h, 16), max(w, 16))[:h, :w]
    for src in (img, few_colours(h, w, 3), few_colours(h, w, 40)):
        buf = io.BytesIO()
        pillow.fromarray(np.ascontiguousarray(src)).save(
            buf, "WEBP", lossless=True, **kw)
        data = buf.getvalue()
        want = np.asarray(pillow.open(io.BytesIO(data)).convert("RGB"))
        assert np.array_equal(want, src)
        assert np.array_equal(vp8ldec.decode_rgb(data), want)


def test_the_distance_map_is_the_programs():
    from webp_tpu_torch.lossless.decode import CODE_TO_PLANE

    assert [tuple(p) for p in CODE_TO_PLANE] == list(vp8ldec.DISTANCE_MAP)


@pytest.mark.parametrize("fault", [
    "truncated", "half", "signature", "version", "riff_size", "vp8_chunk",
    "trailing_chunk", "not_riff"])
def test_malformed_files_are_refused(files, fault):
    data = files["medium"][1]
    payload = vp8ldec.vp8l_payload(data)
    riff = EL._riff
    two = riff(b"VP8L", payload)
    two = b"RIFF" + (len(two) - 8 + 10).to_bytes(4, "little") + two[8:] \
        + b"EXIF" + (2).to_bytes(4, "little") + b"xx"
    bad = {
        "truncated": lambda: riff(b"VP8L", payload[:-40]),
        "half": lambda: riff(b"VP8L", payload[:len(payload) // 2]),
        "signature": lambda: riff(b"VP8L", b"\x2e" + payload[1:]),
        "version": lambda: riff(b"VP8L", payload[:4] + bytes(
            [payload[4] | 0x20]) + payload[5:]),
        "riff_size": lambda: data[:4] + len(data).to_bytes(4, "little")
        + data[8:],
        "vp8_chunk": lambda: data[:12] + b"VP8 " + data[16:],
        "trailing_chunk": lambda: two,
        "not_riff": lambda: payload,
    }[fault]()
    with pytest.raises(vp8ldec.VP8LError):
        DL.decode_rgb(bad, True)
    with pytest.raises(ValueError):
        DL.decode_unfiltered(bad)


def test_malformed_prefix_codes_are_refused():
    # An over-subscribed code: three symbols of length 1.
    with pytest.raises(vp8ldec.VP8LError):
        vp8ldec._Code([1, 1, 1])
    # An incomplete one: one symbol of length 1, one of length 2.
    with pytest.raises(vp8ldec.VP8LError):
        vp8ldec._Code([1, 2, 0])
    with pytest.raises(vp8ldec.VP8LError):
        vp8ldec._Code([0, 0, 0])
    assert vp8ldec._Code([0, 3, 0]).mask == 0      # one symbol: no bits


@pytest.mark.parametrize("opts", [
    {"lossless": False}, {"iccp": b"x"}, {"exif": b"x"}, {"xmp": b"x"},
    {"segments": 4}, {"backend": "host"}, {"method": 7},
    {"near_lossless": 101}])
def test_options_the_reference_cannot_follow_are_refused(opts):
    with pytest.raises(ValueError):
        EL.encode_file(synth(1, 16, 16), opts)


def test_there_is_no_lossless_stream():
    with pytest.raises(ValueError):
        EL.stream_frame(synth(1, 16, 16), {})


# -- tiny CPU runs of the cell ------------------------------------------------

def tiny_cell():
    cell = runner.Cell(CELL)
    cell.mix = dict(cell.mix, **TINY)
    return cell


def run(seconds=0.5, trace=False):
    return runner.run(tiny_cell(), SEED, seconds, trace, device="cpu",
                      workers=2)


def test_the_cell_names_the_lossless_reference():
    cell = runner.Cell(CELL)
    assert cell.reference == {"encoder": "encode_lossless",
                              "decoder": "decode_lossless"}
    assert cell.options["lossless"] is True


def test_a_sound_run_is_correct():
    result, nums = run()
    assert result["correct"], nums
    assert result["failed"] == 0 and result["attempted"] > 0
    assert set(nums) == {"outputs_missing", "files_differing",
                         "files_unlike_recon"}


def test_a_byte_altered_in_the_coder_is_caught(monkeypatch):
    from webp_tpu_torch.lossless import encode as LE

    encode = LE.encode_vp8l

    def altered(*a, **k):
        data = bytearray(encode(*a, **k))
        data[len(data) // 2] ^= 0x10
        return bytes(data)

    monkeypatch.setattr(LE, "encode_vp8l", altered)
    result, nums = run()
    assert not result["correct"]
    assert nums["files_differing"][0] > 0


def test_a_traced_run_reads_the_coders_spans(monkeypatch):
    import torch

    monkeypatch.setattr(torch.cuda, "synchronize", lambda *a: None)
    result, nums = run(trace=True)
    assert result["correct"], nums
    spans = {m["name"] for m in runner.Cell(CELL).metrics(True)
             if m["source"] == "program_span"}
    assert len(spans) == 3 and spans <= set(result["metrics"])
    assert all(result["metrics"][n]["value"] > 0 for n in spans)


def test_the_control_is_not_correct():
    from benchmark.control import control_numbers

    out = control_numbers(tiny_cell(), SEED, 2, device="cpu")
    assert all(v <= lim for v, lim in out["program"].values())
    assert out["control"]["files_differing"][0] > 0
    assert out["control"]["files_unlike_recon"][0] > 0
