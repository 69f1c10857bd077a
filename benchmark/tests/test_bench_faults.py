"""A run with the timed path broken underneath comes out not correct,
once for each fault the cells can have: an answer altered where it is
produced (a byte of a file, a pixel of a decode) and half of a batch left
out. The run skips the look for a card and drives the measured package's
plain versions on the CPU at tiny sizes; everything else is a run's.
The control of each configuration (the reference with one guarantee
broken, put in the program's place) is not correct either."""

import pytest

from benchmark.harness import runner

TINY = {
    "default.stream_1536x1024": dict(
        sizes=[{"w": 64, "h": 48, "share": 1}], distinct_per_size=4,
        items_per_request=4, call_options={"batch": 2}),
    "default.decode_1536x1024": dict(
        sizes=[{"w": 64, "h": 48, "share": 1}], distinct_per_size=3,
        files={"entry": "encode_batch", "batch": 2}),
    "default.single_mixed": dict(
        sizes=[{"w": 48, "h": 32, "share": 1},
               {"w": 32, "h": 48, "share": 1}],
        distinct_per_size=2, check_items=2),
}
SEED = 2 ** 31 + 99


def tiny_cell(name):
    cell = runner.Cell(name)
    cell.mix = dict(cell.mix, **TINY[name])
    return cell


def run(name, seconds=0.5):
    return runner.run(tiny_cell(name), SEED, seconds, False, device="cpu",
                      workers=2)


@pytest.mark.parametrize("name", sorted(TINY))
def test_a_sound_run_is_correct(name):
    result, nums = run(name)
    assert result["correct"], nums
    assert result["failed"] == 0 and result["attempted"] > 0


@pytest.mark.parametrize("name", sorted(
    n for n in TINY if "decode" not in n))
def test_a_byte_altered_in_the_host_tail_is_caught(monkeypatch, name):
    from webp_tpu_torch.lossy.device_encode import DeviceVP8Encoder

    finish = DeviceVP8Encoder.finish

    def altered(self, out_i):
        data = bytearray(finish(self, out_i))
        data[-1] ^= 1
        return bytes(data)

    monkeypatch.setattr(DeviceVP8Encoder, "finish", altered)
    result, nums = run(name)
    assert not result["correct"] and nums["files_differing"][0] > 0


def test_a_level_altered_on_the_device_is_caught(monkeypatch):
    from webp_tpu_torch.ops import fastpath

    unpack = fastpath.unpack_levels

    def altered(*a, **k):
        lv = unpack(*a, **k).copy()
        lv[0, 1, 0] += 1
        return lv

    monkeypatch.setattr(fastpath, "unpack_levels", altered)
    result, nums = run("default.single_mixed")
    assert not result["correct"] and nums["files_differing"][0] > 0


def test_a_pixel_altered_in_the_decode_is_caught(monkeypatch):
    from webp_tpu_torch.lossy import device_decode

    dec = device_decode.decode_vp8_rgb_device

    def altered(*a, **k):
        rgb = dec(*a, **k).copy()
        rgb[0, 0, 0] ^= 4
        return rgb

    monkeypatch.setattr(device_decode, "decode_vp8_rgb_device", altered)
    result, nums = run("default.decode_1536x1024")
    assert not result["correct"] and nums["pixels_differing"][0] > 0


def test_a_pool_file_altered_in_set_up_is_caught(monkeypatch):
    from benchmark.harness import entries

    make = entries.make_files

    def altered(*a, **k):
        files = make(*a, **k)
        files[1] = files[1][:-1] + bytes([files[1][-1] ^ 1])
        return files

    monkeypatch.setattr(entries, "make_files", altered)
    result, nums = run("default.decode_1536x1024")
    assert not result["correct"] and nums["pool_files_differing"][0] == 1


def test_a_file_unlike_the_reconstruction_is_caught():
    import webp_tpu_torch

    from benchmark.harness import check, images

    img = images.synth_images(images.generator(SEED, "cpu"), 1, 48, 64,
                              "cpu").numpy()[0]
    good = webp_tpu_torch.encode(img, device="cpu")
    ref, differs, compared = check._encode_job("encode", img, {}, good)
    assert ref == good and compared and differs == 0
    # A token altered: the file, read back, is not what the encoder's
    # closed loop reconstructed.
    bad = bytearray(good)
    bad[len(bad) * 2 // 3] ^= 0x10
    assert check._encode_job("encode", img, {}, bytes(bad))[1:] == (1, True)


def test_half_of_a_batch_left_out_is_caught(monkeypatch):
    from webp_tpu_torch.lossy import device_encode

    stream = device_encode.encode_lossy_stream

    def half(images, **k):
        return stream(images, **k)[:len(images) // 2]

    monkeypatch.setattr(device_encode, "encode_lossy_stream", half)
    result, nums = run("default.stream_1536x1024")
    assert not result["correct"] and nums["outputs_missing"][0] > 0
    assert result["failed"] == 0


@pytest.mark.parametrize("name", sorted(TINY))
def test_the_control_is_not_correct(name):
    from benchmark.control import control_numbers

    out = control_numbers(tiny_cell(name), SEED, 2, device="cpu")
    assert all(v <= lim for v, lim in out["program"].values())
    assert any(v > lim for v, lim in out["control"].values())


@pytest.mark.cuda
def test_a_tiny_traced_run_on_the_card_is_correct(card):
    result, nums = runner.run(tiny_cell("default.single_mixed"), SEED, 0.5,
                              True, workers=2)
    assert result["correct"], nums
    assert result["device"]["platform"] == "gpu"
    assert result["device"]["busy_s"] > 0
