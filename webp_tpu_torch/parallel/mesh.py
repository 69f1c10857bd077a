"""Row-band sharded encoding over a grid of devices (PyTorch port of
webp_tpu/parallel/mesh.py).

A Mesh is a grid of torch devices with axes ("dp", "sp"), the
counterpart of a jax.sharding.Mesh, driven by one controller as the
reference's shard_map is:
  - 'dp': image-batch data parallelism (groups of images);
  - 'sp': spatial row bands. Each band runs the two-phase encoder
    (ops/fastpath.py encode_band); the source pixel row above a band
    comes from the band above (pass_down), and the segment statistics
    are summed over the bands of each image (psum), so every band plans
    with the image's histogram.
A Python loop launches each band's program on its device; the launches
are asynchronous, so bands on different cards run at once. A device may
appear more than once in the grid (["cpu"] * 4 in the tests, ["cuda:0"] *
4 on a one-card machine): the bands then take turns on it.

The band boundary is approximated as in the reference: each band's first
MB row predicts from the *source* row above, in phase 1 and in phase 2,
and stays I16; with sharp YUV each band refines its own rows. Only
exact.py is bit-identical to the single-device encoder.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import fastpath


class Mesh:
    """A dp x sp grid of torch devices: devices[d][s] runs band s of image
    group d. shape: {"dp": dp, "sp": sp}."""

    def __init__(self, devices, dp: int = 1):
        devs = [torch.device(d) for d in devices]
        if not devs or len(devs) % dp:
            raise ValueError(f"a mesh of {len(devs)} devices cannot have "
                             f"dp={dp} rows")
        sp = len(devs) // dp
        self.devices = [devs[i * sp:(i + 1) * sp] for i in range(dp)]
        self.shape = {"dp": dp, "sp": sp}


def visible_cards():
    """Every CUDA device torch sees; raises when there is none."""
    n = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n == 0:
        raise RuntimeError("no CUDA device is visible; pass devices= "
                           "(e.g. ['cpu'] * 2) to run on others")
    return [torch.device(f"cuda:{i}") for i in range(n)]


def make_mesh(n_devices: int = None, dp: int = None, devices=None) -> Mesh:
    """A ('dp', 'sp') mesh over `devices` (default: the visible cards;
    the list may repeat a device), the first n_devices of them. dp
    defaults to 4, 2 or 1, the first that divides the device count, as
    the reference's."""
    devs = list(devices) if devices is not None else visible_cards()
    n = n_devices or len(devs)
    devs = devs[:n]
    if dp is None:
        dp = next(c for c in (4, 2, 1) if n % c == 0)
    return Mesh(devs, dp)


def pass_down(rows, devs):
    """One hop toward the next band: band s gets band s-1's tensor on its
    own device, band 0 zeros (the reference's ppermute)."""
    return [torch.zeros_like(rows[0])] + [r.to(d) for r, d in
                                          zip(rows[:-1], devs[1:])]


def psum(values, devs):
    """The sum of one integer tensor per band, on every band's device
    (integers, so the order of the additions does not matter)."""
    total = values[0]
    for v in values[1:]:
        total = total + v.to(total.device)
    return [total.to(d) for d in devs]


def make_sharded_encode_fn(mesh: Mesh, quality: int = 75,
                           segments: int = 4, sns_strength: int = 50,
                           i4_blocks: bool = True, sharp_yuv: bool = False,
                           uv_ac: bool = False):
    """Returns step(rgb): the multi-device encode of rgb [B, H, W, 3]
    uint8 (numpy or a tensor on any device).

    B must divide by mesh 'dp', H by 16 * mesh 'sp'. Runs the full
    flagship configuration per band: segmentation (alpha histograms
    summed over 'sp', so every band derives the image's plan), I16 and I4
    search and the closed-loop wavefront. The outputs follow the
    reference's tuple (packed, esc_idx, esc_val, esc_cnt [B, sp], y2,
    modes, uvmodes, skip, is_i4, imodes, seg_map, seg_q, seg_beta, dq_uv,
    hist): per-MB fields concatenated over the bands in MB order, escape
    lists band by band (band-local indices, esc_cap each), the plan's
    fields from band 0 (every band's are equal), hist [16] summed over
    the whole mesh; all on the mesh's first device.

    sharp_yuv runs the sharp-YUV refinement band-locally: each band
    refines its own rows, clamped at the band boundary (as the
    reference's). uv_ac derives the chroma AC quantizer delta from the
    image's mean UV alpha, summed over the bands (fastpath._uv_deltas).
    """
    dp, sp = mesh.shape["dp"], mesh.shape["sp"]

    def to_yuv(rgb):
        if sharp_yuv:
            from ..ops import sharpyuv

            return sharpyuv.sharp_yuv420(rgb)
        from ..ops import yuv

        return yuv.rgb_to_yuv420(rgb)

    def step(rgb):
        rgb = torch.as_tensor(rgb)
        B, H, W = rgb.shape[:3]
        if B % dp or H % (16 * sp) or W % 16:
            raise ValueError(f"{B} images of {W}x{H} do not shard over "
                             f"dp={dp}, sp={sp} (16 * sp must divide H)")
        bl, Hb = B // dp, H // sp
        mb_w, mb_h = W // 16, Hb // 16
        n_mb = mb_w * mb_h
        esc_cap = max(1024, fastpath.ESC_BLOCKS_PER_MB * n_mb)
        rows = []
        for d in range(dp):
            devs = mesh.devices[d]
            yuv = [[p.to(torch.int32) for p in to_yuv(
                rgb[d * bl:(d + 1) * bl, s * Hb:(s + 1) * Hb].to(devs[s]))]
                for s in range(sp)]
            # The source pixel row above each band, one hop down.
            halos = [pass_down([b[i][:, -1, :] for b in yuv], devs)
                     for i in range(3)]
            stats = [None] * sp
            if segments > 1:
                loc = [fastpath.band_stats(*b, mb_w, mb_h) for b in yuv]
                histo = psum([st[1] for st in loc], devs)
                uv_sum = psum([st[2] for st in loc], devs)
                stats = [(loc[s][0], histo[s], uv_sum[s], n_mb * sp)
                         for s in range(sp)]
            rows.append([fastpath.encode_band(
                *yuv[s], halos[0][s], halos[1][s], halos[2][s], s > 0,
                mb_w, mb_h, esc_cap, quality, segments, sns_strength,
                i4_blocks, stats=stats[s], uv_ac=uv_ac)
                for s in range(sp)])
        return _assemble_device(rows, mesh.devices[0][0])

    return step


# Output tuple order of the band encoders, and how each field joins the
# bands: along the MB (or escape) axis, stacked per band, or band 0's.
_FIELDS = (("packed", "cat"), ("esc_idx", "cat"), ("esc_val", "cat"),
           ("esc_cnt", "stack"), ("y2", "cat"), ("modes", "cat"),
           ("uvmodes", "cat"), ("skip", "cat"), ("is_i4", "cat"),
           ("imodes", "cat"), ("seg_map", "cat"), ("seg_q", "first"),
           ("seg_beta", "first"), ("dq_uv", "first"))


def _assemble_device(rows, dev):
    """Per-group, per-band field dicts (rows[d][s]) -> the output tuple
    on `dev`, groups along the batch axis."""
    out = []
    for name, how in _FIELDS:
        groups = []
        for bands in rows:
            parts = [b[name] for b in bands]
            parts = [p.to(dev) for p in parts]
            groups.append(torch.cat(parts, 1) if how == "cat"
                          else torch.stack(parts, 1) if how == "stack"
                          else parts[0])
        out.append(torch.cat(groups, dim=0))
    hist = sum(b["hist"].sum(dim=0).to(dev) for bands in rows for b in bands)
    return tuple(out) + (hist,)


def assemble_from_sharded(outputs, sp: int, mb_w: int, mb_h: int):
    """Host side: the sharded step's outputs -> per-image dicts of numpy
    arrays (lv24 unpacked, the side fields). Escape indices are
    band-local, so each band unpacks before the bands are stitched. A
    band whose escape list overflowed raises OverflowError (re-encode
    the image on the host path)."""
    from ..ops.fastpath import unpack_levels

    (packed, esc_idx, esc_val, esc_cnt, y2, modes, uvm, skip, is_i4,
     imodes, seg_map, seg_q, seg_beta, dq_uv, hist) = [
        o.cpu().numpy() if isinstance(o, torch.Tensor) else np.asarray(o)
        for o in outputs]
    B = packed.shape[0]
    n_mb = mb_w * mb_h
    n_loc = n_mb // sp
    cap = esc_idx.shape[1] // sp
    out = []
    for b in range(B):
        lv = np.empty((n_mb, 24, 16), np.int16)
        for s in range(sp):
            sl = slice(s * n_loc, (s + 1) * n_loc)
            cnt = int(esc_cnt[b, s])
            if cnt > cap:
                # unpack_levels would decode the blocks past the list as
                # all-zero levels: a corrupt image.
                raise OverflowError(
                    f"escape-block overflow in band {s} of image {b}: "
                    f"{cnt} > capacity {cap}; re-encode on the host path")
            lv[sl] = unpack_levels(
                packed[b, sl], esc_idx[b, s * cap:(s + 1) * cap],
                esc_val[b, s * cap:(s + 1) * cap], esc_cnt[b, s], n_loc)
        out.append({"lv24": lv, "y2": y2[b], "modes": modes[b],
                    "uvmodes": uvm[b], "skip": skip[b], "is_i4": is_i4[b],
                    "imodes": imodes[b], "seg_map": seg_map[b],
                    "seg_q": seg_q[b][:4], "seg_beta": seg_beta[b][:4],
                    "dq_uv": dq_uv[b][:2]})
    return out
