"""Device VP8 decode (PyTorch): reconstruction and loop filter of the
macroblocks on a skew-2 wavefront, then fancy upsampling. Counterpart of
webp_tpu/ops/decode.py.

The host (the native vp8_parse, native/src/vp8_dec.cc) stops after the
token pass and hands over dequantized coefficients and per-MB info;
every pixel-shaped stage runs here. On the card one launch of the
hand-written kernel csrc/decode_wavefront.cu (`wavefront`) reconstructs
and filters the whole batch. Its plain version, for CPU tensors, is the
step loop below (DecodeFn.plain):

  * the residual IDCT, one batched tensor operation over every 4x4 block
    (ops/dct.py's integer transform);
  * reconstruction, a step loop over the anti-diagonals t = x + 2y (lane
    (b, y) holds MB x = t - 2y): intra prediction from the reconstructed
    neighbours; an I4 macroblock is a 10-substep walk over its subblocks'
    anti-diagonals, whose above-right strip comes from MB (x+1, y-1),
    reconstructed one step earlier;
  * the loop filter, at lag 0 inside the same step in the host decoder's
    raster order: each step filters its MB's edges and emits writeback
    patches for the right columns of its left neighbour and the bottom
    rows of the MB above, which the assembly overlays afterwards;
  * fancy upsampling and YUV -> RGB (ops/yuv.py), on every device.

The step loop reads its inputs and writes its outputs and carry through
fixed buffers indexed by a step counter on the device, and runs its
steps eagerly on whatever device its inputs lie on (chip_smoke.py times
it on the card).

Exact against the host decoder on all three filter branches (none,
simple, normal), the kernel and the plain version alike. The reference's
simple filter reads the left neighbour's columns 14 and 15 out of its
4-column patch (JAX clamps the gather to column 3 and drops the
write-back), so on simple-filtered bitstreams the reference's device
decode differs from its own host decoder; this port follows the host
decoder there.
"""

from __future__ import annotations

import functools

import torch

from .. import trace
from . import cuda, dct
from .fastpath import _preds4, _unblock
from .i4 import pred4_all
from .p2_kernel import cluster_size, sm_count

SK = 2  # the decode's skew: the I4 walk needs the true above-right MB

# The I4 walk's substeps: the subblock anti-diagonals (row, column).
_GROUPS = [[(0, 0)], [(0, 1)], [(0, 2), (1, 0)], [(0, 3), (1, 1)],
           [(1, 2), (2, 0)], [(1, 3), (2, 1)], [(2, 2), (3, 0)],
           [(2, 3), (3, 1)], [(3, 2)], [(3, 3)]]


# ---------------------------------------------------------------------------
# Skew helpers.
# ---------------------------------------------------------------------------

def n_steps_of(mb_w: int, mb_h: int) -> int:
    return mb_w + SK * (mb_h - 1)


def _shear(a, mb_w, mb_h):
    """[B, n_mb, ...] -> [n_steps, B * mb_h, ...] with out[t, (b, y)] =
    a[b, y, t - 2y], by pad + reshape (invalid lanes read zeros)."""
    B, tail = a.shape[0], tuple(a.shape[2:])
    n_steps = n_steps_of(mb_w, mb_h)
    P = n_steps + SK
    b = a.reshape(B, mb_h, mb_w, *tail)
    pad = torch.zeros((B, mb_h, P - mb_w) + tail, dtype=a.dtype,
                      device=a.device)
    flat = torch.cat([b, pad], dim=2).reshape(B, mb_h * P, *tail)
    c = flat[:, :mb_h * n_steps].reshape(B, mb_h, n_steps, *tail)
    perm = (2, 0, 1) + tuple(range(3, 3 + len(tail)))
    return c.permute(perm).reshape(n_steps, B * mb_h, *tail)


def _unshear(c, B, mb_w, mb_h):
    """Inverse of _shear on per-step outputs [n_steps, B * mb_h, ...] ->
    [B, n_mb, ...]."""
    n_steps, tail = c.shape[0], tuple(c.shape[2:])
    perm = (1, 2, 0) + tuple(range(3, 3 + len(tail)))
    g = c.reshape(n_steps, B, mb_h, *tail).permute(perm)
    flat = g.reshape(B, mb_h * n_steps, *tail)
    pad = torch.zeros((B, mb_h * SK) + tail, dtype=c.dtype, device=c.device)
    flat = torch.cat([flat, pad], dim=1)
    out = flat.reshape(B, mb_h, n_steps + SK, *tail)[:, :, :mb_w]
    return out.reshape(B, mb_h * mb_w, *tail)


def _shift1(a):
    """a[l] <- a[l - 1] along the lanes (lane 0 zeros). Lanes fuse batch x
    mb_h; a value leaked across an image boundary lands on a y == 0 lane,
    whose has_top is False, so every consumer masks it."""
    out = torch.zeros_like(a)
    out[1:] = a[:-1]
    return out


def _sel4(stack, idx):
    """stack [L, 4, ...]; idx [L] in 0..3 -> [L, ...]."""
    i = idx.to(torch.int32).reshape(idx.shape + (1,) * (stack.dim() - 2))
    return torch.where(i == 0, stack[:, 0],
                       torch.where(i == 1, stack[:, 1],
                                   torch.where(i == 2, stack[:, 2],
                                               stack[:, 3])))


# ---------------------------------------------------------------------------
# Reconstruction.
# ---------------------------------------------------------------------------

def _i4_decode_walk(res_b, modes, topY, leftY, tlY, trs, has_top, has_left):
    """Closed-loop I4 reconstruction of one MB per lane, prediction only
    (the residuals are IDCT'd already): 10 anti-diagonal substeps over the
    16 subblocks. res_b [L, 16, 4, 4] int32; modes [L, 16]."""
    top_row = torch.where(has_top[:, None], topY, 127)
    left_col = torch.where(has_left[:, None], leftY, 129)
    tl0 = torch.where(has_top & has_left, tlY,
                      127 + 2 * has_top.to(torch.int32))
    tr_strip = torch.where(has_top[:, None], trs, 127)
    L = res_b.shape[0]

    def ctx_of(work, r, c):
        t = top_row[:, c * 4:c * 4 + 4] if r == 0 \
            else work[:, r * 4 - 1, c * 4:c * 4 + 4]
        lf = left_col[:, r * 4:r * 4 + 4] if c == 0 \
            else work[:, r * 4:r * 4 + 4, c * 4 - 1]
        if r == 0 and c == 0:
            tl = tl0
        elif r == 0:
            tl = top_row[:, c * 4 - 1]
        elif c == 0:
            tl = left_col[:, r * 4 - 1]
        else:
            tl = work[:, r * 4 - 1, c * 4 - 1]
        if c == 3:
            tr = tr_strip
        elif r == 0:
            tr = top_row[:, c * 4 + 4:c * 4 + 8]
        else:
            tr = work[:, r * 4 - 1, c * 4 + 4:c * 4 + 8]
        return t, lf, tl, tr

    work = torch.zeros((L, 16, 16), dtype=torch.int32, device=res_b.device)
    for group in _GROUPS:
        ctxs = [ctx_of(work, r, c) for (r, c) in group]
        t, lf, tl, tr = (torch.cat([cx[i] for cx in ctxs], dim=0)
                         for i in range(4))
        preds = pred4_all(t, lf, tl, tr)
        mode = torch.cat([modes[:, r * 4 + c] for (r, c) in group],
                         dim=0).to(torch.int32)[:, None, None]
        pred = preds[0]
        for m in range(1, 10):
            pred = torch.where(mode == m, preds[m], pred)
        res = torch.cat([res_b[:, r * 4 + c] for (r, c) in group], dim=0)
        rec = (pred + res).clamp(0, 255)
        for i, (r, c) in enumerate(group):
            work[:, r * 4:r * 4 + 4, c * 4:c * 4 + 4] = rec[i * L:(i + 1) * L]
    return work


def _recon_step(carry, x, lanes_y, mb_w):
    """One reconstruction step. carry: per plane the bottom row of this
    step's and the previous step's MB (B*1, B*2), the right column (R*)
    and the bottom-right corner of the last three steps (C*1..3). Returns
    (new carry, (rY, rU, rV) int32)."""
    (By1, By2, Ry, Cy1, Cy2, Cy3,
     Bu1, Bu2, Ru, Cu1, Cu2, Cu3,
     Bv1, Bv2, Rv, Cv1, Cv2, Cv3) = carry
    has_left = x["valid"] & (x["x"] > 0)
    has_top = x["valid"] & (lanes_y > 0)

    topY, leftY, tlY = _shift1(By2), Ry, _shift1(Cy3)
    predsY = _preds4(16, topY, leftY, tlY, has_top, has_left)
    predY = _sel4(predsY, x["im"][:, 0].clamp_max(3))
    rec16 = (predY + _unblock(x["ry"], 16)).clamp(0, 255)

    # I4: the above-right strip is the bottom row [0:4] of MB (x+1, y-1),
    # reconstructed one step earlier; past the last column the strip
    # repeats the top row's last pixel.
    trs = _shift1(By1)[:, 0:4]
    edge = topY[:, 15:16].expand(-1, 4)
    trs = torch.where((x["x"] + 1 >= mb_w)[:, None], edge, trs)
    work = _i4_decode_walk(x["ry"], x["im"], topY, leftY, tlY, trs,
                           has_top, has_left)
    rY = torch.where(x["i4"][:, None, None], work, rec16)

    topU, leftU, tlU = _shift1(Bu2), Ru, _shift1(Cu3)
    topV, leftV, tlV = _shift1(Bv2), Rv, _shift1(Cv3)
    predsU = _preds4(8, topU, leftU, tlU, has_top, has_left)
    predsV = _preds4(8, topV, leftV, tlV, has_top, has_left)
    rU = (_sel4(predsU, x["uvm"]) + _unblock(x["ru"], 8)).clamp(0, 255)
    rV = (_sel4(predsV, x["uvm"]) + _unblock(x["rv"], 8)).clamp(0, 255)

    new = (rY[:, 15, :], By1, rY[:, :, 15], rY[:, 15, 15], Cy1, Cy2,
           rU[:, 7, :], Bu1, rU[:, :, 7], rU[:, 7, 7], Cu1, Cu2,
           rV[:, 7, :], Bv1, rV[:, :, 7], rV[:, 7, 7], Cv1, Cv2)
    return new, (rY, rU, rV)


def _recon_carry0(N, device):
    z16 = torch.zeros((N, 16), dtype=torch.int32, device=device)
    z8 = torch.zeros((N, 8), dtype=torch.int32, device=device)
    z1 = torch.zeros((N,), dtype=torch.int32, device=device)
    return (z16, z16, z16, z1, z1, z1,
            z8, z8, z8, z1, z1, z1,
            z8, z8, z8, z1, z1, z1)


# ---------------------------------------------------------------------------
# Loop filter (lossy/dsp.py's edge filters, vectorized over lanes).
# ---------------------------------------------------------------------------

def _sclip1(v):
    return v.clamp(-128, 127)


def _sclip2(v):
    return v.clamp(-16, 15)


def _c255(v):
    return v.clamp(0, 255)


def _sel(cond, a, b):
    """torch.where with a Python bool or a tensor condition."""
    if isinstance(cond, bool):
        return a if cond else b
    return torch.where(cond, a, b)


def _needs_filter(p1, p0, q0, q1, thresh):
    return 4 * (p0 - q0).abs() + (p1 - q1).abs() <= thresh


def _needs_filter2(p, thresh, it):
    p3, p2, p1, p0, q0, q1, q2, q3 = p
    ok = _needs_filter(p1, p0, q0, q1, thresh)
    for a, b in ((p3, p2), (p2, p1), (p1, p0), (q3, q2), (q2, q1), (q1, q0)):
        ok = ok & ((a - b).abs() <= it)
    return ok


def _do2(p1, p0, q0, q1):
    a = 3 * (q0 - p0) + _sclip1(p1 - q1)
    a1 = _sclip2((a + 4) >> 3)
    a2 = _sclip2((a + 3) >> 3)
    return _c255(p0 + a2), _c255(q0 - a1)


def _filter_edge(p, limit, ilevel, hev_t, inner, enable):
    """The normal filter across one edge. p: 8 vectors [L, n] int32
    (p3..q3); limit/ilevel/hev_t [L, 1] int32; inner a Python bool or
    [L, 1] bool; enable [L, 1] bool. Returns the 6 updated vectors p2..q2
    (p3 and q3 never change)."""
    p3, p2, p1, p0, q0, q1, q2, q3 = p
    mask = _needs_filter2(p, 2 * limit + 1, ilevel) & enable
    hv = ((p1 - p0).abs() > hev_t) | ((q1 - q0).abs() > hev_t)
    f2p0, f2q0 = _do2(p1, p0, q0, q1)
    # The inner edge, not high-variance (doFilter4).
    a = 3 * (q0 - p0)
    a1 = _sclip2((a + 4) >> 3)
    a2 = _sclip2((a + 3) >> 3)
    a3 = (a1 + 1) >> 1
    f4 = (_c255(p1 + a3), _c255(p0 + a2), _c255(q0 - a1), _c255(q1 - a3))
    # The MB edge, not high-variance (doFilter6).
    b = _sclip1(3 * (q0 - p0) + _sclip1(p1 - q1))
    b1 = (27 * b + 63) >> 7
    b2 = (18 * b + 63) >> 7
    b3 = (9 * b + 63) >> 7
    f6 = (_c255(p2 + b3), _c255(p1 + b2), _c255(p0 + b1),
          _c255(q0 - b1), _c255(q1 - b2), _c255(q2 - b3))
    np2 = _sel(inner, p2, torch.where(hv, p2, f6[0]))
    np1 = _sel(inner, torch.where(hv, p1, f4[0]), torch.where(hv, p1, f6[1]))
    np0 = torch.where(hv, f2p0, _sel(inner, f4[1], f6[2]))
    nq0 = torch.where(hv, f2q0, _sel(inner, f4[2], f6[3]))
    nq1 = _sel(inner, torch.where(hv, q1, f4[3]), torch.where(hv, q1, f6[4]))
    nq2 = _sel(inner, q2, torch.where(hv, q2, f6[5]))
    return [torch.where(mask, new, old) for old, new in (
        (p2, np2), (p1, np1), (p0, np0), (q0, nq0), (q1, nq1), (q2, nq2))]


def _filter_edge_simple(p1, p0, q0, q1, limit, enable):
    mask = _needs_filter(p1, p0, q0, q1, 2 * limit + 1) & enable
    np0, nq0 = _do2(p1, p0, q0, q1)
    return torch.where(mask, np0, p0), torch.where(mask, nq0, q0)


def _v_edge(bl, br, col, limit, il, hev, inner, enable):
    """The normal filter across the vertical edge at br[:, :, col], in
    place; columns left of 0 are bl's last ones. bl, br: [L, n, w]."""
    def getc(c):
        return bl[:, :, bl.shape[2] + c] if c < 0 else br[:, :, c]

    upd = _filter_edge([getc(col + d) for d in range(-4, 4)], limit, il, hev,
                       inner, enable)
    for d, v in zip(range(-3, 3), upd):
        c = col + d
        if c < 0:
            bl[:, :, bl.shape[2] + c] = v
        else:
            br[:, :, c] = v


def _h_edge(bt, bb, row, limit, il, hev, inner, enable):
    """The normal filter across the horizontal edge at bb[:, row, :], in
    place; rows above 0 are bt's last ones."""
    def getr(r):
        return bt[:, bt.shape[1] + r, :] if r < 0 else bb[:, r, :]

    upd = _filter_edge([getr(row + d) for d in range(-4, 4)], limit, il, hev,
                       inner, enable)
    for d, v in zip(range(-3, 3), upd):
        r = row + d
        if r < 0:
            bt[:, bt.shape[1] + r, :] = v
        else:
            bb[:, r, :] = v


def _v_simple(bl, br, col, limit, enable):
    """The simple filter across the vertical edge at br[:, :, col], in
    place (p1, p0 from bl's last columns at col 0)."""
    def getc(c):
        return bl[:, :, bl.shape[2] + c] if c < 0 else br[:, :, c]

    np0, nq0 = _filter_edge_simple(getc(col - 2), getc(col - 1), getc(col),
                                   getc(col + 1), limit, enable)
    if col == 0:
        bl[:, :, bl.shape[2] - 1] = np0
    else:
        br[:, :, col - 1] = np0
    br[:, :, col] = nq0


def _h_simple(bt, bb, row, limit, enable):
    """The simple filter across the horizontal edge at bb[:, row, :], in
    place."""
    def getr(r):
        return bt[:, bt.shape[1] + r, :] if r < 0 else bb[:, r, :]

    np0, nq0 = _filter_edge_simple(getr(row - 2), getr(row - 1), getr(row),
                                   getr(row + 1), limit, enable)
    if row == 0:
        bt[:, bt.shape[1] - 1, :] = np0
    else:
        bb[:, row - 1, :] = np0
    bb[:, row, :] = nq0


def _filter_step(carry, x, own, uv, lanes_y, simple):
    """One loop-filter step, at lag 0 behind the reconstruction.

    own: [L, 16, 16] int32 reconstructed luma MB; uv: [L, 16, 8] (U over
    V). carry: (Ry, Bsy, Bhy, Ruv, Bsuv, Bhuv): R* the right 4 columns of
    the previous MB after filtering, Bs* its bottom 4 rows, Bh* the bottom
    rows of the MB before that with every patch applied, for the lane
    below. Returns (new carry, the step's u8 outputs: the filtered MB,
    the right-column patch of its left neighbour, the bottom-row patch of
    the MB above, and the same three for chroma)."""
    Ry, Bsy, Bhy, Ruv, Bsuv, Bhuv = carry
    leftR, topB = Ry.clone(), _shift1(Bhy)
    leftRuv, topBuv = Ruv.clone(), _shift1(Bhuv)

    en = (x["valid"] & (x["limit"] > 0))[:, None]
    has_left = en & (x["x"] > 0)[:, None]
    has_top = en & (lanes_y > 0)[:, None]
    lim = x["limit"][:, None]
    il = x["il"][:, None]
    hv = x["hev"][:, None]
    inn = en & x["inner"][:, None]

    if simple:
        # Luma only, 2 taps on p1..q1.
        _v_simple(leftR, own, 0, lim + 4, has_left)
        for k in (4, 8, 12):
            _v_simple(own, own, k, lim, inn)
        _h_simple(topB, own, 0, lim + 4, has_top)
        for k in (4, 8, 12):
            _h_simple(own, own, k, lim, inn)
    else:
        _v_edge(leftR, own, 0, lim + 4, il, hv, False, has_left)
        for k in (4, 8, 12):
            _v_edge(own, own, k, lim, il, hv, True, inn)
        _v_edge(leftRuv, uv, 0, lim + 4, il, hv, False, has_left)
        _v_edge(uv, uv, 4, lim, il, hv, True, inn)
        _h_edge(topB, own, 0, lim + 4, il, hv, False, has_top)
        for k in (4, 8, 12):
            _h_edge(own, own, k, lim, il, hv, True, inn)
        # Chroma's horizontal edges per plane (U and V stacked on the row
        # axis would couple across their boundary); the views write
        # through to uv and topBuv.
        for rows in (slice(0, 8), slice(8, 16)):
            u_own = uv[:, rows]
            top_u = topBuv[:, rows.start // 2:rows.start // 2 + 4]
            _h_edge(top_u, u_own, 0, lim + 4, il, hv, False, has_top)
            _h_edge(u_own, u_own, 4, lim, il, hv, True, inn)

    # The next carry: Bh is the previous Bs with the left edge's write
    # into the previous MB's bottom rows (its right columns) applied.
    Bhy_new = Bsy.clone()
    Bhy_new[:, :, 12:16] = leftR[:, 12:16, :]
    Bhuv_new = Bsuv.clone()
    Bhuv_new[:, :, 4:8] = torch.cat([leftRuv[:, 4:8, :],
                                     leftRuv[:, 12:16, :]], dim=1)
    new = (own[:, :, 12:16], own[:, 12:16, :], Bhy_new, uv[:, :, 4:8],
           torch.cat([uv[:, 4:8, :], uv[:, 12:16, :]], dim=1), Bhuv_new)
    u8 = torch.uint8
    return new, (own.to(u8), leftR.to(u8), topB.to(u8), uv.to(u8),
                 leftRuv.to(u8), topBuv.to(u8))


def _filter_carry0(N, device):
    def z(*s):
        return torch.zeros((N,) + s, dtype=torch.int32, device=device)
    return (z(16, 4), z(4, 16), z(4, 16), z(16, 4), z(8, 8), z(8, 8))


def _filter_assemble(outs, B, mb_w, mb_h):
    """The filtered planes from the step outputs: each MB's core, then the
    right-column patches from step t+1 (same lane), then the bottom-row
    patches from step t+2 (the lane below). The patch for MB (x, y) sits
    at grid slot (x+1, y) of the unsheared right-patch stream and (x, y+1)
    of the bottom-patch stream."""
    core_sk, rp_sk, bp_sk, uv_sk, rpuv_sk, bpuv_sk = outs

    def un(a):
        return _unshear(a, B, mb_w, mb_h)

    def shift(a, dim):
        g = a.reshape(B, mb_h, mb_w, *a.shape[2:])
        n = g.shape[dim]
        g = torch.cat([g.narrow(dim, 1, n - 1), g.narrow(dim, n - 1, 1)],
                      dim=dim)
        return g.reshape(a.shape)

    dev = core_sk.device
    n_mb = mb_w * mb_h
    idx = torch.arange(n_mb, device=dev)
    has_r = (idx % mb_w < mb_w - 1)[None, :, None, None]
    has_b = (idx // mb_w < mb_h - 1)[None, :, None, None]
    core, uvc = un(core_sk), un(uv_sk)
    rp = shift(un(rp_sk), 2)
    core = torch.where(has_r, torch.cat([core[..., :12], rp], dim=-1), core)
    rpuv = shift(un(rpuv_sk), 2)
    uvc = torch.where(has_r, torch.cat([uvc[..., :4], rpuv], dim=-1), uvc)
    bp = shift(un(bp_sk), 1)
    core = torch.where(has_b, torch.cat([core[:, :, :12], bp], dim=2), core)
    bpuv = shift(un(bpuv_sk), 1)                      # [B, n_mb, 8, 8]
    ub = torch.cat([uvc[:, :, :4], bpuv[:, :, :4]], dim=2)
    vb = torch.cat([uvc[:, :, 8:12], bpuv[:, :, 4:]], dim=2)
    uvc = torch.where(has_b, torch.cat([ub, vb], dim=2), uvc)
    return core, uvc[:, :, :8], uvc[:, :, 8:]


# ---------------------------------------------------------------------------
# The step loop and the decode function.
# ---------------------------------------------------------------------------

class _StepLoop:
    """The fused decode's step loop for one geometry, filter type, batch
    and device: static step inputs, carry, outputs and a step counter on
    the device."""

    def __init__(self, mb_w, mb_h, filter_type, B, device):
        self.mb_w, self.mb_h, self.B = mb_w, mb_h, B
        self.filter_type = filter_type
        self.n_steps = n_steps_of(mb_w, mb_h)
        self.dev = device
        N = B * mb_h
        self.yy = torch.arange(mb_h, dtype=torch.int32,
                               device=device).repeat(B)
        carry = _recon_carry0(N, device)
        if filter_type > 0:
            carry = carry + _filter_carry0(N, device)
        # One buffer per carry entry (the initial tuple shares its zeros).
        self.carry = [c.clone() for c in carry]
        self.t = torch.zeros((1,), dtype=torch.long, device=device)
        self.xs = None
        self.outs = []

    def _body(self):
        t = self.t
        x = {k: v.index_select(0, t)[0] for k, v in self.xs.items()}
        xcol = t.to(torch.int32) - SK * self.yy
        x["valid"] = (xcol >= 0) & (xcol < self.mb_w)
        x["x"] = xcol.clamp(0, self.mb_w - 1)
        n_r = 18
        new, (rY, rU, rV) = _recon_step(self.carry[:n_r], x, self.yy,
                                        self.mb_w)
        if self.filter_type > 0:
            # The filter works in place on its own copy: the carry keeps
            # the unfiltered reconstruction.
            new_f, ys = _filter_step(self.carry[n_r:], x, rY.clone(),
                                     torch.cat([rU, rV], dim=1), self.yy,
                                     simple=self.filter_type == 1)
            new = new + new_f
        else:
            ys = (rY.to(torch.uint8), rU.to(torch.uint8), rV.to(torch.uint8))
        if not self.outs:
            self.outs = [torch.empty((self.n_steps,) + tuple(y.shape),
                                     dtype=y.dtype, device=self.dev)
                         for y in ys]
        # A value carried over unchanged (B*2 <- B*1, ...) is copied before
        # its source is overwritten.
        new = [v.clone() if any(v is c for c in self.carry) else v
               for v in new]
        for c, v in zip(self.carry, new):
            c.copy_(v)
        for o, y in zip(self.outs, ys):
            o.index_copy_(0, t, y[None])
        t.add_(1)

    def run(self, xs: dict) -> list:
        """Runs every step on the sheared inputs xs ({name: [n_steps, N,
        ...]}); returns the step outputs [n_steps, N, ...] (the loop's own
        buffers, overwritten by the next run)."""
        if self.xs is None:
            self.xs = {k: v.clone() for k, v in xs.items()}
        else:
            for k, v in xs.items():
                self.xs[k].copy_(v)
            for c in self.carry:
                c.zero_()
            self.t.zero_()
        for _ in range(self.n_steps):
            self._body()
        return self.outs


def wavefront(coeffs, is_i4, imodes, uvmode, limit, ilevel, hevt, inner,
              mb_w: int, mb_h: int, filter_type: int):
    """The kernel's launch alone, on card tensors that DecodeFn has
    checked: one launch of csrc/decode_wavefront.cu with
    cluster_size(B, mb_h, SMs) blocks per image. Returns the filtered
    MB-padded planes (Y [B, 16 mb_h, 16 mb_w], U, V [B, 8 mb_h, 8 mb_w])
    u8."""
    B, dev = coeffs.shape[0], coeffs.device
    C = cluster_size(B, mb_h, sm_count(dev))
    Y = torch.empty((B, mb_h * 16, mb_w * 16), dtype=torch.uint8, device=dev)
    U = torch.empty((B, mb_h * 8, mb_w * 8), dtype=torch.uint8, device=dev)
    V = torch.empty_like(U)
    cuda.launch("decode_wavefront", coeffs, is_i4, imodes, uvmode, limit,
                ilevel, hevt, inner, B, mb_w, mb_h, C, filter_type, Y, U, V)
    return Y, U, V


def _mb_to_plane(b, mb_w, mb_h, s):
    """[B, n_mb, s, s] -> [B, mb_h * s, mb_w * s]."""
    B = b.shape[0]
    return b.reshape(B, mb_h, mb_w, s, s).permute(0, 1, 3, 2, 4).reshape(
        B, mb_h * s, mb_w * s)


class DecodeFn:
    """The batched device decoder of one geometry and filter type:

    fn(coeffs [B, n_mb, 24, 16] i16, is_i4 [B, n_mb] bool,
       imodes [B, n_mb, 16] u8, uvmode [B, n_mb] u8,
       limit/ilevel/hevt [B, n_mb] i32, inner [B, n_mb] bool)
      -> (Y [B, H, W] u8, U, V) MB-padded planes, or with upsample RGB
      [B, h, w, 3] cropped to width x height.

    All inputs on one device: on the card the kernel runs (`wavefront`),
    on the CPU the plain version (`plain`); no other path. fn.steps is
    the number of wavefront steps."""

    def __init__(self, mb_w, mb_h, filter_type, upsample, width, height):
        self.mb_w, self.mb_h = mb_w, mb_h
        self.filter_type, self.upsample = filter_type, upsample
        self.width = width or mb_w * 16
        self.height = height or mb_h * 16
        self.steps = n_steps_of(mb_w, mb_h)
        self._loops = {}

    def loop(self, B, device) -> _StepLoop:
        device = torch.device(device)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        key = (B, str(device))
        if key not in self._loops:
            trace.count(trace.PROGRAMS, "built")
            self._loops[key] = _StepLoop(self.mb_w, self.mb_h,
                                         self.filter_type, B, device)
        return self._loops[key]

    def plain(self, coeffs, is_i4, imodes, uvmode, limit, ilevel, hevt,
              inner):
        """The plain version of the kernel: the step loop, on the inputs'
        device, -> the MB-padded planes (Y, U, V)."""
        mb_w, mb_h = self.mb_w, self.mb_h
        B, n_mb = coeffs.shape[0], mb_w * mb_h
        res = dct.idct4x4(coeffs.to(torch.int32).reshape(B, n_mb, 24, 4, 4))

        def sh(a):
            return _shear(a, mb_w, mb_h)

        xs = {"ry": sh(res[:, :, :16]), "ru": sh(res[:, :, 16:20]),
              "rv": sh(res[:, :, 20:24]), "i4": sh(is_i4.to(torch.bool)),
              "im": sh(imodes), "uvm": sh(uvmode)}
        if self.filter_type > 0:
            xs.update(limit=sh(limit.to(torch.int32)),
                      il=sh(ilevel.to(torch.int32)),
                      hev=sh(hevt.to(torch.int32)),
                      inner=sh(inner.to(torch.bool)))
        outs = self.loop(B, coeffs.device).run(xs)
        if self.filter_type > 0:
            Yb, Ub, Vb = _filter_assemble(outs, B, mb_w, mb_h)
        else:
            Yb, Ub, Vb = (_unshear(o, B, mb_w, mb_h) for o in outs)
        return (_mb_to_plane(Yb, mb_w, mb_h, 16),
                _mb_to_plane(Ub, mb_w, mb_h, 8),
                _mb_to_plane(Vb, mb_w, mb_h, 8))

    def __call__(self, coeffs, is_i4, imodes, uvmode, limit, ilevel, hevt,
                 inner):
        mb_w, mb_h = self.mb_w, self.mb_h
        B, n_mb = coeffs.shape[0], mb_w * mb_h
        if B == 0:
            raise ValueError("decode: an empty batch")
        cuda.check("coeffs", coeffs, torch.int16, (B, n_mb, 24, 16))
        for name, t in (("is_i4", is_i4), ("inner", inner)):
            cuda.check(name, t, torch.bool, (B, n_mb))
        cuda.check("imodes", imodes, torch.uint8, (B, n_mb, 16))
        cuda.check("uvmode", uvmode, torch.uint8, (B, n_mb))
        for name, t in (("limit", limit), ("ilevel", ilevel), ("hevt", hevt)):
            cuda.check(name, t, torch.int32, (B, n_mb))
        args = (coeffs, is_i4, imodes, uvmode, limit, ilevel, hevt, inner)
        if cuda.on_cpu(*args):
            Y, U, V = self.plain(*args)
        else:
            Y, U, V = wavefront(*args, mb_w, mb_h, self.filter_type)
        if not self.upsample:
            return Y, U, V
        from . import yuv as devyuv

        w, h = self.width, self.height
        cw, ch = (w + 1) >> 1, (h + 1) >> 1
        return devyuv.yuv420_to_rgb_fancy(Y[:, :h, :w], U[:, :ch, :cw],
                                          V[:, :ch, :cw])


@functools.lru_cache(maxsize=8)
def decode_fn(mb_w: int, mb_h: int, filter_type: int, upsample: bool = True,
              width: int = 0, height: int = 0) -> DecodeFn:
    """The cached DecodeFn of a geometry, filter type (vp8_parse's
    finfo[0]: 0 none, 1 simple, 2 normal) and output form; its plain
    version keeps one step loop per batch size and device."""
    return DecodeFn(mb_w, mb_h, filter_type, upsample, width, height)
