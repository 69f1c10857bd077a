"""Transfer-function library for SharpYUV: the port's own copy of
webp_tpu/sharpyuv/gamma.py (after the Go reference's sharpyuv/gamma.go).

Each entry maps gamma-encoded values in [0, 1] to linear light and back.
The default used by the converter is the BT.709/601 curve (kGammaF), same
as the reference; the rest cover the full CICP transfer-characteristics
set the reference exposes.
"""

from __future__ import annotations

import numpy as np

# CICP transfer characteristic codes (subset names as in gamma.go).
BT709 = "bt709"            # also BT601 / BT2020 10/12-bit (same curve)
BT470M = "bt470m"          # gamma 2.2
BT470BG = "bt470bg"        # gamma 2.8
SMPTE240 = "smpte240"
LINEAR = "linear"
LOG100 = "log100"
LOG100_SQRT10 = "log100_sqrt10"
IEC61966 = "iec61966"      # sRGB
BT1361 = "bt1361"
PQ = "smpte2084"           # PQ
SMPTE428 = "smpte428"
HLG = "hlg"


def _to_linear_709(g):
    a = 0.09929682680944
    t = 0.018053968510807 * 4.5
    return np.where(g <= t, g / 4.5,
                    ((g + a) / (1.0 + a)) ** (1.0 / 0.45))


def _from_linear_709(v):
    a = 0.09929682680944
    t = 0.018053968510807
    return np.where(v <= t, 4.5 * v, (1.0 + a) * v ** 0.45 - a)


def _to_linear_srgb(g):
    return np.where(g <= 0.04045, g / 12.92, ((g + 0.055) / 1.055) ** 2.4)


def _from_linear_srgb(v):
    return np.where(v <= 0.0031308, 12.92 * v,
                    1.055 * v ** (1.0 / 2.4) - 0.055)


def _to_linear_pq(g):
    m1, m2 = 2610.0 / 16384, 2523.0 / 32
    c1, c2, c3 = 3424.0 / 4096, 2413.0 / 128, 2392.0 / 128
    p = np.maximum(g, 0.0) ** (1.0 / m2)
    return (np.maximum(p - c1, 0.0) / (c2 - c3 * p)) ** (1.0 / m1)


def _from_linear_pq(v):
    m1, m2 = 2610.0 / 16384, 2523.0 / 32
    c1, c2, c3 = 3424.0 / 4096, 2413.0 / 128, 2392.0 / 128
    vm = np.maximum(v, 0.0) ** m1
    return ((c1 + c2 * vm) / (1.0 + c3 * vm)) ** m2


def _to_linear_hlg(g):
    a, b, c = 0.17883277, 0.28466892, 0.55991073
    return np.where(g <= 0.5, (g * g) / 3.0,
                    (np.exp((g - c) / a) + b) / 12.0)


def _from_linear_hlg(v):
    a, b, c = 0.17883277, 0.28466892, 0.55991073
    return np.where(v <= 1.0 / 12.0, np.sqrt(3.0 * v),
                    a * np.log(np.maximum(12.0 * v - b, 1e-12)) + c)


def _to_linear_bt1361(g):
    a = 0.09929682680944
    t = 0.018053968510807 * 4.5
    lo = -0.25  # extended range clamp
    g = np.clip(g, lo, 1.0)
    pos = np.where(g <= t, g / 4.5, ((g + a) / (1.0 + a)) ** (1.0 / 0.45))
    neg = -(((-(4.0 * g) + a) / (1.0 + a)) ** (1.0 / 0.45)) / 4.0
    return np.where(g >= 0.0, pos, np.where(g >= -t / 4.0, g / 4.5, neg))


def _from_linear_bt1361(v):
    a = 0.09929682680944
    t = 0.018053968510807
    v = np.clip(v, -0.25, 1.0)
    pos = np.where(v <= t, 4.5 * v, (1.0 + a) * v ** 0.45 - a)
    neg = -((1.0 + a) * (np.maximum(-4.0 * v, 0.0)) ** 0.45 - a) / 4.0
    return np.where(v >= 0.0, pos, np.where(v >= -t, 4.5 * v, neg))


TRANSFER_FUNCTIONS = {
    BT709: (_to_linear_709, _from_linear_709),
    BT470M: (lambda g: np.maximum(g, 0.0) ** 2.2,
             lambda v: np.maximum(v, 0.0) ** (1.0 / 2.2)),
    BT470BG: (lambda g: np.maximum(g, 0.0) ** 2.8,
              lambda v: np.maximum(v, 0.0) ** (1.0 / 2.8)),
    SMPTE240: (lambda g: np.where(g < 4.0 * 0.022821585529445,
                                  g / 4.0, ((g + 0.111572195921731)
                                            / 1.111572195921731) ** (1 / 0.45)),
               lambda v: np.where(v < 0.022821585529445, 4.0 * v,
                                  1.111572195921731 * v ** 0.45
                                  - 0.111572195921731)),
    LINEAR: (lambda g: g, lambda v: v),
    LOG100: (lambda g: np.where(g <= 0.0, 0.01, 10.0 ** (2.0 * (g - 1.0))),
             lambda v: np.where(v < 0.01, 0.0,
                                1.0 + np.log10(np.maximum(v, 1e-12)) / 2.0)),
    LOG100_SQRT10: (
        lambda g: np.where(g <= 0.0, np.sqrt(10.0) / 1000.0,
                           10.0 ** (2.5 * (g - 1.0))),
        lambda v: np.where(v < np.sqrt(10.0) / 1000.0, 0.0,
                           1.0 + np.log10(np.maximum(v, 1e-12)) / 2.5)),
    IEC61966: (_to_linear_srgb, _from_linear_srgb),
    BT1361: (_to_linear_bt1361, _from_linear_bt1361),
    PQ: (_to_linear_pq, _from_linear_pq),
    SMPTE428: (lambda g: (np.maximum(g, 0.0) ** 2.6) * 52.37 / 48.0,
               lambda v: (np.maximum(48.0 * v / 52.37, 0.0)) ** (1.0 / 2.6)),
    HLG: (_to_linear_hlg, _from_linear_hlg),
}


def to_linear(name: str, g: np.ndarray) -> np.ndarray:
    return TRANSFER_FUNCTIONS[name][0](np.asarray(g, np.float64))


def from_linear(name: str, v: np.ndarray) -> np.ndarray:
    return TRANSFER_FUNCTIONS[name][1](np.asarray(v, np.float64))


def build_tables(name: str, g2l_size: int, l2g_size: int, linear_bits: int):
    """Fixed-point table pair for the converter (gamma.go table builders)."""
    final_scale = float(1 << linear_bits)
    g = np.arange(g2l_size + 1) / g2l_size
    g2l = np.empty(g2l_size + 2, np.int64)
    g2l[:g2l_size + 1] = (to_linear(name, g) * final_scale + 0.5).astype(
        np.int64)
    g2l[g2l_size + 1] = g2l[g2l_size]
    v = np.arange(l2g_size + 1) / l2g_size
    l2g = np.empty(l2g_size + 2, np.int64)
    l2g[:l2g_size + 1] = (from_linear(name, v) * final_scale + 0.5).astype(
        np.int64)
    l2g[l2g_size + 1] = l2g[l2g_size]
    return g2l, l2g
