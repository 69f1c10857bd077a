"""VP8Random: Knuth lagged-Fibonacci dither PRNG (x_n = x_{n-55} - x_{n-24}
mod 2^31), matching the reference dsp/random.go and libwebp
random_utils.c. Includes a vectorized stream generator for batched dithered
RGB->YUV import."""

from __future__ import annotations

import numpy as np

DITHER_FIX = 8
TABLE_SIZE = 55

# libwebp's published 31-bit seed table (random_utils.c kRandomTable).
RANDOM_TABLE = np.array([
    0x0DE15230, 0x03B31886, 0x775FACCB, 0x1C88626A, 0x68385C55, 0x14B3B828,
    0x4A85FEF8, 0x49DDB84B, 0x64FCF397, 0x5C550289, 0x4A290000, 0x0D7EC1DA,
    0x5940B7AB, 0x5492577D, 0x4E19CA72, 0x38D38C69, 0x0C01EE65, 0x32A1755F,
    0x5437F652, 0x5ABB2C32, 0x0FAA57B1, 0x73F533E7, 0x685FEEDA, 0x7563CCE2,
    0x6E990E83, 0x4730A7ED, 0x4FC0D9C6, 0x496B153C, 0x4F1403FA, 0x541AFB0C,
    0x73990B32, 0x26D7CB1C, 0x6FCC3706, 0x2CBB77D8, 0x75762F2A, 0x6425CCDD,
    0x24B35461, 0x0A7D8715, 0x220414A8, 0x141EBF67, 0x56B41583, 0x73E502E3,
    0x44CAB16F, 0x28264D42, 0x73BAAEFB, 0x0A50EBED, 0x1D6AB6FB, 0x0D3AD40B,
    0x35DB3B68, 0x2B081E83, 0x77CE6B95, 0x5181E5F0, 0x78853BBC, 0x009F9494,
    0x27E5ED3C,
], dtype=np.int64)


class VP8Random:
    """Scalar-compatible generator (parity with dsp/random.go)."""

    def __init__(self, dithering: float):
        self.tab = RANDOM_TABLE.copy()
        self.index1 = 0
        self.index2 = 31
        if dithering < 0.0:
            self.amp = 0
        elif dithering > 1.0:
            self.amp = 1 << DITHER_FIX
        else:
            self.amp = int((1 << DITHER_FIX) * dithering)

    def random_bits2(self, num_bits: int, amp: int) -> int:
        diff = int(self.tab[self.index1]) - int(self.tab[self.index2])
        if diff < 0:
            diff += 1 << 31
        self.tab[self.index1] = diff
        self.index1 = (self.index1 + 1) % TABLE_SIZE
        self.index2 = (self.index2 + 1) % TABLE_SIZE
        # Sign-extend and center.
        diff = np.int32(np.uint32(diff << 1) & 0xFFFFFFFF) >> np.int32(32 - num_bits)
        diff = (int(diff) * amp) >> DITHER_FIX
        return diff + (1 << (num_bits - 1))

    def random_bits(self, num_bits: int) -> int:
        return self.random_bits2(num_bits, self.amp)


def random_stream(n: int, num_bits: int, dithering: float) -> np.ndarray:
    """Vectorized generation of n successive random_bits() draws."""
    rg = VP8Random(dithering)
    # Generate raw lagged-Fibonacci stream in 24-step chunks (the smaller lag).
    raw = np.empty(n, dtype=np.int64)
    tab = rg.tab.copy()
    i = 0
    i1, i2 = 0, 31
    while i < n:
        # One full pass over the table produces TABLE_SIZE values but lags
        # wrap; do it in safe strides of min(24, remaining).
        take = min(24, n - i, TABLE_SIZE - max(i1, i2))
        if take <= 0:  # wrap indices
            if i1 >= TABLE_SIZE:
                i1 = 0
            if i2 >= TABLE_SIZE:
                i2 = 0
            continue
        d = (tab[i1 : i1 + take] - tab[i2 : i2 + take]) % (1 << 31)
        tab[i1 : i1 + take] = d
        raw[i : i + take] = d
        i += take
        i1 += take
        i2 += take
        if i1 >= TABLE_SIZE:
            i1 = 0
        if i2 >= TABLE_SIZE:
            i2 = 0
    amp = VP8Random(dithering).amp
    diff = (np.uint32(raw << 1) & np.uint32(0xFFFFFFFF)).astype(np.int32) \
        >> np.int32(32 - num_bits)
    out = ((diff.astype(np.int64) * amp) >> DITHER_FIX) + (1 << (num_bits - 1))
    return out
