"""The lossless encoder's bit writer: LSB-first, with a splice of a
pre-packed bit buffer (a copy of the measured package's
bitio/lossless.py LosslessBitWriter)."""

from __future__ import annotations

import numpy as np


class LosslessBitWriter:
    """LE bit accumulator writer (reference bitio/writer_lossless.go)."""

    __slots__ = ("buf", "acc", "used")

    def __init__(self):
        self.buf = bytearray()
        self.acc = 0  # bit accumulator
        self.used = 0  # bits in accumulator

    def write_bits(self, value: int, n: int) -> None:
        if n == 0:
            return
        self.acc |= (value & ((1 << n) - 1)) << self.used
        self.used += n
        while self.used >= 32:
            self.buf += (self.acc & 0xFFFFFFFF).to_bytes(4, "little")
            self.acc >>= 32
            self.used -= 32

    def bit_position(self) -> int:
        return len(self.buf) * 8 + self.used

    def append_bits_buffer(self, data: bytes, nbits: int) -> None:
        """Splices a pre-packed LSB-first bit buffer (e.g. from the native
        encoder) in one vectorized pass instead of per-symbol write_bits."""
        if nbits <= 0:
            return
        while self.used >= 8:  # normalize accumulator to < 8 bits
            self.buf.append(self.acc & 0xFF)
            self.acc >>= 8
            self.used -= 8
        s = self.used
        arr = np.frombuffer(data, dtype=np.uint8)[: (nbits + 7) // 8]
        total = s + nbits
        if s == 0:
            shifted = arr
        else:
            a = arr.astype(np.uint16)
            out = np.empty(len(arr) + 1, dtype=np.uint8)
            out[0] = (self.acc | (int(a[0]) << s)) & 0xFF
            carry = (a >> (8 - s)).astype(np.uint8)
            lo = ((a << s) & 0xFF).astype(np.uint8)
            out[1:-1] = carry[:-1] | lo[1:]
            out[-1] = carry[-1]
            shifted = out
        full = total // 8
        self.buf += shifted[:full].tobytes()
        rem = total % 8
        if rem:
            self.acc = int(shifted[full]) & ((1 << rem) - 1)
            self.used = rem
        else:
            self.acc = 0
            self.used = 0

    def finish(self) -> bytes:
        while self.used > 0:
            self.buf.append(self.acc & 0xFF)
            self.acc >>= 8
            self.used -= 8
        self.used = 0
        return bytes(self.buf)
