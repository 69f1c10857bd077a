"""VP8 boolean (arithmetic) decoder — host primitive.

Classic RFC 6386 §7 formulation (16-bit value window); the encoder's
boolean writer is native (native/src/bitio.h).

Behavioral parity with the reference internal/bitio/reader_bool.go (which
uses the equivalent libwebp 56-bit-prefetch variant).
"""

from __future__ import annotations


class BoolReader:
    """RFC 6386 boolean decoder over a byte buffer."""

    __slots__ = ("data", "n", "pos", "value", "range", "bit_count", "eof")

    def __init__(self, data: bytes):
        self.data = data
        self.n = len(data)
        self.pos = 0
        self.value = 0
        self.range = 255
        self.bit_count = -8  # bits needed before value window is full
        self.eof = False
        # Prime the 16-bit window.
        for _ in range(2):
            self.value = (self.value << 8) | self._next_byte()
        self.bit_count = 0

    def _next_byte(self) -> int:
        if self.pos < self.n:
            b = self.data[self.pos]
            self.pos += 1
            return b
        self.eof = True
        return 0

    def get_bit(self, prob: int) -> int:
        split = 1 + (((self.range - 1) * prob) >> 8)
        bigsplit = split << 8
        if self.value >= bigsplit:
            bit = 1
            self.range -= split
            self.value -= bigsplit
        else:
            bit = 0
            self.range = split
        while self.range < 128:
            self.value <<= 1
            self.range <<= 1
            self.bit_count += 1
            if self.bit_count == 8:
                self.bit_count = 0
                self.value |= self._next_byte()
        return bit

    def get_value(self, nbits: int) -> int:
        v = 0
        for _ in range(nbits):
            v = (v << 1) | self.get_bit(0x80)
        return v

    def get_signed_value(self, nbits: int) -> int:
        v = self.get_value(nbits)
        return -v if self.get_bit(0x80) else v

    def get_sign_applied(self, v: int) -> int:
        """GetSigned: reads one sign bit and negates v accordingly."""
        return -v if self.get_bit(0x80) else v
