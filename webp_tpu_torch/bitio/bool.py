"""VP8 boolean (arithmetic) coder — host primitives.

Classic RFC 6386 §7 formulation (16-bit value window) for the reader and the
carry-propagating writer. These are the correct-by-construction references;
the native C++ fast paths in webp_tpu_torch/native mirror them byte-for-byte.

Behavioral parity with the reference internal/bitio/{reader_bool.go,
writer_bool.go} (which use the equivalent libwebp 56-bit-prefetch variant).
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


class BoolWriter:
    """RFC 6386 §7.2 boolean encoder (32-bit bottom register, carry
    propagation into already-emitted bytes)."""

    __slots__ = ("buf", "range", "bottom", "bit_count")

    def __init__(self):
        self.buf = bytearray()
        self.range = 255
        self.bottom = 0  # 32-bit accumulator
        self.bit_count = 24

    def _carry(self) -> None:
        i = len(self.buf) - 1
        while i >= 0 and self.buf[i] == 0xFF:
            self.buf[i] = 0
            i -= 1
        if i >= 0:
            self.buf[i] += 1

    def _shift_once(self) -> None:
        if self.bottom & 0x80000000:
            self._carry()
        self.bottom = (self.bottom << 1) & 0xFFFFFFFF
        self.bit_count -= 1
        if self.bit_count == 0:
            self.buf.append((self.bottom >> 24) & 0xFF)
            self.bottom &= 0xFFFFFF
            self.bit_count = 8

    def put_bit(self, prob: int, bit: int) -> int:
        split = 1 + (((self.range - 1) * prob) >> 8)
        if bit:
            self.bottom += split
            self.range -= split
        else:
            self.range = split
        while self.range < 128:
            self.range <<= 1
            self._shift_once()
        return bit

    def put_bits(self, value: int, nbits: int) -> None:
        for i in range(nbits - 1, -1, -1):
            self.put_bit(0x80, (value >> i) & 1)

    def put_signed_bits(self, value: int, nbits: int) -> None:
        if value < 0:
            self.put_bits(-value, nbits)
            self.put_bit(0x80, 1)
        else:
            self.put_bits(value, nbits)
            self.put_bit(0x80, 0)

    def num_bytes(self) -> int:
        return len(self.buf)

    def finish(self) -> bytes:
        for _ in range(32):
            self._shift_once()
        return bytes(self.buf)
