"""VP8 boolean (arithmetic) coder — host primitives.

Classic RFC 6386 §7 formulation: the carry-propagating writer. It is the
correct-by-construction reference; the native C++ fast path in
webp_tpu_torch/native mirrors it byte-for-byte.

Behavioral parity with the reference internal/bitio/{reader_bool.go,
writer_bool.go} (which use the equivalent libwebp 56-bit-prefetch variant).
"""

from __future__ import annotations


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
