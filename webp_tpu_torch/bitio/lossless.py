"""VP8L raw-bit I/O (little-endian bit packing).

Host-side primitives; the serial hot loops have native C++ equivalents in
webp_tpu_torch/native/src (vp8l_enc.cc, vp8l_dec.cc). Parity with the
reference's internal/bitio/{reader_lossless.go,writer_lossless.go}.
"""

from __future__ import annotations


class LosslessBitReader:
    """LE bit reader with a 64-bit window, 32-bit refills.

    Mirrors the semantics of the reference LosslessReader
    (bitio/reader_lossless.go:16-158): reads never raise on overrun; instead
    `eos` latches once bits past the end are consumed, and reads return what
    zero-padding would give.
    """

    __slots__ = ("data", "val", "bit_pos", "pos", "n", "eos")

    def __init__(self, data: bytes):
        self.data = data
        self.n = len(data)
        self.val = 0
        self.bit_pos = 0
        self.pos = 0
        self.eos = False
        # Initial fill: up to 8 bytes.
        v = 0
        for i in range(8):
            b = data[self.pos] if self.pos < self.n else 0
            if self.pos < self.n:
                self.pos += 1
            v |= b << (8 * i)
        self.val = v

    def _shift_bytes(self) -> None:
        while self.bit_pos >= 8 and self.pos < self.n:
            self.val = (self.val >> 8) | (self.data[self.pos] << 56)
            self.pos += 1
            self.bit_pos -= 8

    def fill_bit_window(self) -> None:
        if self.bit_pos >= 32:
            self._shift_bytes()

    def prefetch_bits(self) -> int:
        return (self.val >> self.bit_pos) & 0xFFFFFFFFFFFFFFFF

    def set_bit_pos(self, pos: int) -> None:
        self.bit_pos = pos
        if pos > 64 - 8:
            self._check_eos(0)

    def read_bits(self, n: int) -> int:
        """Reads n (<=24) bits LE-first."""
        if n == 0:
            return 0
        self.fill_bit_window()
        if self.bit_pos + n > 64:
            self._check_eos(n)
            self.bit_pos = min(self.bit_pos + n, 64)
            return 0
        v = (self.val >> self.bit_pos) & ((1 << n) - 1)
        self.bit_pos += n
        self._check_eos(0)
        return v

    def _check_eos(self, upcoming: int) -> None:
        # Total consumed bits vs total available bits.
        consumed = (self.pos * 8) - (64 - self.bit_pos - upcoming)
        if consumed > self.n * 8:
            self.eos = True

    def is_end_of_stream(self) -> bool:
        if self.eos:
            return True
        consumed = (self.pos * 8) - (64 - self.bit_pos)
        return consumed > self.n * 8


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
        import numpy as np

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
