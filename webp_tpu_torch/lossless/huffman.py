"""Canonical Huffman table build for VP8L decode.

Two-level lookup tables (8-bit root) in the canonical-code order mandated by
the WebP lossless spec. Parity with
the reference's internal/lossless/huffman.go (BuildHuffmanTable/ReadSymbol).
"""

from __future__ import annotations

import numpy as np

MAX_ALLOWED_CODE_LENGTH = 15
ROOT_BITS = 8
ROOT_MASK = (1 << ROOT_BITS) - 1

# Code-length-code transmission order (WebP lossless spec §4.1.1).
CODE_LENGTH_CODE_ORDER = (17, 18, 0, 1, 2, 3, 4, 5, 16, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15)
CODE_LENGTH_CODES = 19
CODE_LENGTH_LITERALS = 16
CODE_LENGTH_REPEAT_CODE = 16
CODE_LENGTH_EXTRA_BITS = (2, 3, 7)
CODE_LENGTH_REPEAT_OFFSETS = (3, 3, 11)

NUM_LITERAL_CODES = 256
NUM_LENGTH_CODES = 24
NUM_DISTANCE_CODES = 40
HUFFMAN_CODES_PER_META = 5


def alphabet_size(huff_index: int, color_cache_bits: int) -> int:
    if huff_index == 0:
        n = NUM_LITERAL_CODES + NUM_LENGTH_CODES
        if color_cache_bits > 0:
            n += 1 << color_cache_bits
        return n
    if huff_index == 4:
        return NUM_DISTANCE_CODES
    return NUM_LITERAL_CODES


class HuffmanTable:
    """Flat two-level decode table.

    Entry layout: root slots 0..255. A root slot with bits <= ROOT_BITS is a
    direct hit (consume `bits`, emit `value`). bits > ROOT_BITS means the low
    8 bits were consumed conceptually at the root and `value` is the offset of
    a subtable indexed by the next (bits - ROOT_BITS) bits; subtable entries
    store the TOTAL code length in `bits`.
    """

    __slots__ = ("bits", "value", "max_length", "num_symbols", "single_symbol")

    def __init__(self, bits: np.ndarray, value: np.ndarray, max_length: int,
                 num_symbols: int, single_symbol: int):
        self.bits = bits
        self.value = value
        self.max_length = max_length
        self.num_symbols = num_symbols
        self.single_symbol = single_symbol  # -1 unless exactly one code

    def read_symbol(self, br) -> int:
        """Decode one symbol from a LosslessBitReader."""
        if self.single_symbol >= 0:
            return self.single_symbol
        br.fill_bit_window()
        pre = br.prefetch_bits()
        idx = pre & ROOT_MASK
        nbits = int(self.bits[idx])
        if nbits > ROOT_BITS:
            off = int(self.value[idx])
            sub = off + ((pre >> ROOT_BITS) & ((1 << (nbits - ROOT_BITS)) - 1))
            nbits = int(self.bits[sub])
            br.set_bit_pos(br.bit_pos + nbits)
            return int(self.value[sub])
        br.set_bit_pos(br.bit_pos + nbits)
        return int(self.value[idx])


def _reverse_bits(code: int, length: int) -> int:
    out = 0
    for _ in range(length):
        out = (out << 1) | (code & 1)
        code >>= 1
    return out


def build_huffman_table(code_lengths) -> HuffmanTable:
    """Builds the decode table from per-symbol code lengths.

    Raises ValueError on an over/under-subscribed code (matching the strict
    validation the reference performs in BuildHuffmanTable, huffman.go:70).
    """
    code_lengths = list(code_lengths)
    n = len(code_lengths)
    counts = [0] * (MAX_ALLOWED_CODE_LENGTH + 1)
    for l in code_lengths:
        if l < 0 or l > MAX_ALLOWED_CODE_LENGTH:
            raise ValueError("invalid code length")
        counts[l] += 1
    num_used = n - counts[0]
    if num_used == 0:
        raise ValueError("empty huffman code")
    if num_used == 1:
        sym = next(i for i, l in enumerate(code_lengths) if l > 0)
        # A lone symbol must have length 1 per the simple-code path; general
        # path tolerates it too (zero bits consumed).
        bits = np.zeros(1 << ROOT_BITS, dtype=np.uint8)
        value = np.full(1 << ROOT_BITS, sym, dtype=np.uint16)
        return HuffmanTable(bits, value, 0, 1, sym)

    # Kraft check (complete code required).
    total = 0
    for l in range(1, MAX_ALLOWED_CODE_LENGTH + 1):
        total += counts[l] << (MAX_ALLOWED_CODE_LENGTH - l)
    if total != 1 << MAX_ALLOWED_CODE_LENGTH:
        raise ValueError("invalid huffman code (not complete)")

    # Canonical code assignment: increasing length, then symbol order.
    next_code = [0] * (MAX_ALLOWED_CODE_LENGTH + 1)
    code = 0
    for l in range(1, MAX_ALLOWED_CODE_LENGTH + 1):
        code = (code + counts[l - 1]) << 1
        next_code[l] = code

    max_len = max(l for l in code_lengths if l > 0)
    root_size = 1 << ROOT_BITS

    # Size subtables: group long codes by root prefix.
    # First pass: per-prefix max length.
    sub_max: dict[int, int] = {}
    codes = [0] * n
    for sym in range(n):
        l = code_lengths[sym]
        if l == 0:
            continue
        c = next_code[l]
        next_code[l] += 1
        rc = _reverse_bits(c, l)
        codes[sym] = rc
        if l > ROOT_BITS:
            prefix = rc & ROOT_MASK
            sub_max[prefix] = max(sub_max.get(prefix, 0), l)

    total_size = root_size + sum(1 << (m - ROOT_BITS) for m in sub_max.values())
    bits = np.zeros(total_size, dtype=np.uint8)
    value = np.zeros(total_size, dtype=np.uint16)

    # Allocate subtable offsets and mark root pointers.
    sub_off: dict[int, int] = {}
    off = root_size
    for prefix, m in sub_max.items():
        sub_off[prefix] = off
        bits[prefix] = m  # total bits; > ROOT_BITS flags a subtable pointer
        value[prefix] = off
        off += 1 << (m - ROOT_BITS)

    for sym in range(n):
        l = code_lengths[sym]
        if l == 0:
            continue
        rc = codes[sym]
        if l <= ROOT_BITS:
            step = 1 << l
            for i in range(rc, root_size, step):
                bits[i] = l
                value[i] = sym
        else:
            prefix = rc & ROOT_MASK
            m = sub_max[prefix]
            base = sub_off[prefix]
            hi = rc >> ROOT_BITS  # remaining l-ROOT_BITS bits
            step = 1 << (l - ROOT_BITS)
            for i in range(hi, 1 << (m - ROOT_BITS), step):
                bits[base + i] = l
                value[base + i] = sym

    return HuffmanTable(bits, value, max_len, num_used, -1)
