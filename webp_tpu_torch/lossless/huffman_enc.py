"""Huffman code construction + bitstream emission for VP8L encoding.

Length-limited (15) canonical Huffman codes matching the decoder's
canonical-code convention (build order: code length, then symbol index),
with code-lengths themselves RLE- and Huffman-coded (codes 16/17/18).
Parity with the reference's internal/lossless/encode_huffman.go, with one
difference from webp_tpu's copy: where the code-length code has a single
used symbol, each run-length token's code takes 0 bits (write_huffman_code),
as every decoder reads it and as libwebp's encoder writes it.
"""

from __future__ import annotations

import heapq
from dataclasses import dataclass
from typing import List, Sequence

import numpy as np

from ..bitio.lossless import LosslessBitWriter
from .huffman import (
    CODE_LENGTH_CODE_ORDER,
    CODE_LENGTH_CODES,
    MAX_ALLOWED_CODE_LENGTH,
)


def _tree_depths(counts: Sequence[int]) -> List[int]:
    """Plain Huffman depths via a heap (ties broken deterministically)."""
    heap = []
    for sym, c in enumerate(counts):
        if c > 0:
            heap.append((c, sym, None))
    if not heap:
        return [0] * len(counts)
    if len(heap) == 1:
        d = [0] * len(counts)
        d[heap[0][1]] = 1
        return d
    heapq.heapify(heap)
    seq = len(counts)
    nodes = {}
    while len(heap) > 1:
        c1, s1, n1 = heapq.heappop(heap)
        c2, s2, n2 = heapq.heappop(heap)
        nodes[seq] = ((s1, n1), (s2, n2))
        heapq.heappush(heap, (c1 + c2, seq, seq))
        seq += 1
    depths = [0] * len(counts)

    def walk(sym, node, depth):
        if node is None:
            depths[sym] = max(1, depth)
            return
        (s1, n1), (s2, n2) = nodes[node]
        walk(s1, n1, depth + 1)
        walk(s2, n2, depth + 1)

    _, root_sym, root_node = heap[0]
    walk(root_sym, root_node, 0)
    return depths


def build_code_lengths(counts: Sequence[int],
                       limit: int = MAX_ALLOWED_CODE_LENGTH) -> List[int]:
    """Length-limited Huffman code lengths (libwebp GenerateOptimalTree's
    count-clamping retry strategy)."""
    counts = list(counts)
    count_min = 1
    while True:
        adjusted = [0 if c == 0 else max(c, count_min) for c in counts]
        depths = _tree_depths(adjusted)
        if max(depths, default=0) <= limit:
            return depths
        count_min *= 2


def canonical_codes(lengths: Sequence[int]) -> List[int]:
    """Bit-reversed canonical codes (ready for LSB-first writing)."""
    max_len = max(lengths, default=0)
    counts = [0] * (max_len + 1)
    for l in lengths:
        counts[l] += 1
    counts[0] = 0
    next_code = [0] * (max_len + 1)
    code = 0
    for l in range(1, max_len + 1):
        code = (code + counts[l - 1]) << 1
        next_code[l] = code
    codes = [0] * len(lengths)
    for sym, l in enumerate(lengths):
        if l == 0:
            continue
        c = next_code[l]
        next_code[l] += 1
        # reverse bits
        rc = 0
        for _ in range(l):
            rc = (rc << 1) | (c & 1)
            c >>= 1
        codes[sym] = rc
    return codes


@dataclass
class HuffmanCode:
    desc_lengths: List[int]  # lengths as described in the bitstream
    lengths: List[int]       # lengths used for symbol emission (0 if 1-symbol)
    codes: List[int]

    @staticmethod
    def from_counts(counts: Sequence[int]) -> "HuffmanCode":
        counts = list(counts)
        if not any(counts):
            counts[0] = 1  # degenerate: describe a 1-symbol tree for symbol 0
        desc = build_code_lengths(counts)
        emit = list(desc)
        if sum(1 for l in desc if l > 0) == 1:
            # The decoder consumes 0 bits per symbol from a 1-symbol tree.
            emit = [0] * len(desc)
        return HuffmanCode(desc, emit, canonical_codes(emit))

    def write_symbol(self, bw: LosslessBitWriter, sym: int) -> None:
        bw.write_bits(self.codes[sym], self.lengths[sym])

    def cost(self, sym: int) -> int:
        return self.lengths[sym]


def _rle_tokens(lengths: Sequence[int]):
    """Tokenizes code lengths with repeat codes (16: prev x3-6, 17: zeros
    x3-10, 18: zeros x11-138), mirroring the decoder's expansion."""
    tokens = []  # (symbol, extra_bits_value)
    n = len(lengths)
    prev = 8
    i = 0
    while i < n:
        v = lengths[i]
        run = 1
        while i + run < n and lengths[i + run] == v:
            run += 1
        if v == 0:
            # zero runs
            k = run
            while k >= 3:
                if k >= 11:
                    take = min(k, 138)
                    tokens.append((18, take - 11))
                else:
                    take = min(k, 10)
                    tokens.append((17, take - 3))
                k -= take
            for _ in range(k):
                tokens.append((0, None))
        else:
            k = run
            # First occurrence written literally (and becomes `prev`).
            if v != prev:
                tokens.append((v, None))
                prev = v
                k -= 1
            while k >= 3:
                take = min(k, 6)
                tokens.append((16, take - 3))
                k -= take
            for _ in range(k):
                tokens.append((v, None))
        i += run
    return tokens


def write_huffman_code(bw: LosslessBitWriter, lengths: Sequence[int]) -> None:
    """Writes one Huffman tree description (simple or full form)."""
    nonzero = [s for s, l in enumerate(lengths) if l > 0]
    if 1 <= len(nonzero) <= 2 and all(s <= 255 for s in nonzero):
        # Simple code.
        bw.write_bits(1, 1)
        bw.write_bits(len(nonzero) - 1, 1)
        s0 = nonzero[0]
        if s0 <= 1:
            bw.write_bits(0, 1)  # 1-bit first symbol
            bw.write_bits(s0, 1)
        else:
            bw.write_bits(1, 1)
            bw.write_bits(s0, 8)
        if len(nonzero) == 2:
            bw.write_bits(nonzero[1], 8)
        return

    bw.write_bits(0, 1)
    tokens = _rle_tokens(lengths)
    # Histogram of token kinds.
    hist = [0] * CODE_LENGTH_CODES
    for sym, _ in tokens:
        hist[sym] += 1
    cl_lengths = build_code_lengths(hist, limit=7)
    cl_codes = canonical_codes(cl_lengths)
    # Number of transmitted code-length-code lengths (trim in transmission
    # order, minimum 4).
    num_codes = CODE_LENGTH_CODES
    while num_codes > 4 and cl_lengths[CODE_LENGTH_CODE_ORDER[num_codes - 1]] == 0:
        num_codes -= 1
    bw.write_bits(num_codes - 4, 4)
    for i in range(num_codes):
        bw.write_bits(cl_lengths[CODE_LENGTH_CODE_ORDER[i]], 3)
    # No max-symbol trick.
    bw.write_bits(0, 1)
    # A code-length code with one used symbol is read with 0 bits per
    # token (huffman.build_huffman_table, libwebp's decoder); libwebp's
    # encoder clears that symbol's code after transmitting its length
    # (ClearHuffmanTreeIfOnlyOneSymbol). It happens when every length is
    # 8, the decoder's initial previous length: only code 16 is emitted.
    if sum(1 for l in cl_lengths if l > 0) == 1:
        cl_lengths = [0] * CODE_LENGTH_CODES
    extra_bits = {16: 2, 17: 3, 18: 7}
    for sym, extra in tokens:
        bw.write_bits(cl_codes[sym], cl_lengths[sym])
        if sym >= 16:
            bw.write_bits(extra, extra_bits[sym])
