// Boolean (RFC 6386 §7) and VP8L bit I/O primitives.
// Native runtime for webp_tpu_torch: the serial bit loops the TPU cannot run.
#pragma once

#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <vector>

namespace webptpu {

// --- RFC 6386 boolean encoder (32-bit bottom register, carry into buffer).
struct BoolEncoder {
  std::vector<uint8_t> buf;
  uint32_t range = 255;
  uint32_t bottom = 0;
  int bit_count = 24;

  inline void carry() {
    for (ssize_t i = (ssize_t)buf.size() - 1; i >= 0; --i) {
      if (buf[i] == 0xFF) {
        buf[i] = 0;
      } else {
        buf[i]++;
        return;
      }
    }
  }

  inline void shift_once() {
    if (bottom & 0x80000000u) carry();
    bottom <<= 1;
    if (--bit_count == 0) {
      buf.push_back((bottom >> 24) & 0xFF);
      bottom &= 0xFFFFFF;
      bit_count = 8;
    }
  }

  // The RFC's bit-at-a-time renormalization done in one step, without a
  // branch on the bit: the range's leading zeros give the shifts (0 when
  // range >= 128); at most one byte completes within them, and only the
  // shift that completes it can carry out of bit 31 (bottom holds at most
  // 24 bits after a byte leaves and gains under 2^8 before each shift).
  // The same bytes as shift_once a shift at a time.
  inline void put_bit(int prob, int bit) {
    const uint32_t split = 1 + (((range - 1) * (uint32_t)prob) >> 8);
    const uint32_t mask = 0u - (uint32_t)(bit != 0);
    bottom += split & mask;
    range = ((range - split) & mask) | (split & ~mask);
    int shift = __builtin_clz(range) - 24;
    range <<= shift;
    if (shift >= bit_count) {
      const int offset = bit_count;
      if ((bottom << (offset - 1)) & 0x80000000u) carry();
      buf.push_back((uint8_t)(bottom >> (24 - offset)));
      bottom = (bottom << offset) & 0xFFFFFF;
      shift -= offset;
      bit_count = 8;
    }
    bottom <<= shift;
    bit_count -= shift;
  }

  inline void put_bits(uint32_t value, int n) {
    for (int i = n - 1; i >= 0; --i) put_bit(0x80, (value >> i) & 1);
  }

  inline void put_signed_bits(int value, int n) {
    if (value < 0) {
      put_bits((uint32_t)(-value), n);
      put_bit(0x80, 1);
    } else {
      put_bits((uint32_t)value, n);
      put_bit(0x80, 0);
    }
  }

  inline void finish() {
    for (int i = 0; i < 32; ++i) shift_once();
  }
};

// --- RFC 6386 boolean decoder.
//
// 64-bit sliding window: `value` holds the 16-bit compare window at bit
// offset `cbits` plus up to 48 preloaded bits below it. Renormalization
// only decrements `cbits` (no value shift, no per-byte injection); bytes
// are loaded five at a time when the preload runs low. Bit-exact with the
// canonical per-byte decoder: the compare window tracks the identical
// stream position, refills just batch the byte loads.
struct BoolReader {
  const uint8_t* data;
  size_t n, pos = 0;
  uint64_t value = 0;
  uint32_t range = 255;
  int cbits = 0;   // preloaded bits below the 16-bit compare window
  long vbits = 0;  // virtual (past-end) bits loaded; lowest bits of value
  bool eof = false;

  explicit BoolReader(const uint8_t* d, size_t len) : data(d), n(len) {
    for (int i = 0; i < 2; ++i)
      value = (value << 8) | (pos < n ? data[pos++] : (vbits += 8, 0));
    if (vbits > 0) eof = true;  // stream shorter than the initial window
    refill();
  }

  inline void refill() {
    // Fast path: all needed bytes in one big-endian 64-bit load (the
    // window is MSB-first, so bswap lands them in stream order).
    if (cbits <= 40 && pos + 8 <= n) {
      uint64_t w;
      std::memcpy(&w, data + pos, 8);
      w = __builtin_bswap64(w);
      const int k = (48 - cbits) >> 3;
      value = (value << (8 * k)) | (w >> (64 - 8 * k));
      pos += (size_t)k;
      cbits += 8 * k;
      return;
    }
    while (cbits <= 40) {
      value = (value << 8) | (pos < n ? data[pos++] : (vbits += 8, 0));
      cbits += 8;
    }
  }

  inline int get_bit(int prob) {
    const uint32_t split = 1 + (((range - 1) * (uint32_t)prob) >> 8);
    const uint64_t bigsplit = (uint64_t)split << (8 + cbits);
    int bit;
    if (value >= bigsplit) {
      bit = 1;
      range -= split;
      value -= bigsplit;
    } else {
      bit = 0;
      range = split;
    }
    if (range < 128) {
      // Bulk renormalization: one clz instead of up to 7 loop iterations.
      const int shift = 7 - (31 - __builtin_clz(range));
      range <<= shift;
      cbits -= shift;
      if (cbits < 7) refill();
      // Flag end-of-stream with the same threshold as a per-byte decoder
      // (which injects byte k only after 8k renorm bits, so its window's
      // last 8 bits ride on implicit zeros without flagging): the stream
      // is over when more than a byte of the window is virtual.
      if (vbits > 0 && vbits >= cbits + 8) eof = true;
    }
    return bit;
  }

  inline int get_value(int nbits) {
    int v = 0;
    for (int i = 0; i < nbits; ++i) v = (v << 1) | get_bit(0x80);
    return v;
  }

  inline int get_signed(int v) { return get_bit(0x80) ? -v : v; }
};

// --- VP8L little-endian bit I/O.
struct LBitWriter {
  std::vector<uint8_t> buf;
  uint64_t acc = 0;
  int used = 0;

  inline void write_bits(uint64_t value, int n) {
    acc |= (value & ((1ull << n) - 1)) << used;
    used += n;
    while (used >= 32) {
      for (int i = 0; i < 4; ++i) buf.push_back((acc >> (8 * i)) & 0xFF);
      acc >>= 32;
      used -= 32;
    }
  }

  inline void finish() {
    while (used > 0) {
      buf.push_back(acc & 0xFF);
      acc >>= 8;
      used -= 8;
    }
    used = 0;
  }
};

struct LBitReader {
  const uint8_t* data;
  size_t n;
  uint64_t val = 0;
  int bit_pos = 0;
  size_t pos = 0;
  bool eos = false;

  explicit LBitReader(const uint8_t* d, size_t len) : data(d), n(len) {
    uint64_t v = 0;
    for (int i = 0; i < 8; ++i) {
      uint64_t b = pos < n ? data[pos] : 0;
      if (pos < n) pos++;
      v |= b << (8 * i);
    }
    val = v;
  }

  inline void shift_bytes() {
    while (bit_pos >= 8 && pos < n) {
      val = (val >> 8) | ((uint64_t)data[pos] << 56);
      pos++;
      bit_pos -= 8;
    }
  }

  inline void fill() {
    if (bit_pos >= 32) shift_bytes();
  }

  inline uint64_t prefetch() const { return val >> bit_pos; }

  inline void consume(int nbits) {
    bit_pos += nbits;
    if ((pos * 8) - (64 - (size_t)bit_pos) > n * 8) eos = true;
  }

  inline uint32_t read_bits(int nbits) {
    if (nbits == 0) return 0;
    fill();
    if (bit_pos + nbits > 64) {
      eos = true;
      bit_pos = 64;
      return 0;
    }
    uint32_t v = (uint32_t)((val >> bit_pos) & ((1ull << nbits) - 1));
    consume(nbits);
    return v;
  }
};

}  // namespace webptpu
