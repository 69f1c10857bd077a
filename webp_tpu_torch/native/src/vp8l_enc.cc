// Native VP8L entropy-image encoder core.
//
// Implements the bit-serial half of the lossless encoder — hash-chain
// greedy LZ77 with the row-above candidate, color-cache replay and
// entropy-based cache-size search, histograms, length-limited (15)
// canonical Huffman code construction, tree serialization (simple and
// RLE-coded forms), and token emission — matching the semantics of
// webp_tpu_torch/lossless/{encode,huffman_enc}.py (reference:
// internal/lossless/{encode_backward.go,encode_huffman.go,encode.go}).
//
// The Python layer keeps the array-parallel work (transforms, palette,
// analysis) and splices the returned bit buffer into its stream.

#include <algorithm>
#include <array>
#include <cmath>
#include <cstddef>
#include <cstdint>
#include <cstring>
#include <cstdio>
#include <queue>
#include <thread>
#include <vector>

using std::size_t;

namespace {

constexpr int kNumLiteral = 256;
constexpr int kNumLength = 24;
constexpr int kNumDistance = 40;
constexpr int kCodeLengthCodes = 19;
constexpr int kMaxCodeLength = 15;
constexpr long kWindowSize = (1 << 20) - 120;
constexpr long kMaxLength = 4095;  // must fit the 12-bit packed length field
constexpr int kHashBits = 18;
constexpr long kHashSize = 1L << kHashBits;
const uint8_t kClcOrder[kCodeLengthCodes] = {17, 18, 0, 1, 2,  3,  4,  5, 16,
                                             6,  7,  8, 9, 10, 11, 12, 13, 14,
                                             15};
// (dx, dy) pairs for the 2D distance plane codes (decode.py CODE_TO_PLANE).
const int8_t kPlane[120][2] = {
    {0, 1},  {1, 0},  {1, 1},  {-1, 1}, {0, 2},  {2, 0},  {1, 2},  {-1, 2},
    {2, 1},  {-2, 1}, {2, 2},  {-2, 2}, {0, 3},  {3, 0},  {1, 3},  {-1, 3},
    {3, 1},  {-3, 1}, {2, 3},  {-2, 3}, {3, 2},  {-3, 2}, {0, 4},  {4, 0},
    {1, 4},  {-1, 4}, {4, 1},  {-4, 1}, {3, 3},  {-3, 3}, {2, 4},  {-2, 4},
    {4, 2},  {-4, 2}, {0, 5},  {3, 4},  {-3, 4}, {4, 3},  {-4, 3}, {5, 0},
    {1, 5},  {-1, 5}, {5, 1},  {-5, 1}, {2, 5},  {-2, 5}, {5, 2},  {-5, 2},
    {4, 4},  {-4, 4}, {3, 5},  {-3, 5}, {5, 3},  {-5, 3}, {0, 6},  {6, 0},
    {1, 6},  {-1, 6}, {6, 1},  {-6, 1}, {2, 6},  {-2, 6}, {6, 2},  {-6, 2},
    {4, 5},  {-4, 5}, {5, 4},  {-5, 4}, {3, 6},  {-3, 6}, {6, 3},  {-6, 3},
    {0, 7},  {7, 0},  {1, 7},  {-1, 7}, {5, 5},  {-5, 5}, {7, 1},  {-7, 1},
    {4, 6},  {-4, 6}, {6, 4},  {-6, 4}, {2, 7},  {-2, 7}, {7, 2},  {-7, 2},
    {3, 7},  {-3, 7}, {7, 3},  {-7, 3}, {5, 6},  {-5, 6}, {6, 5},  {-6, 5},
    {8, 0},  {4, 7},  {-4, 7}, {7, 4},  {-7, 4}, {8, 1},  {8, 2},  {6, 6},
    {-6, 6}, {8, 3},  {5, 7},  {-5, 7}, {7, 5},  {-7, 5}, {8, 4},  {6, 7},
    {-6, 7}, {7, 6},  {-7, 6}, {8, 5},  {7, 7},  {-7, 7}, {8, 6},  {8, 7}};

struct BitWriter {
  std::vector<uint8_t> buf;
  uint64_t acc = 0;
  int used = 0;
  void Put(uint32_t value, int n) {
    if (!n) return;
    acc |= (uint64_t)(value & ((1u << n) - 1)) << used;
    used += n;
    while (used >= 8) {
      buf.push_back((uint8_t)(acc & 0xFF));
      acc >>= 8;
      used -= 8;
    }
  }
  long BitPos() const { return (long)buf.size() * 8 + used; }
  void FinishByte() {
    if (used > 0) {
      buf.push_back((uint8_t)(acc & 0xFF));
      acc = 0;
      used = 0;
    }
  }
};

struct Token {
  uint8_t kind;  // 0 literal, 1 copy, 2 cache
  uint32_t v;    // argb / length / cache index
  uint32_t d;    // distance (copy)
};

inline void PrefixEncode(uint32_t value, int* code, int* nbits,
                         uint32_t* extra) {
  uint32_t x = value - 1;
  if (x < 4) {
    *code = (int)x;
    *nbits = 0;
    *extra = 0;
    return;
  }
  int h = 31 - __builtin_clz(x);
  int b = (x >> (h - 1)) & 1;
  *code = 2 * h + b;
  *nbits = h - 1;
  *extra = x & ((1u << (h - 1)) - 1);
}

// ---------------------------------------------------------------------------
// LZ77 (greedy hash chain + explicit row-above candidate); parity with
// encode.py backward_references.
// ---------------------------------------------------------------------------

inline long Hash2(const uint32_t* a, long i) {
  uint64_t key = ((uint64_t)a[i + 1] << 32) | a[i];
  key *= 0x9E3779B185EBCA87ULL;
  return (long)(key >> (64 - kHashBits));
}

inline long MatchLen(const uint32_t* p, const uint32_t* q, long limit) {
  long len = 0;
  while (len + 2 <= limit) {  // two pixels per 64-bit compare
    uint64_t a, b;
    std::memcpy(&a, p + len, 8);
    std::memcpy(&b, q + len, 8);
    if (a != b) return ((uint32_t)a == (uint32_t)b) ? len + 1 : len;
    len += 2;
  }
  if (len < limit && p[len] == q[len]) ++len;
  return len;
}

// Greedy scan of [start, end): hash entries are seeded (search-free) from
// [seed_start, start) so matches can reach back across the chunk boundary.
void BackwardReferencesRange(const uint32_t* a, long n, long seed_start,
                             long start, long end, int xsize, int quality,
                             std::vector<Token>* out) {
  out->clear();
  if (end <= start) return;
  out->reserve((size_t)(end - start) / 2);
  // Chain budget: deeper searches pay off most below the parallel-chunk
  // scale; large images keep the cheaper budget for throughput.
  const long span = end - start;
  // At quality >= 50 the cost-model re-parse (TraceParse) rewrites the
  // token stream from its own match table, so this greedy pass only
  // seeds the cost model and the cache-bits search — a shallow chain is
  // plenty there, and on repetitive content the deep walk dominated the
  // whole encode.
  const int max_chain = quality < 25 ? 8
                        : quality < 50 ? 32
                        : (span <= (1L << 18) ? 96 : 16);
  std::vector<int64_t> head((size_t)kHashSize, -1);
  std::vector<int64_t> prev((size_t)n, -1);
  for (long p = seed_start; p < start && p + 1 < n; ++p) {
    long h = Hash2(a, p);
    prev[(size_t)p] = head[(size_t)h];
    head[(size_t)h] = p;
  }
  long pos = start;
  const long n_cap = end;  // tokens must not spill into the next chunk

  // O(1) row-above match lengths (the naive MatchLen rescans whole
  // constant runs; see FillMatchTable).
  std::vector<int32_t> upm;
  if (xsize > 0 && n > xsize) {
    upm.assign((size_t)n, 0);
    for (long i = n - 1; i >= xsize; --i) {
      if (a[i] != a[i - xsize]) continue;
      const int32_t nxt = i + 1 < n ? upm[(size_t)i + 1] : 0;
      upm[(size_t)i] = std::min(nxt + 1, (int32_t)kMaxLength);
    }
  }

  // Match finder at `pos` (hash chain + explicit row-above candidate).
  auto find_best = [&](long p, long* bl, long* bd) {
    *bl = 0;
    *bd = 0;
    if (p + 1 >= n) return;
    long cand = head[(size_t)Hash2(a, p)];
    int chain = 0;
    const long min_pos = p > kWindowSize ? p - kWindowSize : 0;
    const long limit = std::min(n_cap - p, kMaxLength);
    while (cand >= min_pos && chain < max_chain) {
      if (*bl >= limit) break;
      if (*bl == 0 || (p + *bl < n && a[cand + *bl] == a[p + *bl])) {
        const long length = MatchLen(a + cand, a + p, limit);
        if (length > *bl) {
          *bl = length;
          *bd = p - cand;
        }
      }
      cand = prev[(size_t)cand];
      ++chain;
    }
    if (p >= xsize) {
      const long length = std::min((long)upm[(size_t)p], limit);
      // Prefer the row-above copy on length ties (encode.py:123-128).
      if (length >= 1 && (length > *bl || (length == *bl && xsize < *bd))) {
        *bl = length;
        *bd = xsize;
      }
    }
  };
  auto insert = [&](long p) {
    if (p + 1 < n) {
      const long h = Hash2(a, p);
      prev[(size_t)p] = head[(size_t)h];
      head[(size_t)h] = p;
    }
  };

  while (pos < n_cap) {
    long best_len, best_dist;
    find_best(pos, &best_len, &best_dist);
    if (best_len >= 3) {
      // Lazy matching: a strictly longer match one pixel later wins
      // (quality >= 50 only; it doubles the match searches).
      bool pos_inserted = false;
      if (quality >= 50 && span <= (1L << 18) && pos + 1 < n_cap &&
          best_len < kMaxLength) {
        insert(pos);
        pos_inserted = true;
        long l2, d2;
        find_best(pos + 1, &l2, &d2);
        if (l2 > best_len + 1) {
          out->push_back({0, a[pos], 0});
          ++pos;
          pos_inserted = false;  // the new pos was not inserted yet
          best_len = l2;
          best_dist = d2;
        }
      }
      out->push_back({1, (uint32_t)best_len, (uint32_t)best_dist});
      const long ins_end = std::min(pos + best_len, n - 1);
      for (long p = pos + (pos_inserted ? 1 : 0); p < ins_end; ++p) insert(p);
      pos += best_len;
    } else {
      out->push_back({0, a[pos], 0});
      insert(pos);
      ++pos;
    }
  }
}

// Parallel chunked LZ77 (reference P5, hashchain.go:322-388): row-aligned
// chunks scanned concurrently, each seeding its hash table from up to
// kSeedRows rows of lookback so near matches cross chunk starts.
void BackwardReferences(const uint32_t* a, long n, int xsize, int quality,
                        std::vector<Token>* out) {
  out->clear();
  if (n <= 0) return;
  const long rows = xsize > 0 ? (n + xsize - 1) / xsize : 1;
  unsigned hw = std::thread::hardware_concurrency();
  long nthreads = hw ? (hw > 8 ? 8 : hw) : 4;
  const long min_chunk = 64 * 1024;
  if (nthreads > (n + min_chunk - 1) / min_chunk)
    nthreads = (n + min_chunk - 1) / min_chunk;
  if (nthreads <= 1 || rows < 2 * nthreads) {
    BackwardReferencesRange(a, n, 0, 0, n, xsize, quality, out);
    return;
  }
  const long kSeedRows = 32;
  const long rows_per = (rows + nthreads - 1) / nthreads;
  std::vector<std::vector<Token>> parts((size_t)nthreads);
  std::vector<std::thread> threads;
  for (long t = 0; t < nthreads; ++t) {
    const long start = std::min(t * rows_per * xsize, n);
    const long end = std::min((t + 1) * rows_per * xsize, n);
    const long seed = std::max(0L, start - kSeedRows * xsize);
    threads.emplace_back([&, t, start, end, seed]() {
      BackwardReferencesRange(a, n, seed, start, end, xsize, quality,
                              &parts[(size_t)t]);
    });
  }
  size_t total = 0;
  for (auto& th : threads) th.join();
  for (const auto& p : parts) total += p.size();
  out->reserve(total);
  for (const auto& p : parts) out->insert(out->end(), p.begin(), p.end());
}

// ---------------------------------------------------------------------------
// Color cache replay (encode.py _apply_color_cache).
// ---------------------------------------------------------------------------

void ApplyColorCache(const std::vector<Token>& in, const uint32_t* a,
                     int cache_bits, std::vector<Token>* out) {
  out->clear();
  out->reserve(in.size());
  const int shift = 32 - cache_bits;
  std::vector<int64_t> cache((size_t)1 << cache_bits, -1);
  long pos = 0;
  for (const Token& t : in) {
    if (t.kind == 0) {
      uint32_t key = (uint32_t)(0x1E35A7BDu * t.v) >> shift;
      if (cache[key] == (int64_t)t.v) {
        out->push_back({2, key, 0});
      } else {
        cache[key] = t.v;
        out->push_back(t);
      }
      ++pos;
    } else {
      for (long p = pos; p < pos + (long)t.v; ++p) {
        uint32_t px = a[p];
        cache[(uint32_t)(0x1E35A7BDu * px) >> shift] = px;
      }
      pos += t.v;
      out->push_back(t);
    }
  }
}

// ---------------------------------------------------------------------------
// Histograms + entropy cost (encode.py _histogram/_histo_cost_bits).
// ---------------------------------------------------------------------------

struct Histos {
  std::vector<int64_t> h[5];  // green, red, blue, alpha, dist
  int64_t extra = 0;          // raw extra bits of length/distance codes
  void Init(int cache_bits) {
    h[0].assign(kNumLiteral + kNumLength + (cache_bits ? 1L << cache_bits : 0),
                0);
    h[1].assign(256, 0);
    h[2].assign(256, 0);
    h[3].assign(256, 0);
    h[4].assign(kNumDistance, 0);
    extra = 0;
  }
};

struct PlaneMap {
  // dist -> plane code (or dist + 120), dense for |dy| <= 8 window.
  std::vector<int32_t> map;  // index: dist (1..8*xsize+8); value or -1
  int xsize;
  void Init(int xs) {
    xsize = xs;
    map.assign((size_t)(8 * (long)xs + 10), -1);
    for (int i = 0; i < 120; ++i) {
      long d = (long)kPlane[i][1] * xs + kPlane[i][0];
      if (d >= 1 && d < (long)map.size() && map[(size_t)d] < 0)
        map[(size_t)d] = i + 1;
    }
  }
  uint32_t Code(uint32_t dist) const {
    if (dist < map.size() && map[dist] >= 0) return (uint32_t)map[dist];
    return dist + 120;
  }
};

void BuildHistogram(const std::vector<Token>& toks, const PlaneMap& pm,
                    int cache_bits, Histos* hs) {
  hs->Init(cache_bits);
  int code, nbits;
  uint32_t extra;
  for (const Token& t : toks) {
    if (t.kind == 0) {
      hs->h[0][(t.v >> 8) & 0xFF]++;
      hs->h[1][(t.v >> 16) & 0xFF]++;
      hs->h[2][t.v & 0xFF]++;
      hs->h[3][(t.v >> 24) & 0xFF]++;
    } else if (t.kind == 1) {
      PrefixEncode(t.v, &code, &nbits, &extra);
      hs->h[0][kNumLiteral + code]++;
      hs->extra += nbits;
      PrefixEncode(pm.Code(t.d), &code, &nbits, &extra);
      hs->h[4][code]++;
      hs->extra += nbits;
    } else {
      hs->h[0][kNumLiteral + kNumLength + t.v]++;
    }
  }
}

// c * log2(c) with a small-count LUT (counts in tile/cluster histograms are
// overwhelmingly small); identical values to direct evaluation.
struct SLog2LUT {
  static const int kMax = 1 << 16;
  std::vector<double> t;
  SLog2LUT() : t((size_t)kMax) {
    t[0] = 0.0;
    for (int i = 1; i < kMax; ++i) t[(size_t)i] = i * std::log2((double)i);
  }
};
inline double SLog2(int64_t c) {
  static const SLog2LUT lut;
  return c < SLog2LUT::kMax ? lut.t[(size_t)c] : c * std::log2((double)c);
}

// Per-population entropy+refine cost of (A.h[i] + B.h[i]) without
// materializing the merged histogram (B == nullptr -> just A).
double PopCombinedCost(const std::vector<int64_t>& a,
                       const std::vector<int64_t>* b) {
  int64_t n = 0, max_val = 0;
  long nnz = 0;
  double s = 0;
  const size_t sz = a.size();
  for (size_t j = 0; j < sz; ++j) {
    const int64_t c = a[j] + (b ? (*b)[j] : 0);
    if (!c) continue;
    n += c;
    if (c > max_val) max_val = c;
    ++nnz;
    s += SLog2(c);
  }
  if (!n) return 0.0;
  const double ent = SLog2(n) - s;
  double refined;
  if (nnz <= 1) {
    refined = 0;
  } else if (nnz == 2) {
    refined = 0.99 * (double)n + 0.01 * ent;
  } else {
    const double mix = nnz == 3 ? 0.95 : (nnz == 4 ? 0.7 : 0.627);
    double min_limit = 2.0 * (double)n - (double)max_val;
    min_limit = mix * min_limit + (1.0 - mix) * ent;
    refined = ent < min_limit ? min_limit : ent;
  }
  return refined + 40 + 5.0 * nnz;
}

double HistoCostBits(const Histos& hs) {
  // Shannon entropy per population, refined the way libwebp's
  // BitsEntropyRefine does (losslessi_dec cost model): skewed histograms
  // cost at least their dominant-symbol lower bound, so merging two
  // differently-skewed histograms looks as expensive as it really is
  // under integer-length Huffman codes.
  double total = 0;
  for (int i = 0; i < 5; ++i) {
    int64_t n = 0, max_val = 0;
    long nnz = 0;
    for (int64_t c : hs.h[i]) {
      n += c;
      if (c > max_val) max_val = c;
      nnz += c > 0;
    }
    if (!n) continue;
    const double log2n = std::log2((double)n);
    double ent = 0;
    for (int64_t c : hs.h[i])
      if (c > 0) ent += (double)c * (log2n - std::log2((double)c));
    double refined;
    if (nnz <= 1) {
      refined = 0;
    } else if (nnz == 2) {
      refined = 0.99 * (double)n + 0.01 * ent;
    } else {
      const double mix = nnz == 3 ? 0.95 : (nnz == 4 ? 0.7 : 0.627);
      double min_limit = 2.0 * (double)n - (double)max_val;
      min_limit = mix * min_limit + (1.0 - mix) * ent;
      refined = ent < min_limit ? min_limit : ent;
    }
    total += refined + 40 + 5.0 * nnz;
  }
  return total;
}

// Entropy cost + the raw extra bits the stream pays for length/distance
// codes. Comparisons across DIFFERENT token parses must use this (the
// entropy alone is blind to far-distance extra bits, which is how a
// cheaper parse can look more expensive).
double HistoCostBitsFull(const Histos& hs) {
  return HistoCostBits(hs) + (double)hs.extra;
}

// ---------------------------------------------------------------------------
// Huffman code construction (huffman_enc.py parity, incl. tie-breaking).
// ---------------------------------------------------------------------------

void TreeDepths(const std::vector<int64_t>& counts, std::vector<int>* depths) {
  const int n = (int)counts.size();
  depths->assign(n, 0);
  struct Node {
    int64_t count;
    int id;       // symbol index or internal seq (>= n)
    int node;     // -1 for leaf, else internal node index
  };
  auto cmp = [](const Node& a, const Node& b) {
    if (a.count != b.count) return a.count > b.count;  // min-heap
    return a.id > b.id;
  };
  std::priority_queue<Node, std::vector<Node>, decltype(cmp)> heap(cmp);
  int live = 0;
  int last_sym = 0;
  for (int s = 0; s < n; ++s)
    if (counts[s] > 0) {
      heap.push({counts[s], s, -1});
      ++live;
      last_sym = s;
    }
  if (!live) return;
  if (live == 1) {
    (*depths)[last_sym] = 1;
    return;
  }
  // children[k] = two (id, node) pairs.
  std::vector<std::array<int, 4>> kids;
  int seq = n;
  while (heap.size() > 1) {
    Node a = heap.top();
    heap.pop();
    Node b = heap.top();
    heap.pop();
    kids.push_back({a.id, a.node, b.id, b.node});
    heap.push({a.count + b.count, seq, (int)kids.size() - 1});
    ++seq;
  }
  Node root = heap.top();
  // Iterative walk.
  struct Item {
    int id, node, depth;
  };
  std::vector<Item> stack;
  stack.push_back({root.id, root.node, 0});
  while (!stack.empty()) {
    Item it = stack.back();
    stack.pop_back();
    if (it.node < 0) {
      (*depths)[it.id] = std::max(1, it.depth);
    } else {
      const auto& k = kids[(size_t)it.node];
      stack.push_back({k[0], k[1], it.depth + 1});
      stack.push_back({k[2], k[3], it.depth + 1});
    }
  }
}

void BuildCodeLengths(const std::vector<int64_t>& counts, int limit,
                      std::vector<int>* depths) {
  int64_t count_min = 1;
  for (;;) {
    std::vector<int64_t> adj(counts.size());
    for (size_t i = 0; i < counts.size(); ++i)
      adj[i] = counts[i] == 0 ? 0 : std::max(counts[i], count_min);
    TreeDepths(adj, depths);
    int mx = 0;
    for (int d : *depths) mx = std::max(mx, d);
    if (mx <= limit) return;
    count_min *= 2;
  }
}

void CanonicalCodes(const std::vector<int>& lengths,
                    std::vector<uint32_t>* codes) {
  int max_len = 0;
  for (int l : lengths) max_len = std::max(max_len, l);
  codes->assign(lengths.size(), 0);
  if (!max_len) return;
  std::vector<int> counts((size_t)max_len + 1, 0);
  for (int l : lengths) counts[(size_t)l]++;
  counts[0] = 0;
  std::vector<uint32_t> next((size_t)max_len + 1, 0);
  uint32_t code = 0;
  for (int l = 1; l <= max_len; ++l) {
    code = (code + (uint32_t)counts[(size_t)l - 1]) << 1;
    next[(size_t)l] = code;
  }
  for (size_t s = 0; s < lengths.size(); ++s) {
    int l = lengths[s];
    if (!l) continue;
    uint32_t c = next[(size_t)l]++;
    uint32_t rc = 0;
    for (int i = 0; i < l; ++i) {
      rc = (rc << 1) | (c & 1);
      c >>= 1;
    }
    (*codes)[s] = rc;
  }
}

struct HuffCode {
  std::vector<int> desc;       // described lengths
  std::vector<int> lengths;    // emission lengths (0s if 1-symbol tree)
  std::vector<uint32_t> codes;
  void FromCounts(std::vector<int64_t> counts) {
    bool any = false;
    for (int64_t c : counts) any |= (c != 0);
    if (!any) counts[0] = 1;
    BuildCodeLengths(counts, kMaxCodeLength, &desc);
    lengths = desc;
    int nnz = 0;
    for (int l : desc) nnz += (l > 0);
    if (nnz == 1) std::fill(lengths.begin(), lengths.end(), 0);
    CanonicalCodes(lengths, &codes);
  }
  inline void Write(BitWriter* bw, int sym) const {
    bw->Put(codes[(size_t)sym], lengths[(size_t)sym]);
  }
};

// Tree serialization (huffman_enc.py write_huffman_code + _rle_tokens).
void WriteHuffmanCode(BitWriter* bw, const std::vector<int>& lengths) {
  std::vector<int> nonzero;
  for (size_t s = 0; s < lengths.size(); ++s)
    if (lengths[s] > 0) nonzero.push_back((int)s);
  if (nonzero.size() >= 1 && nonzero.size() <= 2 &&
      nonzero.back() <= 255) {
    bw->Put(1, 1);
    bw->Put((uint32_t)nonzero.size() - 1, 1);
    if (nonzero[0] <= 1) {
      bw->Put(0, 1);
      bw->Put((uint32_t)nonzero[0], 1);
    } else {
      bw->Put(1, 1);
      bw->Put((uint32_t)nonzero[0], 8);
    }
    if (nonzero.size() == 2) bw->Put((uint32_t)nonzero[1], 8);
    return;
  }
  bw->Put(0, 1);
  // RLE tokens.
  struct Tok {
    int sym;
    int extra;  // -1 = none
  };
  std::vector<Tok> toks;
  const int n = (int)lengths.size();
  int prev = 8, i = 0;
  while (i < n) {
    const int v = lengths[(size_t)i];
    int run = 1;
    while (i + run < n && lengths[(size_t)(i + run)] == v) ++run;
    if (v == 0) {
      int k = run;
      while (k >= 3) {
        if (k >= 11) {
          int take = std::min(k, 138);
          toks.push_back({18, take - 11});
          k -= take;
        } else {
          int take = std::min(k, 10);
          toks.push_back({17, take - 3});
          k -= take;
        }
      }
      for (; k > 0; --k) toks.push_back({0, -1});
    } else {
      int k = run;
      if (v != prev) {
        toks.push_back({v, -1});
        prev = v;
        --k;
      }
      while (k >= 3) {
        int take = std::min(k, 6);
        toks.push_back({16, take - 3});
        k -= take;
      }
      for (; k > 0; --k) toks.push_back({v, -1});
    }
    i += run;
  }
  std::vector<int64_t> hist(kCodeLengthCodes, 0);
  for (const Tok& t : toks) hist[(size_t)t.sym]++;
  std::vector<int> cl_len;
  BuildCodeLengths(hist, 7, &cl_len);
  std::vector<uint32_t> cl_codes;
  CanonicalCodes(cl_len, &cl_codes);
  int num_codes = kCodeLengthCodes;
  while (num_codes > 4 && cl_len[kClcOrder[num_codes - 1]] == 0) --num_codes;
  bw->Put((uint32_t)(num_codes - 4), 4);
  for (int j = 0; j < num_codes; ++j)
    bw->Put((uint32_t)cl_len[kClcOrder[j]], 3);
  bw->Put(0, 1);  // no max-symbol trick
  // A code-length code with one used symbol is read with 0 bits per token
  // (every decoder does; libwebp's encoder clears the lone symbol's code
  // after transmitting its length, ClearHuffmanTreeIfOnlyOneSymbol). It
  // happens when every length is 8, the decoder's initial previous length,
  // so that only code 16 is emitted.
  int cl_used = 0;
  for (int l : cl_len) cl_used += l > 0;
  if (cl_used == 1) std::fill(cl_len.begin(), cl_len.end(), 0);
  for (const Tok& t : toks) {
    bw->Put(cl_codes[(size_t)t.sym], cl_len[(size_t)t.sym]);
    if (t.sym == 16) bw->Put((uint32_t)t.extra, 2);
    else if (t.sym == 17) bw->Put((uint32_t)t.extra, 3);
    else if (t.sym == 18) bw->Put((uint32_t)t.extra, 7);
  }
}

void EmitTokens(BitWriter* bw, const std::vector<Token>& toks,
                const HuffCode codes[5], const PlaneMap& pm) {
  int code, nbits;
  uint32_t extra;
  for (const Token& t : toks) {
    if (t.kind == 0) {
      codes[0].Write(bw, (int)((t.v >> 8) & 0xFF));
      codes[1].Write(bw, (int)((t.v >> 16) & 0xFF));
      codes[2].Write(bw, (int)(t.v & 0xFF));
      codes[3].Write(bw, (int)((t.v >> 24) & 0xFF));
    } else if (t.kind == 1) {
      PrefixEncode(t.v, &code, &nbits, &extra);
      codes[0].Write(bw, kNumLiteral + code);
      if (nbits) bw->Put(extra, nbits);
      PrefixEncode(pm.Code(t.d), &code, &nbits, &extra);
      codes[4].Write(bw, code);
      if (nbits) bw->Put(extra, nbits);
    } else {
      codes[0].Write(bw, kNumLiteral + kNumLength + (int)t.v);
    }
  }
}


// ---------------------------------------------------------------------------
// Meta-Huffman clustering (encoder): per-tile histograms -> greedy streaming
// clusters -> remap -> entropy image + per-group trees (the reference's
// GetHistoImageSymbols role, encode_histogram.go:1400, simplified: streaming
// assignment + one remap pass instead of stochastic merging).
// ---------------------------------------------------------------------------

double TreeCostEstimate(const Histos& hs) {
  double c = 0;
  for (int i = 0; i < 5; ++i) {
    long nnz = 0;
    for (int64_t v : hs.h[i]) nnz += (v > 0);
    c += 40.0 + 5.0 * nnz;
  }
  return c;
}

struct SparseTile {
  // (histo index << 16 | entry, count) pairs + per-histo totals.
  std::vector<std::pair<uint32_t, int32_t>> entries;
  int64_t totals[5] = {0, 0, 0, 0, 0};
  void From(const Histos& t) {
    for (int i = 0; i < 5; ++i)
      for (size_t j = 0; j < t.h[i].size(); ++j)
        if (t.h[i][j]) {
          entries.push_back({((uint32_t)i << 16) | (uint32_t)j,
                             (int32_t)t.h[i][j]});
          totals[i] += t.h[i][j];
        }
  }
};

double AddCostDelta(const Histos& c, const int64_t c_totals[5],
                    const SparseTile& t) {
  // HistoCostBits(c + t) - HistoCostBits(c) over the tile's nonzeros only.
  double d = 0;
  for (const auto& e : t.entries) {
    const int64_t a = c.h[e.first >> 16][e.first & 0xFFFF];
    const int64_t b = e.second;
    d -= (a + b) * std::log2((double)(a + b));
    if (a) d += a * std::log2((double)a);
  }
  for (int i = 0; i < 5; ++i) {
    const int64_t tc = c_totals[i], tt = t.totals[i];
    if (!tt) continue;
    d += (tc + tt) * std::log2((double)(tc + tt));
    if (tc) d -= tc * std::log2((double)tc);
  }
  return d;
}

void AddHistos(Histos* a, const Histos& b) {
  for (int i = 0; i < 5; ++i)
    for (size_t j = 0; j < a->h[i].size(); ++j) a->h[i][j] += b.h[i][j];
  a->extra += b.extra;
}

void AddToken(Histos* hs, const Token& t, const PlaneMap& pm) {
  int code, nbits;
  uint32_t extra;
  if (t.kind == 0) {
    hs->h[0][(t.v >> 8) & 0xFF]++;
    hs->h[1][(t.v >> 16) & 0xFF]++;
    hs->h[2][t.v & 0xFF]++;
    hs->h[3][(t.v >> 24) & 0xFF]++;
  } else if (t.kind == 1) {
    PrefixEncode(t.v, &code, &nbits, &extra);
    hs->h[0][kNumLiteral + code]++;
    hs->extra += nbits;
    PrefixEncode(pm.Code(t.d), &code, &nbits, &extra);
    hs->h[4][code]++;
    hs->extra += nbits;
  } else {
    hs->h[0][kNumLiteral + kNumLength + t.v]++;
  }
}

struct MetaPlan {
  int hb = 0;
  long tx = 0, ty = 0;
  std::vector<uint16_t> tile_group;   // [tx*ty]
  int num_groups = 0;
  double cost = 0;                    // token+tree bits estimate
};

bool BuildMetaPlanMerge(const std::vector<Token>& toks,
                        const PlaneMap& pm, long n, int xsize,
                        int cache_bits, MetaPlan* plan,
                        std::vector<std::vector<uint16_t>>* snapshots) {
  const long ysize = n / xsize;
  int hb = 3;
  while (hb < 9 &&
         (((xsize + (1L << hb) - 1) >> hb) *
          ((ysize + (1L << hb) - 1) >> hb)) > 2048)
    ++hb;
  const long tx = (xsize + (1L << hb) - 1) >> hb;
  const long ty = (ysize + (1L << hb) - 1) >> hb;
  const long T = tx * ty;
  if (T < 4) return false;

  std::vector<Histos> th((size_t)T);
  for (auto& h : th) h.Init(cache_bits);
  long pos = 0;
  for (const Token& t : toks) {
    const long y = pos / xsize, x = pos % xsize;
    AddToken(&th[(size_t)((y >> hb) * tx + (x >> hb))], t, pm);
    pos += (t.kind == 1) ? (long)t.v : 1;
  }

  // 1) Entropy-bin seed (reference histogramCombineEntropyBin): tiles
  // bucketed by (bits/symbol, literal fraction) merge within their bin,
  // collapsing up to 2048 tiles into <= 64 starter clusters without any
  // pairwise work.
  std::vector<int> bin_of((size_t)T);
  std::vector<int> bin_cluster(128, -1);
  std::vector<Histos> cl;
  std::vector<uint16_t> assign((size_t)T, 0);
  for (long t = 0; t < T; ++t) {
    const Histos& h = th[(size_t)t];
    int64_t tot = 0, lit = 0, cop = 0;
    for (size_t j = 0; j < h.h[0].size(); ++j) {
      tot += h.h[0][j];
      if (j < (size_t)kNumLiteral) lit += h.h[0][j];
      else if (j < (size_t)(kNumLiteral + kNumLength)) cop += h.h[0][j];
    }
    const double n0 = tot > 0 ? (double)tot : 1.0;
    const double cps = HistoCostBits(h) / n0;           // bits per symbol
    const int q1 = std::min(7, (int)(cps * 0.5));
    const int q2 = std::min(3, (int)((double)lit / n0 * 4.0));
    const int q3 = std::min(3, (int)((double)cop / n0 * 8.0));
    bin_of[(size_t)t] = (q1 * 4 + q2) * 4 + q3;
  }
  // Cap members per seed cluster: homogeneous images (photos) land every
  // tile in one or two entropy bins, which used to collapse the whole
  // image before pairwise merging could see any structure. Splitting a
  // full bin into a fresh cluster keeps ~64 raster-local starters for
  // the greedy merge + remap to refine.
  // Large images keep the cheap full-bin collapse (their pairwise merge
  // cost would be quadratic in starters and kmeans covers the fine
  // structure); small ones afford the 64-starter search.
  const long kSeedCap =
      n <= (1L << 16) ? std::max<long>(1, (T + 63) / 64) : (long)T;
  std::vector<long> cl_members;
  for (long t = 0; t < T; ++t) {
    int& c = bin_cluster[(size_t)bin_of[(size_t)t]];
    if (c < 0 || cl_members[(size_t)c] >= kSeedCap) {
      c = (int)cl.size();
      cl.emplace_back();
      cl.back().Init(cache_bits);
      cl_members.push_back(0);
    }
    AddHistos(&cl[(size_t)c], th[(size_t)t]);
    cl_members[(size_t)c]++;
    assign[(size_t)t] = (uint16_t)c;
  }

  int K = (int)cl.size();
  std::vector<char> alive((size_t)K, 1);

  std::vector<double> ccost((size_t)K);
  for (int k = 0; k < K; ++k)
    ccost[(size_t)k] = HistoCostBits(cl[(size_t)k]) +
                       TreeCostEstimate(cl[(size_t)k]);
  // Merged-pair cost without materializing the merged histogram, with
  // early bail once the partial sum already exceeds `cap`.
  auto pair_cost = [&](int a, int b, double cap) {
    double total = 0;
    for (int i = 0; i < 5; ++i) {
      // HistoCostBits + TreeCostEstimate both charge 40 + 5*nnz, so the
      // merged fixed term appears twice.
      const double pc = PopCombinedCost(cl[(size_t)a].h[i],
                                        &cl[(size_t)b].h[i]);
      total += pc;
      if (total >= cap) return total;
    }
    // Second copy of the per-population fixed tree term.
    for (int i = 0; i < 5; ++i) {
      long nnz = 0;
      const auto& ha = cl[(size_t)a].h[i];
      const auto& hb = cl[(size_t)b].h[i];
      for (size_t j = 0; j < ha.size(); ++j) nnz += (ha[j] | hb[j]) > 0;
      total += 40.0 + 5.0 * nnz;
      if (total >= cap) return total;
    }
    return total;
  };
  std::vector<int> parent((size_t)K);
  for (int k = 0; k < K; ++k) parent[(size_t)k] = k;
  int n_alive = K;
  auto root = [&](int k) {
    while (parent[(size_t)k] != k) k = parent[(size_t)k];
    return k;
  };
  // Snapshots at fixed group counts: the bit-cost estimate cannot always
  // see when a split pays off under real integer-length codes (libwebp
  // finds profitable 2-group plans the entropy model scores as losses),
  // so the caller emits each snapshot and compares actual sizes.
  auto snap_now = [&](std::vector<std::vector<uint16_t>>* snaps) {
    std::vector<uint16_t> a2((size_t)T);
    for (long t = 0; t < T; ++t)
      a2[(size_t)t] = (uint16_t)root(assign[(size_t)t]);
    snaps->push_back(std::move(a2));
  };
  std::vector<std::vector<uint16_t>> snaps;
  const bool want_snaps = snapshots != nullptr;
  for (;;) {
    double best = -1e-9;
    int ba = -1, bb = -1;
    for (int a = 0; a < K; ++a) {
      if (!alive[(size_t)a]) continue;
      for (int b = a + 1; b < K; ++b) {
        if (!alive[(size_t)b]) continue;
        const double cap = ccost[(size_t)a] + ccost[(size_t)b] + best;
        const double d =
            pair_cost(a, b, cap) - ccost[(size_t)a] - ccost[(size_t)b];
        if (d < best) {
          best = d;
          ba = a;
          bb = b;
        }
      }
    }
    if (ba < 0 && !(want_snaps && n_alive > 2)) break;
    if (ba < 0) {
      // Estimate says stop, but keep merging toward the snapshot counts
      // with the least-bad pair so small group counts get considered.
      double least = 1e99;
      for (int a = 0; a < K; ++a) {
        if (!alive[(size_t)a]) continue;
        for (int b = a + 1; b < K; ++b) {
          if (!alive[(size_t)b]) continue;
          const double cap = ccost[(size_t)a] + ccost[(size_t)b] + least;
          const double d =
              pair_cost(a, b, cap) - ccost[(size_t)a] - ccost[(size_t)b];
          if (d < least) {
            least = d;
            ba = a;
            bb = b;
          }
        }
      }
      if (ba < 0) break;
      if (snaps.empty()) snap_now(&snaps);  // the natural stopping point
    }
    AddHistos(&cl[(size_t)ba], cl[(size_t)bb]);
    ccost[(size_t)ba] = HistoCostBits(cl[(size_t)ba]) +
                        TreeCostEstimate(cl[(size_t)ba]);
    alive[(size_t)bb] = 0;
    parent[(size_t)bb] = ba;
    --n_alive;
    if (want_snaps && (n_alive == 8 || n_alive == 4 || n_alive == 2))
      snap_now(&snaps);
  }
  if (want_snaps) {
    if (snaps.empty()) snap_now(&snaps);
    *snapshots = snaps;
  }
  for (long t = 0; t < T; ++t)
    assign[(size_t)t] = (uint16_t)root(assign[(size_t)t]);

  // 3) Remap each tile to the cluster whose CODES encode it cheapest
  // (reference histogramRemap) — per-symbol code lengths, not marginal
  // add-cost, so large clusters get no unfair advantage.
  std::vector<SparseTile> sp((size_t)T);
  for (long t = 0; t < T; ++t) sp[(size_t)t].From(th[(size_t)t]);
  std::vector<int> live;
  for (int k = 0; k < K; ++k)
    if (alive[(size_t)k]) live.push_back(k);
  if (live.size() > 1) {
    std::vector<std::array<double, 5>> logtot(cl.size());
    for (int k : live) {
      int64_t tot[5] = {0, 0, 0, 0, 0};
      for (int i = 0; i < 5; ++i)
        for (int64_t v : cl[(size_t)k].h[i]) tot[i] += v;
      for (int i = 0; i < 5; ++i)
        logtot[(size_t)k][i] = std::log2((double)std::max<int64_t>(tot[i], 1));
    }
    std::vector<uint16_t> next = assign;
    for (long t = 0; t < T; ++t) {
      double bc = 1e99;
      int bk = assign[(size_t)t];
      for (int k : live) {
        double c = 0;
        for (const auto& e : sp[(size_t)t].entries) {
          const int i = (int)(e.first >> 16);
          const int64_t cnt = cl[(size_t)k].h[i][e.first & 0xFFFF];
          const double len =
              cnt > 0 ? logtot[(size_t)k][i] - std::log2((double)cnt)
                      : logtot[(size_t)k][i] + 2.0;  // unseen symbol
          c += (double)e.second * len;
          if (c >= bc) break;
        }
        if (c < bc) {
          bc = c;
          bk = k;
        }
      }
      next[(size_t)t] = (uint16_t)bk;
    }
    assign.swap(next);
    // Rebuild clusters from the final assignment.
    for (int k : live) cl[(size_t)k].Init(cache_bits);
    for (long t = 0; t < T; ++t)
      AddHistos(&cl[(size_t)assign[(size_t)t]], th[(size_t)t]);
  }
  // Compact away empty clusters.
  {
    std::vector<int> remap2(cl.size(), -1);
    std::vector<Histos> used;
    for (long t = 0; t < T; ++t) {
      const int c = assign[(size_t)t];
      if (remap2[(size_t)c] < 0) {
        remap2[(size_t)c] = (int)used.size();
        used.push_back(cl[(size_t)c]);
      }
      assign[(size_t)t] = (uint16_t)remap2[(size_t)c];
    }
    cl.swap(used);
  }

  double total = 0;
  for (const auto& c : cl) total += HistoCostBits(c) + TreeCostEstimate(c);
  // Entropy-image side channel: ~log2(K) bits per tile + its trees.
  total += T * (cl.size() > 1 ? std::log2((double)cl.size()) : 0.0) + 200.0;

  plan->hb = hb;
  plan->tx = tx;
  plan->ty = ty;
  plan->tile_group.swap(assign);
  plan->num_groups = (int)cl.size();
  plan->cost = total;
  return plan->num_groups > 1;
}

// Previous-generation clusterer kept as a second candidate: k-means on
// per-tile features + marginal-add-cost remap. On some images it finds
// finer group structure than the merge-based clusterer (and vice versa);
// EncodeStream emits both plans and keeps the smaller stream.
bool BuildMetaPlanKMeans(const std::vector<Token>& toks,
                         const PlaneMap& pm,
                   long n, int xsize, int cache_bits, MetaPlan* plan) {
  const long ysize = n / xsize;
  int hb = 3;
  while (hb < 9 &&
         (((xsize + (1L << hb) - 1) >> hb) *
          ((ysize + (1L << hb) - 1) >> hb)) > 2048)
    ++hb;
  const long tx = (xsize + (1L << hb) - 1) >> hb;
  const long ty = (ysize + (1L << hb) - 1) >> hb;
  const long T = tx * ty;
  if (T < 4) return false;

  std::vector<Histos> th((size_t)T);
  for (auto& h : th) h.Init(cache_bits);
  long pos = 0;
  for (const Token& t : toks) {
    const long y = pos / xsize, x = pos % xsize;
    AddToken(&th[(size_t)((y >> hb) * tx + (x >> hb))], t, pm);
    pos += (t.kind == 1) ? (long)t.v : 1;
  }

  // Seed clusters by k-means on cheap per-tile features (entropy + token
  // mix), then cost-based remapping below does the real work. This avoids
  // the degenerate all-in-one outcome of threshold-based streaming.
  const int kMaxGroups = 24;
  std::vector<std::array<double, 3>> feat((size_t)T);
  for (long t = 0; t < T; ++t) {
    const Histos& h = th[(size_t)t];
    int64_t lit = 0, cop = 0, tot = 0;
    for (size_t j = 0; j < h.h[0].size(); ++j) {
      tot += h.h[0][j];
      if (j < (size_t)kNumLiteral) lit += h.h[0][j];
      else if (j < (size_t)(kNumLiteral + kNumLength)) cop += h.h[0][j];
    }
    const double n0 = tot > 0 ? (double)tot : 1.0;
    feat[(size_t)t] = {HistoCostBits(h) / n0, (double)lit / n0,
                       (double)cop / n0};
  }
  int K = (int)std::min<long>(kMaxGroups, std::max<long>(2, T / 8));
  std::vector<std::array<double, 3>> cent((size_t)K);
  for (int k = 0; k < K; ++k) cent[(size_t)k] = feat[(size_t)(T * k / K)];
  std::vector<uint16_t> assign((size_t)T, 0);
  for (int it = 0; it < 4; ++it) {
    for (long t = 0; t < T; ++t) {
      double bd = 1e99;
      int bk = 0;
      for (int k = 0; k < K; ++k) {
        double d = 0;
        for (int f = 0; f < 3; ++f) {
          const double df = feat[(size_t)t][f] - cent[(size_t)k][f];
          d += df * df * (f == 0 ? 0.02 : 100.0);  // scale features
        }
        if (d < bd) { bd = d; bk = k; }
      }
      assign[(size_t)t] = (uint16_t)bk;
    }
    std::vector<std::array<double, 3>> acc((size_t)K, {0, 0, 0});
    std::vector<long> cnt((size_t)K, 0);
    for (long t = 0; t < T; ++t) {
      for (int f = 0; f < 3; ++f)
        acc[assign[(size_t)t]][f] += feat[(size_t)t][f];
      cnt[assign[(size_t)t]]++;
    }
    for (int k = 0; k < K; ++k)
      if (cnt[(size_t)k])
        for (int f = 0; f < 3; ++f)
          cent[(size_t)k][f] = acc[(size_t)k][f] / cnt[(size_t)k];
  }
  std::vector<Histos> cl((size_t)K);
  for (auto& h : cl) h.Init(cache_bits);
  for (long t = 0; t < T; ++t)
    AddHistos(&cl[assign[(size_t)t]], th[(size_t)t]);
  std::vector<double> cl_cost((size_t)K);
  for (int k = 0; k < K; ++k) cl_cost[(size_t)k] = HistoCostBits(cl[(size_t)k]);

  // Remap passes: reassign each tile to the argmin-add-cost cluster.
  std::vector<SparseTile> sp((size_t)T);
  for (long t = 0; t < T; ++t) sp[(size_t)t].From(th[(size_t)t]);
  for (int rp = 0; rp < 2 && cl.size() > 1; ++rp) {
    std::vector<std::array<int64_t, 5>> ctot(cl.size(), {0, 0, 0, 0, 0});
    for (size_t c = 0; c < cl.size(); ++c)
      for (int i = 0; i < 5; ++i)
        for (int64_t v : cl[c].h[i]) ctot[c][i] += v;
    std::vector<uint16_t> next = assign;
    for (long t = 0; t < T; ++t) {
      int best = assign[(size_t)t];
      double best_inc = 1e99;
      for (size_t c = 0; c < cl.size(); ++c) {
        const double inc =
            AddCostDelta(cl[c], ctot[c].data(), sp[(size_t)t]);
        if (inc < best_inc) {
          best_inc = inc;
          best = (int)c;
        }
      }
      next[(size_t)t] = (uint16_t)best;
    }
    // Rebuild clusters from the remap.
    std::vector<Histos> re(cl.size());
    for (auto& h : re) h.Init(cache_bits);
    for (long t = 0; t < T; ++t)
      AddHistos(&re[(size_t)next[(size_t)t]], th[(size_t)t]);
    cl.swap(re);
    assign.swap(next);
    for (size_t c = 0; c < cl.size(); ++c) cl_cost[c] = HistoCostBits(cl[c]);
  }
  // Compact away empty clusters.
  {
    std::vector<int> remap2(cl.size(), -1);
    std::vector<Histos> used;
    for (long t = 0; t < T; ++t) {
      const int c = assign[(size_t)t];
      if (remap2[(size_t)c] < 0) {
        remap2[(size_t)c] = (int)used.size();
        used.push_back(cl[(size_t)c]);
      }
      assign[(size_t)t] = (uint16_t)remap2[(size_t)c];
    }
    cl.swap(used);
  }

  double total = 0;
  for (const auto& c : cl) total += HistoCostBits(c) + TreeCostEstimate(c);
  // Entropy-image side channel: ~log2(K) bits per tile + its trees.
  total += T * (cl.size() > 1 ? std::log2((double)cl.size()) : 0.0) + 200.0;

  plan->hb = hb;
  plan->tx = tx;
  plan->ty = ty;
  plan->tile_group.swap(assign);
  plan->num_groups = (int)cl.size();
  plan->cost = total;
  return plan->num_groups > 1;
}

void EmitTokensMeta(BitWriter* bw, const std::vector<Token>& toks,
                    const std::vector<std::array<HuffCode, 5>>& codes,
                    const PlaneMap& pm, long xsize, const MetaPlan& mp) {
  int code, nbits;
  uint32_t extra;
  long pos = 0;
  for (const Token& t : toks) {
    const long y = pos / xsize, x = pos % xsize;
    const auto& g =
        codes[mp.tile_group[(size_t)((y >> mp.hb) * mp.tx + (x >> mp.hb))]];
    if (t.kind == 0) {
      g[0].Write(bw, (int)((t.v >> 8) & 0xFF));
      g[1].Write(bw, (int)((t.v >> 16) & 0xFF));
      g[2].Write(bw, (int)(t.v & 0xFF));
      g[3].Write(bw, (int)((t.v >> 24) & 0xFF));
      ++pos;
    } else if (t.kind == 1) {
      PrefixEncode(t.v, &code, &nbits, &extra);
      g[0].Write(bw, kNumLiteral + code);
      if (nbits) bw->Put(extra, nbits);
      PrefixEncode(pm.Code(t.d), &code, &nbits, &extra);
      g[4].Write(bw, code);
      if (nbits) bw->Put(extra, nbits);
      pos += t.v;
    } else {
      g[0].Write(bw, kNumLiteral + kNumLength + (int)t.v);
      ++pos;
    }
  }
}

// ---------------------------------------------------------------------------
// Cost-model optimal parse ("trace" pass).
//
// Semantics follow reference internal/lossless/encode_backward.go:847-1540
// and hashchain.go:389-455 (libwebp's backward_references_cost_enc.c): build
// a per-pixel best-match table, estimate per-symbol bit costs from a seed
// token stream, run a forward shortest-path DP over (literal | cache | copy)
// steps, then trace the cheapest path back into tokens. Our DP serializes
// candidate intervals directly into the cost array (the piecewise-constant
// length-cost runs plus the constant-offset reach extension keep that near
// linear) instead of the reference's interval linked list.
// ---------------------------------------------------------------------------

// Per-pixel best match, packed (offset << 12) | length. Iteration budget and
// window scale with quality (hashchain.go:59-66,110-134).
void FillMatchTable(const uint32_t* a, long n, int xsize, int quality,
                    std::vector<uint32_t>* out) {
  out->assign((size_t)n, 0);
  if (n < 2) return;
  // The chain budget follows the reference (hashchain.go:59-66), except
  // megapixel-class images at quality <= 75 take a shallow chain: the
  // cost-model re-parse rewrites the tokens from this same table anyway,
  // and the row-above/run percolation heuristics already seed near-best
  // matches (measured on the 1.57 Mpx benchmark photo: iter 33 -> 8 is
  // +17% whole-encode speed at -0.01% size; sub-megapixel images keep
  // the deep walk — the 0.44 Mpx graphics fixture pays +0.8% at iter 8).
  int iter_def = quality > 75 ? 8 + quality * quality / 128
                              : 8 + quality / 3;
  if (quality <= 75 && n > (1L << 20) && iter_def > 8) iter_def = 8;
  const int iter_max = iter_def;
  long win = quality > 75   ? kWindowSize
             : quality > 50 ? (long)xsize << 8
             : quality > 25 ? (long)xsize << 6
                            : (long)xsize << 4;
  if (win > kWindowSize) win = kWindowSize;

  // Forward pass: singly-linked same-hash chains.
  std::vector<int32_t> head((size_t)kHashSize, -1);
  std::vector<int32_t> chain((size_t)n, -1);
  for (long i = 0; i + 1 < n; ++i) {
    const long h = Hash2(a, i);
    chain[(size_t)i] = head[(size_t)h];
    head[(size_t)h] = (int32_t)i;
  }

  // O(1) lookups for the two spatial heuristics (their naive MatchLen
  // rescans whole constant runs, O(run^2) in total on smooth images):
  // eqrun[j] = run of a[j]==a[j+1]; upm[i] = match length vs the row above.
  std::vector<int32_t> eqrun((size_t)n, 0);
  for (long j = n - 2; j >= 0; --j)
    eqrun[(size_t)j] =
        a[j] == a[j + 1]
            ? std::min(eqrun[(size_t)j + 1] + 1, (int32_t)kMaxLength)
            : 0;
  std::vector<int32_t> upm;
  if (xsize > 0 && n > xsize) {
    upm.assign((size_t)n, 0);
    for (long i = n - 1; i >= xsize; --i) {
      if (a[i] != a[i - xsize]) continue;
      const int32_t nxt = i + 1 < n ? upm[(size_t)i + 1] : 0;
      upm[(size_t)i] = std::min(nxt + 1, (int32_t)kMaxLength);
    }
  }

  // Reverse fill: budgeted chain walk with the row-above / previous-pixel
  // spatial heuristics tried first.
  for (long i = n - 2; i >= 1; --i) {
    // Last pixel stays length-0 (a match never covers argb[n-1] so the
    // bestArgb probe below stays in bounds; reference hashchain.go:391).
    const long max_len = std::min(kMaxLength, n - 1 - i);
    if (max_len < 1) continue;
    const long min_pos = i > win ? i - win : 0;
    long best_len = 0, best_dist = 0;
    int iter = iter_max;
    // Percolate the next position's match backward: a (dist, len) match at
    // i+1 extends to (dist, len+1) at i whenever a[i] == a[i-dist]
    // (reference hashchain.go's reverse-fill shortcut). Seeding best_len
    // high makes the chain walk below skip almost everything via the
    // probe check.
    if (i + 1 < n) {
      const uint32_t nx = (*out)[(size_t)(i + 1)];
      if (nx) {
        const long d = nx >> 12;
        if (i >= d && a[i] == a[i - d]) {
          best_len = std::min((long)(nx & 0xFFF) + 1, max_len);
          best_dist = d;
        }
      }
    }
    if (i >= xsize) {
      const long l = std::min((long)upm[(size_t)i], max_len);
      if (l > best_len || (l == best_len && xsize < best_dist)) {
        best_len = l;
        best_dist = xsize;
      }
      --iter;
    }
    if (best_len < max_len) {
      const long l = std::min((long)eqrun[(size_t)(i - 1)], max_len);
      if (l > best_len) {
        best_len = l;
        best_dist = 1;
      }
      --iter;
    }
    const long len_stop = std::min(max_len, (long)256);
    if (best_len < len_stop) {
      uint32_t probe = a[i + best_len];
      for (long pos = chain[(size_t)i]; pos >= min_pos && iter > 0;
           pos = chain[(size_t)pos]) {
        --iter;
        if (a[pos + best_len] != probe) continue;
        const long l = MatchLen(a + pos, a + i, max_len);
        if (l > best_len) {
          best_len = l;
          best_dist = i - pos;
          if (best_len >= len_stop || best_len >= max_len) break;
          probe = a[i + best_len];
        }
      }
    }
    if (best_len >= 2)
      (*out)[(size_t)i] = ((uint32_t)best_dist << 12) | (uint32_t)best_len;
  }
}

// LZ77-Box (reference encode_backward.go:193-373): matches restricted to
// the window of the 32 smallest plane-code offsets, so every copy gets a
// cheap distance code. Run-length counts make the per-offset match-length
// computation O(runs) instead of O(pixels).
void FillBoxMatchTable(const uint32_t* a, long n, int xsize,
                       const PlaneMap& pm,
                       const std::vector<uint32_t>& best_ol,
                       std::vector<uint32_t>* out) {
  out->assign((size_t)n, 0);
  if (n < 2) return;
  std::vector<uint16_t> counts((size_t)n);
  counts[(size_t)n - 1] = 1;
  for (long i = n - 2; i >= 0; --i)
    counts[(size_t)i] =
        a[i] == a[i + 1]
            ? (uint16_t)std::min<long>(counts[(size_t)i + 1] + 1, kMaxLength)
            : (uint16_t)1;

  // Window offsets indexed by plane code (spiral order), deduped, plus the
  // subset not reachable as (previous offset + 1).
  int win[32] = {0}, win_new[32];
  int nwin = 0, nnew = 0;
  for (int y = 0; y <= 6; ++y)
    for (int x = -6; x <= 6; ++x) {
      long off = (long)y * xsize + x;
      if (off <= 0 || off >= n) continue;
      int pc = (int)pm.Code((uint32_t)off) - 1;
      if (pc >= 0 && pc < 32 && win[pc] == 0) win[pc] = (int)off;
    }
  for (int i = 0; i < 32; ++i)
    if (win[i]) win[nwin++] = win[i];
  for (int i = 0; i < nwin; ++i) {
    bool reach = false;
    for (int j = 0; j < nwin && !reach; ++j) reach = win[i] == win[j] + 1;
    if (!reach) win_new[nnew++] = win[i];
  }

  long best_off_prev = -1, best_len_prev = -1;
  for (long i = 1; i < n; ++i) {
    long best_len = (long)(best_ol[(size_t)i] & 0xFFF);
    long best_off = 0;
    bool compute = true;
    if (best_len >= kMaxLength) {
      best_off = best_ol[(size_t)i] >> 12;
      for (int k = 0; k < nwin; ++k)
        if (best_off == win[k]) {
          compute = false;
          break;
        }
    }
    if (compute) {
      const bool use_prev = best_len_prev > 1 && best_len_prev < kMaxLength;
      const int num = use_prev ? nnew : nwin;
      const int* offs = use_prev ? win_new : win;
      if (use_prev) {
        best_len = best_len_prev - 1;
        best_off = best_off_prev;
      } else {
        best_len = 0;
        best_off = 0;
      }
      for (int k = 0; k < num; ++k) {
        long joff = i - offs[k];
        if (joff < 0 || a[joff] != a[i]) continue;
        long cur = 0, j = i;
        for (;;) {
          const long cj = counts[(size_t)j], cjo = counts[(size_t)joff];
          if (cjo != cj) {
            cur += std::min(cj, cjo);
            break;
          }
          cur += cjo;
          joff += cjo;
          j += cjo;
          if (cur > kMaxLength || j >= n || joff >= n || a[joff] != a[j])
            break;
        }
        if (best_len < cur) {
          best_off = offs[k];
          if (cur >= kMaxLength) {
            best_len = kMaxLength;
            break;
          }
          best_len = cur;
        }
      }
    }
    if (best_len <= 4) {  // minLength (hashchain.go:33)
      (*out)[(size_t)i] = 0;
      best_off_prev = 0;
      best_len_prev = 0;
    } else {
      (*out)[(size_t)i] = ((uint32_t)best_off << 12) | (uint32_t)best_len;
      best_off_prev = best_off;
      best_len_prev = best_len;
    }
  }
}

// Greedy token emission from a per-position match table.
void TokensFromTable(const uint32_t* a, long n,
                     const std::vector<uint32_t>& ol,
                     std::vector<Token>* out) {
  out->clear();
  out->reserve((size_t)n / 2);
  long i = 0;
  while (i < n) {
    const long len = ol[(size_t)i] & 0xFFF;
    const long off = ol[(size_t)i] >> 12;
    if (len >= 4 && off > 0) {
      out->push_back({1, (uint32_t)len, (uint32_t)off});
      i += len;
    } else {
      out->push_back({0, a[i], 0});
      ++i;
    }
  }
}

// Entropy estimates (bits per symbol) from a seed token stream:
// cost[s] = log2(total) - log2(count[s]) (encode_backward.go:885-911).
struct TraceModel {
  double red[256], blue[256], alpha[256], dist[kNumDistance];
  std::vector<double> lit;  // green | length codes | cache indices

  static void ToBits(const std::vector<int64_t>& c, double* o, size_t k) {
    int64_t sum = 0;
    int nz = 0;
    for (size_t i = 0; i < k; ++i) {
      sum += c[i];
      nz += c[i] > 0;
    }
    if (nz <= 1) {
      for (size_t i = 0; i < k; ++i) o[i] = 0.0;
      return;
    }
    const double ls = std::log2((double)sum);
    for (size_t i = 0; i < k; ++i)
      o[i] = c[i] > 0 ? ls - std::log2((double)c[i]) : ls;
  }

  void Build(const std::vector<Token>& seed, const PlaneMap& pm,
             int cache_bits) {
    Histos hs;
    BuildHistogram(seed, pm, cache_bits, &hs);
    lit.resize(hs.h[0].size());
    ToBits(hs.h[0], lit.data(), hs.h[0].size());
    ToBits(hs.h[1], red, 256);
    ToBits(hs.h[2], blue, 256);
    ToBits(hs.h[3], alpha, 256);
    ToBits(hs.h[4], dist, kNumDistance);
  }

  double LiteralCost(uint32_t v) const {
    return alpha[(v >> 24) & 0xFF] + red[(v >> 16) & 0xFF] +
           lit[(v >> 8) & 0xFF] + blue[v & 0xFF];
  }
  double LengthCost(long length) const {  // prefix code + extra bits
    int code, nbits;
    uint32_t extra;
    PrefixEncode((uint32_t)length, &code, &nbits, &extra);
    return lit[(size_t)(kNumLiteral + code)] + nbits;
  }
  double DistCost(uint32_t plane_code) const {
    int code, nbits;
    uint32_t extra;
    PrefixEncode(plane_code, &code, &nbits, &extra);
    return dist[code] + nbits;
  }
};

// Forward DP + backward trace. Seed tokens (already cache-applied) define
// the cost model; `out` gets the re-parsed token stream with the same
// cache_bits applied. Returns false when the parse is degenerate.
bool TraceParse(const uint32_t* a, long n, int xsize, int quality,
                int cache_bits, const PlaneMap& pm,
                const std::vector<uint32_t>& ol,
                const std::vector<Token>& seed, std::vector<Token>* out) {
  if (n < 2) return false;

  TraceModel cm;
  cm.Build(seed, pm, cache_bits);

  // Piecewise-constant runs of the length cost, indexed by length.
  const long max_l = std::min(kMaxLength, n);
  std::vector<float> len_cost((size_t)max_l + 1, 0.f);
  for (long l = 1; l <= max_l; ++l) len_cost[(size_t)l] = (float)cm.LengthCost(l);
  struct Run {
    long lo, hi;  // lengths [lo, hi]
    float cost;
  };
  std::vector<Run> runs;
  for (long l = 1; l <= max_l; ++l) {
    if (!runs.empty() && runs.back().cost == len_cost[(size_t)l])
      runs.back().hi = l;
    else
      runs.push_back({l, l, len_cost[(size_t)l]});
  }

  constexpr float kInf = 3.4e38f;
  std::vector<float> costs((size_t)n, kInf);
  std::vector<uint16_t> step((size_t)n, 0);

  // Serialize one copy candidate: copies starting at `pos` with lengths
  // 1..len (cost base + len_cost[L]) land on pixels pos..pos+len-1.
  auto push = [&](float base, long pos, long len) {
    for (const Run& r : runs) {
      if (r.lo > len) break;
      const long hi = std::min(r.hi, len);
      const float c = base + r.cost;
      for (long L = r.lo; L <= hi; ++L) {
        const long i = pos + L - 1;
        if (costs[(size_t)i] > c) {
          costs[(size_t)i] = c;
          step[(size_t)i] = (uint16_t)L;
        }
      }
    }
  };

  // Approximate running color cache (exact replay happens on emission).
  const uint32_t cshift = 32 - (uint32_t)cache_bits;
  std::vector<int64_t> cc;
  if (cache_bits > 0) cc.assign((size_t)1 << cache_bits, -1);
  // The 0.68/0.82 scalers bias the DP toward cache hits / literals the
  // final (cache-replayed) emission will actually shorten
  // (encode_backward.go:1313-1326, libwebp's DivRound heuristic).
  auto literal_at = [&](long i, float prev) {
    float c = prev;
    const uint32_t px = a[i];
    if (cache_bits > 0) {
      const uint32_t key = (0x1E35A7BDu * px) >> cshift;
      if (cc[key] == (int64_t)px) {
        c += (float)(cm.lit[(size_t)(kNumLiteral + kNumLength + key)] * 0.68);
      } else {
        cc[key] = px;
        c += (float)(cm.LiteralCost(px) * 0.82);
      }
    } else {
      c += (float)(cm.LiteralCost(px) * 0.82);
    }
    if (costs[(size_t)i] > c) {
      costs[(size_t)i] = c;
      step[(size_t)i] = 1;
    }
  };

  literal_at(0, 0.f);
  long off_prev = -1, len_prev = 0, reach = 0;
  float off_cost = 0.f;
  bool first_const = false;
  for (long i = 1; i < n; ++i) {
    const float prev = costs[(size_t)(i - 1)];
    const long off = ol[(size_t)i] >> 12;
    const long len = ol[(size_t)i] & 0xFFF;
    literal_at(i, prev);
    if (len >= 2) {
      if (off != off_prev) {
        off_cost = (float)cm.DistCost(pm.Code((uint32_t)off));
        push(prev + off_cost, i, len);
        first_const = true;
        reach = i + len - 1;
      } else {
        // Constant-offset run: pixels i..reach are already covered by the
        // interval pushed at the run's start; only extend past `reach`
        // (encode_backward.go:1382-1432).
        if (first_const) {
          reach = i - 1 + len_prev - 1;
          first_const = false;
        }
        if (i + len - 1 > reach) {
          long j = i;
          while (j <= reach && (long)(ol[(size_t)(j + 1)] >> 12) == off) ++j;
          const long len_j = ol[(size_t)j] & 0xFFF;
          if (len_j >= 2) {
            push(costs[(size_t)(j - 1)] + off_cost, j, len_j);
            reach = j + len_j - 1;
          }
        }
      }
    }
    off_prev = off;
    len_prev = len;
  }

  // Backward trace: pack chosen step sizes right-to-left.
  std::vector<uint16_t> path;
  path.reserve((size_t)n / 4);
  for (long cur = n - 1; cur >= 0;) {
    const long k = step[(size_t)cur];
    if (k < 1) return false;  // unreachable pixel: bail out
    path.push_back((uint16_t)k);
    cur -= k;
  }

  // Emit tokens along the path (exact color-cache replay).
  out->clear();
  out->reserve(path.size());
  if (cache_bits > 0) cc.assign((size_t)1 << cache_bits, -1);
  long i = 0;
  for (size_t ix = path.size(); ix-- > 0;) {
    const long L = path[ix];
    if (L != 1) {
      const uint32_t off = ol[(size_t)i] >> 12;
      if (off == 0) return false;
      out->push_back({1, (uint32_t)L, off});
      if (cache_bits > 0)
        for (long k = 0; k < L; ++k)
          cc[(0x1E35A7BDu * a[i + k]) >> cshift] = a[i + k];
      i += L;
    } else {
      const uint32_t px = a[i];
      if (cache_bits > 0) {
        const uint32_t key = (0x1E35A7BDu * px) >> cshift;
        if (cc[key] == (int64_t)px) {
          out->push_back({2, key, 0});
        } else {
          cc[key] = px;
          out->push_back({0, px, 0});
        }
      } else {
        out->push_back({0, px, 0});
      }
      ++i;
    }
  }
  return i == n;
}

void EncodeStream(BitWriter* bw, const uint32_t* argb, long n, int xsize,
                  int quality, int method, bool is_level0) {
  // When the cost-model re-parse will run it needs the full match table
  // anyway, and its DP rewrites the token stream regardless — so skip the
  // greedy chain search entirely and derive the seed tokens from the
  // table (one chain pass instead of two; the seed only feeds cache-size
  // selection and the trace-lost fallback, both exact-size-compared).
  // Method ladder (reference encode.go maps method to search effort): the
  // full match table + cost-model re-parse only from method 3 up; below
  // that the one-pass greedy chain is the parse. Methods 0-1 further trim
  // the cache-size search and the clustering candidates — measured on a
  // 1.5 Mpx photo this makes m0 ~3x faster than m4 (libwebp's own m0/m4
  // spread on the same host).
  const bool want_trace = method >= 3 && quality >= 50 && n >= 64;
  std::vector<Token> base;
  std::vector<uint32_t> shared_mt;
  if (want_trace) {
    FillMatchTable(argb, n, xsize, quality, &shared_mt);
    TokensFromTable(argb, n, shared_mt, &base);
  } else {
    BackwardReferences(argb, n, xsize, quality, &base);
  }

  PlaneMap pm;
  pm.Init(xsize);

  Histos hs;
  BuildHistogram(base, pm, 0, &hs);
  double best_cost = HistoCostBits(hs);

  // LZ77-Box candidate at quality >= 90 (reference encode.go:547-550):
  // cheap-distance matching wins on palette-heavy content.
  if (quality >= 90 && method >= 3 && n >= 64) {
    std::vector<uint32_t> std_mt_local, box_mt;
    const std::vector<uint32_t>& std_mt =
        shared_mt.empty()
            ? (FillMatchTable(argb, n, xsize, quality, &std_mt_local),
               std_mt_local)
            : shared_mt;
    FillBoxMatchTable(argb, n, xsize, pm, std_mt, &box_mt);
    std::vector<Token> box;
    TokensFromTable(argb, n, box_mt, &box);
    Histos bh;
    BuildHistogram(box, pm, 0, &bh);
    const double bc = HistoCostBits(bh);
    if (bc < best_cost) {
      best_cost = bc;
      base.swap(box);
      hs = std::move(bh);
    }
  }

  int best_cb = 0;
  if (is_level0 && n >= 512 && quality >= 25) {
    constexpr int kNumCbs = 6;
    constexpr int kCbs[kNumCbs] = {1, 2, 4, 6, 8, 10};
    // Small cache sizes only pay off on small/graphic images; skip them on
    // large ones so the per-token candidate loop stays cheap. Low methods
    // keep only the two big sizes.
    const int c0 = method <= 1 ? 4 : n > (1L << 18) ? 3 : 0;
    Histos ch[kNumCbs];
    std::vector<int64_t> cache[kNumCbs];
    for (int c = c0; c < kNumCbs; ++c) {
      ch[c].Init(kCbs[c]);
      cache[c].assign((size_t)1 << kCbs[c], -1);
    }
    int code, nbits;
    uint32_t extra;
    long pos = 0;
    for (const Token& t : base) {
      if (t.kind == 0) {
        const uint32_t hash = 0x1E35A7BDu * t.v;
        for (int c = c0; c < kNumCbs; ++c) {
          const uint32_t key = hash >> (32 - kCbs[c]);
          if (cache[c][key] == (int64_t)t.v) {
            ch[c].h[0][kNumLiteral + kNumLength + key]++;
          } else {
            cache[c][key] = t.v;
            ch[c].h[0][(t.v >> 8) & 0xFF]++;
            ch[c].h[1][(t.v >> 16) & 0xFF]++;
            ch[c].h[2][t.v & 0xFF]++;
            ch[c].h[3][(t.v >> 24) & 0xFF]++;
          }
        }
        ++pos;
      } else {
        for (long p = pos; p < pos + (long)t.v; ++p) {
          const uint32_t px = argb[p];
          const uint32_t hash = 0x1E35A7BDu * px;
          for (int c = c0; c < kNumCbs; ++c)
            cache[c][hash >> (32 - kCbs[c])] = px;
        }
        pos += t.v;
        PrefixEncode(t.v, &code, &nbits, &extra);
        for (int c = c0; c < kNumCbs; ++c) ch[c].h[0][kNumLiteral + code]++;
        PrefixEncode(pm.Code(t.d), &code, &nbits, &extra);
        for (int c = c0; c < kNumCbs; ++c) ch[c].h[4][code]++;
      }
    }
    for (int c = c0; c < kNumCbs; ++c) {
      const double cost = HistoCostBits(ch[c]);
      if (cost < best_cost) {
        best_cost = cost;
        best_cb = kCbs[c];
      }
    }
  }
  std::vector<Token> best_toks;
  if (best_cb) {
    ApplyColorCache(base, argb, best_cb, &best_toks);
  } else {
    best_toks.swap(base);
  }
  BuildHistogram(best_toks, pm, best_cb, &hs);

  // Cost-model re-parse: always at quality >= 90; at default qualities only
  // where the greedy parse leaves the most on the table (small images) so
  // the large-image throughput path keeps its speed (the reference gates on
  // quality alone, encode_backward.go:773-795).
  if (want_trace) {
    const std::vector<uint32_t>& mt = shared_mt;  // filled above
    std::vector<Token> traced;
    const bool traced_ok =
        TraceParse(argb, n, xsize, quality, best_cb, pm, mt, best_toks,
                   &traced);
    if (traced_ok) {
      Histos ths;
      BuildHistogram(traced, pm, best_cb, &ths);
      if (HistoCostBitsFull(ths) < HistoCostBitsFull(hs)) {
        best_toks.swap(traced);
        hs = std::move(ths);
      }
    }
  }

  // Meta-Huffman clustering (level-0 streams only). The plan's value is
  // decided by EXACT emitted size — both variants are cheap to emit
  // relative to the parse, and estimates were measurably wrong in both
  // directions on real images.
  MetaPlan mp_merge, mp_km;
  bool have_merge = false, have_km = false;
  std::vector<std::vector<uint16_t>> snaps;
  if (is_level0 && quality >= 25 && n >= 4096 && (n % xsize) == 0) {
    // Snapshot plans (fixed group counts) only where the emission cost is
    // negligible; large images keep the two main clusterings.
    have_merge = BuildMetaPlanMerge(
        best_toks, pm, n, xsize, best_cb, &mp_merge,
        (method >= 2 && n <= (1L << 18)) ? &snaps : nullptr);
    if (method >= 2)
      have_km = BuildMetaPlanKMeans(best_toks, pm, n, xsize, best_cb, &mp_km);
  }
  std::vector<MetaPlan> cands;
  if (have_merge) cands.push_back(mp_merge);
  if (have_km) cands.push_back(mp_km);
  for (auto& a : snaps) {
    MetaPlan p;
    p.hb = mp_merge.hb;
    p.tx = mp_merge.tx;
    p.ty = mp_merge.ty;
    std::vector<int> remap2(65536, -1);  // raw cluster ids, may exceed 256
    p.tile_group = a;
    int ng = 0;
    for (auto& g : p.tile_group) {
      if (remap2[(size_t)g] < 0) remap2[(size_t)g] = ng++;
      g = (uint16_t)remap2[(size_t)g];
    }
    p.num_groups = ng;
    if (ng < 2) continue;
    bool dup = false;
    for (const auto& c : cands) dup |= c.num_groups == ng;
    if (!dup) cands.push_back(std::move(p));
  }

  MetaPlan mp;  // the plan emit_stream(meta=true) uses
  auto emit_stream = [&](BitWriter* w, bool meta) {
    if (best_cb) {
      w->Put(1, 1);
      w->Put((uint32_t)best_cb, 4);
    } else {
      w->Put(0, 1);
    }
    if (is_level0) w->Put(meta ? 1 : 0, 1);

    if (!meta) {
      HuffCode codes[5];
      for (int i = 0; i < 5; ++i) codes[i].FromCounts(hs.h[i]);
      for (int i = 0; i < 5; ++i) WriteHuffmanCode(w, codes[i].desc);
      EmitTokens(w, best_toks, codes, pm);
      return;
    }

    // Entropy image: tile -> group ids in the green channel, encoded
    // recursively as its own entropy-coded stream.
    w->Put((uint32_t)(mp.hb - 2), 3);
    std::vector<uint32_t> meta_px((size_t)(mp.tx * mp.ty));
    for (size_t i = 0; i < meta_px.size(); ++i)
      meta_px[i] = 0xFF000000u | ((uint32_t)mp.tile_group[i] << 8);
    EncodeStream(w, meta_px.data(), (long)meta_px.size(), (int)mp.tx,
                 quality, method, /*is_level0=*/false);

    // Per-group histograms + trees.
    std::vector<Histos> gh((size_t)mp.num_groups);
    for (auto& h : gh) h.Init(best_cb);
    long pos = 0;
    for (const Token& t : best_toks) {
      const long y = pos / xsize, x = pos % xsize;
      AddToken(
          &gh[mp.tile_group[(size_t)((y >> mp.hb) * mp.tx + (x >> mp.hb))]],
          t, pm);
      pos += (t.kind == 1) ? (long)t.v : 1;
    }
    std::vector<std::array<HuffCode, 5>> codes((size_t)mp.num_groups);
    for (int gidx = 0; gidx < mp.num_groups; ++gidx)
      for (int i = 0; i < 5; ++i)
        codes[(size_t)gidx][(size_t)i].FromCounts(gh[(size_t)gidx].h[i]);
    for (int gidx = 0; gidx < mp.num_groups; ++gidx)
      for (int i = 0; i < 5; ++i)
        WriteHuffmanCode(w, codes[(size_t)gidx][(size_t)i].desc);
    EmitTokensMeta(w, best_toks, codes, pm, xsize, mp);
  };

  if (cands.empty()) {
    emit_stream(bw, false);
    return;
  }
  std::vector<BitWriter> ws(cands.size() + 1);
  emit_stream(&ws[0], false);
  size_t win = 0;
  for (size_t c = 0; c < cands.size(); ++c) {
    mp = cands[c];
    emit_stream(&ws[c + 1], true);
    if (ws[c + 1].BitPos() < ws[win].BitPos()) win = c + 1;
  }
  const BitWriter& w = ws[win];
  for (uint8_t byte : w.buf) bw->Put(byte, 8);
  if (w.used) bw->Put((uint32_t)(w.acc & ((1u << w.used) - 1)), w.used);
}

}  // namespace

extern "C" {

// Encodes one entropy-coded image stream (cache bit + optional meta-huffman
// entropy image + trees + LZ77 tokens). Returns number of bits written to
// `out` (bit 0 = LSB of out[0]), or -1 on overflow.
long vp8l_encode_entropy_image(const uint32_t* argb, long n, int xsize,
                               int quality, int method, int is_level0,
                               uint8_t* out, long cap_bytes) {
  BitWriter bw;
  EncodeStream(&bw, argb, n, xsize, quality, method, is_level0 != 0);
  const long bits = bw.BitPos();
  bw.FinishByte();
  if ((long)bw.buf.size() > cap_bytes) return -1;
  std::memcpy(out, bw.buf.data(), bw.buf.size());
  return bits;
}

}  // extern "C"
