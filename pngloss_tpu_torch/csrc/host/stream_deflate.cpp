// stream_deflate.cpp — zlib 1.2.13's deflate at level 9 / windowBits 15 /
// memLevel 9 / Z_FILTERED, byte for byte, over an input that arrives in
// order: the PNG encoder of the port feeds it a band of filtered rows at a
// time while the card is still making the rows after it. It is
// native/fast_deflate.cpp's clone (the one-shot form the codec of both
// packages deflates with) made incremental; the matcher and the Huffman back
// end are that file's, copied here so that the one-shot clone stays as it
// is. What the stream adds:
//  * the hash buckets are counting-sorted per segment of the input, as it
//    arrives; a walk runs newest first through the segment that takes the
//    current insertion, then on into the older ones, to the same MAX_DIST
//    limit, and segments out of every later walk's reach are freed;
//  * the run lengths are extended as bytes arrive (a forward run that
//    reaches the last byte present reads as ending there, exact below 258
//    for every position the matcher reaches by then);
//  * the matcher stops MIN_LOOKAHEAD short of the bytes present, where
//    zlib under Z_NO_FLUSH would wait for more input, and goes on at the
//    next feed; the window bookkeeping counts the whole input from the
//    start, so the bytes are one deflate(Z_FINISH) call's over it.
// Differential fuzz against the system libz over random segment splits:
// stream_test.cpp.
//
// The one-shot clone's notes, which hold here segment by segment:
//
//
// Why it is faster while staying bit-exact:
//  * zlib walks hash chains through prev[] — a serially dependent
//    pointer chase (~5 cycles minimum per candidate).  Every position is
//    inserted into its hash bucket exactly once, in stream order, so the
//    chain contents are STATIC: a counting sort over the whole input
//    yields per-bucket ascending position arrays, and the newest-first
//    walk becomes a contiguous descending scan with full ILP.
//  * Equivalence of the candidate set with zlib's windowed model:
//      - chains are strictly descending, so zlib's walk stops at the
//        first entry <= limit (= strstart - MAX_DIST); the array scan
//        applies the same cutoff.
//      - window slides NIL out exactly the entries with window offset
//        < 32768 at slide time; at any later search those are all
//        <= limit (post-slide strstart_w >= 32506 == MAX_DIST), so the
//        limit cutoff subsumes slide-NILing.
//      - head[] == NIL after a slide only for entries at distance
//        > MAX_DIST, which the `strstart - hash_head <= MAX_DIST` gate
//        rejects anyway.
//      - position 0 is zlib's NIL and can never be a match source; the
//        bucket arrays simply never contain it.
//      - prev[] slot collisions (positions 32768 apart) can't corrupt a
//        walk: the newer position isn't inserted yet when the older one
//        is still reachable (distance <= MAX_DIST < 32768).
//  * Bytes beyond the input read as zeros: zlib's fill_window zeroes
//    WIN_INIT (= MAX_MATCH) bytes past the valid data, so comparisons at
//    the stream tail see zeros.  The caller-facing API copies the input
//    into a zero-padded buffer to reproduce this.
//  * The match compare runs 8 bytes per step with XOR+ctz instead of
//    byte-at-a-time; the reject filter and final length are unchanged
//    (bytes 0..2 are equal for every same-bucket candidate passing the
//    2-byte filter because HASH_BITS >= 8, zlib's own argument).
//
// The Huffman back end (tree build, bit-length overflow adjustment,
// code-length RLE, stored/static/dynamic block decision, 32767-symbol
// block boundaries from lit_bufsize = 1 << (memLevel + 6)) replicates
// zlib's trees.c decisions exactly; tables are generated at runtime with
// the canonical DEFLATE construction.
#include <algorithm>
#include <cstdint>
#include <cstring>
#include <cstdlib>
#include <new>
#include <vector>

#if defined(__AVX512F__)
#include <immintrin.h>
#endif

namespace streamdeflate {

static const int MIN_MATCH = 3, MAX_MATCH = 258;
static const int W_SIZE = 32768;
static const int HASH_BITS = 16, HASH_SIZE = 1 << HASH_BITS;
static const unsigned HASH_MASK = HASH_SIZE - 1;
static const int MIN_LOOKAHEAD = MAX_MATCH + MIN_MATCH + 1;  // 262
static const unsigned MAX_DIST = W_SIZE - MIN_LOOKAHEAD;     // 32506
// level 9 configuration_table entry: good 32, lazy 258, nice 258, chain 4096
static const unsigned GOOD_MATCH = 32, MAX_LAZY = 258, NICE_MATCH = 258,
                      MAX_CHAIN = 4096;
static const int LENGTH_CODES = 29, LITERALS = 256,
                 L_CODES = LITERALS + 1 + LENGTH_CODES, D_CODES = 30,
                 BL_CODES = 19, HEAP_SIZE = 2 * L_CODES + 1, MAX_BITS = 15,
                 MAX_BL_BITS = 7, END_BLOCK = 256;
static const int REP_3_6 = 16, REPZ_3_10 = 17, REPZ_11_138 = 18;
// memLevel 9: lit_bufsize = 1 << (9 + 6); a block flushes one symbol early
// (sym_next == sym_end with sym_end = (lit_bufsize - 1) * 3, deflate.c)
static const unsigned SYM_LIMIT = (1u << 15) - 1;  // 32767 symbols per block

static const int extra_lbits[LENGTH_CODES] = {
    0, 0, 0, 0, 0, 0, 0, 0, 1, 1, 1, 1, 2, 2, 2,
    2, 3, 3, 3, 3, 4, 4, 4, 4, 5, 5, 5, 5, 0};
static const int extra_dbits[D_CODES] = {
    0, 0, 0, 0, 1, 1, 2, 2,  3,  3,  4,  4,  5,  5,  6,
    6, 7, 7, 8, 8, 9, 9, 10, 10, 11, 11, 12, 12, 13, 13};
static const int extra_blbits[BL_CODES] = {0, 0, 0, 0, 0, 0, 0, 0, 0, 0,
                                           0, 0, 0, 0, 0, 0, 2, 3, 7};
static const uint8_t bl_order[BL_CODES] = {16, 17, 18, 0, 8,  7, 9,  6, 10, 5,
                                           11, 4,  12, 3, 13, 2, 14, 1, 15};

struct ct_data {
  uint16_t fc;   // frequency, then code after gen_codes
  uint16_t dl;   // dad, then length
};

// ---- static tables, generated once with zlib's tr_static_init algorithm
struct StaticTables {
  uint8_t length_code[256];   // (len - MIN_MATCH) -> length code index
  uint8_t dist_code[512];     // dist -> code (first 256: dist 1..256;
                              //  last 256: (dist-1) >> 7 for dist > 256)
  int base_length[LENGTH_CODES];
  int base_dist[D_CODES];
  ct_data static_ltree[L_CODES + 2];
  ct_data static_dtree[D_CODES];
  StaticTables();
};

static unsigned bi_reverse(unsigned code, int len) {
  unsigned res = 0;
  do {
    res |= code & 1;
    code >>= 1;
    res <<= 1;
  } while (--len > 0);
  return res >> 1;
}

static void gen_codes(ct_data* tree, int max_code, const uint16_t* bl_count) {
  uint16_t next_code[MAX_BITS + 1];
  unsigned code = 0;
  for (int bits = 1; bits <= MAX_BITS; bits++) {
    code = (code + bl_count[bits - 1]) << 1;
    next_code[bits] = (uint16_t)code;
  }
  for (int n = 0; n <= max_code; n++) {
    int len = tree[n].dl;
    if (len == 0) continue;
    tree[n].fc = (uint16_t)bi_reverse(next_code[len]++, len);
  }
}

StaticTables::StaticTables() {
  int length = 0;
  for (int code = 0; code < LENGTH_CODES - 1; code++) {
    base_length[code] = length;
    for (int n = 0; n < (1 << extra_lbits[code]); n++)
      length_code[length++] = (uint8_t)code;
  }
  length_code[length - 1] = LENGTH_CODES - 1;  // length 258 -> code 28
  base_length[LENGTH_CODES - 1] = 255;  // unused for emission (code 28 has
                                        // no extra bits) but mirrors zlib
  int dist = 0;
  for (int code = 0; code < 16; code++) {
    base_dist[code] = dist;
    for (int n = 0; n < (1 << extra_dbits[code]); n++)
      dist_code[dist++] = (uint8_t)code;
  }
  dist >>= 7;
  for (int code = 16; code < D_CODES; code++) {
    base_dist[code] = dist << 7;
    for (int n = 0; n < (1 << (extra_dbits[code] - 7)); n++)
      dist_code[256 + dist++] = (uint8_t)code;
  }
  uint16_t bl_count[MAX_BITS + 1];
  memset(bl_count, 0, sizeof bl_count);
  int n = 0;
  while (n <= 143) static_ltree[n++].dl = 8, bl_count[8]++;
  while (n <= 255) static_ltree[n++].dl = 9, bl_count[9]++;
  while (n <= 279) static_ltree[n++].dl = 7, bl_count[7]++;
  while (n <= 287) static_ltree[n++].dl = 8, bl_count[8]++;
  gen_codes(static_ltree, L_CODES + 1, bl_count);
  for (n = 0; n < D_CODES; n++) {
    static_dtree[n].dl = 5;
    static_dtree[n].fc = (uint16_t)bi_reverse(n, 5);
  }
}

static const StaticTables T;

static inline unsigned d_code(unsigned dist) {
  return dist < 256 ? T.dist_code[dist] : T.dist_code[256 + (dist >> 7)];
}

// ---- bit writer: LSB-first like zlib's bi_buf; byte output is identical
// regardless of internal buffer width
struct BitWriter {
  std::vector<uint8_t>& out;
  uint64_t buf = 0;
  int valid = 0;
  explicit BitWriter(std::vector<uint8_t>& o) : out(o) {}
  inline void send(unsigned value, int length) {
    buf |= (uint64_t)value << valid;
    valid += length;
    while (valid >= 8) {
      out.push_back((uint8_t)buf);
      buf >>= 8;
      valid -= 8;
    }
  }
  void windup() {
    if (valid > 0) out.push_back((uint8_t)buf);
    buf = 0;
    valid = 0;
  }
};

// ---- per-block Huffman state (mirrors trees.c)
struct TreeDesc {
  ct_data* dyn_tree;
  const ct_data* stat_tree;  // NULL for the bl tree
  const int* extra_bits;
  int extra_base;
  int elems;
  int max_length;
  int max_code;  // out
};

struct Compressor {
  const uint8_t* in;  // the whole input, zero-padded; read below `fed` only
  size_t n;           // the whole input's length, known from the start
  size_t m;           // insertable positions: < m
  std::vector<uint8_t>& out;
  BitWriter bw;

  // hash buckets: counting-sorted position arrays (see header comment), one
  // set per segment of the input: each stretch fed is sorted once it holds
  // seg_min positions (at the end, whatever waits). The walk runs newest first through the segment that
  // takes the current insertion, then back through the older ones.
  struct Segment {
    uint32_t lo = 0, hi = 0;             // its positions [lo, hi), lo >= 1
    std::vector<uint32_t> start;         // HASH_SIZE + 1 offsets
    std::vector<uint32_t> entries;       // positions grouped by bucket
  };
  std::vector<Segment> segs;
  size_t alive = 0;                    // older segments are out of reach
  size_t ins = 0;                      // the segment taking insertions
  std::vector<uint32_t> cnt;           // inserted-so-far per bucket of ins
  std::vector<uint32_t> fill_at;       // build_segment's scratch
  std::vector<uint16_t> hash_of;       // hash of each position
  size_t fed = 0;                      // input bytes present
  size_t built = 0;                    // positions sorted into segments
  size_t seg_min;
  // single-byte run lengths, saturated at Q_SAT (all decisions compare
  // against thresholds < 258, so saturation never loses information).
  // Packed as one u32 per position: forward length (X-run starting at p,
  // incl. the zero padding past the input, like fill_window's zeroing) in
  // the low half, backward length (X-run ending at p) in the high half.
  // While the input is still arriving, a forward run that reaches the last
  // byte present reads as ending there: a lower bound, exact below 258 for
  // every position the matcher reaches then (fed - MIN_LOOKAHEAD and
  // earlier), where longest_match only tells lengths below 258 apart.
  static const unsigned Q_SAT = 1024;
  static const long SEG_MIN = 4;  // below this, the scalar walk is cheaper
  std::vector<uint32_t> qq;

  // symbol buffer (one block)
  struct Sym { uint16_t dist; uint8_t lc; };
  std::vector<Sym> syms;

  ct_data dyn_ltree[HEAP_SIZE];
  ct_data dyn_dtree[2 * D_CODES + 1];
  ct_data bl_tree[2 * BL_CODES + 1];
  uint16_t bl_count[MAX_BITS + 1];
  int heap[HEAP_SIZE];
  int heap_len, heap_max;
  uint8_t depth[HEAP_SIZE];
  unsigned long opt_len, static_len;

  // window-coordinate bookkeeping, only to reproduce zlib's
  // "buf == NULL" stored-block gate when block_start slides negative
  long block_start_w = 0;
  size_t slide_base = 0;   // absolute position of window offset 0
  size_t strstart = 0;     // absolute
  size_t lookahead = 0;    // == bytes in window past strstart (zlib's)
  size_t in_pos = 0;       // absolute bytes pulled into the window
  unsigned match_start = 0;
  // deflate_slow's state between the matcher's calls
  unsigned match_length = MIN_MATCH - 1;
  int match_available = 0;

  // in_ holds n_ bytes and MAX_MATCH + 16 zeros past them; the caller
  // writes the input into it in order and calls advance as it goes
  Compressor(const uint8_t* in_, size_t n_, std::vector<uint8_t>& out_,
             size_t seg_min_)
      : in(in_), n(n_), m(n_ >= MIN_MATCH ? n_ - (MIN_MATCH - 1) : 0),
        out(out_), bw(out_), seg_min(seg_min_) {
    cnt.assign(HASH_SIZE, 0);
    // hash_of covers ALL hashable positions 0..m-1 (position 0 is looked
    // up at strstart == 0 even though it is never inserted: zlib's NIL)
    hash_of.resize(m);
    qq.assign(n + MAX_MATCH, 0);
    init_block();
    fill_window();
  }

  // Positions [lo, hi) hashed and counting-sorted into a new segment
  // (every position 1..m-1 is inserted exactly once; position 0 is NIL).
  void build_segment(size_t lo, size_t hi) {
    for (size_t p = lo; p < hi; p++)
      hash_of[p] = (uint16_t)((((unsigned)in[p] << 12) ^
                               ((unsigned)in[p + 1] << 6) ^ in[p + 2]) &
                              HASH_MASK);
    Segment s;
    s.lo = (uint32_t)(lo > 0 ? lo : 1);
    s.hi = (uint32_t)(hi > s.lo ? hi : s.lo);
    s.start.assign(HASH_SIZE + 1, 0);
    for (size_t p = s.lo; p < s.hi; p++) s.start[hash_of[p] + 1]++;
    for (int h = 0; h < HASH_SIZE; h++) s.start[h + 1] += s.start[h];
    s.entries.resize(s.hi - s.lo);
    fill_at.assign(s.start.begin(), s.start.end() - 1);
    for (size_t p = s.lo; p < s.hi; p++)
      s.entries[fill_at[hash_of[p]]++] = (uint32_t)p;
    segs.push_back(std::move(s));
  }

  // Takes in[fed, F), which the caller has written, and with `final` the
  // end of the input (F == n): the run lengths of the new bytes, a new
  // segment once seg_min positions wait for one (at the end, whatever
  // waits), then the matcher as far as the data present lets it go.
  void advance(size_t F, bool final) {
    for (size_t p = fed; p < F; p++) {
      unsigned bwd = p > 0 && in[p] == in[p - 1] ? (qq[p - 1] >> 16) + 1 : 1;
      qq[p] = (bwd < Q_SAT ? bwd : Q_SAT) << 16;
    }
    // forward lengths from the last byte present (at the end, from the
    // padding), back over every position they may change: those below
    // fed - Q_SAT were already exact or saturated
    size_t top = final ? qq.size() : F;
    size_t from = fed > Q_SAT ? fed - Q_SAT : 0;
    if (top > from) {
      unsigned fwd = 1;
      qq[top - 1] = (qq[top - 1] & 0xFFFF0000u) | fwd;
      for (size_t p = top - 1; p-- > from;) {
        fwd = in[p] == in[p + 1] ? (fwd < Q_SAT ? fwd + 1 : Q_SAT) : 1;
        qq[p] = (qq[p] & 0xFFFF0000u) | fwd;
      }
    }
    fed = F;
    size_t hashable = F >= MIN_MATCH - 1 ? F - (MIN_MATCH - 1) : 0;
    if (hashable > m) hashable = m;
    if (hashable > built && (final || hashable - built >= seg_min)) {
      build_segment(built, hashable);
      built = hashable;
    }
    match(final);
  }

  // Makes ins the segment holding position p (p < built), and lets go of
  // the segments that no walk from p on can reach: every entry at or below
  // p - MAX_DIST - 1 lies at or below the limit of any later strstart.
  void seek(size_t p) {
    while (p >= segs[ins].hi) {
      ++ins;
      std::fill(cnt.begin(), cnt.end(), 0u);
      while (alive < ins && (size_t)segs[alive].hi + MAX_DIST <= p) {
        std::vector<uint32_t>().swap(segs[alive].start);
        std::vector<uint32_t>().swap(segs[alive].entries);
        ++alive;
      }
    }
  }

  // the newest position of `bucket` inserted so far (0, zlib's NIL, if
  // none is within reach); `inserted` is ins's count of it
  uint32_t newest(unsigned bucket, unsigned inserted) const {
    if (inserted > 0)
      return segs[ins].entries[segs[ins].start[bucket] + inserted - 1];
    for (size_t k = ins; k-- > alive;) {
      const Segment& s = segs[k];
      if (s.start[bucket + 1] > s.start[bucket])
        return s.entries[s.start[bucket + 1] - 1];
    }
    return 0;
  }

  // exact deflate_slow fill_window bookkeeping (no data movement needed;
  // only the slide timing matters, for block_start_w's sign)
  void fill_window() {
    do {
      size_t strstart_w = strstart - slide_base;
      size_t more = 2 * (size_t)W_SIZE - lookahead - strstart_w;
      if (strstart_w >= W_SIZE + MAX_DIST) {
        slide_base += W_SIZE;
        block_start_w -= W_SIZE;
        more += W_SIZE;
      }
      if (in_pos >= n) break;
      size_t k = n - in_pos;
      if (k > more) k = more;
      in_pos += k;
      lookahead += k;
    } while (lookahead < (size_t)MIN_LOOKAHEAD && in_pos < n);
  }

  void init_block() {
    for (int i = 0; i < L_CODES; i++) dyn_ltree[i].fc = 0;
    for (int i = 0; i < D_CODES; i++) dyn_dtree[i].fc = 0;
    for (int i = 0; i < BL_CODES; i++) bl_tree[i].fc = 0;
    dyn_ltree[END_BLOCK].fc = 1;
    opt_len = static_len = 0;
    syms.clear();
  }

  // ---- trees.c: build_tree and friends, replicated decision-for-decision
  inline bool smaller(const ct_data* tree, int m, int k) {
    return tree[m].fc < tree[k].fc ||
           (tree[m].fc == tree[k].fc && depth[m] <= depth[k]);
  }

  void pqdownheap(ct_data* tree, int k) {
    int v = heap[k];
    int j = k << 1;
    while (j <= heap_len) {
      if (j < heap_len && smaller(tree, heap[j + 1], heap[j])) j++;
      if (smaller(tree, v, heap[j])) break;
      heap[k] = heap[j];
      k = j;
      j <<= 1;
    }
    heap[k] = v;
  }

  void gen_bitlen(TreeDesc* desc) {
    ct_data* tree = desc->dyn_tree;
    int max_code = desc->max_code;
    const ct_data* stree = desc->stat_tree;
    const int* extra = desc->extra_bits;
    int base = desc->extra_base;
    int max_length = desc->max_length;
    int overflow = 0;

    for (int bits = 0; bits <= MAX_BITS; bits++) bl_count[bits] = 0;
    tree[heap[heap_max]].dl = 0;  // root
    int h;
    for (h = heap_max + 1; h < HEAP_SIZE; h++) {
      int nn = heap[h];
      int bits = tree[tree[nn].dl].dl + 1;  // dl is still "dad" here
      if (bits > max_length) bits = max_length, overflow++;
      tree[nn].dl = (uint16_t)bits;
      if (nn > max_code) continue;
      bl_count[bits]++;
      int xbits = 0;
      if (nn >= base) xbits = extra[nn - base];
      unsigned f = tree[nn].fc;
      opt_len += (unsigned long)f * (unsigned)(bits + xbits);
      if (stree)
        static_len += (unsigned long)f * (unsigned)(stree[nn].dl + xbits);
    }
    if (overflow == 0) return;
    do {
      int bits = max_length - 1;
      while (bl_count[bits] == 0) bits--;
      bl_count[bits]--;
      bl_count[bits + 1] += 2;
      bl_count[max_length]--;
      overflow -= 2;
    } while (overflow > 0);
    for (int bits = max_length; bits != 0; bits--) {
      int m = bl_count[bits];
      while (m != 0) {
        int nn = heap[--h];
        if (nn > max_code) continue;
        if ((int)tree[nn].dl != bits) {
          opt_len += ((unsigned long)bits - tree[nn].dl) * tree[nn].fc;
          tree[nn].dl = (uint16_t)bits;
        }
        m--;
      }
    }
  }

  void build_tree(TreeDesc* desc) {
    ct_data* tree = desc->dyn_tree;
    const ct_data* stree = desc->stat_tree;
    int elems = desc->elems;
    int max_code = -1;
    heap_len = 0;
    heap_max = HEAP_SIZE;
    for (int nn = 0; nn < elems; nn++) {
      if (tree[nn].fc != 0) {
        heap[++heap_len] = max_code = nn;
        depth[nn] = 0;
      } else {
        tree[nn].dl = 0;
      }
    }
    while (heap_len < 2) {
      int node = heap[++heap_len] = (max_code < 2 ? ++max_code : 0);
      tree[node].fc = 1;
      depth[node] = 0;
      opt_len--;
      if (stree) static_len -= stree[node].dl;
    }
    desc->max_code = max_code;
    for (int nn = heap_len / 2; nn >= 1; nn--) pqdownheap(tree, nn);
    int node = elems;
    do {
      int nn = heap[1];
      heap[1] = heap[heap_len--];
      pqdownheap(tree, 1);
      int m = heap[1];
      heap[--heap_max] = nn;
      heap[--heap_max] = m;
      tree[node].fc = (uint16_t)(tree[nn].fc + tree[m].fc);
      depth[node] =
          (uint8_t)((depth[nn] >= depth[m] ? depth[nn] : depth[m]) + 1);
      tree[nn].dl = tree[m].dl = (uint16_t)node;  // dad
      heap[1] = node++;
      pqdownheap(tree, 1);
    } while (heap_len >= 2);
    heap[--heap_max] = heap[1];
    gen_bitlen(desc);
    gen_codes(tree, max_code, bl_count);
  }

  void scan_tree(ct_data* tree, int max_code) {
    int prevlen = -1;
    int nextlen = tree[0].dl;
    int count = 0;
    int max_count = 7, min_count = 4;
    if (nextlen == 0) max_count = 138, min_count = 3;
    tree[max_code + 1].dl = 0xffff;  // guard
    for (int nn = 0; nn <= max_code; nn++) {
      int curlen = nextlen;
      nextlen = tree[nn + 1].dl;
      if (++count < max_count && curlen == nextlen) {
        continue;
      } else if (count < min_count) {
        bl_tree[curlen].fc = (uint16_t)(bl_tree[curlen].fc + count);
      } else if (curlen != 0) {
        if (curlen != prevlen) bl_tree[curlen].fc++;
        bl_tree[REP_3_6].fc++;
      } else if (count <= 10) {
        bl_tree[REPZ_3_10].fc++;
      } else {
        bl_tree[REPZ_11_138].fc++;
      }
      count = 0;
      prevlen = curlen;
      if (nextlen == 0) {
        max_count = 138, min_count = 3;
      } else if (curlen == nextlen) {
        max_count = 6, min_count = 3;
      } else {
        max_count = 7, min_count = 4;
      }
    }
  }

  inline void send_code(const ct_data* tree, int c) {
    bw.send(tree[c].fc, tree[c].dl);
  }

  void send_tree(ct_data* tree, int max_code) {
    int prevlen = -1;
    int nextlen = tree[0].dl;
    int count = 0;
    int max_count = 7, min_count = 4;
    if (nextlen == 0) max_count = 138, min_count = 3;
    for (int nn = 0; nn <= max_code; nn++) {
      int curlen = nextlen;
      nextlen = tree[nn + 1].dl;
      if (++count < max_count && curlen == nextlen) {
        continue;
      } else if (count < min_count) {
        do {
          send_code(bl_tree, curlen);
        } while (--count != 0);
      } else if (curlen != 0) {
        if (curlen != prevlen) {
          send_code(bl_tree, curlen);
          count--;
        }
        send_code(bl_tree, REP_3_6);
        bw.send((unsigned)(count - 3), 2);
      } else if (count <= 10) {
        send_code(bl_tree, REPZ_3_10);
        bw.send((unsigned)(count - 3), 3);
      } else {
        send_code(bl_tree, REPZ_11_138);
        bw.send((unsigned)(count - 11), 7);
      }
      count = 0;
      prevlen = curlen;
      if (nextlen == 0) {
        max_count = 138, min_count = 3;
      } else if (curlen == nextlen) {
        max_count = 6, min_count = 3;
      } else {
        max_count = 7, min_count = 4;
      }
    }
  }

  int build_bl_tree() {
    scan_tree(dyn_ltree, l_desc.max_code);
    scan_tree(dyn_dtree, d_desc.max_code);
    build_tree(&bl_desc);
    int max_blindex;
    for (max_blindex = BL_CODES - 1; max_blindex >= 3; max_blindex--)
      if (bl_tree[bl_order[max_blindex]].dl != 0) break;
    opt_len += 3 * ((unsigned long)max_blindex + 1) + 5 + 5 + 4;
    return max_blindex;
  }

  void send_all_trees(int lcodes, int dcodes, int blcodes) {
    bw.send((unsigned)(lcodes - 257), 5);
    bw.send((unsigned)(dcodes - 1), 5);
    bw.send((unsigned)(blcodes - 4), 4);
    for (int rank = 0; rank < blcodes; rank++)
      bw.send(bl_tree[bl_order[rank]].dl, 3);
    send_tree(dyn_ltree, lcodes - 1);
    send_tree(dyn_dtree, dcodes - 1);
  }

  void compress_block(const ct_data* ltree, const ct_data* dtree) {
    for (const Sym& s : syms) {
      unsigned dist = s.dist;
      unsigned lc = s.lc;
      if (dist == 0) {
        send_code(ltree, (int)lc);
      } else {
        unsigned code = T.length_code[lc];
        send_code(ltree, (int)(code + LITERALS + 1));
        int extra = extra_lbits[code];
        if (extra != 0) {
          lc -= T.base_length[code];
          bw.send(lc, extra);
        }
        dist--;
        code = d_code(dist);
        send_code(dtree, (int)code);
        extra = extra_dbits[code];
        if (extra != 0) {
          dist -= T.base_dist[code];
          bw.send(dist, extra);
        }
      }
    }
    send_code(ltree, END_BLOCK);
  }

  void stored_block(const uint8_t* buf, size_t stored_len, int last) {
    bw.send((0 << 1) + (unsigned)last, 3);  // STORED_BLOCK
    bw.windup();
    out.push_back((uint8_t)stored_len);
    out.push_back((uint8_t)(stored_len >> 8));
    out.push_back((uint8_t)~stored_len);
    out.push_back((uint8_t)(~stored_len >> 8));
    out.insert(out.end(), buf, buf + stored_len);
  }

  TreeDesc l_desc{dyn_ltree, T.static_ltree, extra_lbits, LITERALS + 1,
                  L_CODES,   MAX_BITS,       0};
  TreeDesc d_desc{dyn_dtree, T.static_dtree, extra_dbits, 0,
                  D_CODES,   MAX_BITS,       0};
  TreeDesc bl_desc{bl_tree, nullptr, extra_blbits, 0,
                   BL_CODES, MAX_BL_BITS,  0};

  void flush_block(int last) {
    // _tr_flush_block(buf = block_start >= 0 ? window + block_start : NULL,
    //                 stored_len = strstart - block_start, last)
    size_t block_start_abs = slide_base + (size_t)block_start_w;
    size_t stored_len =
        (strstart - slide_base) - (size_t)block_start_w;  // window coords
    bool buf_ok = block_start_w >= 0L;

    build_tree(&l_desc);
    build_tree(&d_desc);
    int max_blindex = build_bl_tree();
    unsigned long opt_lenb = (opt_len + 3 + 7) >> 3;
    unsigned long static_lenb = (static_len + 3 + 7) >> 3;
    if (static_lenb <= opt_lenb) opt_lenb = static_lenb;

    if (stored_len + 4 <= opt_lenb && buf_ok) {
      stored_block(in + block_start_abs, stored_len, last);
    } else if (static_lenb == opt_lenb) {
      bw.send((1u << 1) + (unsigned)last, 3);  // STATIC_TREES
      compress_block(T.static_ltree, T.static_dtree);
    } else {
      bw.send((2u << 1) + (unsigned)last, 3);  // DYN_TREES
      send_all_trees(l_desc.max_code + 1, d_desc.max_code + 1,
                     max_blindex + 1);
      compress_block(dyn_ltree, dyn_dtree);
    }
    init_block();
    if (last) bw.windup();
    block_start_w = (long)(strstart - slide_base);
  }

  // _tr_tally; returns true when the symbol buffer is full
  inline bool tally_lit(unsigned c) {
    syms.push_back({0, (uint8_t)c});
    dyn_ltree[c].fc++;
    return syms.size() == SYM_LIMIT;
  }
  inline bool tally_dist(unsigned dist, unsigned len_minus3) {
    syms.push_back({(uint16_t)dist, (uint8_t)len_minus3});
    dist--;
    dyn_ltree[T.length_code[len_minus3] + LITERALS + 1].fc++;
    dyn_dtree[d_code(dist)].fc++;
    return syms.size() == SYM_LIMIT;
  }

  // ---- longest_match over the contiguous bucket array (exact semantics;
  // see header comment for the equivalence argument)
  //
  // Segment fast path: zlib's scan_start/scan_end filters are semantics-
  // free accelerators (any candidate with true length > best_len passes
  // them), so the walk's outcome is a pure function of the candidate
  // slice: final best = max(prev best, max length over visited), reported
  // at the NEWEST candidate attaining it, with the walk cut at the first
  // candidate reaching `nice`.  For candidates inside a single-byte run
  // of X (the dominant case on lossy scanline data — 75-81%% of all
  // visits), the length has a closed form: with qc = X-run length at the
  // candidate and qs = X-run length at scan,
  //     len = qc        if qc < qs     (cand run ends first)
  //         = qs        if qc > qs     (scan run ends first)
  //         = qs + lcp(scan+qs, cand+qs)   if qc == qs  (one real compare)
  // and every position [run_start .. run_end-3] hashes to this bucket, so
  // the run occupies a contiguous slice of the entry array — the whole
  // segment resolves with index arithmetic + at most one compare.
  unsigned longest_match(unsigned prev_length, unsigned bucket,
                         unsigned inserted) {
    long chain_left =
        (long)(prev_length >= GOOD_MATCH ? MAX_CHAIN >> 2 : MAX_CHAIN);
    const uint8_t* scan = in + strstart;
    unsigned best_len = prev_length;
    unsigned nice = NICE_MATCH;
    if ((size_t)nice > lookahead) nice = (unsigned)lookahead;
    // segments assume nice == 258 (the whole stream except the last
    // ~258 bytes, where zlib truncates nice to the lookahead)
    const bool seg_ok = nice == NICE_MATCH;
    uint32_t limit =
        strstart > (size_t)MAX_DIST ? (uint32_t)(strstart - MAX_DIST) : 0;
    uint16_t scan_start;
    memcpy(&scan_start, scan, 2);
    uint16_t scan_end;
    memcpy(&scan_end, scan + best_len - 1, 2);
    const unsigned scan_byte = in[strstart];
    const unsigned qs_scan = seg_ok ? (qq[strstart] & 0xFFFF) : 0;

    // the walk's cursor: entry idx of segment k's bucket array (its first
    // position seg_lo), newest first, then on into the older segments
    size_t k = ins;
    const uint32_t* base = segs[k].entries.data() + segs[k].start[bucket];
    long idx = (long)inserted - 1;  // newest previously-inserted entry
    uint32_t seg_lo = segs[k].lo;
    auto older = [&]() {
      while (k > alive) {
        const Segment& s = segs[--k];
        if (s.start[bucket + 1] > s.start[bucket]) {
          base = s.entries.data() + s.start[bucket];
          idx = (long)(s.start[bucket + 1] - s.start[bucket]) - 1;
          seg_lo = s.lo;
          return true;
        }
      }
      return false;
    };
    if (idx < 0) older();

    // zlib examines the FIRST candidate (hash_head) unconditionally — the
    // caller's `strstart - hash_head <= MAX_DIST` gate admits distance ==
    // MAX_DIST exactly, and the `> limit` cutoff applies only to the
    // prev[] links that FOLLOW.  Process it scalar before the loop.
    if (idx >= 0) {
      uint32_t cur = base[idx];
      const uint8_t* match = in + cur;
      uint16_t m_end, m_start;
      memcpy(&m_end, match + best_len - 1, 2);
      memcpy(&m_start, match, 2);
      if (m_end == scan_end && m_start == scan_start) {
        unsigned len = 2;
        while (len < MAX_MATCH) {
          uint64_t a, b;
          memcpy(&a, scan + len, 8);
          memcpy(&b, match + len, 8);
          uint64_t x = a ^ b;
          if (x) {
            len += (unsigned)(__builtin_ctzll(x) >> 3);
            break;
          }
          len += 8;
        }
        if (len > MAX_MATCH) len = MAX_MATCH;
        if (len > best_len) {
          match_start = cur;
          best_len = len;
          if (len >= nice) chain_left = 1;  // zlib breaks on update only
          memcpy(&scan_end, scan + best_len - 1, 2);
        }
      }
      idx--;
      if (--chain_left == 0) goto walk_done;
    }

    for (;;) {
      if (idx < 0 && !older()) break;
#if defined(__AVX512F__)
      // ---- vectorized stretch: filter 16 candidates with one gather.
      // The end-filter is a semantics-free accelerator, and a result
      // computed against a STALE (smaller) best_len stays sound: a
      // candidate failing the filter at old best b has some byte <= b
      // differing, so its length <= b <= current best — never an
      // improvement.  Hits are verified (and ordered) scalar.
      while (idx >= 18 && chain_left >= 16) {
        __m512i vpos = _mm512_loadu_si512((const void*)(base + idx - 15));
        __m512i vpos3 = _mm512_loadu_si512((const void*)(base + idx - 18));
        // stop lanes: position <= limit, or a run-segment head (3
        // consecutive positions below it => let the segment collapse it)
        __mmask16 bad =
            _mm512_cmple_epu32_mask(vpos, _mm512_set1_epi32((int)limit)) |
            _mm512_cmpeq_epu32_mask(
                vpos, _mm512_add_epi32(vpos3, _mm512_set1_epi32(3)));
        int take = 16;
        if (bad) {
          int h = 31 - __builtin_clz((unsigned)bad);  // highest stop lane
          take = 15 - h;
          if (take == 0) break;  // stop lane on top: per-entry logic
        }
        __mmask16 active = (__mmask16)(0xFFFFu << (16 - take));
        unsigned o = best_len >= 3 ? best_len - 3 : best_len - 1;
        uint32_t ref;
        memcpy(&ref, scan + o, 4);
        __m512i gat = _mm512_mask_i32gather_epi32(
            _mm512_setzero_si512(), active, vpos, (const void*)(in + o), 1);
        __mmask16 hits;
        if (best_len >= 3) {
          hits = _mm512_mask_cmpeq_epi32_mask(active, gat,
                                              _mm512_set1_epi32((int)ref));
        } else {  // best_len == 2: only bytes 1..2 may be assumed
          __m512i mask16 = _mm512_set1_epi32(0xFFFF);
          hits = _mm512_mask_cmpeq_epi32_mask(
              active, _mm512_and_si512(gat, mask16),
              _mm512_set1_epi32((int)(ref & 0xFFFF)));
        }
        if (hits) {
          alignas(64) uint32_t posbuf[16];
          _mm512_storeu_si512((void*)posbuf, vpos);
          bool brk = false;
          do {
            int k = 31 - __builtin_clz((unsigned)hits);
            hits = (__mmask16)(hits & ~(1u << k));
            uint32_t cpos = posbuf[k];
            const uint8_t* match = in + cpos;
            uint16_t m_start;
            memcpy(&m_start, match, 2);
            if (m_start != scan_start) continue;
            unsigned len = 2;
            while (len < MAX_MATCH) {
              uint64_t a, b;
              memcpy(&a, scan + len, 8);
              memcpy(&b, match + len, 8);
              uint64_t x = a ^ b;
              if (x) {
                len += (unsigned)(__builtin_ctzll(x) >> 3);
                break;
              }
              len += 8;
            }
            if (len > MAX_MATCH) len = MAX_MATCH;
            if (len > best_len) {
              match_start = cpos;
              best_len = len;
              if (len >= nice) {  // walk ends AT this candidate
                chain_left -= 15 - k + 1;
                idx -= 15 - k + 1;
                brk = true;
                break;
              }
              memcpy(&scan_end, scan + best_len - 1, 2);
            }
          } while (hits);
          if (brk) goto walk_done;
        }
        idx -= take;
        chain_left -= take;
        if (chain_left == 0) goto walk_done;
        if (take < 16) break;  // stop lane next: per-entry logic
      }
      if (idx < 0) continue;
#endif
      uint32_t cur = base[idx];
      if (cur <= limit) break;

      uint32_t qcur = seg_ok ? qq[cur] : 0;
      unsigned qc0 = qcur & 0xFFFF;
      if (qc0 >= MIN_MATCH && (long)(qcur >> 16) >= SEG_MIN) {
        uint32_t lo = cur - (qcur >> 16) + 1;  // run start (qb >= 1; may be
                                               // saturated -> chunked)
        if (lo < seg_lo) lo = seg_lo;          // the run's older positions
                                               // lie in older segments (and
                                               // 0 is never an entry)
        bool limit_clip = lo <= limit;
        if (limit_clip) lo = limit + 1;
        long S = (long)(cur - lo) + 1;    // candidates at cur-d, d=0..S-1,
        if (S > chain_left) S = chain_left;  // with qc(d) = qc0 + d
        unsigned qs = in[cur] == scan_byte ? qs_scan : 0;
        unsigned M;            // max length over the visited candidates
        long d_at;             // newest candidate attaining it
        bool nice_brk = false;
        long consumed = S;
        if (qc0 > qs && qs < NICE_MATCH) {
          M = qs, d_at = 0;  // hot class: every len == qs; newest first
        } else if (qs >= NICE_MATCH) {
          // len(d) = min(qc0 + d, 258); break at the first len == 258
          if (qc0 >= NICE_MATCH) {
            M = NICE_MATCH, d_at = 0, nice_brk = true, consumed = 1;
          } else if ((long)(NICE_MATCH - qc0) <= S - 1) {
            d_at = (long)(NICE_MATCH - qc0);
            M = NICE_MATCH, nice_brk = true, consumed = d_at + 1;
          } else {
            M = qc0 + (unsigned)(S - 1), d_at = S - 1;  // ascending class
          }
        } else {             // qc0 <= qs < 258
          long d_s = (long)(qs - qc0);  // the qc == qs candidate
          if (d_s > S - 1) {
            M = qc0 + (unsigned)(S - 1), d_at = S - 1;  // all len = qc < qs
          } else {
            // one real compare: both tails start at their first non-X byte
            const uint8_t* cs = scan + qs;
            const uint8_t* cm = in + (cur - (uint32_t)d_s) + qs;
            unsigned ext = 0;
            const unsigned room = NICE_MATCH - qs;
            while (ext < room) {
              uint64_t a, b;
              memcpy(&a, cs + ext, 8);
              memcpy(&b, cm + ext, 8);
              uint64_t x = a ^ b;
              if (x) {
                ext += (unsigned)(__builtin_ctzll(x) >> 3);
                break;
              }
              ext += 8;
            }
            if (ext > room) ext = room;
            M = qs + ext, d_at = d_s;  // >= qs > every other class
            if (M >= NICE_MATCH) nice_brk = true, consumed = d_s + 1;
          }
        }
        if (M > best_len) {
          best_len = M;
          match_start = cur - (uint32_t)d_at;
          memcpy(&scan_end, scan + best_len - 1, 2);
        }
        chain_left -= consumed;
        if (nice_brk || chain_left == 0) break;
        idx -= S;
        if (limit_clip || lo == limit + 1) break;  // next pos <= limit
        continue;
      }

      const uint8_t* match = in + cur;
      uint16_t m_end, m_start;
      memcpy(&m_end, match + best_len - 1, 2);
      memcpy(&m_start, match, 2);
      if (m_end == scan_end && m_start == scan_start) {
        // full compare from offset 2 (byte 2 equal for same-bucket
        // candidates passing the 2-byte filter; zlib's own argument),
        // 8 bytes per step; the input buffer is padded so reads up to
        // scan + 258 + 7 are in bounds
        unsigned len = 2;
        while (len < MAX_MATCH) {
          uint64_t a, b;
          memcpy(&a, scan + len, 8);
          memcpy(&b, match + len, 8);
          uint64_t x = a ^ b;
          if (x) {
            len += (unsigned)(__builtin_ctzll(x) >> 3);
            break;
          }
          len += 8;
        }
        if (len > MAX_MATCH) len = MAX_MATCH;
        if (len > best_len) {
          match_start = cur;
          best_len = len;
          if (len >= nice) break;
          memcpy(&scan_end, scan + best_len - 1, 2);
        }
      }
      idx--;
      if (--chain_left == 0) break;
    }
  walk_done:
    return (size_t)best_len <= lookahead ? best_len : (unsigned)lookahead;
  }

  // deflate_slow's loop from where the last call left it. Until the end
  // of the input it stops at the first strstart without MIN_LOOKAHEAD
  // bytes of sorted input ahead, where zlib under Z_NO_FLUSH would wait for
  // more: every decision before that point reads only bytes present. The
  // window bookkeeping counts the whole input from the start, as one
  // deflate(Z_FINISH) call over it does, so the output is that call's.
  void match(bool final) {
    const size_t ready =
        final ? n : std::min(fed, built + (size_t)(MIN_MATCH - 1));
    for (;;) {
      if (!final && strstart + MIN_LOOKAHEAD > ready) return;
      if (lookahead < (size_t)MIN_LOOKAHEAD) {
        fill_window();
        if (lookahead == 0) break;
      }
      // INSERT_STRING(strstart): bump the bucket cursor; hash_head is the
      // newest entry inserted before this one
      unsigned bucket = 0;
      uint32_t hash_head = 0;
      unsigned inserted = 0;
      if (lookahead >= MIN_MATCH) {
        bucket = hash_of[strstart];
        seek(strstart);
        inserted = cnt[bucket];
        hash_head = newest(bucket, inserted);
        if (strstart > 0) cnt[bucket] = inserted + 1;  // position 0 is NIL
      }
      unsigned prev_length = match_length;
      unsigned prev_match = match_start;
      match_length = MIN_MATCH - 1;

      if (hash_head != 0 && prev_length < MAX_LAZY &&
          strstart - hash_head <= (size_t)MAX_DIST) {
        match_length = longest_match(prev_length, bucket, inserted);
        // Z_FILTERED: drop all matches of length <= 5 (deflate.c's
        // deflate_slow filter; TOO_FAR is subsumed)
        if (match_length <= 5) match_length = MIN_MATCH - 1;
      }
      if (prev_length >= MIN_MATCH && match_length <= prev_length) {
        size_t max_insert = strstart + lookahead - MIN_MATCH;
        bool bflush = tally_dist((unsigned)(strstart - 1 - prev_match),
                                 prev_length - MIN_MATCH);
        lookahead -= prev_length - 1;
        prev_length -= 2;
        do {
          ++strstart;
          if (strstart <= max_insert && strstart < m) {
            seek(strstart);
            cnt[hash_of[strstart]]++;
          }
        } while (--prev_length != 0);
        match_available = 0;
        match_length = MIN_MATCH - 1;
        strstart++;
        if (bflush) flush_block(0);
      } else if (match_available) {
        bool bflush = tally_lit(in[strstart - 1]);
        if (bflush) flush_block(0);
        strstart++;
        lookahead--;
      } else {
        match_available = 1;
        strstart++;
        lookahead--;
      }
    }
    if (match_available) tally_lit(in[strstart - 1]);
    flush_block(1);
  }

};

}  // namespace streamdeflate

// zlib's adler32 (RFC 1950): straightforward reimplementation, from the
// checksum of the bytes before p
static uint32_t fd_adler32(const uint8_t* p, size_t n, uint32_t adler = 1) {
  uint32_t a = adler & 0xFFFF, b = adler >> 16;
  while (n > 0) {
    size_t k = n < 5552 ? n : 5552;  // NMAX: max before 32-bit overflow
    n -= k;
    while (k--) {
      a += *p++;
      b += a;
    }
    a %= 65521;
    b %= 65521;
  }
  return (b << 16) | a;
}

// The zlib stream of an input of n bytes that arrives in order: write it
// into fd_stream_input(s) and call fd_stream_feed(s, bytes written so far)
// as it goes; each call runs the matcher as far as the bytes present let
// it. fd_stream_end gives the bytes of zlib's deflate(Z_FINISH) over the
// whole input, zlib wrapper included. seg_min: the
// positions a new set of hash buckets waits for (a feed sorts its bytes
// once that many have arrived; 1 sorts every feed at once).
struct FdStream {
  std::vector<uint8_t> input;  // zero-padded: tail compares read zeros,
                               // as fill_window's WIN_INIT zeroing
  std::vector<uint8_t> out;
  streamdeflate::Compressor c;
  size_t fed = 0;
  uint32_t adler = 1;
  FdStream(size_t n, size_t seg_min)
      : input(n + streamdeflate::MAX_MATCH + 16, 0),
        out{0x78, 0xDA},  // CM=8 CINFO=7; FLEVEL=3 (level 9), FCHECK
        c(input.data(), n, out, seg_min) {}
};

extern "C" void* fd_stream_begin(size_t n, size_t seg_min) {
  try {
    return new FdStream(n, seg_min);
  } catch (const std::bad_alloc&) {
    return nullptr;
  }
}

extern "C" uint8_t* fd_stream_input(void* s) {
  return static_cast<FdStream*>(s)->input.data();
}

// Returns 0, or -1 (no memory, or bytes past the input's end).
extern "C" int fd_stream_feed(void* s, size_t fed) {
  FdStream* st = static_cast<FdStream*>(s);
  if (fed < st->fed || fed > st->c.n) return -1;
  try {
    st->adler = fd_adler32(st->input.data() + st->fed, fed - st->fed,
                           st->adler);
    st->fed = fed;
    st->c.advance(fed, false);
  } catch (const std::bad_alloc&) {
    return -1;
  }
  return 0;
}

// Ends the stream (every byte fed) and frees it: 0 with the zlib stream in
// *out_data (malloc'd), or -1.
extern "C" int fd_stream_end(void* s, uint8_t** out_data, size_t* out_len) {
  FdStream* st = static_cast<FdStream*>(s);
  int rc = -1;
  if (st->fed == st->c.n) {
    try {
      st->c.advance(st->c.n, true);
      uint32_t ad = st->adler;
      st->out.push_back((uint8_t)(ad >> 24));
      st->out.push_back((uint8_t)(ad >> 16));
      st->out.push_back((uint8_t)(ad >> 8));
      st->out.push_back((uint8_t)ad);
      uint8_t* buf = static_cast<uint8_t*>(std::malloc(st->out.size()));
      if (buf) {
        memcpy(buf, st->out.data(), st->out.size());
        *out_data = buf;
        *out_len = st->out.size();
        rc = 0;
      }
    } catch (const std::bad_alloc&) {
    }
  }
  delete st;
  return rc;
}

// Frees a stream that will not be ended.
extern "C" void fd_stream_free(void* s) { delete static_cast<FdStream*>(s); }
