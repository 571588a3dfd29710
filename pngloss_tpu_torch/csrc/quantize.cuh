// Device functions shared by the row kernel (row.cu) and the image kernel
// (image.cu): the per-pixel predictor, the band of candidate symbols, the
// warp-wide symbol selection, the pixel loop of one row under one filter
// with Sierra-lite diffusion, and, for the variants that pick a winner, the
// row cost's histogram part and libpng's MSAD self-check.
//
// One warp quantizes one (image, filter) row. The pixel recurrence is
// sequential, so every lane of the warp runs the same scalar chain in
// registers; only the band scan is spread over the lanes. What bounds it
// is the latency of that chain, W * bpp channel steps per row (band ->
// selection -> histogram update -> next channel; selection -> diffusion
// -> the next pixel's band), not bytes or operations: ablations on an H100
// showed no single part dominating, and a warp issues in order, so what
// the compiler cannot overlap is paid in full. The design:
//   * the pixel body has no branch (see quantize_row_warp), and the
//     filter id is a run-time value with a select-based predictor: one
//     copy of the loop, where one copy per filter overflowed the
//     instruction cache and ran 1.7x slower;
//   * the adaptive histogram lives in registers, 8 entries per lane (lane
//     l holds symbols l, l+32, ..., l+224), so an update is a predicated
//     add in the owning lane: no shared-memory store, no __syncwarp;
//   * the selection takes two warp reductions, not three: the maximum
//     frequency, then the maximum of a 32-bit key (the rank of the
//     original frequency among the filter's 256, computed once per block
//     into shared memory, then "is the original symbol", then the lowest
//     offset); bands wider than the warp (s >= 32) take a separate loop;
//   * a pixel's channels read the histogram as it stood at the pixel's
//     start, in parallel, and patch in the symbols of the channels before
//     them, so only the patch sits between one channel and the next;
//   * the row's inputs are loaded two pixels ahead into registers, so no
//     global load sits between one pixel's symbol and the next band;
//   * the divisions by s+1 and by bleed, fixed for the launch, multiply by
//     an invariant-divisor magic number (plain division ran the row and
//     image kernels 24% slower on an H100; tests/test_torch_divide.py
//     mirrors the arithmetic and holds this code to C division), and the
//     Sierra split runs on magnitudes with one sign restore;
//   * the pixel loop is unrolled by two, so one pixel's diffusion overlaps
//     the next one's bands.
// Integer division is C's: it truncates toward zero, as the reference does.
#pragma once

#include <atomic>
#include <cstdint>
#include <cuda_runtime.h>

namespace plk {

constexpr int kFilters = 5;
constexpr int kWarp = 32;
constexpr int kSlots = 256 / kWarp;   // histogram entries per lane
constexpr unsigned kFull = 0xffffffffu;
// the most rungs a ladder's cluster may have (row.cu, image.cu): the
// largest portable cluster size
constexpr int kMaxRungs = 8;

// Dynamic shared memory each rung of a ladder (row.cu, image.cu) claims and
// leaves unused: more than half of an SM's 228 KB, so no two rungs share an
// SM. With the registers alone the occupancy queries counted 30 clusters of
// 8 where only 15 fit one block to an SM (the row ladder at bpp 1-3, the
// image ladder at bpp 1), and 16 images at k = 8 put one cluster two to an
// SM, whose rounds ran slower (PERF.md §6).
constexpr int kRungClaim = 120 * 1024;
// devices whose claims a caller's flags (claim_shared) keep apart
constexpr int kMaxDevices = 64;

// Lets a ladder kernel take kRungClaim bytes of dynamic shared memory on
// the current device. The attribute holds per device and kernel, so each
// ladder keeps one word of flags a device (claimed, bit bpp for its kernel
// at bpp) and the attribute is set once per device and bpp, at the first
// launch or occupancy query there.
template <typename Kernel>
cudaError_t claim_shared(Kernel kernel, int bpp,
                         std::atomic<unsigned>* claimed) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  const unsigned bit = 1u << bpp;
  if (dev < kMaxDevices && (claimed[dev].load() & bit)) return cudaSuccess;
  err = cudaFuncSetAttribute(reinterpret_cast<const void*>(kernel),
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kRungClaim);
  if (err == cudaSuccess && dev < kMaxDevices) claimed[dev].fetch_or(bit);
  return err;
}

// The launch attribute of a cluster of k blocks along x (the ladders).
inline cudaLaunchAttribute cluster_of(int k) {
  cudaLaunchAttribute attr = {};
  attr.id = cudaLaunchAttributeClusterDimension;
  attr.val.clusterDim.x = static_cast<unsigned>(k);
  attr.val.clusterDim.y = 1;
  attr.val.clusterDim.z = 1;
  return attr;
}

// Exact unsigned division by a divisor fixed for the launch: the
// round-up method of Granlund and Montgomery (1994, fig. 4.1), exact for
// every 32-bit dividend and every divisor >= 1 (tests/test_torch_divide.py).
struct Divisor {
  unsigned m;   // magic multiplier
  int s1, s2;   // shifts
};

__host__ __device__ inline Divisor make_divisor(unsigned d) {
  int l = 0;
  while ((1ull << l) < d) ++l;   // ceil(log2(d))
  const unsigned long long m =
      ((1ull << 32) * ((1ull << l) - d)) / d + 1;
  return Divisor{static_cast<unsigned>(m), l < 1 ? l : 1, l > 1 ? l - 1 : 0};
}

__device__ __forceinline__ unsigned udiv(unsigned n, Divisor d) {
  const unsigned t = __umulhi(n, d.m);
  return (t + ((n - t) >> d.s1)) >> d.s2;
}

// PNG predictor of filter f on quantized neighbour bytes
// (optimize_state.c:575-613), as selects: f is the warp's, and a branch on
// it would split the pixel body.
__device__ __forceinline__ int predict(int f, int above, int diag,
                                       int left) {
  const int p = above - diag, pd = left - diag;
  const int pa = abs(p), pb = abs(pd), pc = abs(p + pd);
  const int paeth = pa <= pb && pa <= pc ? left : (pb <= pc ? above : diag);
  return f == 0 ? 0
       : f == 1 ? left
       : f == 2 ? above
       : f == 3 ? (above + left) >> 1
       : paeth;
}

// Dither lane a channel reads its carried error from: gray+alpha's alpha
// reads lane 3 (color_delta.c:9-39).
template <int BPP>
__device__ __forceinline__ constexpr int dither_lane(int c) {
  return (BPP == 2 && c == 1) ? 3 : c;
}

// Channel feeding dither lane k, or -1 for a lane that stays zero.
template <int BPP>
__device__ __forceinline__ constexpr int lane_source(int k) {
  return BPP == 1 ? (k < 3 ? 0 : -1)
       : BPP == 2 ? (k < 3 ? 0 : 1)
       : BPP == 3 ? (k < 3 ? k : -1)
       : k;
}

// Derivative-error weight of channel c: how many color_delta lanes it feeds.
template <int BPP>
__device__ __forceinline__ constexpr int channel_weight(int c) {
  return BPP == 1 ? 3 : (BPP == 2 ? (c == 0 ? 3 : 1) : 1);
}

__device__ __forceinline__ int lane_of(const int4& v, int k) {
  return k == 0 ? v.x : k == 1 ? v.y : k == 2 ? v.z : v.w;
}

// a[j] for a run-time j in [0, 8): a tree of selects, so the array stays in
// registers.
__device__ __forceinline__ int pick8(const int (&a)[kSlots], int j) {
  const int b0 = j & 1, b1 = j & 2, b2 = j & 4;
  const int l0 = b0 ? a[1] : a[0], l1 = b0 ? a[3] : a[2];
  const int l2 = b0 ? a[5] : a[4], l3 = b0 ? a[7] : a[6];
  const int m0 = b1 ? l1 : l0, m1 = b1 ? l3 : l2;
  return b2 ? m1 : m0;
}

// Turns one filter's original frequencies ofr[0..255], in shared memory,
// into rank keys in place: ofr[t] = #{t' : ofr[t'] < ofr[t]} << 9. The rank
// keeps the order and the ties of the frequencies in 8 bits, so the
// selection's second level fits one 32-bit key. Every lane of the warp
// must call it.
__device__ __forceinline__ void rank_keys(int* ofr, int lane) {
  int o[kSlots], rk[kSlots];
#pragma unroll
  for (int j = 0; j < kSlots; ++j) {
    o[j] = ofr[lane + kWarp * j];
    rk[j] = 0;
  }
  for (int t = 0; t < 256; ++t) {
    const int v = ofr[t];
#pragma unroll
    for (int j = 0; j < kSlots; ++j) rk[j] += v < o[j];
  }
  __syncwarp();
#pragma unroll
  for (int j = 0; j < kSlots; ++j) ofr[lane + kWarp * j] = rk[j] << 9;
  __syncwarp();
}

// The band of candidate symbols for one channel (optimize_state.c:167-210):
// the original residual with the +-256 predictor wrap, truncating division
// by s+1, the clamp to bytes and the exact-saturation fallback.
struct Band {
  int mn;      // lowest candidate symbol (unwrapped)
  int width;   // candidates are mn .. mn+width, width in [0, 255]
  int u_orig;  // offset of the original symbol (may lie outside the band)
  int predw;   // wrapped predictor
};

__device__ __forceinline__ Band make_band(int orig, int here, int pred,
                                          int s, Divisor band) {
  int osym = orig - pred;
  const int predw = pred + (osym < -128 ? -256 : (osym > 127 ? 256 : 0));
  osym = orig - predw;
  const int filt = here - predw;
  const int qb = static_cast<int>(udiv(abs(filt), band)) * (s + 1);
  int mn = filt < 0 ? -qb - s : qb;
  int mx = mn + s;
  if (mn + predw < 0) mn = -predw;
  if (mx + predw > 255) mx = 255 - predw;
  if (mx < mn) {
    if (filt + predw > 255) mn = mx = 255 - predw;
    if (filt + predw < 0) mn = mx = -predw;
  }
  return Band{mn, mx - mn, osym - mn, predw};
}

// What one lane reads for a band narrower than the warp: its one candidate
// u = (lane - start) & 31, symbol t = start + u (t = lane mod 32, so the
// lane owns it), its histogram slot and its rank key.
struct Narrow {
  int u, t, slot;
  bool in;      // u lies in the band
  int fr;       // frequency at the pixel's start
  int key;      // rank key | is-original << 8 | (255 - u)
};

__device__ __forceinline__ Narrow narrow(const Band& bd, int lane,
                                         const int (&h)[kSlots],
                                         const int* rk) {
  const int start = bd.mn & 0xFF;
  Narrow n;
  n.u = (lane - start) & (kWarp - 1);
  n.t = (start + n.u) & 0xFF;
  n.slot = n.t >> 5;
  n.in = n.u <= bd.width;
  n.fr = pick8(h, n.slot);
  n.key = rk[n.t] | (n.u == bd.u_orig ? 256 : 0) | (255 - n.u);
  return n;
}

// Three-level selection (optimize_state.c:212-248) as two reductions:
// highest adaptive frequency, then the highest key (original frequency's
// rank, then the original symbol, then the lowest u). Every lane of the
// warp must call it with its lane-best (frequency, key), -1 for a lane
// with no candidate; all get u_best.
__device__ __forceinline__ int select_u(int bf, int bkey) {
  const int fmax = __reduce_max_sync(kFull, bf);
  const unsigned k = __reduce_max_sync(
      kFull, bf == fmax ? static_cast<unsigned>(bkey) : 0u);
  return 255 - static_cast<int>(k & 0xFF);
}

// Offset of the chosen symbol in a band of any width: lane l scans its 8
// symbols l + 32j (the histogram as it stands now).
__device__ __forceinline__ int select_wide(const Band& bd, int lane,
                                           const int (&h)[kSlots],
                                           const int* rk) {
  const int start = bd.mn & 0xFF;
  int fr[kSlots], key[kSlots];
  int bf = -1;
#pragma unroll
  for (int j = 0; j < kSlots; ++j) {
    const int u = (lane + kWarp * j - start) & 0xFF;
    fr[j] = u <= bd.width ? h[j] : -1;
    key[j] = rk[lane + kWarp * j] | (u == bd.u_orig ? 256 : 0) | (255 - u);
    bf = max(bf, fr[j]);
  }
  int bkey = 0;
#pragma unroll
  for (int j = 0; j < kSlots; ++j)
    if (fr[j] == bf) bkey = max(bkey, key[j]);
  return select_u(bf, bkey);
}

// The row inputs a pixel's band needs, loaded two pixels ahead of it.
template <int BPP>
struct Pixel {
  int above[BPP];            // quantized previous row
  int o[BPP];                // originals
  int4 e0;                   // dither row 0, column x+2 (carried error)
};

template <int BPP, typename OrigT>
__device__ __forceinline__ void load_pixel(Pixel<BPP>& p, int x, int W,
                                           const OrigT* __restrict__ orig,
                                           const int* __restrict__ qprev,
                                           const int* __restrict__ e0) {
  x = min(x, W - 1);   // past the row: a valid column, never used
#pragma unroll
  for (int c = 0; c < BPP; ++c) {
    p.above[c] = qprev[x * BPP + c];
    p.o[c] = static_cast<int>(__ldg(orig + x * BPP + c));
  }
  p.e0 = reinterpret_cast<const int4*>(e0)[x + 2];
}

// Histogram state of one warp: entries lane + 32j in registers, and the
// rank keys of all 256 symbols in shared memory (rank_keys).
struct Hist {
  int h[kSlots];
  const int* rk;
};

// One row of one image under filter f, run by one whole warp
// (optimize_state_row, optimize_state.c:114-313). WIDE: bands may be wider
// than the warp (s >= 32); else every band fits the warp (width <= s).
//
//   orig, oprev  this row's / the previous row's originals (W*BPP);
//                oprev is read only when DERIV
//   qprev        quantized previous row (W*BPP), zeros at row 0
//   e0, e1       dither rows 0 and 1 at row start ((W+5)*4); row 2 is zero
//   hs           this filter's adaptive histogram, updated, and rank keys
//   qrow         out: quantized row (W*BPP)
//   e0n, e1n     out: the next row's dither rows 0 and 1 ((W+5)*4)
//   qcopy        out, when not null: a copy of qprev (W*BPP)
//   wr           real width: pixels x >= wr count in no histogram,
//                diffuse nothing and add no derivative error
//
// Inputs and outputs must not overlap, and the dither rows must be 16-byte
// aligned. The pixel body has no branch: whatever the compiler cannot prove
// warp-uniform would split it into blocks that issue one after another, so
// selections, the transparent-pixel rule and the stores (every lane writes
// the same value) are all selects and straight-line code, and each dither
// lane's diffusion follows its channel's selection, where it overlaps the
// next channel's. The dither rows are never read back while the row runs:
// pixel x's diffusion lands on columns x..x+4 and is consumed within 4
// pixels, so a register window per dither lane holds the pending sums and
// each column of e0n/e1n is written once, when it is final. Returns the
// row's derivative error (optimize_state.c:265-289) when DERIV, else 0.
template <int BPP, bool DERIV, bool WIDE, typename OrigT>
__device__ __forceinline__ long long quantize_row_warp(
    int f, int lane, int s, Divisor band, Divisor bleed, int wr, int W,
    const OrigT* __restrict__ orig, const OrigT* __restrict__ oprev,
    const int* __restrict__ qprev, const int* __restrict__ e0,
    const int* __restrict__ e1, Hist& hs, int* __restrict__ qrow,
    int* __restrict__ e0n, int* __restrict__ e1n,
    int* __restrict__ qcopy) {
  // pa/pb: pending adds to the current row's columns x+2 / x+3 (read back
  // by the carried-error fetch); n1..n4: next row, columns x..x+3;
  // m2/m3: row after next, columns x+1 / x+2
  int pa[4] = {0, 0, 0, 0}, pb[4] = {0, 0, 0, 0};
  int n1[4] = {0, 0, 0, 0}, n2[4] = {0, 0, 0, 0};
  int n3[4] = {0, 0, 0, 0}, n4[4] = {0, 0, 0, 0};
  int m2[4] = {0, 0, 0, 0}, m3[4] = {0, 0, 0, 0};
  int left[BPP], diag[BPP], oleft[BPP], odiag[BPP];
#pragma unroll
  for (int c = 0; c < BPP; ++c) left[c] = diag[c] = oleft[c] = odiag[c] = 0;
  long long err = 0;

  Pixel<BPP> cur, nx1, nx2;
  load_pixel(cur, 0, W, orig, qprev, e0);
  load_pixel(nx1, 1, W, orig, qprev, e0);

#pragma unroll 2
  for (int x = 0; x < W; ++x) {
    load_pixel(nx2, x + 2, W, orig, qprev, e0);
    // read only after this pixel's selections: loaded here, in their shadow
    const int4 seed = reinterpret_cast<const int4*>(e1)[x];
    int op[BPP];
    if constexpr (DERIV) {
#pragma unroll
      for (int c = 0; c < BPP; ++c)
        op[c] = static_cast<int>(__ldg(oprev + x * BPP + c));
    }
    const int cm = x < wr ? 1 : 0;

    // every channel's band and narrow read, from the histogram as it
    // stands at the pixel's start
    Band bd[BPP];
    Narrow nr[BPP];
    int pred[BPP], here[BPP];
#pragma unroll
    for (int c = 0; c < BPP; ++c) {
      pred[c] = predict(f, cur.above[c], diag[c], left[c]);
      here[c] = cur.o[c] + lane_of(cur.e0, dither_lane<BPP>(c)) +
                pa[dither_lane<BPP>(c)];
      bd[c] = make_band(cur.o[c], here[c], pred[c], s, band);
      if constexpr (!WIDE) nr[c] = narrow(bd[c], lane, hs.h, hs.rk);
    }

    int back[BPP], sym[BPP], e0o[4], e1o[4];
#pragma unroll
    for (int c = 0; c < BPP; ++c) {
      int ub;
      if constexpr (WIDE) {
        ub = select_wide(bd[c], lane, hs.h, hs.rk);
      } else {
        // the narrow read, patched with this pixel's earlier symbols
        int fr = nr[c].fr;
#pragma unroll
        for (int p = 0; p < c; ++p) fr += cm & (nr[c].t == sym[p]);
        ub = select_u(nr[c].in ? fr : -1, nr[c].key);
      }
      // fully transparent pixels stay fully transparent; the emitted
      // symbol uses the UNwrapped predictor (optimize_state.c:158-164)
      const bool clear = BPP % 2 == 0 && c == BPP - 1 && cur.o[c] == 0;
      sym[c] = clear ? (0 - pred[c]) & 0xFF : (bd[c].mn + ub) & 0xFF;
      back[c] = clear ? 0 : ub + bd[c].mn + bd[c].predw;
      here[c] = clear ? 0 : here[c];
      // the owning lane counts the symbol
      const bool hit = cm && lane == (sym[c] & (kWarp - 1));
#pragma unroll
      for (int j = 0; j < kSlots; ++j) hs.h[j] += hit && j == (sym[c] >> 5);

      // Sierra-lite diffusion of the dither lanes this channel feeds
      // (diffuse_color_error, optimize_state.c:390-490), on magnitudes:
      // truncating division and the remainder subtractions with positive
      // weights commute with negation, so each part is the magnitude's
      // part with the error's sign
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        if (lane_source<BPP>(k) != c) continue;
        const int n = here[c] - back[c];
        unsigned du = cm ? udiv(abs(n), bleed) : 0u;
        const unsigned tw = du >> 4;
        du -= tw << 2;
        const unsigned th = du >> 3;
        du -= th << 1;
        const unsigned fo = (du << 1) / 9u;
        du -= fo << 1;
        const unsigned fi = du >> 1;
        du -= fi;
        const int sg = n < 0 ? -1 : 1;
        const int twos = sg * static_cast<int>(tw);
        const int threes = sg * static_cast<int>(th);
        const int fours = sg * static_cast<int>(fo);
        const int five = sg * static_cast<int>(fi);
        e0o[k] = lane_of(seed, k) + n1[k] + twos;
        e1o[k] = m2[k] + twos;
        n1[k] = n2[k] + fours;
        n2[k] = n3[k] + five;
        n3[k] = n4[k] + fours;
        n4[k] = twos;
        m2[k] = m3[k] + threes;
        m3[k] = twos;
        pa[k] = pb[k] + sg * static_cast<int>(du);
        pb[k] = threes;
      }
    }
    // a dither lane no channel feeds stays zero: its window only shifts
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (lane_source<BPP>(k) >= 0) continue;
      e0o[k] = lane_of(seed, k) + n1[k];
      e1o[k] = m2[k];
      n1[k] = n2[k];
      n2[k] = n3[k];
      n3[k] = n4[k];
      n4[k] = 0;
      m2[k] = m3[k];
      m3[k] = 0;
      pa[k] = pb[k];
      pb[k] = 0;
    }

    // every lane stores the same values: no branch on the lane
#pragma unroll
    for (int c = 0; c < BPP; ++c) qrow[x * BPP + c] = back[c];
    if (qcopy) {
#pragma unroll
      for (int c = 0; c < BPP; ++c) qcopy[x * BPP + c] = cur.above[c];
    }
    reinterpret_cast<int4*>(e0n)[x] = make_int4(e0o[0], e0o[1], e0o[2], e0o[3]);
    reinterpret_cast<int4*>(e1n)[x + 1] =
        make_int4(e1o[0], e1o[1], e1o[2], e1o[3]);
    if constexpr (DERIV) {
      int e = 0;
#pragma unroll
      for (int c = 0; c < BPP; ++c) {
        const int da = (back[c] - cur.above[c]) - (cur.o[c] - op[c]);
        const int dd = (back[c] - diag[c]) - (cur.o[c] - odiag[c]);
        const int dl = (back[c] - left[c]) - (cur.o[c] - oleft[c]);
        e += channel_weight<BPP>(c) * (da * da + dd * dd + dl * dl);
        odiag[c] = op[c];
      }
      err += cm * e;
    }
#pragma unroll
    for (int c = 0; c < BPP; ++c) {
      left[c] = back[c];
      diag[c] = cur.above[c];
      oleft[c] = cur.o[c];
    }
    cur = nx1;
    nx1 = nx2;
  }
  // flush the windows: e0n columns W..W+3 get their pendings over the
  // seed, column W+4 is the seed alone; e1n columns W+1 / W+2 are the
  // pendings, columns 0, W+3 and W+4 receive nothing
  if (lane == 0) {
    const int4* e1v = reinterpret_cast<const int4*>(e1);
    int4* e0nv = reinterpret_cast<int4*>(e0n);
    int4* e1nv = reinterpret_cast<int4*>(e1n);
    const int4 s0 = e1v[W], s1 = e1v[W + 1], s2 = e1v[W + 2];
    const int4 s3 = e1v[W + 3], s4 = e1v[W + 4];
    e0nv[W] = make_int4(s0.x + n1[0], s0.y + n1[1], s0.z + n1[2],
                        s0.w + n1[3]);
    e0nv[W + 1] = make_int4(s1.x + n2[0], s1.y + n2[1], s1.z + n2[2],
                            s1.w + n2[3]);
    e0nv[W + 2] = make_int4(s2.x + n3[0], s2.y + n3[1], s2.z + n3[2],
                            s2.w + n3[3]);
    e0nv[W + 3] = make_int4(s3.x + n4[0], s3.y + n4[1], s3.z + n4[2],
                            s3.w + n4[3]);
    e0nv[W + 4] = s4;
    e1nv[0] = make_int4(0, 0, 0, 0);
    e1nv[W + 1] = make_int4(m2[0], m2[1], m2[2], m2[3]);
    e1nv[W + 2] = make_int4(m3[0], m3[1], m3[2], m3[3]);
    e1nv[W + 3] = make_int4(0, 0, 0, 0);
    e1nv[W + 4] = make_int4(0, 0, 0, 0);
  }
  __syncwarp();
  return err;
}

// Does filter f pass libpng's MSAD heuristic on its candidate row q
// (adaptive_filter_for_rows, optimize_state.c:492-562)? The 5 trial sums
// of |residual| (as a signed byte) over the real columns, lane-strided,
// then summed over the warp; ties go to the earliest trial. Every lane of
// the warp must call it; all get the answer.
template <int BPP>
__device__ bool msad_passes(int f, int lane, int wr,
                            const int* __restrict__ q,
                            const int* __restrict__ qprev) {
  int sums[kFilters] = {0, 0, 0, 0, 0};
  for (int x = lane; x < wr; x += kWarp) {
#pragma unroll
    for (int c = 0; c < BPP; ++c) {
      const int i = x * BPP + c;
      const int v = q[i];
      const int above = qprev[i];
      const int left = x ? q[i - BPP] : 0;
      const int diag = x ? qprev[i - BPP] : 0;
#pragma unroll
      for (int t = 0; t < kFilters; ++t) {
        const int r = (v - predict(t, above, diag, left)) & 0xFF;
        sums[t] += r < 128 ? r : 256 - r;
      }
    }
  }
  int best = 0, best_sum = 0;
#pragma unroll
  for (int t = 0; t < kFilters; ++t) {
    const int total = __reduce_add_sync(kFull, sums[t]);
    if (t == 0 || total < best_sum) {
      best = t;
      best_sum = total;
    }
  }
  return best == f;
}

// The histogram part of one candidate's row cost (optimize_state.c:314-361):
// sum over the symbols t of (hist_out - hist_in)[t] * (33 + clz(hist_out[t]))
// = 65 - bitlength, from the warp's histogram after the row (hs) and the
// histogram at row start (hw, entries lane + 32j as in hs), summed over the
// warp in 64 bits. Every lane of the warp must call it; all get the sum.
__device__ __forceinline__ long long row_bits(const Hist& hs, const int* hw,
                                              int lane) {
  long long bits = 0;
#pragma unroll
  for (int j = 0; j < kSlots; ++j) {
    const int fr = hs.h[j];
    if (fr > 0)
      bits += static_cast<long long>(fr - hw[lane + kWarp * j]) *
              (33 + __clz(fr));
  }
  for (int off = kWarp / 2; off > 0; off /= 2)
    bits += __shfl_xor_sync(kFull, bits, off);
  return bits;
}

// quantize_row_warp with the selection the block's strength needs: every
// band fits the warp when s < 32.
template <int BPP, bool DERIV, typename OrigT>
__device__ __forceinline__ long long quantize_row(
    int f, int lane, int s, Divisor band, Divisor bleed, int wr, int W,
    const OrigT* __restrict__ orig, const OrigT* __restrict__ oprev,
    const int* __restrict__ qprev, const int* __restrict__ e0,
    const int* __restrict__ e1, Hist& hs, int* __restrict__ qrow,
    int* __restrict__ e0n, int* __restrict__ e1n,
    int* __restrict__ qcopy) {
  if (s < kWarp)
    return quantize_row_warp<BPP, DERIV, false, OrigT>(
        f, lane, s, band, bleed, wr, W, orig, oprev, qprev, e0, e1, hs,
        qrow, e0n, e1n, qcopy);
  return quantize_row_warp<BPP, DERIV, true, OrigT>(
      f, lane, s, band, bleed, wr, W, orig, oprev, qprev, e0, e1, hs, qrow,
      e0n, e1n, qcopy);
}

}  // namespace plk
