// Rows 1..H-1 of every image in one launch, in CLI mode, in embedding
// mode's speculation and in embedding mode's per-row path.
//
// Replaces the TPU kernel pngloss_tpu/ops/pallas_image.py:_image_kernel
// (launched by image_rows_pallas), both variants, and the device program
// the JAX package runs around its row kernel in embedding mode:
//   image_kernel, adaptive=False (CLI mode): only row 0 runs the MSAD
//     self-check, so rows >= 1 never fall back to a lower strength;
//   image_kernel, adaptive=True (embedding mode's speculation): every row
//     runs libpng's MSAD self-check at full strength; a failing candidate
//     costs LLONG_MAX (UINTMAX_MAX in the C code), and a per-image ok flag
//     is cleared by any row where no filter passes. Such a row carries on
//     with filter 0, as the TPU kernel does; the caller re-runs its image
//     through the per-row path;
//   ladder_kernel (embedding mode's per-row path, the scan over rows with
//     a while_loop over the strength of
//     pngloss_tpu/ops/optimize_pallas.py:optimize_batch_pallas_t): every
//     row starts at the image's full strength s; while no filter passes
//     the self-check and the strength is above 0, the row runs again one
//     strength lower; at strength 0 with no passing filter the minimum
//     true cost wins (where the C tool would abort). It never fails; it
//     reports the row attempts each image took, as that sequential loop
//     counts them. At strength 0 the 5 candidates are one row, whose MSAD
//     choice is one of them, so no real input reaches the strength-0
//     branch: the test-only never_pass flag fails every filter of an
//     image's rows, which then take the branch (in the adaptive variant,
//     the image's ok is 0).
// Every block or cluster stops at its image's last real row (h_real): a
// padded row neither clears ok nor retries, and its output row and filter
// are written as 0.
//
// Per row: each filter's candidate (the per-pixel math of the row kernel,
// quantize.cuh), its cost sum_t (hist_out - hist_in)[t] *
// (33 + clz(hist_out[t])) plus the derivative error / 128 (accumulated
// exactly in 64 bits), the minimum-cost winner with ties to the lowest
// filter, and the winner's row, histogram and dither rows carried on.
//
// Bound: the same per-channel latency chain as the row kernel, (H-1) * W *
// bpp steps long per image and attempt, so the time of one image is
// latency, not bytes or operations; the card is filled by running images
// (and, in the ladder, strengths) side by side on SMs of their own. The
// MSAD pass adds one read of the candidate row and the previous row per
// warp, lane-strided and off the chain.
//
// image_kernel: one block per image, one warp per filter, quantize.cuh's
// chain per warp (histogram in registers, two-reduction selection, inputs
// two pixels ahead, invariant divisors). The winner's state passes by
// index: each filter writes its candidate row and next dither rows into
// one of two global sets, and the next row reads the winner's set in
// place while writing the other. After each row the block meets once to
// post the costs; every thread picks the first minimum itself, the winning
// warp posts its histogram through shared memory, and the block meets
// again. The winner's row goes on to qrows off the chain: the warps store
// it (the same values) while they read it as the next row's previous row.
// The TPU kernel's lane rolls, selection matmuls and bf16 tricks are TPU
// forms of this broadcast and are not needed here.
//
// split::image_kernel, CLI mode for launches whose images each fit a cluster
// of their own (ops/image.pick_split): the same chain, one image per
// thread-block cluster of 2 blocks of 4 warps, each block on an SM of its
// own. Block 0 runs filters 0-3, one warp on each of the SM's four
// schedulers; block 1 runs filter 4, and its other three warps only copy and
// meet. In image_kernel two of the five warps share a scheduler. On an H100
// the 2-block layout took 16-17% less time than image_kernel over the rows
// of a 1920x1080 screenshot, 5 one-warp blocks on 5 SMs no less, and 5
// blocks of 4 warps, one of them running, 14% less (PERF.md §6). The launch bound asks for one block per SM, and each
// block claims more than half of the SM's shared memory (plk::kRungClaim), as
// a ladder rung does, so no two blocks share an SM.
// Per row: each running warp posts its cost to its block's shared memory and
// the cluster meets (barrier.cluster); every thread reads the five costs,
// over distributed shared memory where another block holds them, and picks
// the same first minimum; the winning warp posts its histogram and the
// cluster meets again. The winner's block reads the winner's set in place, as
// image_kernel does; the other block copies the histogram over distributed
// shared memory, and the winner's row and next dither rows from the winner's
// global set into its own first filter's set, which its warps then read. The
// copy reads with ld.global.cg, coherent across SMs and ordered by the
// barrier's release and acquire, because the chain reads its previous row
// through const __restrict__ pointers that may compile to non-coherent loads,
// which the barrier does not order (as in ladder_kernel below): the chain
// only ever reads rows its own block wrote. Only the winner writes filt; the
// previous row's winner's block copies that row to qrows off its chain, and
// block 0 writes the padded rows. Where the launch passes a carry, the last
// row's winner's block also writes the state that row leaves (its histogram,
// next dither rows and row), so that a later launch
// on the rows after it continues the chain: a one-image call runs its rows in
// bands, each band's rows final and copied to the host while the next runs.
//
// ladder_kernel: the attempts of one row at strengths s, s-1, ... all start
// from the same state (the previous row's winner row, dither rows and
// histogram), so they are independent; the loop keeps the first of them, in
// descending strength, with a passing filter. A thread-block cluster of k
// blocks ("rungs") runs one image and k strengths at once: in round j of a
// row, rung r runs strength s - j*k - r (a rung below 0 runs nothing and
// passes nothing) as one block of the image kernel's shape, each rung on an SM
// of its own (a sixth warp on an SM's four schedulers would slow the chain,
// where the SMs a one-block-per-image launch leaves idle cost nothing): the
// launch bound asks for one block per SM, and each rung claims more than half
// of the SM's shared memory (plk::kRungClaim; at bpp 1 the registers alone let
// two blocks in). After a round the cluster meets (barrier.cluster) and every
// block reads all rungs' passing flags and costs from their shared memory
// (distributed shared memory) and picks the same winner: the lowest rung with
// a passing filter, its first passing minimum; where none passes and the round
// reached strength 0, the strength-0 rung with its minimum true cost;
// otherwise every rung reloads the histogram at row start and runs the next
// round. Rounds write alternating cost and flag buffers, so a round's flags
// are never rewritten before every block has read them. The winning warp posts
// its histogram to its block's shared memory and the cluster meets again;
// every other block copies that histogram over distributed shared memory, and
// the winner's row and dither rows from the winner rung's global set into its
// own set (same filter slot), which the next row then reads in place. That
// copy is what makes the next row correct on every rung: cluster::sync() is
// barrier.cluster.arrive.release followed by barrier.cluster.wait.acquire, so
// every global and shared store a block makes before it arrives happens before
// every load another block of the cluster makes after its wait (PTX memory
// model, cluster scope). Those loads must be ordinary coherent ones: the chain
// reads its previous row through const __restrict__ pointers, which the
// compiler may turn into non-coherent loads (ld.global.nc) that the barrier
// does not cover, so the chain only ever reads rows its own block wrote, as in
// image_kernel, and the copy reads the other rung's set with ld.global.cg (L2,
// coherent across SMs). The winner rung reads its own set and copies nothing;
// at k = 1 nothing is ever copied and the kernel does what the one-block retry
// loop did. The sequential count of attempts, s - s_win + 1 a row, is j*k + r
// + 1 for rung r winning round j; rounds per row are ceil(attempts / k). Only
// the winner rung writes qrows (the previous row's winner copies that row off
// its chain, as in image_kernel) and filt; rung 0 writes attempts, rounds and
// the padded rows.

#include <atomic>
#include <climits>
#include <cstdint>
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "quantize.cuh"

namespace cg = cooperative_groups;

namespace {

// Block set-up shared by both kernels: the rank keys of image b's original
// frequencies into os, the histogram at row 1's start into hw and into the
// warp's registers.
__device__ __forceinline__ void load_block(int b, int tid, int f, int lane,
                                           const int* __restrict__ ofreq,
                                           const int* __restrict__ hist0,
                                           int (*os)[256], int* hw,
                                           plk::Hist& hs) {
  for (int i = tid; i < plk::kFilters * 256; i += blockDim.x)
    os[i / 256][i % 256] = ofreq[b * plk::kFilters * 256 + i];
  __syncthreads();
  plk::rank_keys(os[f], lane);
  hs.rk = os[f];
  for (int i = tid; i < 256; i += blockDim.x) hw[i] = hist0[b * 256 + i];
  __syncthreads();
#pragma unroll
  for (int j = 0; j < plk::kSlots; ++j) hs.h[j] = hw[lane + plk::kWarp * j];
}

// The rows of image b after its last real row hr - 1 (qrows rows hr-1 ..
// H-2 and their filters) as 0: no row runs there.
__device__ __forceinline__ void zero_padded(int b, int hr, int H,
                                            long long wb, int tid,
                                            int* __restrict__ qrows,
                                            int* __restrict__ filt) {
  int* my_q = qrows + b * wb * (H - 1);
  for (long long i = (hr - 1) * wb + tid; i < (H - 1) * wb; i += blockDim.x)
    my_q[i] = 0;
  for (int y = hr - 1 + tid; y < H - 1; y += blockDim.x)
    filt[static_cast<long long>(b) * (H - 1) + y] = 0;
}

template <int BPP, bool ADAPTIVE>
__global__ void __launch_bounds__(plk::kFilters * plk::kWarp)
image_kernel(const int* __restrict__ s, int bleed,
             const int* __restrict__ w_real, const int* __restrict__ h_real,
             const int* __restrict__ ofreq,
             const uint8_t* __restrict__ rows,
             const int* __restrict__ qprev0, const int* __restrict__ e00,
             const int* __restrict__ e10, const int* __restrict__ hist0,
             int* __restrict__ qrows, int* __restrict__ filt,
             int* __restrict__ ok, const int* __restrict__ never_pass,
             int* cand, int* e0n5, int* e1n5, int B, int H, int W) {
  __shared__ int os[plk::kFilters][256];      // rank keys (rank_keys)
  __shared__ int hw[256];                     // histogram at row start
  __shared__ long long cost[plk::kFilters];
  __shared__ bool passing[plk::kFilters];

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int f = tid / plk::kWarp;
  const int lane = tid % plk::kWarp;
  const long long wb = static_cast<long long>(W) * BPP;
  const long long we = static_cast<long long>(W + 5) * 4;
  const int sb = s[b], wr = w_real[b];
  const int hr = min(max(h_real[b], 1), H);
  const plk::Divisor band = plk::make_divisor(sb + 1);
  const plk::Divisor bl = plk::make_divisor(bleed);
  const uint8_t* img = rows + b * wb * H;
  int* my_q = qrows + b * wb * (H - 1);
  // candidate k's row and next dither rows in set p (two sets, ping-pong)
  auto set = [&](int p, int k) {
    return (static_cast<long long>(p) * B + b) * plk::kFilters + k;
  };
  int all_rows_pass = 1;                      // read by thread 0 only

  plk::Hist hs;
  load_block(b, tid, f, lane, ofreq, hist0, os, hw, hs);

  const int* qprev = qprev0 + b * wb;
  const int* e0 = e00 + b * we;
  const int* e1 = e10 + b * we;
  for (int y = 1, p = 0; y < hr; ++y, p ^= 1) {
    const long long mine = set(p, f);
    int* qrow = cand + mine * wb;
    const long long err = plk::quantize_row<BPP, true, uint8_t>(
        f, lane, sb, band, bl, wr, W, img + y * wb, img + (y - 1) * wb,
        qprev, e0, e1, hs, qrow, e0n5 + mine * we, e1n5 + mine * we,
        y >= 2 ? my_q + (y - 2) * wb : nullptr);
    const long long bits = plk::row_bits(hs, hw, lane);
    bool pass = true;
    if constexpr (ADAPTIVE) {
      // every lane stored the same values of the candidate row, and
      // quantize_row_warp ends in __syncwarp, so the whole warp sees them;
      // never_pass (test-only, null in production) is read here, per row
      // and off the chain
      pass = plk::msad_passes<BPP>(f, lane, wr, qrow, qprev) &&
             !(never_pass && never_pass[b]);
    }
    if (lane == 0) {
      cost[f] = pass ? bits + err / 128 : LLONG_MAX;
      passing[f] = pass;
    }
    __syncthreads();
    int best = 0;
#pragma unroll
    for (int k = 1; k < plk::kFilters; ++k)
      if (cost[k] < cost[best]) best = k;
    if (f == best) {
#pragma unroll
      for (int j = 0; j < plk::kSlots; ++j)
        hw[lane + plk::kWarp * j] = hs.h[j];
    }
    if (tid == 0) {
      filt[static_cast<long long>(b) * (H - 1) + y - 1] = best;
      if constexpr (ADAPTIVE) {
        bool any = false;
        for (int k = 0; k < plk::kFilters; ++k) any = any || passing[k];
        if (!any) all_rows_pass = 0;
      }
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < plk::kSlots; ++j) hs.h[j] = hw[lane + plk::kWarp * j];
    const long long won = set(p, best);
    qprev = cand + won * wb;
    e0 = e0n5 + won * we;
    e1 = e1n5 + won * we;
  }
  // the last real row's winner, which no later row copies
  if (hr >= 2)
    for (long long i = tid; i < wb; i += blockDim.x)
      my_q[(hr - 2) * wb + i] = qprev[i];
  zero_padded(b, hr, H, wb, tid, qrows, filt);
  if (ADAPTIVE && tid == 0) ok[b] = all_rows_pass;
}

// n elements of T from src, which another block of the cluster wrote before
// the barrier, to dst, by the block: coherent loads (ld.global.cg), kAhead in
// flight per thread.
template <typename T>
__device__ __forceinline__ void copy_coherent(T* __restrict__ dst,
                                              const T* src, long long n,
                                              int tid) {
  constexpr int kAhead = 4;
  const int nt = blockDim.x;
  long long i = tid;
  for (; i + (kAhead - 1) * nt < n; i += kAhead * nt) {
    T v[kAhead];
#pragma unroll
    for (int u = 0; u < kAhead; ++u) v[u] = __ldcg(src + i + u * nt);
#pragma unroll
    for (int u = 0; u < kAhead; ++u) dst[i + u * nt] = v[u];
  }
  for (; i < n; i += nt) dst[i] = __ldcg(src + i);
}

namespace split {

// filters a block runs, one a warp: block 0 runs filters 0-3, block 1
// filter 4 (its other warps only copy and meet)
constexpr int kPerBlock = 4;
constexpr int kBlocks = (plk::kFilters + kPerBlock - 1) / kPerBlock;
constexpr int kThreads = kPerBlock * plk::kWarp;

// One image per cluster of kBlocks blocks; see the header. cand, e0n5, e1n5
// hold one set per (ping-pong parity, image, filter), as for the one-block
// kernel.
template <int BPP>
__global__ void __launch_bounds__(kThreads, 1)
image_kernel(const int* __restrict__ s, int bleed,
             const int* __restrict__ w_real, const int* __restrict__ h_real,
             const int* __restrict__ ofreq,
             const uint8_t* __restrict__ rows,
             const int* __restrict__ qprev0, const int* __restrict__ e00,
             const int* __restrict__ e10, const int* __restrict__ hist0,
             int* __restrict__ qrows, int* __restrict__ filt, int* carry,
             int* cand, int* e0n5, int* e1n5, int B, int H, int W) {
  __shared__ int os[plk::kFilters][256];      // rank keys (rank_keys)
  __shared__ int hw[256];                     // histogram at row start
  __shared__ long long cost[kPerBlock];       // this block's filters' costs

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int b = blockIdx.x / kBlocks;
  const int tid = threadIdx.x;
  const int warp = tid / plk::kWarp;
  const int lane = tid % plk::kWarp;
  const int f = rank * kPerBlock + warp;
  const bool runs = f < plk::kFilters;        // warp-uniform
  const long long wb = static_cast<long long>(W) * BPP;
  const long long we = static_cast<long long>(W + 5) * 4;
  const int sb = s[b], wr = w_real[b];
  const int hr = min(max(h_real[b], 1), H);
  const plk::Divisor band = plk::make_divisor(sb + 1);
  const plk::Divisor bl = plk::make_divisor(bleed);
  const uint8_t* img = rows + b * wb * H;
  int* my_q = qrows + b * wb * (H - 1);
  // candidate k's row and next dither rows in set p (two sets, ping-pong)
  auto set = [&](int p, int k) {
    return (static_cast<long long>(p) * B + b) * plk::kFilters + k;
  };

  // load_block, but only the warps that run a filter rank its keys
  for (int i = tid; i < plk::kFilters * 256; i += kThreads)
    os[i / 256][i % 256] = ofreq[b * plk::kFilters * 256 + i];
  __syncthreads();
  plk::Hist hs;
  if (runs) plk::rank_keys(os[f], lane);
  hs.rk = os[runs ? f : 0];
  for (int i = tid; i < 256; i += kThreads) hw[i] = hist0[b * 256 + i];
  __syncthreads();
#pragma unroll
  for (int j = 0; j < plk::kSlots; ++j) hs.h[j] = hw[lane + plk::kWarp * j];

  const int* qprev = qprev0 + b * wb;
  const int* e0 = e00 + b * we;
  const int* e1 = e10 + b * we;
  int prev_win = 0;                           // filter that won row y-1
  for (int y = 1, p = 0; y < hr; ++y, p ^= 1) {
    if (runs) {
      const long long mine = set(p, f);
      const long long err = plk::quantize_row<BPP, true, uint8_t>(
          f, lane, sb, band, bl, wr, W, img + y * wb, img + (y - 1) * wb,
          qprev, e0, e1, hs, cand + mine * wb, e0n5 + mine * we,
          e1n5 + mine * we,
          y >= 2 && rank == prev_win / kPerBlock ? my_q + (y - 2) * wb
                                                 : nullptr);
      const long long bits = plk::row_bits(hs, hw, lane);
      if (lane == 0) cost[warp] = bits + err / 128;
    }
    cluster.sync();
    long long c[plk::kFilters];
#pragma unroll
    for (int k = 0; k < plk::kFilters; ++k)
      c[k] = *cluster.map_shared_rank(&cost[k % kPerBlock], k / kPerBlock);
    int best = 0;
#pragma unroll
    for (int k = 1; k < plk::kFilters; ++k)
      if (c[k] < c[best]) best = k;
    const int win = best / kPerBlock;         // the winner's block
    if (runs && f == best) {
#pragma unroll
      for (int j = 0; j < plk::kSlots; ++j)
        hw[lane + plk::kWarp * j] = hs.h[j];
      if (lane == 0) filt[static_cast<long long>(b) * (H - 1) + y - 1] = best;
    }
    cluster.sync();
    // the set this block's warps read next: the winner's where it ran here,
    // else the block's first filter's, filled by a copy
    long long next = set(p, best);
    if (rank != win) {                        // block-uniform
      next = set(p, rank * kPerBlock);
      const int* rhw = cluster.map_shared_rank(hw, win);
      for (int i = tid; i < 256; i += kThreads) hw[i] = rhw[i];
      const long long src = set(p, best);
      if (wb % 4 == 0)
        copy_coherent(reinterpret_cast<int4*>(cand + next * wb),
                      reinterpret_cast<const int4*>(cand + src * wb), wb / 4,
                      tid);
      else
        copy_coherent(cand + next * wb, cand + src * wb, wb, tid);
      copy_coherent(reinterpret_cast<int4*>(e0n5 + next * we),
                    reinterpret_cast<const int4*>(e0n5 + src * we), W + 5,
                    tid);
      copy_coherent(reinterpret_cast<int4*>(e1n5 + next * we),
                    reinterpret_cast<const int4*>(e1n5 + src * we), W + 5,
                    tid);
    }
    __syncthreads();
#pragma unroll
    for (int j = 0; j < plk::kSlots; ++j) hs.h[j] = hw[lane + plk::kWarp * j];
    prev_win = best;
    qprev = cand + next * wb;
    e0 = e0n5 + next * we;
    e1 = e1n5 + next * we;
  }
  // the last real row's winner, which no later row copies
  if (hr >= 2 && rank == prev_win / kPerBlock)
    for (long long i = tid; i < wb; i += kThreads)
      my_q[(hr - 2) * wb + i] = qprev[i];
  // the state the last real row leaves (row 0's, where no row ran): the B
  // histograms, then the B next dither rows e0, the B e1 and the B rows
  if (carry && rank == prev_win / kPerBlock) {
    for (int i = tid; i < 256; i += kThreads) carry[b * 256 + i] = hw[i];
    int4* c0 = reinterpret_cast<int4*>(carry + B * 256LL + b * we);
    int4* c1 = reinterpret_cast<int4*>(carry + B * (256LL + we) + b * we);
    const int4* s0 = reinterpret_cast<const int4*>(e0);
    const int4* s1 = reinterpret_cast<const int4*>(e1);
    for (int i = tid; i < W + 5; i += kThreads) {
      c0[i] = s0[i];
      c1[i] = s1[i];
    }
    int* cq = carry + B * (256LL + 2 * we) + b * wb;
    for (long long i = tid; i < wb; i += kThreads) cq[i] = qprev[i];
  }
  if (rank == 0) zero_padded(b, hr, H, wb, tid, qrows, filt);
  // no block may leave while another can still read its shared memory
  cluster.sync();
}

}  // namespace split

using SplitFn = void (*)(const int*, int, const int*, const int*, const int*,
                         const uint8_t*, const int*, const int*, const int*,
                         const int*, int*, int*, int*, int*, int*, int*, int,
                         int, int);

cudaError_t split_kernel_of(int bpp, SplitFn* kernel) {
  switch (bpp) {
    case 1: *kernel = split::image_kernel<1>; break;
    case 2: *kernel = split::image_kernel<2>; break;
    case 3: *kernel = split::image_kernel<3>; break;
    case 4: *kernel = split::image_kernel<4>; break;
    default: return cudaErrorInvalidValue;
  }
  return cudaSuccess;
}

// the split kernel's shared-memory claims (plk::claim_shared)
std::atomic<unsigned> split_claimed[plk::kMaxDevices];

// The split kernel at bpp and its launch configuration for B images, its
// shared-memory claim made on the current device.
cudaError_t split_config(int bpp, int B, SplitFn* kernel,
                         cudaLaunchAttribute* attr, cudaLaunchConfig_t* cfg) {
  cudaError_t err = split_kernel_of(bpp, kernel);
  if (err == cudaSuccess) err = plk::claim_shared(*kernel, bpp, split_claimed);
  if (err != cudaSuccess) return err;
  *attr = plk::cluster_of(split::kBlocks);
  *cfg = {};
  cfg->gridDim = dim3(static_cast<unsigned>(B) * split::kBlocks);
  cfg->blockDim = dim3(split::kThreads);
  cfg->dynamicSmemBytes = plk::kRungClaim;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  return cudaSuccess;
}

// One image per cluster of k rungs (the cluster's size); see the header.
// cand, e0n5, e1n5 hold one set per (ping-pong parity, image, rung,
// filter). Strengths below 0 count as 0. A rung wants an SM of its own, so
// the launch bound asks for one block per SM, which leaves ptxas the
// registers to keep the chain out of local memory (at bpp 3, nvcc 12.9:
// 194 registers and no spill; 168 and a spill without the minimum), and
// the launch claims plk::kRungClaim bytes of shared memory.
template <int BPP>
__global__ void __launch_bounds__(plk::kFilters * plk::kWarp, 1)
ladder_kernel(const int* __restrict__ s, int bleed,
              const int* __restrict__ w_real, const int* __restrict__ h_real,
              const int* __restrict__ ofreq,
              const uint8_t* __restrict__ rows,
              const int* __restrict__ qprev0, const int* __restrict__ e00,
              const int* __restrict__ e10, const int* __restrict__ hist0,
              int* __restrict__ qrows, int* __restrict__ filt,
              int* __restrict__ attempts, int* __restrict__ rounds,
              const int* __restrict__ never_pass, int* cand, int* e0n5,
              int* e1n5, int B, int H, int W) {
  __shared__ int os[plk::kFilters][256];      // rank keys (rank_keys)
  __shared__ int hw[256];                     // histogram at row start
  // per round parity: each filter's cost, and its pass flag in byte f of
  // one word (bytes 5-7 stay 0), so a rung's flags are one remote load
  __shared__ long long cost[2][plk::kFilters];
  __shared__ unsigned long long passing[2];
  __shared__ int tally[2];                    // attempts, rounds

  cg::cluster_group cluster = cg::this_cluster();
  const int k = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int b = blockIdx.x / k;
  const int tid = threadIdx.x;
  const int f = tid / plk::kWarp;
  const int lane = tid % plk::kWarp;
  const long long wb = static_cast<long long>(W) * BPP;
  const long long we = static_cast<long long>(W + 5) * 4;
  const int sb = max(s[b], 0), wr = w_real[b];
  const int hr = min(max(h_real[b], 1), H);
  const plk::Divisor bl = plk::make_divisor(bleed);
  const uint8_t* img = rows + b * wb * H;
  int* my_q = qrows + b * wb * (H - 1);
  // rung r's candidate g row and next dither rows in set p (ping-pong)
  auto set = [&](int p, int r, int g) {
    return ((static_cast<long long>(p) * B + b) * k + r) * plk::kFilters + g;
  };
  if (tid == 0) {
    passing[0] = passing[1] = 0;
    tally[0] = tally[1] = 0;
  }
  plk::Hist hs;
  load_block(b, tid, f, lane, ofreq, hist0, os, hw, hs);

  const int* qprev = qprev0 + b * wb;
  const int* e0 = e00 + b * we;
  const int* e1 = e10 + b * we;
  int par = 0;                                // buffer this round writes
  int prev_win = 0;                           // rung that won row y-1
  for (int y = 1, p = 0; y < hr; ++y, p ^= 1) {
    const long long mine = set(p, rank, f);
    int* qrow = cand + mine * wb;
    int j = 0, win;
    for (;;) {
      const int sr = sb - j * k - rank;       // block-uniform
      long long c = LLONG_MAX;
      bool pass = false;
      if (sr >= 0) {
        const long long err = plk::quantize_row<BPP, true, uint8_t>(
            f, lane, sr, plk::make_divisor(sr + 1), bl, wr, W, img + y * wb,
            img + (y - 1) * wb, qprev, e0, e1, hs, qrow, e0n5 + mine * we,
            e1n5 + mine * we,
            j == 0 && rank == prev_win && y >= 2 ? my_q + (y - 2) * wb
                                                 : nullptr);
        // the true cost: the strength-0 rung may win with no filter passing
        c = plk::row_bits(hs, hw, lane) + err / 128;
        // never_pass (test-only, null in production) is read per attempt,
        // off the chain: held in a register across the rows it cost the
        // one-block retry loop 1.6% through a spill
        pass = plk::msad_passes<BPP>(f, lane, wr, qrow, qprev) &&
               !(never_pass && never_pass[b]);
      }
      if (lane == 0) {
        cost[par][f] = c;
        reinterpret_cast<unsigned char*>(&passing[par])[f] = pass;
      }
      cluster.sync();
      unsigned found = 0;                     // bit r: rung r passed
#pragma unroll
      for (int r = 0; r < plk::kMaxRungs; ++r)
        if (r < k && *cluster.map_shared_rank(&passing[par], r))
          found |= 1u << r;
      win = found ? __ffs(found) - 1 : -1;
      if (win < 0 && sb - j * k - (k - 1) <= 0)
        win = sb - j * k;                     // give up: the strength-0 rung
      if (win >= 0) break;
      // no rung passed above strength 0: every rung runs the row again, k
      // strengths lower, from the histogram at row start
      par ^= 1;
      ++j;
#pragma unroll
      for (int i = 0; i < plk::kSlots; ++i)
        hs.h[i] = hw[lane + plk::kWarp * i];
    }
    // the winner rung's first minimum, failing filters out unless none
    // passed (the give-up branch keeps the true costs)
    const unsigned long long wp = *cluster.map_shared_rank(&passing[par], win);
    const long long* wc = cluster.map_shared_rank(cost[par], win);
    int best = 0;
    long long least = 0;
#pragma unroll
    for (int g = 0; g < plk::kFilters; ++g) {
      const long long ck = (wp && !((wp >> (8 * g)) & 0xff)) ? LLONG_MAX
                                                             : wc[g];
      if (g == 0 || ck < least) {
        best = g;
        least = ck;
      }
    }
    par ^= 1;
    if (rank == win && f == best) {
#pragma unroll
      for (int i = 0; i < plk::kSlots; ++i)
        hw[lane + plk::kWarp * i] = hs.h[i];
    }
    if (tid == 0) {
      if (rank == win) filt[static_cast<long long>(b) * (H - 1) + y - 1] = best;
      tally[0] += j * k + win + 1;
      tally[1] += j + 1;
    }
    cluster.sync();
    const long long won = set(p, rank, best);
    if (rank != win) {                        // block-uniform
      const int* rhw = cluster.map_shared_rank(hw, win);
      for (int i = tid; i < 256; i += blockDim.x) hw[i] = rhw[i];
      const long long src = set(p, win, best);
      for (long long i = tid; i < wb; i += blockDim.x)
        cand[won * wb + i] = __ldcg(cand + src * wb + i);
      const int4* s0 = reinterpret_cast<const int4*>(e0n5 + src * we);
      const int4* s1 = reinterpret_cast<const int4*>(e1n5 + src * we);
      int4* d0 = reinterpret_cast<int4*>(e0n5 + won * we);
      int4* d1 = reinterpret_cast<int4*>(e1n5 + won * we);
      for (int i = tid; i < W + 5; i += blockDim.x) {
        d0[i] = __ldcg(s0 + i);
        d1[i] = __ldcg(s1 + i);
      }
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < plk::kSlots; ++i) hs.h[i] = hw[lane + plk::kWarp * i];
    prev_win = win;
    qprev = cand + won * wb;
    e0 = e0n5 + won * we;
    e1 = e1n5 + won * we;
  }
  // the last real row's winner, which no later row copies
  if (hr >= 2 && rank == prev_win)
    for (long long i = tid; i < wb; i += blockDim.x)
      my_q[(hr - 2) * wb + i] = qprev[i];
  if (rank == 0) {
    zero_padded(b, hr, H, wb, tid, qrows, filt);
    if (tid == 0) {
      attempts[b] = tally[0];
      if (rounds) rounds[b] = tally[1];
    }
  }
  // no block may leave while another can still read its shared memory
  cluster.sync();
}

using LadderFn = void (*)(const int*, int, const int*, const int*,
                          const int*, const uint8_t*, const int*, const int*,
                          const int*, const int*, int*, int*, int*, int*,
                          const int*, int*, int*, int*, int, int, int);

cudaError_t ladder_kernel_of(int bpp, int k, LadderFn* kernel) {
  if (k < 1 || k > plk::kMaxRungs) return cudaErrorInvalidValue;
  switch (bpp) {
    case 1: *kernel = ladder_kernel<1>; break;
    case 2: *kernel = ladder_kernel<2>; break;
    case 3: *kernel = ladder_kernel<3>; break;
    case 4: *kernel = ladder_kernel<4>; break;
    default: return cudaErrorInvalidValue;
  }
  return cudaSuccess;
}

// the image ladder's shared-memory claims (plk::claim_shared)
std::atomic<unsigned> claimed[plk::kMaxDevices];

}  // namespace

// s, w_real, h_real (B,); ofreq (B, 5, 256); rows (B, H, W*bpp) uint8;
// row-0 winner state qprev0 (B, W, bpp), e00, e10 (B, W+5, 4), 16-byte
// aligned, hist0 (B, 256) -> qrows (B, H-1, W, bpp), filt (B, H-1), 0 in
// the rows at and after h_real; ok (B,) selects embedding mode's MSAD
// self-check on every row when not null (1 = every real row had a passing
// filter); attempts (B,) selects, when not null (ok is null then), the
// ladder of k rungs (1 <= k <= 8) with the strength loop per row, and
// gets the row attempts each image took; rounds (B,), ladder only and
// optional, gets the rounds; never_pass (B,), test-only and null in every
// production call, fails every filter of the images where it is not 0
// (adaptive and ladder only); scratch: the candidates' rows cand (2, B,
// k, 5, W, bpp) and next dither rows e0n5, e1n5 (2, B, k, 5, W+5, 4),
// 16-byte aligned, k = 1 but for the ladder; all int32 but rows.
extern "C" int plk_image_rows(const void* s, int bleed, const void* w_real,
                              const void* h_real, const void* ofreq,
                              const void* rows, const void* qprev0,
                              const void* e00, const void* e10,
                              const void* hist0, void* qrows, void* filt,
                              void* ok, void* attempts, void* rounds,
                              const void* never_pass, void* cand, void* e0n5,
                              void* e1n5, int B, int H, int W, int bpp, int k,
                              void* stream) {
  if (B <= 0 || H < 2) return static_cast<int>(cudaGetLastError());
  if ((ok && attempts) || (never_pass && !ok && !attempts) ||
      (rounds && !attempts) || (!attempts && k != 1))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* si = static_cast<const int*>(s);
  const auto* wri = static_cast<const int*>(w_real);
  const auto* hri = static_cast<const int*>(h_real);
  const auto* of = static_cast<const int*>(ofreq);
  const auto* rw = static_cast<const uint8_t*>(rows);
  const auto* q0 = static_cast<const int*>(qprev0);
  const auto* a0 = static_cast<const int*>(e00);
  const auto* a1 = static_cast<const int*>(e10);
  const auto* h0 = static_cast<const int*>(hist0);
  auto* qr = static_cast<int*>(qrows);
  auto* fl = static_cast<int*>(filt);
  const auto* np = static_cast<const int*>(never_pass);
  auto* cd = static_cast<int*>(cand);
  auto* n0 = static_cast<int*>(e0n5);
  auto* n1 = static_cast<int*>(e1n5);
  if (attempts) {
    LadderFn kernel = nullptr;
    cudaError_t err = ladder_kernel_of(bpp, k, &kernel);
    if (err == cudaSuccess) err = plk::claim_shared(kernel, bpp, claimed);
    if (err != cudaSuccess) return static_cast<int>(err);
    cudaLaunchAttribute attr = plk::cluster_of(k);
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(static_cast<unsigned>(B) * k);
    cfg.blockDim = dim3(plk::kFilters * plk::kWarp);
    cfg.dynamicSmemBytes = plk::kRungClaim;
    cfg.stream = st;
    cfg.attrs = &attr;
    cfg.numAttrs = 1;
    err = cudaLaunchKernelEx(&cfg, kernel, si, bleed, wri, hri, of, rw, q0,
                             a0, a1, h0, qr, fl, static_cast<int*>(attempts),
                             static_cast<int*>(rounds), np, cd, n0, n1, B, H,
                             W);
    if (err != cudaSuccess) return static_cast<int>(err);
    return static_cast<int>(cudaGetLastError());
  }
  const dim3 grid(B), block(plk::kFilters * plk::kWarp);
  auto* oki = static_cast<int*>(ok);
#define PLK_IMAGE_LAUNCH(BPP)                                                \
  if (ok)                                                                    \
    image_kernel<BPP, true><<<grid, block, 0, st>>>(                         \
        si, bleed, wri, hri, of, rw, q0, a0, a1, h0, qr, fl, oki, np, cd,    \
        n0, n1, B, H, W);                                                    \
  else                                                                       \
    image_kernel<BPP, false><<<grid, block, 0, st>>>(                        \
        si, bleed, wri, hri, of, rw, q0, a0, a1, h0, qr, fl, oki, np, cd,    \
        n0, n1, B, H, W);
  switch (bpp) {
    case 1: PLK_IMAGE_LAUNCH(1) break;
    case 2: PLK_IMAGE_LAUNCH(2) break;
    case 3: PLK_IMAGE_LAUNCH(3) break;
    case 4: PLK_IMAGE_LAUNCH(4) break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef PLK_IMAGE_LAUNCH
  return static_cast<int>(cudaGetLastError());
}

// CLI mode on split::image_kernel, a cluster of 2 blocks per image;
// arguments as for plk_image_rows (ok, attempts, rounds and never_pass are
// the other variants' and are not taken; k = 1 in the scratch's shape).
// carry, null or B * (256 + 2 * (W+5) * 4 + W * bpp) int32, 16-byte
// aligned, gets the state each image's last real row leaves: the B
// histograms, then the B next dither rows e0 (B, W+5, 4), the B e1, and the
// B rows (B, W, bpp).
extern "C" int plk_image_split(const void* s, int bleed, const void* w_real,
                               const void* h_real, const void* ofreq,
                               const void* rows, const void* qprev0,
                               const void* e00, const void* e10,
                               const void* hist0, void* qrows, void* filt,
                               void* carry, void* cand, void* e0n5,
                               void* e1n5, int B, int H, int W, int bpp,
                               void* stream) {
  if (B <= 0 || H < 2) return static_cast<int>(cudaGetLastError());
  SplitFn kernel = nullptr;
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg;
  cudaError_t err = split_config(bpp, B, &kernel, &attr, &cfg);
  if (err != cudaSuccess) return static_cast<int>(err);
  cfg.stream = static_cast<cudaStream_t>(stream);
  err = cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const int*>(s), bleed,
      static_cast<const int*>(w_real), static_cast<const int*>(h_real),
      static_cast<const int*>(ofreq), static_cast<const uint8_t*>(rows),
      static_cast<const int*>(qprev0), static_cast<const int*>(e00),
      static_cast<const int*>(e10), static_cast<const int*>(hist0),
      static_cast<int*>(qrows), static_cast<int*>(filt),
      static_cast<int*>(carry), static_cast<int*>(cand),
      static_cast<int*>(e0n5), static_cast<int*>(e1n5), B, H, W);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// The most clusters of split::image_kernel at bpp that the card keeps
// resident at once (cudaOccupancyMaxActiveClusters), into *clusters.
extern "C" int plk_split_clusters(int bpp, int* clusters) {
  SplitFn kernel = nullptr;
  cudaLaunchAttribute attr;
  cudaLaunchConfig_t cfg;
  cudaError_t err = split_config(bpp, 1, &kernel, &attr, &cfg);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaOccupancyMaxActiveClusters(
      clusters, reinterpret_cast<const void*>(kernel), &cfg));
}

// The most clusters of k rungs of the ladder at bpp that the card keeps
// resident at once (cudaOccupancyMaxActiveClusters), into *clusters.
extern "C" int plk_ladder_clusters(int k, int bpp, int* clusters) {
  LadderFn kernel = nullptr;
  cudaError_t err = ladder_kernel_of(bpp, k, &kernel);
  if (err == cudaSuccess) err = plk::claim_shared(kernel, bpp, claimed);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute attr = plk::cluster_of(k);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(k));
  cfg.blockDim = dim3(plk::kFilters * plk::kWarp);
  cfg.dynamicSmemBytes = plk::kRungClaim;
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  return static_cast<int>(cudaOccupancyMaxActiveClusters(
      clusters, reinterpret_cast<const void*>(kernel), &cfg));
}
