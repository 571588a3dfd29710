// One row of B images under all 5 filters: one strength attempt, or the
// row with its strength loop.
//
// Replaces the TPU kernel pngloss_tpu/ops/pallas_row.py:_row_kernel
// (launched by row_attempt_pallas): per pixel and channel the predictor
// with the +-256 wrap, the band by truncating division by s+1 with clamp
// and exact-saturation fallback, the three-level symbol selection, the
// transparent-pixel rule, the histogram update, and the Sierra split into
// the next two dither rows.
//
// Two kernels:
//   row_kernel, one attempt: the 5 candidates at the given strengths, all
//     returned (row_attempt; the plain path's and the fuzz's yardstick);
//   row_ladder_kernel, one row with its strength loop, the counterpart of
//     the lax.while_loop around _row_kernel in
//     pngloss_tpu/ops/optimize_pallas.py:optimize_batch_pallas_t (263-300),
//     which the JAX package runs for row 0 inside the same device program
//     as the pre-pass and the image kernel. The loop runs the 5 candidates
//     at strength s, their row cost (the histogram-delta bits plus the
//     derivative error / 128, in 64 bits, as image.cu) and libpng's MSAD
//     self-check; while no filter passes and the strength is above 0, it
//     runs the row again one strength lower from the same state; at
//     strength 0 the first minimum of the true cost wins (where the C tool
//     would abort). The winner's row, histogram and dither rows, its filter
//     and the attempts go out. The loop is on the device, so row 0 costs
//     one launch and no host round trip. The test-only never_pass flag
//     (null in production) fails every filter of the images it flags, so
//     the give-up branch runs.
//
// Bound: the pixel chain is sequential per (image, filter), so an attempt
// is bound by the latency of one channel step (band, selection, histogram
// update), W * bpp steps long, not by bytes or operations. Design: one
// block per image (per rung, in the ladder) and one warp per filter, so the
// 5 filters run side by side; each warp runs quantize.cuh's branch-free
// chain with its histogram in registers (8 entries per lane), a
// two-reduction selection keyed by the rank of the original frequencies
// (ranked once per block into shared memory), the row's inputs loaded two
// pixels ahead, and the divisions by s+1 and bleed as invariant-divisor
// multiplies. The TPU kernel's reciprocal division with corrections,
// rotated band window and stride-8 layout are TPU forms of the same
// function and are not needed.
//
// row_ladder_kernel: the attempts at s, s-1, ... all start from the same
// state, so they are independent, and the loop keeps the first of them, in
// descending strength, with a passing filter. A textured row retries tens
// to hundreds of times at high strengths, and a launch lasts as long as
// its slowest image, so a thread-block cluster of k blocks ("rungs") runs
// one image and k strengths at once, as image.cu's ladder_kernel does for
// rows 1..H-1: in round j, rung r runs strength s - j*k - r (a rung below
// 0 runs nothing and passes nothing), each rung on an SM of its own (the
// launch bound asks for one block per SM, and each rung claims more than
// half of the SM's shared memory). After a round the cluster meets
// (barrier.cluster) and every block reads all rungs' passing flags from
// their shared memory (distributed shared memory) and finds the same
// winner: the lowest rung with a passing filter; where none passes and the
// round reached strength 0, the strength-0 rung; otherwise every rung
// reloads the histogram at row start and runs the next round. Rounds write
// alternating cost and flag buffers, so a round's flags are never
// rewritten before every block has read them. Row 0 carries nothing to a
// next row inside the kernel, so the winner rung alone picks its first
// passing minimum (the true minimum in the give-up branch) and writes the
// outputs from its own scratch set; the other rungs copy nothing, and no
// block reads another's global memory. The kernel ends in a cluster
// barrier, so no block leaves while another can still read its shared
// memory. At k = 1 it is the one-block sequential loop. The sequential
// count of attempts, s - s_win + 1, is j*k + r + 1 for rung r winning
// round j; rounds are ceil(attempts / k).

#include <atomic>
#include <climits>
#include <cstdint>
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "quantize.cuh"

namespace cg = cooperative_groups;

namespace {

// One row of B images, one attempt, one block per image, one warp per
// filter: the 5 candidates (qrow, hist_out (B, 5, 256), e0n, e1n).
template <int BPP>
__global__ void __launch_bounds__(plk::kFilters * plk::kWarp)
row_kernel(const int* __restrict__ s, int bleed,
           const int* __restrict__ w_real, const int* __restrict__ orig,
           const int* __restrict__ qprev, const int* __restrict__ e0,
           const int* __restrict__ e1, const int* __restrict__ hist,
           const int* __restrict__ ofreq, int* __restrict__ qrow,
           int* __restrict__ hist_out, int* __restrict__ e0n,
           int* __restrict__ e1n, int W) {
  __shared__ int os[plk::kFilters][256];   // rank keys (rank_keys)
  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int f = tid / plk::kWarp;
  const int lane = tid % plk::kWarp;
  for (int i = tid; i < plk::kFilters * 256; i += blockDim.x)
    os[i / 256][i % 256] = ofreq[b * plk::kFilters * 256 + i];
  __syncthreads();
  plk::rank_keys(os[f], lane);
  plk::Hist hs;
  hs.rk = os[f];
  const long long wb = static_cast<long long>(W) * BPP;
  const long long we = static_cast<long long>(W + 5) * 4;
  const long long bf = static_cast<long long>(b) * plk::kFilters + f;
  const int sb = s[b];
#pragma unroll
  for (int j = 0; j < plk::kSlots; ++j)
    hs.h[j] = hist[b * 256 + lane + plk::kWarp * j];
  plk::quantize_row<BPP, false, int>(
      f, lane, sb, plk::make_divisor(sb + 1), plk::make_divisor(bleed),
      w_real[b], W, orig + b * wb, nullptr, qprev + b * wb, e0 + b * we,
      e1 + b * we, hs, qrow + bf * wb, e0n + bf * we, e1n + bf * we,
      nullptr);
#pragma unroll
  for (int j = 0; j < plk::kSlots; ++j)
    hist_out[bf * 256 + lane + plk::kWarp * j] = hs.h[j];
}

// One row of one image per cluster of k rungs (the cluster's size), with
// its strength loop; see the header. cand, e0n5, e1n5 hold one set of the 5
// candidates per (image, rung). Strengths below 0 count as 0. A rung wants
// an SM of its own, so the launch bound asks for one block per SM, which
// leaves ptxas the registers for the chain (as ladder_kernel in image.cu),
// and the launch claims plk::kRungClaim bytes of shared memory.
template <int BPP>
__global__ void __launch_bounds__(plk::kFilters * plk::kWarp, 1)
row_ladder_kernel(const int* __restrict__ s, int bleed,
                  const int* __restrict__ w_real,
                  const int* __restrict__ orig,
                  const int* __restrict__ qprev,
                  const int* __restrict__ oprev, const int* __restrict__ e0,
                  const int* __restrict__ e1, const int* __restrict__ hist,
                  const int* __restrict__ ofreq,
                  const int* __restrict__ never_pass, int* cand, int* e0n5,
                  int* e1n5, int* __restrict__ won_q,
                  int* __restrict__ hist_out, int* __restrict__ won_e0,
                  int* __restrict__ won_e1, long long* __restrict__ filt,
                  int* __restrict__ attempts, int* __restrict__ rounds,
                  int W) {
  __shared__ int os[plk::kFilters][256];   // rank keys (rank_keys)
  __shared__ int hw[256];                  // histogram at row start
  // per round parity: each filter's cost, and its pass flag in byte f of
  // one word (bytes 5-7 stay 0), so a rung's flags are one remote load
  __shared__ long long cost[2][plk::kFilters];
  __shared__ unsigned long long passing[2];

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
  const plk::Divisor bl = plk::make_divisor(bleed);
  // this rung's candidate f: its row and next dither rows
  const long long mine =
      (static_cast<long long>(b) * k + rank) * plk::kFilters + f;
  int* qrow = cand + mine * wb;
  if (tid == 0) passing[0] = passing[1] = 0;
  for (int i = tid; i < plk::kFilters * 256; i += blockDim.x)
    os[i / 256][i % 256] = ofreq[b * plk::kFilters * 256 + i];
  for (int i = tid; i < 256; i += blockDim.x) hw[i] = hist[b * 256 + i];
  __syncthreads();
  plk::rank_keys(os[f], lane);
  plk::Hist hs;
  hs.rk = os[f];
#pragma unroll
  for (int i = 0; i < plk::kSlots; ++i) hs.h[i] = hw[lane + plk::kWarp * i];

  int j = 0, par = 0, win;
  for (;;) {
    const int sr = sb - j * k - rank;      // block-uniform
    long long c = LLONG_MAX;
    bool pass = false;
    if (sr >= 0) {
      const long long err = plk::quantize_row<BPP, true, int>(
          f, lane, sr, plk::make_divisor(sr + 1), bl, wr, W, orig + b * wb,
          oprev + b * wb, qprev + b * wb, e0 + b * we, e1 + b * we, hs, qrow,
          e0n5 + mine * we, e1n5 + mine * we, nullptr);
      // the true cost: the strength-0 rung may win with no filter passing
      c = plk::row_bits(hs, hw, lane) + err / 128;
      // quantize_row ends in __syncwarp: the warp sees its whole row.
      // never_pass (test-only, null in production) is read per attempt
      pass = plk::msad_passes<BPP>(f, lane, wr, qrow, qprev + b * wb) &&
             !(never_pass && never_pass[b]);
    }
    if (lane == 0) {
      cost[par][f] = c;
      reinterpret_cast<unsigned char*>(&passing[par])[f] = pass;
    }
    cluster.sync();
    unsigned found = 0;                    // bit r: rung r passed
#pragma unroll
    for (int r = 0; r < plk::kMaxRungs; ++r)
      if (r < k && *cluster.map_shared_rank(&passing[par], r))
        found |= 1u << r;
    win = found ? __ffs(found) - 1 : -1;
    if (win < 0 && sb - j * k - (k - 1) <= 0)
      win = sb - j * k;                    // give up: the strength-0 rung
    if (win >= 0) break;
    // no rung passed above strength 0: every rung runs the row again, k
    // strengths lower, from the histogram at row start
    par ^= 1;
    ++j;
#pragma unroll
    for (int i = 0; i < plk::kSlots; ++i) hs.h[i] = hw[lane + plk::kWarp * i];
  }
  if (rank == win) {                       // block-uniform
    // the first minimum, failing filters out unless none passed (the
    // give-up branch keeps the true costs); every warp's candidate is
    // complete since the cluster met after the round
    const unsigned long long wp = passing[par];
    int best = 0;
    long long least = 0;
#pragma unroll
    for (int g = 0; g < plk::kFilters; ++g) {
      const long long ck = (wp && !((wp >> (8 * g)) & 0xff)) ? LLONG_MAX
                                                             : cost[par][g];
      if (g == 0 || ck < least) {
        best = g;
        least = ck;
      }
    }
    if (f == best) {
#pragma unroll
      for (int i = 0; i < plk::kSlots; ++i)
        hist_out[b * 256 + lane + plk::kWarp * i] = hs.h[i];
    }
    const long long won =
        (static_cast<long long>(b) * k + win) * plk::kFilters + best;
    for (long long i = tid; i < wb; i += blockDim.x)
      won_q[b * wb + i] = cand[won * wb + i];
    const int4* we0 = reinterpret_cast<const int4*>(e0n5 + won * we);
    const int4* we1 = reinterpret_cast<const int4*>(e1n5 + won * we);
    int4* o0 = reinterpret_cast<int4*>(won_e0 + b * we);
    int4* o1 = reinterpret_cast<int4*>(won_e1 + b * we);
    for (int i = tid; i < W + 5; i += blockDim.x) {
      o0[i] = we0[i];
      o1[i] = we1[i];
    }
    if (tid == 0) {
      filt[b] = best;
      attempts[b] = j * k + win + 1;
      if (rounds) rounds[b] = j + 1;
    }
  }
  // no block may leave while another can still read its shared memory
  cluster.sync();
}

using RowLadderFn = void (*)(const int*, int, const int*, const int*,
                             const int*, const int*, const int*, const int*,
                             const int*, const int*, const int*, int*, int*,
                             int*, int*, int*, int*, int*, long long*, int*,
                             int*, int);

cudaError_t row_ladder_of(int bpp, int k, RowLadderFn* kernel) {
  if (k < 1 || k > plk::kMaxRungs) return cudaErrorInvalidValue;
  switch (bpp) {
    case 1: *kernel = row_ladder_kernel<1>; break;
    case 2: *kernel = row_ladder_kernel<2>; break;
    case 3: *kernel = row_ladder_kernel<3>; break;
    case 4: *kernel = row_ladder_kernel<4>; break;
    default: return cudaErrorInvalidValue;
  }
  return cudaSuccess;
}

// the row ladder's shared-memory claims (plk::claim_shared)
std::atomic<unsigned> claimed[plk::kMaxDevices];

}  // namespace

// s, w_real (B,); orig, qprev (B, W, bpp); e0, e1 (B, W+5, 4), 16-byte
// aligned; hist (B, 256); ofreq (B, 5, 256) -> qrow (B, 5, W, bpp),
// hist_out (B, 5, 256), e0n, e1n (B, 5, W+5, 4), 16-byte aligned; all
// int32.
extern "C" int plk_row_attempt(const void* s, int bleed, const void* w_real,
                               const void* orig, const void* qprev,
                               const void* e0, const void* e1,
                               const void* hist, const void* ofreq,
                               void* qrow, void* hist_out, void* e0n,
                               void* e1n, int B, int W, int bpp,
                               void* stream) {
  if (B <= 0) return static_cast<int>(cudaGetLastError());
  const dim3 grid(B), block(plk::kFilters * plk::kWarp);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define PLK_ROW_ARGS                                                      \
  static_cast<const int*>(s), bleed, static_cast<const int*>(w_real),    \
      static_cast<const int*>(orig), static_cast<const int*>(qprev),     \
      static_cast<const int*>(e0), static_cast<const int*>(e1),          \
      static_cast<const int*>(hist), static_cast<const int*>(ofreq),     \
      static_cast<int*>(qrow), static_cast<int*>(hist_out),              \
      static_cast<int*>(e0n), static_cast<int*>(e1n), W
  switch (bpp) {
    case 1: row_kernel<1><<<grid, block, 0, st>>>(PLK_ROW_ARGS); break;
    case 2: row_kernel<2><<<grid, block, 0, st>>>(PLK_ROW_ARGS); break;
    case 3: row_kernel<3><<<grid, block, 0, st>>>(PLK_ROW_ARGS); break;
    case 4: row_kernel<4><<<grid, block, 0, st>>>(PLK_ROW_ARGS); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef PLK_ROW_ARGS
  return static_cast<int>(cudaGetLastError());
}

// One row with its strength loop, from the state the previous row left, as
// a ladder of k rungs (1 <= k <= 8): s, w_real (B,); orig, qprev, oprev
// (B, W, bpp); e0, e1 (B, W+5, 4), 16-byte aligned; hist (B, 256); ofreq
// (B, 5, 256); never_pass (B,), test-only, null in every production call;
// scratch for the rungs' candidates: cand (B, k, 5, W, bpp), e0n5, e1n5
// (B, k, 5, W+5, 4), 16-byte aligned -> the winner's row q (B, W, bpp),
// histogram hist_out (B, 256) and next dither rows e0n, e1n (B, W+5, 4),
// 16-byte aligned; filt (B,) int64; attempts (B,); rounds (B,), optional;
// all int32 but filt.
extern "C" int plk_row_retry(const void* s, int bleed, const void* w_real,
                             const void* orig, const void* qprev,
                             const void* oprev, const void* e0,
                             const void* e1, const void* hist,
                             const void* ofreq, const void* never_pass,
                             void* cand, void* e0n5, void* e1n5, void* q,
                             void* hist_out, void* e0n, void* e1n,
                             void* filt, void* attempts, void* rounds, int B,
                             int W, int bpp, int k, void* stream) {
  if (B <= 0) return static_cast<int>(cudaGetLastError());
  RowLadderFn kernel = nullptr;
  cudaError_t err = row_ladder_of(bpp, k, &kernel);
  if (err == cudaSuccess) err = plk::claim_shared(kernel, bpp, claimed);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute attr = plk::cluster_of(k);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(B) * k);
  cfg.blockDim = dim3(plk::kFilters * plk::kWarp);
  cfg.dynamicSmemBytes = plk::kRungClaim;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cfg.attrs = &attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(
      &cfg, kernel, static_cast<const int*>(s), bleed,
      static_cast<const int*>(w_real), static_cast<const int*>(orig),
      static_cast<const int*>(qprev), static_cast<const int*>(oprev),
      static_cast<const int*>(e0), static_cast<const int*>(e1),
      static_cast<const int*>(hist), static_cast<const int*>(ofreq),
      static_cast<const int*>(never_pass), static_cast<int*>(cand),
      static_cast<int*>(e0n5), static_cast<int*>(e1n5), static_cast<int*>(q),
      static_cast<int*>(hist_out), static_cast<int*>(e0n),
      static_cast<int*>(e1n), static_cast<long long*>(filt),
      static_cast<int*>(attempts), static_cast<int*>(rounds), W);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

// The most clusters of k rungs of the row ladder at bpp that the card
// keeps resident at once (cudaOccupancyMaxActiveClusters), into *clusters.
extern "C" int plk_row_ladder_clusters(int k, int bpp, int* clusters) {
  RowLadderFn kernel = nullptr;
  cudaError_t err = row_ladder_of(bpp, k, &kernel);
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
