// Rows 1..H-1 of every image in one launch, in CLI mode, in embedding
// mode's speculation and in embedding mode's per-row path.
//
// Replaces the TPU kernel pngloss_tpu/ops/pallas_image.py:_image_kernel
// (launched by image_rows_pallas), both variants, and the device program
// the JAX package runs around its row kernel in embedding mode:
//   adaptive=False (CLI mode): only row 0 runs the MSAD self-check, so
//     rows >= 1 never fall back to a lower strength;
//   adaptive=True (embedding mode): every row runs libpng's MSAD
//     self-check at full strength; a failing candidate costs LLONG_MAX
//     (UINTMAX_MAX in the C code), and a per-image ok flag is cleared by
//     any row where no filter passes. Such a row carries on with filter 0,
//     as the TPU kernel does; the caller re-runs its image through the
//     per-row fallback;
//   RETRY (embedding mode's per-row path, the scan over rows with a
//     while_loop over the strength of
//     pngloss_tpu/ops/optimize_pallas.py:optimize_batch_pallas_t): every
//     row starts at the image's full strength; while no filter passes the
//     self-check and the row's strength is above 0, the block lowers it by
//     one and runs the row again; at strength 0 with no passing filter the
//     minimum true cost wins (where the C tool would abort). This variant
//     never fails; it reports the row attempts each image took. At strength
//     0 the 5 candidates are one row, whose MSAD choice is one of them, so
//     no real input reaches the strength-0 branch: the test-only never_pass
//     flag fails every filter of an image's rows, which then retry down to
//     strength 0 and take the branch (in the adaptive variant, the image's
//     ok is 0). A retry
//     writes the same scratch set again (the previous row's winner lives in
//     the other), reloads the histogram at row start, which stays in shared
//     memory until a winner posts, and loops around the one call of the
//     pixel chain: a second call site would be a second copy of the chain,
//     and five copies ran 1.7x slower (instruction cache). Each image
//     retries alone, with no host round trip.
// Per row: each filter's candidate (the per-pixel math of the row kernel,
// quantize.cuh), its cost sum_t (hist_out - hist_in)[t] *
// (33 + clz(hist_out[t])) plus the derivative error / 128 (accumulated
// exactly in 64 bits), the minimum-cost winner with ties to the lowest
// filter, and the winner's row, histogram and dither rows carried on.
//
// Bound: the same per-channel latency chain as the row kernel, (H-1) * W *
// bpp steps long per image, so the time of one image is latency, not
// bytes or operations; the card is filled by running one image per block.
// The MSAD pass adds one read of the candidate row and the previous row
// per warp, lane-strided and off the chain. Design: one block per image,
// one warp per filter, quantize.cuh's chain per warp (histogram in
// registers, two-reduction selection, inputs two pixels ahead, invariant
// divisors). The winner's state passes by index: each filter writes its
// candidate row and next dither rows into one of two global sets, and the
// next row reads the winner's set in place while writing the other. After
// each row the block meets once to post the costs; every thread picks the
// first minimum itself, the winning warp posts its histogram through
// shared memory, and the block meets again. The winner's row goes on to
// qrows off the chain: the warps store it (the same values) while they
// read it as the next row's previous row. The TPU kernel's lane rolls, selection matmuls and
// bf16 tricks are TPU forms of this broadcast and are not needed here.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

#include "quantize.cuh"

namespace {

template <int BPP, bool ADAPTIVE, bool RETRY>
__global__ void __launch_bounds__(plk::kFilters * plk::kWarp)
image_kernel(const int* __restrict__ s, int bleed,
             const int* __restrict__ w_real, const int* __restrict__ ofreq,
             const uint8_t* __restrict__ rows,
             const int* __restrict__ qprev0, const int* __restrict__ e00,
             const int* __restrict__ e10, const int* __restrict__ hist0,
             int* __restrict__ qrows, int* __restrict__ filt,
             int* __restrict__ ok, int* __restrict__ attempts,
             const int* __restrict__ never_pass, int* cand, int* e0n5,
             int* e1n5, int B, int H, int W) {
  static_assert(ADAPTIVE || !RETRY, "only the adaptive check can fail");
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
  const plk::Divisor band = plk::make_divisor(sb + 1);
  const plk::Divisor bl = plk::make_divisor(bleed);
  const uint8_t* img = rows + b * wb * H;
  int* my_q = qrows + b * wb * (H - 1);
  // candidate k's row and next dither rows in set p (two sets, ping-pong)
  auto set = [&](int p, int k) {
    return (static_cast<long long>(p) * B + b) * plk::kFilters + k;
  };
  int all_rows_pass = 1;                      // read by thread 0 only
  int tries = 0;                              // read by thread 0 only

  for (int i = tid; i < plk::kFilters * 256; i += blockDim.x)
    os[i / 256][i % 256] = ofreq[b * plk::kFilters * 256 + i];
  __syncthreads();
  plk::rank_keys(os[f], lane);
  plk::Hist hs;
  hs.rk = os[f];
  for (int i = tid; i < 256; i += blockDim.x) hw[i] = hist0[b * 256 + i];
  __syncthreads();
#pragma unroll
  for (int j = 0; j < plk::kSlots; ++j) hs.h[j] = hw[lane + plk::kWarp * j];

  const int* qprev = qprev0 + b * wb;
  const int* e0 = e00 + b * we;
  const int* e1 = e10 + b * we;
  for (int y = 1, p = 0; y < H; ++y, p ^= 1) {
    const long long mine = set(p, f);
    int* qrow = cand + mine * wb;
    int sr = sb;                              // RETRY: this row's strength
    plk::Divisor bandr = band;
    int best = 0;
    bool again;
    do {
      again = false;
      const long long err = plk::quantize_row<BPP, true, uint8_t>(
          f, lane, sr, bandr, bl, wr, W, img + y * wb, img + (y - 1) * wb,
          qprev, e0, e1, hs, qrow, e0n5 + mine * we, e1n5 + mine * we,
          y >= 2 ? my_q + (y - 2) * wb : nullptr);
      const long long bits = plk::row_bits(hs, hw, lane);
      bool pass = true;
      if constexpr (ADAPTIVE) {
        // every lane stored the same values of the candidate row, and
        // quantize_row_warp ends in __syncwarp, so the whole warp sees them
        // never_pass (test-only, null in production) is read here, per
        // attempt and off the chain: held in a register across the rows it
        // cost the retry variant 1.6% through a spill
        pass = plk::msad_passes<BPP>(f, lane, wr, qrow, qprev) &&
               !(never_pass && never_pass[b]);
      }
      if (lane == 0) {
        // RETRY keeps the true cost: the row may be accepted with no
        // passing filter
        cost[f] = (RETRY || pass) ? bits + err / 128 : LLONG_MAX;
        passing[f] = pass;
      }
      __syncthreads();
      if constexpr (RETRY) {
        bool any = false;
#pragma unroll
        for (int k = 0; k < plk::kFilters; ++k) any = any || passing[k];
        if (tid == 0) ++tries;
        if (!any && sr > 0) {
          // block-uniform: every thread read the same passing[]. The row
          // runs again one strength lower, from the histogram at row start
          --sr;
          bandr = plk::make_divisor(sr + 1);
#pragma unroll
          for (int j = 0; j < plk::kSlots; ++j)
            hs.h[j] = hw[lane + plk::kWarp * j];
          again = true;
          // cost[] and passing[] are rewritten only after all have read them
          __syncthreads();
        } else {
          long long least = 0;
#pragma unroll
          for (int k = 0; k < plk::kFilters; ++k) {
            const long long ck =
                (any && !passing[k]) ? LLONG_MAX : cost[k];
            if (k == 0 || ck < least) {
              best = k;
              least = ck;
            }
          }
        }
      } else {
#pragma unroll
        for (int k = 1; k < plk::kFilters; ++k)
          if (cost[k] < cost[best]) best = k;
      }
    } while (RETRY && again);
    if (f == best) {
#pragma unroll
      for (int j = 0; j < plk::kSlots; ++j)
        hw[lane + plk::kWarp * j] = hs.h[j];
    }
    if (tid == 0) {
      filt[static_cast<long long>(b) * (H - 1) + y - 1] = best;
      if constexpr (ADAPTIVE && !RETRY) {
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
  // the last row's winner, which no later row copies
  for (long long i = tid; i < wb; i += blockDim.x)
    my_q[(H - 2) * wb + i] = qprev[i];
  if (ADAPTIVE && !RETRY && tid == 0) ok[b] = all_rows_pass;
  if (RETRY && tid == 0) attempts[b] = tries;
}

}  // namespace

// s, w_real (B,); ofreq (B, 5, 256); rows (B, H, W*bpp) uint8; row-0
// winner state qprev0 (B, W, bpp), e00, e10 (B, W+5, 4), 16-byte aligned,
// hist0 (B, 256) -> qrows (B, H-1, W, bpp), filt (B, H-1); ok (B,) selects
// embedding mode's MSAD self-check on every row when not null (1 = every
// row had a passing filter); attempts (B,) selects, when not null (ok is
// null then), the self-check with the strength loop per row, and gets the
// row attempts each image took; never_pass (B,), test-only and null in
// every production call, fails every filter of the images where it is not
// 0 (adaptive and retry only); scratch: two sets of the 5 candidates' rows
// cand (2, B, 5, W, bpp) and next dither rows e0n5, e1n5 (2, B, 5, W+5, 4),
// 16-byte aligned; all int32 but rows.
extern "C" int plk_image_rows(const void* s, int bleed, const void* w_real,
                              const void* ofreq, const void* rows,
                              const void* qprev0, const void* e00,
                              const void* e10, const void* hist0,
                              void* qrows, void* filt, void* ok,
                              void* attempts, const void* never_pass,
                              void* cand, void* e0n5, void* e1n5, int B,
                              int H, int W, int bpp, void* stream) {
  if (B <= 0 || H < 2) return static_cast<int>(cudaGetLastError());
  if ((ok && attempts) || (never_pass && !ok && !attempts))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(B), block(plk::kFilters * plk::kWarp);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define PLK_IMAGE_ARGS                                                    \
  static_cast<const int*>(s), bleed, static_cast<const int*>(w_real),    \
      static_cast<const int*>(ofreq), static_cast<const uint8_t*>(rows), \
      static_cast<const int*>(qprev0), static_cast<const int*>(e00),     \
      static_cast<const int*>(e10), static_cast<const int*>(hist0),      \
      static_cast<int*>(qrows), static_cast<int*>(filt),                 \
      static_cast<int*>(ok), static_cast<int*>(attempts),                \
      static_cast<const int*>(never_pass), static_cast<int*>(cand),      \
      static_cast<int*>(e0n5), static_cast<int*>(e1n5), B, H, W
#define PLK_IMAGE_LAUNCH(BPP)                                                \
  if (attempts)                                                              \
    image_kernel<BPP, true, true><<<grid, block, 0, st>>>(PLK_IMAGE_ARGS);   \
  else if (ok)                                                               \
    image_kernel<BPP, true, false><<<grid, block, 0, st>>>(PLK_IMAGE_ARGS);  \
  else                                                                       \
    image_kernel<BPP, false, false><<<grid, block, 0, st>>>(PLK_IMAGE_ARGS);
  switch (bpp) {
    case 1: PLK_IMAGE_LAUNCH(1) break;
    case 2: PLK_IMAGE_LAUNCH(2) break;
    case 3: PLK_IMAGE_LAUNCH(3) break;
    case 4: PLK_IMAGE_LAUNCH(4) break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef PLK_IMAGE_LAUNCH
#undef PLK_IMAGE_ARGS
  return static_cast<int>(cudaGetLastError());
}
