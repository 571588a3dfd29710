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
// Two variants:
//   RETRY=false, one attempt: the 5 candidates at the given strengths, all
//     returned (row_attempt; the plain path's and the fuzz's yardstick);
//   RETRY=true, one row with its strength loop, the counterpart of the
//     lax.while_loop around _row_kernel in
//     pngloss_tpu/ops/optimize_pallas.py:optimize_batch_pallas_t (260-312),
//     which the JAX package runs for row 0 inside the same device program
//     as the pre-pass and the image kernel. Per attempt each block runs the
//     5 candidates, their row cost (the histogram-delta bits plus the
//     derivative error / 128, in 64 bits, as image.cu) and libpng's MSAD
//     self-check; while no filter passes and the strength is above 0, it
//     lowers the strength by one, reloads the histogram at row start and
//     runs the row again; at strength 0 the first minimum of the true cost
//     wins (where the C tool would abort). The winner's row, histogram and
//     dither rows, its filter and the attempts go out. The loop is on the
//     device, so row 0 costs one launch and no host round trip. The
//     test-only never_pass flag (null in production) fails every filter of
//     the images it flags, so the give-up branch runs.
//
// Bound: the pixel chain is sequential per (image, filter), so the kernel
// is bound by the latency of one channel step (band, selection, histogram
// update), W * bpp steps long per attempt, not by bytes or operations. Design: one
// block per image and one warp per filter, so the 5 filters run side by
// side; each warp runs quantize.cuh's branch-free chain with its
// histogram in registers (8 entries per lane), a two-reduction selection
// keyed by the rank of the original frequencies (ranked once per block
// into shared memory), the row's inputs loaded two pixels ahead, and the
// divisions by s+1 and bleed as invariant-divisor multiplies. The TPU
// kernel's reciprocal division with corrections, rotated band window and
// stride-8 layout are TPU forms of the same function and are not needed.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

#include "quantize.cuh"

namespace {

// One row of B images, one block per image, one warp per filter. RETRY=false
// writes the 5 candidates (qrow, hist_out (B, 5, 256), e0n, e1n) and reads
// neither oprev nor never_pass; RETRY=true uses qrow, e0n, e1n as scratch
// for the 5 candidates and writes the winner's row, histogram (hist_out
// (B, 256)) and dither rows to won_q, hist_out, won_e0, won_e1, its filter
// and the attempts.
template <int BPP, bool RETRY>
__global__ void __launch_bounds__(plk::kFilters * plk::kWarp)
row_kernel(const int* __restrict__ s, int bleed,
           const int* __restrict__ w_real, const int* __restrict__ orig,
           const int* __restrict__ qprev, const int* __restrict__ oprev,
           const int* __restrict__ e0, const int* __restrict__ e1,
           const int* __restrict__ hist, const int* __restrict__ ofreq,
           const int* __restrict__ never_pass, int* __restrict__ qrow,
           int* __restrict__ hist_out, int* __restrict__ e0n,
           int* __restrict__ e1n, int* __restrict__ won_q,
           int* __restrict__ won_e0, int* __restrict__ won_e1,
           long long* __restrict__ filt, int* __restrict__ attempts, int W) {
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
  if constexpr (!RETRY) {
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
  } else {
    __shared__ int hw[256];                  // histogram at row start
    __shared__ long long cost[plk::kFilters];
    __shared__ bool passing[plk::kFilters];
    for (int i = tid; i < 256; i += blockDim.x) hw[i] = hist[b * 256 + i];
    __syncthreads();
#pragma unroll
    for (int j = 0; j < plk::kSlots; ++j) hs.h[j] = hw[lane + plk::kWarp * j];
    const int wr = w_real[b];
    const plk::Divisor bl = plk::make_divisor(bleed);
    int* my_q = qrow + bf * wb;
    int sr = sb;
    plk::Divisor bandr = plk::make_divisor(sb + 1);
    int best = 0, tries = 0;
    bool again;
    do {
      again = false;
      const long long err = plk::quantize_row<BPP, true, int>(
          f, lane, sr, bandr, bl, wr, W, orig + b * wb, oprev + b * wb,
          qprev + b * wb, e0 + b * we, e1 + b * we, hs, my_q, e0n + bf * we,
          e1n + bf * we, nullptr);
      const long long bits = plk::row_bits(hs, hw, lane);
      // quantize_row ends in __syncwarp: the warp sees its whole row.
      // never_pass (test-only, null in production) is read here, per
      // attempt, as image.cu reads it
      const bool pass =
          plk::msad_passes<BPP>(f, lane, wr, my_q, qprev + b * wb) &&
          !(never_pass && never_pass[b]);
      if (lane == 0) {
        // the true cost: the row may be accepted with no passing filter
        cost[f] = bits + err / 128;
        passing[f] = pass;
      }
      __syncthreads();
      bool any = false;
#pragma unroll
      for (int k = 0; k < plk::kFilters; ++k) any = any || passing[k];
      ++tries;
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
          const long long ck = (any && !passing[k]) ? LLONG_MAX : cost[k];
          if (k == 0 || ck < least) {
            best = k;
            least = ck;
          }
        }
      }
    } while (again);
    // the winner's state; every warp's candidate is complete since the
    // block met after the last attempt
    if (f == best) {
#pragma unroll
      for (int j = 0; j < plk::kSlots; ++j)
        hist_out[b * 256 + lane + plk::kWarp * j] = hs.h[j];
    }
    const long long won = static_cast<long long>(b) * plk::kFilters + best;
    for (long long i = tid; i < wb; i += blockDim.x)
      won_q[b * wb + i] = qrow[won * wb + i];
    const int4* we0 = reinterpret_cast<const int4*>(e0n + won * we);
    const int4* we1 = reinterpret_cast<const int4*>(e1n + won * we);
    int4* o0 = reinterpret_cast<int4*>(won_e0 + b * we);
    int4* o1 = reinterpret_cast<int4*>(won_e1 + b * we);
    for (int i = tid; i < W + 5; i += blockDim.x) {
      o0[i] = we0[i];
      o1[i] = we1[i];
    }
    if (tid == 0) {
      filt[b] = best;
      attempts[b] = tries;
    }
  }
}

template <bool RETRY>
int launch(const void* s, int bleed, const void* w_real, const void* orig,
           const void* qprev, const void* oprev, const void* e0,
           const void* e1, const void* hist, const void* ofreq,
           const void* never_pass, void* qrow, void* hist_out, void* e0n,
           void* e1n, void* won_q, void* won_e0, void* won_e1, void* filt,
           void* attempts, int B, int W, int bpp, void* stream) {
  if (B <= 0) return static_cast<int>(cudaGetLastError());
  const dim3 grid(B), block(plk::kFilters * plk::kWarp);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define PLK_ROW_ARGS                                                      \
  static_cast<const int*>(s), bleed, static_cast<const int*>(w_real),    \
      static_cast<const int*>(orig), static_cast<const int*>(qprev),     \
      static_cast<const int*>(oprev), static_cast<const int*>(e0),       \
      static_cast<const int*>(e1), static_cast<const int*>(hist),        \
      static_cast<const int*>(ofreq),                                    \
      static_cast<const int*>(never_pass), static_cast<int*>(qrow),      \
      static_cast<int*>(hist_out), static_cast<int*>(e0n),               \
      static_cast<int*>(e1n), static_cast<int*>(won_q),                  \
      static_cast<int*>(won_e0), static_cast<int*>(won_e1),              \
      static_cast<long long*>(filt), static_cast<int*>(attempts), W
  switch (bpp) {
    case 1: row_kernel<1, RETRY><<<grid, block, 0, st>>>(PLK_ROW_ARGS); break;
    case 2: row_kernel<2, RETRY><<<grid, block, 0, st>>>(PLK_ROW_ARGS); break;
    case 3: row_kernel<3, RETRY><<<grid, block, 0, st>>>(PLK_ROW_ARGS); break;
    case 4: row_kernel<4, RETRY><<<grid, block, 0, st>>>(PLK_ROW_ARGS); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef PLK_ROW_ARGS
  return static_cast<int>(cudaGetLastError());
}

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
  return launch<false>(s, bleed, w_real, orig, qprev, nullptr, e0, e1, hist,
                       ofreq, nullptr, qrow, hist_out, e0n, e1n, nullptr,
                       nullptr, nullptr, nullptr, nullptr, B, W, bpp,
                       stream);
}

// One row with its strength loop, from the state the previous row left:
// s, w_real (B,); orig, qprev, oprev (B, W, bpp); e0, e1 (B, W+5, 4),
// 16-byte aligned; hist (B, 256); ofreq (B, 5, 256); never_pass (B,),
// test-only, null in every production call; scratch for the 5 candidates:
// cand (B, 5, W, bpp), e0n5, e1n5 (B, 5, W+5, 4), 16-byte aligned -> the
// winner's row q (B, W, bpp), histogram hist_out (B, 256) and next dither
// rows e0n, e1n (B, W+5, 4), 16-byte aligned; filt (B,) int64; attempts
// (B,); all int32 but filt.
extern "C" int plk_row_retry(const void* s, int bleed, const void* w_real,
                             const void* orig, const void* qprev,
                             const void* oprev, const void* e0,
                             const void* e1, const void* hist,
                             const void* ofreq, const void* never_pass,
                             void* cand, void* e0n5, void* e1n5, void* q,
                             void* hist_out, void* e0n, void* e1n,
                             void* filt, void* attempts, int B, int W,
                             int bpp, void* stream) {
  return launch<true>(s, bleed, w_real, orig, qprev, oprev, e0, e1, hist,
                      ofreq, never_pass, cand, hist_out, e0n5, e1n5, q, e0n,
                      e1n, filt, attempts, B, W, bpp, stream);
}
