// One strength attempt on one row of B images under all 5 filters.
//
// Replaces the TPU kernel pngloss_tpu/ops/pallas_row.py:_row_kernel
// (launched by row_attempt_pallas): per pixel and channel the predictor
// with the +-256 wrap, the band by truncating division by s+1 with clamp
// and exact-saturation fallback, the three-level symbol selection, the
// transparent-pixel rule, the histogram update, and the Sierra split into
// the next two dither rows. It carries row 0 of every image and every row
// of embedding mode's per-row fallback.
//
// Bound: the pixel chain is sequential per (image, filter), so the kernel
// is bound by the latency of one channel step (band, selection, histogram
// update), W * bpp steps long, not by bytes or operations. Design: one
// block per image and one warp per filter, so the 5 filters run side by
// side; each warp runs quantize.cuh's branch-free chain with its
// histogram in registers (8 entries per lane), a two-reduction selection
// keyed by the rank of the original frequencies (ranked once per block
// into shared memory), the row's inputs loaded two pixels ahead, and the
// divisions by s+1 and bleed as invariant-divisor multiplies. The TPU
// kernel's reciprocal division with corrections, rotated band window and
// stride-8 layout are TPU forms of the same function and are not needed.

#include <cstdint>
#include <cuda_runtime.h>

#include "quantize.cuh"

namespace {

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
  const int f = threadIdx.x / plk::kWarp;
  const int lane = threadIdx.x % plk::kWarp;
  for (int i = threadIdx.x; i < plk::kFilters * 256; i += blockDim.x)
    os[i / 256][i % 256] = ofreq[b * plk::kFilters * 256 + i];
  __syncthreads();
  plk::rank_keys(os[f], lane);
  plk::Hist hs;
  hs.rk = os[f];
#pragma unroll
  for (int j = 0; j < plk::kSlots; ++j)
    hs.h[j] = hist[b * 256 + lane + plk::kWarp * j];
  const long long wb = static_cast<long long>(W) * BPP;
  const long long we = static_cast<long long>(W + 5) * 4;
  const long long bf = static_cast<long long>(b) * plk::kFilters + f;
  const int sb = s[b];
  plk::quantize_row<BPP, false, int>(
      f, lane, sb, plk::make_divisor(sb + 1), plk::make_divisor(bleed),
      w_real[b], W, orig + b * wb, nullptr, qprev + b * wb, e0 + b * we,
      e1 + b * we, hs, qrow + bf * wb, e0n + bf * we, e1n + bf * we,
      nullptr);
#pragma unroll
  for (int j = 0; j < plk::kSlots; ++j)
    hist_out[bf * 256 + lane + plk::kWarp * j] = hs.h[j];
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
