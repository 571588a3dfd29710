// Rows 1..H-1 of every image in one launch, in CLI mode and in embedding
// mode's speculation.
//
// Replaces the TPU kernel pngloss_tpu/ops/pallas_image.py:_image_kernel
// (launched by image_rows_pallas), both variants:
//   adaptive=False (CLI mode): only row 0 runs the MSAD self-check, so
//     rows >= 1 never fall back to a lower strength;
//   adaptive=True (embedding mode): every row runs libpng's MSAD
//     self-check at full strength; a failing candidate costs LLONG_MAX
//     (UINTMAX_MAX in the C code), and a per-image ok flag is cleared by
//     any row where no filter passes. Such a row carries on with filter 0,
//     as the TPU kernel does; the caller re-runs its image through the
//     per-row fallback.
// Per row: each filter's candidate (the per-pixel math of the row kernel,
// quantize.cuh), its cost sum_t (hist_out - hist_in)[t] *
// (33 + clz(hist_out[t])) plus the derivative error / 128 (accumulated
// exactly in 64 bits), the minimum-cost winner with ties to the lowest
// filter, and the winner's row, histogram and dither rows carried on.
//
// Bound: the same per-pixel latency chain as the row kernel, H-1 rows
// long, so the time of one image is latency, not bytes or operations; the
// card is filled by running one image per block. The MSAD pass adds one
// read of the candidate row and the previous row per warp, lane-strided
// and off the chain. Design: one block per image, one warp per filter;
// the 5 working histograms, the winner's histogram and the original
// frequencies stay in shared memory for the whole image; the candidates'
// rows and dither rows go to global scratch (a few KB per row, cache
// resident). After each row the block meets at __syncthreads, thread 0
// picks the winner through shared memory, and all threads copy the
// winner's state. The TPU kernel's lane rolls, selection matmuls and bf16
// tricks are TPU forms of this broadcast and are not needed here.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>

#include "quantize.cuh"

namespace {

// Does filter f pass libpng's MSAD heuristic on its candidate row q
// (adaptive_filter_for_rows, optimize_state.c:492-562)? The 5 trial sums
// of |residual| (as a signed byte) over the real columns, lane-strided,
// then summed over the warp; ties go to the earliest trial. Every lane of
// the warp must call it; all get the answer.
template <int BPP>
__device__ bool msad_passes(int f, int lane, int wr, const int* q,
                            const int* qprev) {
  int sums[plk::kFilters] = {0, 0, 0, 0, 0};
  for (int x = lane; x < wr; x += plk::kWarp) {
#pragma unroll
    for (int c = 0; c < BPP; ++c) {
      const int i = x * BPP + c;
      const int v = q[i];
      const int above = qprev[i];
      const int left = x ? q[i - BPP] : 0;
      const int diag = x ? qprev[i - BPP] : 0;
#pragma unroll
      for (int t = 0; t < plk::kFilters; ++t) {
        const int r = (v - plk::predict(t, above, diag, left)) & 0xFF;
        sums[t] += r < 128 ? r : 256 - r;
      }
    }
  }
  int best = 0, best_sum = 0;
#pragma unroll
  for (int t = 0; t < plk::kFilters; ++t) {
    const int total = __reduce_add_sync(plk::kFull, sums[t]);
    if (t == 0 || total < best_sum) {
      best = t;
      best_sum = total;
    }
  }
  return best == f;
}

template <int BPP, bool ADAPTIVE>
__global__ void image_kernel(const int* s, int bleed, const int* w_real,
                             const int* ofreq, const uint8_t* rows,
                             const int* qprev0, const int* e00,
                             const int* e10, const int* hist0, int* qrows,
                             int* filt, int* ok, int* cand, int* e0n5,
                             int* e1n5, int* e0w, int* e1w, int H, int W) {
  __shared__ int hw[256];                     // winner's histogram
  __shared__ int hs[plk::kFilters][256];      // candidates' histograms
  __shared__ int os[plk::kFilters][256];      // original frequencies
  __shared__ long long cost[plk::kFilters];
  __shared__ bool passing[plk::kFilters];
  __shared__ int winner;

  const int b = blockIdx.x;
  const int tid = threadIdx.x;
  const int f = tid / plk::kWarp;
  const int lane = tid % plk::kWarp;
  const long long wb = static_cast<long long>(W) * BPP;
  const long long we = static_cast<long long>(W + 5) * 4;
  const int sb = s[b], wr = w_real[b];
  const uint8_t* img = rows + b * wb * H;
  int* my_e0 = e0w + b * we;
  int* my_e1 = e1w + b * we;
  int* my_q = qrows + b * wb * (H - 1);
  const long long bf = static_cast<long long>(b) * plk::kFilters + f;
  int all_rows_pass = 1;                      // read by thread 0 only

  for (int i = tid; i < plk::kFilters * 256; i += blockDim.x)
    os[i / 256][i % 256] = ofreq[b * plk::kFilters * 256 + i];
  for (int i = tid; i < 256; i += blockDim.x) hw[i] = hist0[b * 256 + i];
  for (long long i = tid; i < we; i += blockDim.x) {
    my_e0[i] = e00[b * we + i];
    my_e1[i] = e10[b * we + i];
  }
  __syncthreads();

  for (int y = 1; y < H; ++y) {
    for (int t = lane; t < 256; t += plk::kWarp) hs[f][t] = hw[t];
    __syncwarp();
    const int* qprev = y == 1 ? qprev0 + b * wb : my_q + (y - 2) * wb;
    const long long err = plk::quantize_row_warp<BPP, true, uint8_t>(
        f, lane, sb, bleed, wr, W, img + y * wb, img + (y - 1) * wb, qprev,
        my_e0, my_e1, hs[f], os[f], cand + bf * wb, e0n5 + bf * we,
        e1n5 + bf * we);
    long long bits = 0;
    for (int t = lane; t < 256; t += plk::kWarp) {
      const int fr = hs[f][t];
      if (fr > 0)
        bits += static_cast<long long>(fr - hw[t]) * (33 + __clz(fr));
    }
    for (int off = plk::kWarp / 2; off > 0; off /= 2)
      bits += __shfl_xor_sync(plk::kFull, bits, off);
    bool pass = true;
    if constexpr (ADAPTIVE) {
      // quantize_row_warp ends in __syncwarp: lane 0's stores of the
      // candidate row are visible to the whole warp
      pass = msad_passes<BPP>(f, lane, wr, cand + bf * wb, qprev);
    }
    if (lane == 0) {
      cost[f] = pass ? bits + err / 128 : LLONG_MAX;
      passing[f] = pass;
    }
    __syncthreads();
    if (tid == 0) {
      int best = 0;
      for (int k = 1; k < plk::kFilters; ++k)
        if (cost[k] < cost[best]) best = k;
      winner = best;
      filt[static_cast<long long>(b) * (H - 1) + y - 1] = best;
      if constexpr (ADAPTIVE) {
        bool any = false;
        for (int k = 0; k < plk::kFilters; ++k) any = any || passing[k];
        if (!any) all_rows_pass = 0;
      }
    }
    __syncthreads();
    const long long wf = static_cast<long long>(b) * plk::kFilters + winner;
    for (long long i = tid; i < wb; i += blockDim.x)
      my_q[(y - 1) * wb + i] = cand[wf * wb + i];
    for (long long i = tid; i < we; i += blockDim.x) {
      my_e0[i] = e0n5[wf * we + i];
      my_e1[i] = e1n5[wf * we + i];
    }
    for (int i = tid; i < 256; i += blockDim.x) hw[i] = hs[winner][i];
    __syncthreads();
  }
  if (ADAPTIVE && tid == 0) ok[b] = all_rows_pass;
}

}  // namespace

// s, w_real (B,); ofreq (B, 5, 256); rows (B, H, W*bpp) uint8; row-0
// winner state qprev0 (B, W, bpp), e00, e10 (B, W+5, 4), hist0 (B, 256)
// -> qrows (B, H-1, W, bpp), filt (B, H-1); ok (B,) selects embedding
// mode's MSAD self-check on every row when not null (1 = every row had a
// passing filter); scratch cand (B, 5, W, bpp), e0n5, e1n5 (B, 5, W+5, 4),
// e0w, e1w (B, W+5, 4); all int32 but rows.
extern "C" int plk_image_rows(const void* s, int bleed, const void* w_real,
                              const void* ofreq, const void* rows,
                              const void* qprev0, const void* e00,
                              const void* e10, const void* hist0,
                              void* qrows, void* filt, void* ok, void* cand,
                              void* e0n5, void* e1n5, void* e0w, void* e1w,
                              int B, int H, int W, int bpp, void* stream) {
  if (B <= 0 || H < 2) return static_cast<int>(cudaGetLastError());
  const dim3 grid(B), block(plk::kFilters * plk::kWarp);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define PLK_IMAGE_ARGS                                                    \
  static_cast<const int*>(s), bleed, static_cast<const int*>(w_real),    \
      static_cast<const int*>(ofreq), static_cast<const uint8_t*>(rows), \
      static_cast<const int*>(qprev0), static_cast<const int*>(e00),     \
      static_cast<const int*>(e10), static_cast<const int*>(hist0),      \
      static_cast<int*>(qrows), static_cast<int*>(filt),                 \
      static_cast<int*>(ok), static_cast<int*>(cand),                    \
      static_cast<int*>(e0n5), static_cast<int*>(e1n5),                  \
      static_cast<int*>(e0w), static_cast<int*>(e1w), H, W
#define PLK_IMAGE_LAUNCH(BPP)                                           \
  if (ok)                                                               \
    image_kernel<BPP, true><<<grid, block, 0, st>>>(PLK_IMAGE_ARGS);    \
  else                                                                  \
    image_kernel<BPP, false><<<grid, block, 0, st>>>(PLK_IMAGE_ARGS);
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
