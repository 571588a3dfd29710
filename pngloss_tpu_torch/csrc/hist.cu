// Original-frequency pre-pass on Hopper.
//
// Replaces the TPU kernel pngloss_tpu/ops/pallas_hist.py:_hist_kernel
// (launched by _hist_contract, wrapped by original_frequencies_pallas): per
// image, the 5x256 histograms of the original residuals
// (orig - predict_f(original neighbours)) & 0xFF under filters 0-4
// (optimize_state.c:66-83). The TPU builds nibble one-hots and contracts
// them on its matrix unit, because it has no fast scatter; this card has
// shared-memory atomics.
//
// Bound: int32 operations (the five predictors and residuals of every
// sample), not bytes: the image is read once, 16 bytes a lane. The five
// shared-memory atomics a sample costs are no int32 operations, so the
// kernel cannot reach that bound. What a
// kernel of this kind loses its time to is address arithmetic per sample,
// narrow loads, and many small blocks that each add 1280 bins into global
// memory. The design:
//   * a block owns a run of whole-row units of one image, and a lane owns
//     16 consecutive bytes of one row, so x, y and the channel are loop
//     counters: the sample loop has no division and, being unrolled over
//     the 16 bytes with the bytes per pixel as a template parameter, no
//     address arithmetic either;
//   * this row and the row above arrive as one 16-byte load each on the
//     read-only path, plus the 4 bytes before them, which hold the left and
//     diagonal neighbours of the lane's first pixel; a pitch or base that
//     is not 16-byte aligned takes byte loads into the same registers;
//   * rows narrower than 512 bytes share a warp (a power-of-two number of
//     lanes per row), so narrow images keep every lane busy;
//   * one copy of the 5 histograms per block in shared memory: a hot bin
//     (a flat image under filters 1-4) costs nothing on an H100, where a
//     constant image ran as fast as noise, so the atomics of one warp on
//     one address do not serialise; 2, 4 and 8 copies per block (one per
//     lane & 7, bank-shifted) ran 3%, 13% and 23% slower, for their
//     zeroing and summing;
//   * a few long-lived blocks per SM (4 measured best of 2-8), split
//     evenly over the images, each adding its bins into global memory
//     once.
// Integer adds are exact in any order, so the result is deterministic.
//
// Samples with x >= w_real or y >= h_real count nothing and are not read.

#include <cstdint>
#include <cuda_runtime.h>

#include "quantize.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / plk::kWarp;
constexpr int kBlocksPerSm = 4;
constexpr int kBins = plk::kFilters * 256;
constexpr int kVec = 16;                  // bytes of a row per lane
constexpr int kSegment = plk::kWarp * kVec;

// 16 bytes of a row from p; ``n`` bytes remain up to the row's end (the
// pitch, not the real width). ALIGNED: p and the pitch are multiples of 16.
template <bool ALIGNED>
__device__ __forceinline__ uint4 load_vec(const uint8_t* __restrict__ p,
                                          int n) {
  if constexpr (ALIGNED) {
    return __ldg(reinterpret_cast<const uint4*>(p));
  } else {
    unsigned w[4] = {0u, 0u, 0u, 0u};
#pragma unroll
    for (int j = 0; j < kVec; ++j)
      if (j < n) w[j / 4] |= static_cast<unsigned>(__ldg(p + j)) << (8 * (j % 4));
    return make_uint4(w[0], w[1], w[2], w[3]);
  }
}

// The 4 bytes before p, which lies ``off`` bytes into its row; bytes before
// the row's start read as 0 (no left or diagonal neighbour at x = 0).
template <bool ALIGNED>
__device__ __forceinline__ unsigned load_before(
    const uint8_t* __restrict__ p, int off) {
  if constexpr (ALIGNED) {
    return off ? __ldg(reinterpret_cast<const unsigned*>(p) - 1) : 0u;
  } else {
    unsigned w = 0u;
#pragma unroll
    for (int j = 1; j <= 4; ++j)
      if (j <= off) w |= static_cast<unsigned>(__ldg(p - j)) << (8 * (4 - j));
    return w;
  }
}

// v[4 + j] = byte j of the 16 in ``vec``, v[0..3] = the 4 bytes ``before``.
__device__ __forceinline__ void unpack(int (&v)[4 + kVec], unsigned before,
                                       const uint4& vec) {
  const unsigned w[5] = {before, vec.x, vec.y, vec.z, vec.w};
#pragma unroll
  for (int j = 0; j < 4 + kVec; ++j) v[j] = (w[j / 4] >> (8 * (j % 4))) & 0xFF;
}

template <int BPP, bool ALIGNED>
__global__ void __launch_bounds__(kThreads)
hist_kernel(const uint8_t* __restrict__ rows, const int* __restrict__ w_real,
            const int* __restrict__ h_real, int* __restrict__ out, int H,
            int W, int blocks_per_image) {
  __shared__ int h[kBins];
  for (int i = threadIdx.x; i < kBins; i += kThreads) h[i] = 0;
  __syncthreads();

  const int b = blockIdx.x / blocks_per_image;
  const int k = blockIdx.x - b * blocks_per_image;
  const int warp = threadIdx.x / plk::kWarp;
  const int lane = threadIdx.x % plk::kWarp;
  const int wb = W * BPP;                               // pitch in bytes
  const int wr = min(max(w_real[b], 0), W) * BPP;       // real bytes a row
  const int hr = min(max(h_real[b], 0), H);
  const uint8_t* img = rows + static_cast<long long>(b) * H * wb;

  // a unit is what one warp takes at once: 32 / lanes rows of up to 512
  // bytes when a row fits part of a warp, else one 512-byte segment of a row
  const int vecs = (wr + kVec - 1) / kVec;
  int log_lanes = 0;
  while ((1 << log_lanes) < vecs && log_lanes < 5) ++log_lanes;
  const int rows_per_unit = plk::kWarp >> log_lanes;
  const int segs = max(1, (vecs + plk::kWarp - 1) / plk::kWarp);
  const int groups = (hr + rows_per_unit - 1) / rows_per_unit;
  const long long units = static_cast<long long>(groups) * segs;
  const long long lo = units * k / blocks_per_image;
  const long long hi = units * (k + 1) / blocks_per_image;
  const int sub = lane >> log_lanes;                    // row in the unit
  const int lane_off = (lane & ((1 << log_lanes) - 1)) * kVec;

  // unit u = (row group g, segment seg), stepped without dividing
  const long long first = lo + warp;
  int g = static_cast<int>(first / segs);
  int seg = static_cast<int>(first - static_cast<long long>(g) * segs);
  const int step_g = kWarps / segs, step_seg = kWarps % segs;
  for (long long u = first; u < hi; u += kWarps) {
    const int y = g * rows_per_unit + sub;
    const int off = seg * kSegment + lane_off;
    const int n = wr - off;                 // real bytes from off onwards
    g += step_g;
    seg += step_seg;
    if (seg >= segs) {
      seg -= segs;
      ++g;
    }
    if (y >= hr || n <= 0) continue;
    const uint8_t* p = img + static_cast<long long>(y) * wb + off;
    int cur[4 + kVec], abv[4 + kVec];
    unpack(cur, load_before<ALIGNED>(p, off), load_vec<ALIGNED>(p, wb - off));
    if (y > 0) {
      unpack(abv, load_before<ALIGNED>(p - wb, off),
             load_vec<ALIGNED>(p - wb, wb - off));
    } else {
#pragma unroll
      for (int j = 0; j < 4 + kVec; ++j) abv[j] = 0;
    }
#pragma unroll
    for (int j = 0; j < kVec; ++j) {
      if (j < n) {
        const int o = cur[4 + j], left = cur[4 + j - BPP];
        const int above = abv[4 + j], diag = abv[4 + j - BPP];
#pragma unroll
        for (int f = 0; f < plk::kFilters; ++f)
          atomicAdd(
              h + f * 256 + ((o - plk::predict(f, above, diag, left)) & 0xFF),
              1);
      }
    }
  }
  __syncthreads();
  int* dst = out + static_cast<long long>(b) * kBins;
  for (int i = threadIdx.x; i < kBins; i += kThreads)
    if (h[i]) atomicAdd(dst + i, h[i]);
}

template <int BPP>
void launch(bool aligned, int grid, cudaStream_t st, const uint8_t* rows,
            const int* w_real, const int* h_real, int* out, int H, int W,
            int blocks_per_image) {
  if (aligned)
    hist_kernel<BPP, true><<<grid, kThreads, 0, st>>>(
        rows, w_real, h_real, out, H, W, blocks_per_image);
  else
    hist_kernel<BPP, false><<<grid, kThreads, 0, st>>>(
        rows, w_real, h_real, out, H, W, blocks_per_image);
}

}  // namespace

// rows (B, H, W*bpp) uint8; w_real, h_real (B,) int32; out (B, 5, 256)
// int32, zeroed by the caller. The grid is one-dimensional, B times the
// blocks per image, so B is bounded only by the grid's 2^31 - 1.
extern "C" int plk_hist(const void* rows, const void* w_real,
                        const void* h_real, void* out, int B, int H, int W,
                        int bpp, void* stream) {
  const long long wb = static_cast<long long>(W) * bpp;
  if (B <= 0 || H <= 0 || wb <= 0) return static_cast<int>(cudaGetLastError());
  if (wb > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0, sms = 0;
  cudaError_t rc = cudaGetDevice(&dev);
  if (rc == cudaSuccess)
    rc = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  // kBlocksPerSm blocks an SM over all images, but no block with less
  // than one unit a warp
  const long long most = (static_cast<long long>(H) *
                          ((wb + kSegment - 1) / kSegment) + kWarps - 1) /
                         kWarps;
  long long per_image = (static_cast<long long>(kBlocksPerSm) * sms + B - 1) / B;
  if (per_image > most) per_image = most;
  if (per_image < 1) per_image = 1;
  if (per_image * B > 0x7fffffffLL)
    return static_cast<int>(cudaErrorInvalidConfiguration);
  const bool aligned =
      reinterpret_cast<uintptr_t>(rows) % 16 == 0 && wb % 16 == 0;
  const int grid = static_cast<int>(per_image * B);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define PLK_HIST_ARGS                                                       \
  aligned, grid, st, static_cast<const uint8_t*>(rows),                    \
      static_cast<const int*>(w_real), static_cast<const int*>(h_real),    \
      static_cast<int*>(out), H, W, static_cast<int>(per_image)
  switch (bpp) {
    case 1: launch<1>(PLK_HIST_ARGS); break;
    case 2: launch<2>(PLK_HIST_ARGS); break;
    case 3: launch<3>(PLK_HIST_ARGS); break;
    case 4: launch<4>(PLK_HIST_ARGS); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
#undef PLK_HIST_ARGS
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* plk_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
