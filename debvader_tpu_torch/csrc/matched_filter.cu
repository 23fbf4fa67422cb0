// Stand-alone matched filter: background subtract, 7x7 filter, threshold.
//
// Replaces the Pallas TPU kernel debvader_tpu/kernels/matched_filter.py
// matched_filter_threshold (_mf_kernel).  For one field (F, F):
//   filt[p] = sum_dx wx[dx] * sum_dy wy[dy] * fore[p + (dy-3, dx-3)]
//             for a separable (rank-1) filter, else
//             sum_dy sum_dx k[dy][dx] * fore[p + (dy-3, dx-3)] in row-major
//             tap order; fore = image - background, 0 outside the field
//             (SAME pad);
//   mask[p] = filt[p] > threshold.
//
// Bound on the H100: bytes.  The kernel reads image and background once
// and writes filt (4 bytes) and mask (1 byte) once, 13 bytes a pixel,
// against 28 operations a pixel (separable) or 98.  Design: one 256-thread
// block per 32x32 output tile stages the tile's 38x38 window of
// image - background in shared memory and filters it there, so the
// difference and the row pass never touch device memory.  The TPU kernel's
// padding to (8, 128)-aligned halo windows is gone: the grid covers F
// exactly and masks the ragged edge.
//
// Built with -fmad=false and explicit _rn intrinsics, accumulated from 0 in
// tap order, so filt matches the plain PyTorch version's separate
// multiplies and adds bit for bit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTile = 32;
constexpr int kHalo = 3;
constexpr int kIn = kTile + 2 * kHalo;  // 38
constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
matched_filter_kernel(const float* __restrict__ img, const float* __restrict__ back,
                      const float* __restrict__ threshold, const float* __restrict__ taps,
                      float* __restrict__ filt, uint8_t* __restrict__ mask, int f,
                      int separable) {
  __shared__ float fore[kIn][kIn + 1];
  __shared__ float tmp[kTile][kIn + 1];
  __shared__ float w[49];  // wy[0..6], wx[0..6], or the 49 taps row-major

  const int r0 = blockIdx.y * kTile;
  const int c0 = blockIdx.x * kTile;
  const float thr = threshold[0];
  const int tid = threadIdx.x;

  if (tid < (separable ? 14 : 49)) w[tid] = taps[tid];
  for (int i = tid; i < kIn * kIn; i += kThreads) {
    const int r = i / kIn, c = i % kIn;
    const int gr = r0 - kHalo + r, gc = c0 - kHalo + c;
    float v = 0.f;
    if (gr >= 0 && gr < f && gc >= 0 && gc < f) {
      const size_t g = static_cast<size_t>(gr) * f + gc;
      v = __fsub_rn(img[g], back[g]);
    }
    fore[r][c] = v;
  }
  __syncthreads();

  if (separable) {
    // down the rows with wy
    for (int i = tid; i < kTile * kIn; i += kThreads) {
      const int r = i / kIn, c = i % kIn;
      float a = 0.f;
#pragma unroll
      for (int dy = 0; dy < 7; ++dy) a = __fadd_rn(a, __fmul_rn(w[dy], fore[r + dy][c]));
      tmp[r][c] = a;
    }
    __syncthreads();
  }

  for (int i = tid; i < kTile * kTile; i += kThreads) {
    const int r = i / kTile, c = i % kTile;
    const int gr = r0 + r, gc = c0 + c;
    if (gr >= f || gc >= f) continue;
    float a = 0.f;
    if (separable) {
#pragma unroll
      for (int dx = 0; dx < 7; ++dx) a = __fadd_rn(a, __fmul_rn(w[7 + dx], tmp[r][c + dx]));
    } else {
      for (int dy = 0; dy < 7; ++dy)
#pragma unroll
        for (int dx = 0; dx < 7; ++dx)
          a = __fadd_rn(a, __fmul_rn(w[dy * 7 + dx], fore[r + dy][c + dx]));
    }
    const size_t g = static_cast<size_t>(gr) * f + gc;
    filt[g] = a;
    mask[g] = a > thr ? 1 : 0;
  }
}

}  // namespace

// img, back, filt: (f, f) float32 contiguous; mask: (f, f) bytes (0 or 1);
// threshold: one float32; taps: wy[7] then wx[7] when separable, else the
// 7x7 filter row-major; all on the device.  Returns the cudaError_t of the
// launch.
extern "C" int dvt_matched_filter(const float* img, const float* back, const float* threshold,
                                  const float* taps, float* filt, uint8_t* mask, int f,
                                  int separable, void* stream) {
  if (f <= 0) return 0;
  const dim3 grid((f + kTile - 1) / kTile, (f + kTile - 1) / kTile);
  matched_filter_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      img, back, threshold, taps, filt, mask, f, separable);
  return static_cast<int>(cudaGetLastError());
}
