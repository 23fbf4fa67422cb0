// Fused detection core: background subtract, 7x7 matched filter, threshold,
// steepest-ascent parent race.
//
// Replaces the Pallas TPU kernel debvader_tpu/kernels/detect_fused.py
// matched_filter_parents (_df_kernel).  For a stack of T fields (F, F):
//   filt[p]   = sum_dx wx[dx] * sum_dy wy[dy] * fore[p + (dy-3, dx-3)]
//               for a separable (rank-1) filter, else
//               sum_dy sum_dx k[dy][dx] * fore[p + (dy-3, dx-3)] in row-major
//               tap order; fore = image - background, 0 outside the field
//               (SAME pad);
//   mask[p]   = filt[p] > threshold[t];
//   parent[p] = the best of p and its 8 neighbours in (value, -index)
//               order, neighbours taken in (dy, dx) row-major order, masked
//               and out-of-field pixels at -inf; dir_code = its position
//               (dy+1)*3 + (dx+1), 4 = self.  Unmasked pixels carry
//               dir_code 4 and parent 0.
// Parent is the per-field flat index row*F + col.
//
// Bound on the H100: bytes.  The kernel reads image and background once
// and writes filt, dir_code and parent once (20 bytes a pixel) against
// about 60 operations a pixel.  Design: one 256-thread block per 32x32
// output tile; the tile's 40x40 window of image - background (3 pixels of
// filter halo plus 1 of race halo) is staged in shared memory, filtered
// (down the rows then along the columns, or with all 49 taps) into a 34x34
// ring, and the race reads the ring, so no intermediate touches device
// memory.  Row padding
// for the TPU's (8, 128) tiling is gone: the grid covers F exactly and
// masks the ragged edge.
//
// Built with -fmad=false and explicit _rn intrinsics so filt matches the
// plain PyTorch version's separate multiplies and adds bit for bit.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kTile = 32;
constexpr int kHalo = 4;                  // 3 filter + 1 race
constexpr int kIn = kTile + 2 * kHalo;    // 40
constexpr int kExt = kTile + 2;           // 34: output tile + race ring
constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads)
detect_fused_kernel(const float* __restrict__ img, const float* __restrict__ back,
                    const float* __restrict__ thresholds, const float* __restrict__ taps,
                    float* __restrict__ filt, int32_t* __restrict__ dir,
                    int32_t* __restrict__ parent, int f, int separable) {
  __shared__ float fore[kIn][kIn + 1];
  __shared__ float tmp[kExt][kIn + 1];
  __shared__ float mval[kExt][kExt + 1];
  __shared__ float w[49];  // wy[0..6], wx[0..6], or the 49 taps row-major

  const int t = blockIdx.z;
  const int r0 = blockIdx.y * kTile;
  const int c0 = blockIdx.x * kTile;
  const size_t plane = static_cast<size_t>(f) * f;
  img += t * plane;
  back += t * plane;
  filt += t * plane;
  dir += t * plane;
  parent += t * plane;
  const float thr = thresholds[t];
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

  // down the rows with wy: ring row e is global row r0 - 1 + e
  if (separable) {
    for (int i = tid; i < kExt * kIn; i += kThreads) {
      const int e = i / kIn, c = i % kIn;
      float a = 0.f;
#pragma unroll
      for (int dy = 0; dy < 7; ++dy) a = __fadd_rn(a, __fmul_rn(w[dy], fore[e + dy][c]));
      tmp[e][c] = a;
    }
    __syncthreads();
  }

  // along the columns with wx (or all 49 taps of a filter that does not
  // separate), then threshold; ring column e is c0 - 1 + e
  for (int i = tid; i < kExt * kExt; i += kThreads) {
    const int er = i / kExt, ec = i % kExt;
    float a = 0.f;
    if (separable) {
#pragma unroll
      for (int dx = 0; dx < 7; ++dx) a = __fadd_rn(a, __fmul_rn(w[7 + dx], tmp[er][ec + dx]));
    } else {
      for (int dy = 0; dy < 7; ++dy)
#pragma unroll
        for (int dx = 0; dx < 7; ++dx)
          a = __fadd_rn(a, __fmul_rn(w[dy * 7 + dx], fore[er + dy][ec + dx]));
    }
    const int gr = r0 - 1 + er, gc = c0 - 1 + ec;
    const bool inside = gr >= 0 && gr < f && gc >= 0 && gc < f;
    if (inside && er >= 1 && er <= kTile && ec >= 1 && ec <= kTile)
      filt[static_cast<size_t>(gr) * f + gc] = a;
    mval[er][ec] = (inside && a > thr) ? a : -INFINITY;
  }
  __syncthreads();

  for (int i = tid; i < kTile * kTile; i += kThreads) {
    const int r = i / kTile, c = i % kTile;
    const int gr = r0 + r, gc = c0 + c;
    if (gr >= f || gc >= f) continue;
    const float center = mval[r + 1][c + 1];
    float best_v = center;
    int32_t best_i = gr * f + gc;
    int32_t best_c = 4;
#pragma unroll
    for (int code = 0; code < 9; ++code) {
      if (code == 4) continue;
      const int dy = code / 3 - 1, dx = code % 3 - 1;
      const int ny = gr + dy, nx = gc + dx;
      const float nv = mval[r + 1 + dy][c + 1 + dx];
      const int32_t ni = (ny >= 0 && ny < f && nx >= 0 && nx < f) ? ny * f + nx : -1;
      if (nv > best_v || (nv == best_v && ni < best_i)) {
        best_v = nv;
        best_i = ni;
        best_c = code;
      }
    }
    const bool masked = center > -INFINITY;
    const size_t g = static_cast<size_t>(gr) * f + gc;
    dir[g] = masked ? best_c : 4;
    parent[g] = masked ? best_i : 0;
  }
}

}  // namespace

// img, back, filt, dir, parent: (t, f, f) contiguous; thresholds (t,);
// taps: wy[7] then wx[7] when separable, else the 7x7 filter row-major; all
// float32 / int32 on the device.  Returns the cudaError_t of the launch.
extern "C" int dvt_detect_fused(const float* img, const float* back, const float* thresholds,
                                const float* taps, float* filt, int32_t* dir, int32_t* parent,
                                int t, int f, int separable, void* stream) {
  if (t <= 0 || f <= 0) return 0;
  const dim3 grid((f + kTile - 1) / kTile, (f + kTile - 1) / kTile, t);
  detect_fused_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      img, back, thresholds, taps, filt, dir, parent, f, separable);
  return static_cast<int>(cudaGetLastError());
}
