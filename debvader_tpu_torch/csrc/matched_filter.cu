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
// against 28 operations a pixel (separable) or 98.  The design is the
// filter half of csrc/detect_fused.cu:
// - The taps are a kernel parameter (constant bank), so each is an operand
//   of its multiply, not a load; the branch is a template parameter.  The
//   threshold stays a device pointer: the caller computes it on the device.
// - One block of 256 threads owns a 32 x 64 output tile (grid: column
//   tiles, row tiles; no division).  The tile's 38 x 72 window of image
//   and background (3 rows of filter halo; 4 columns, so that the window's
//   left edge c0 - 4 is a multiple of 4) is staged with cp.async; outside
//   the field the copy zero-fills (source size 0): 0 - 0 = +0.0, the plain
//   version's padded fore.  With F % 4 == 0 and 16-byte aligned pointers
//   the copies are 16 bytes; other F take the instance with 4-byte copies
//   and scalar stores.  33 KB of shared memory and at most 64 registers a
//   thread let four or more blocks share an SM.
// - Register blocking: in the row pass (separable) a thread owns a column
//   of 11 tile rows and slides a 7-value window down it (17 loads for 11
//   outputs).  In the column pass a thread owns two groups of 4 outputs of
//   a row, 32 columns apart, and reads each group's inputs as 16-byte
//   loads; the 49-tap branch reads 7 such rows of image and background.
//   Eight threads span a row, so a warp's 16-byte stores of filt cover
//   whole 128-byte lines, and each thread writes a group's 4 mask bytes as
//   one 4-byte store.
// - Shared rows have a pitch of 76 floats (304 bytes, a multiple of 16
//   for the copies).
// Each output keeps the plain version's accumulation: from +0.0 in tap
// order, each product and sum rounded on its own (-fmad=false and _rn
// intrinsics), so filt is bit-identical to it.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTileR = 32;                       // output rows a tile
constexpr int kTileC = 64;                       // output columns a tile
constexpr int kHaloR = 3;                        // filter halo rows
constexpr int kHaloC = 4;                        // 3 filter + 1 for 16-byte alignment
constexpr int kInR = kTileR + 2 * kHaloR;        // 38 window rows
constexpr int kInC = kTileC + 2 * kHaloC;        // 72 window columns
constexpr int kPitch = 76;                       // floats a shared row
constexpr int kThreads = 256;
constexpr int kLanesRow = 8;                     // threads a tile row
constexpr int kGroup = 4;                        // outputs a group
constexpr int kGroupGap = kTileC / 2;            // 32: a thread's two groups apart
constexpr int kRowSeg = 11;                      // row pass: tile rows a thread
constexpr int kRowGroups = (kTileR + kRowSeg - 1) / kRowSeg;  // 3
constexpr int kRowItems = kInC * kRowGroups;     // 216

static_assert(kThreads == kLanesRow * kTileR, "eight threads a tile row");
static_assert(kLanesRow * kGroup * 2 == kTileC, "two groups of 4 a thread span the row");
static_assert(kRowItems <= kThreads, "one row-pass item a thread");
static_assert(kPitch % 4 == 0 && kPitch >= kInC, "16-byte shared rows");

struct Taps {
  float w[49];  // wy[0..6], wx[0..6], or the 49 taps row-major
};

template <int kVec>
__device__ __forceinline__ void cp_async(float* dst, const float* src, bool ok) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if (kVec == 4) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src),
                 "r"(ok ? 16 : 0));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src),
                 "r"(ok ? 4 : 0));
  }
}

// Stage the window of the tile at (r0, c0): row i, column j of the window
// is field pixel (r0 - 3 + i, c0 - 4 + j), 0 outside the field.
template <int kVec>
__device__ __forceinline__ void stage(float* s_img, float* s_back, const float* img,
                                      const float* back, int f, int r0, int c0) {
  const int tid = threadIdx.x;
  if (kVec == 4) {
    constexpr int kPerRow = kInC / 4;
    for (int idx = tid; idx < kInR * kPerRow; idx += kThreads) {
      const int i = idx / kPerRow, j = (idx % kPerRow) * 4;
      const int gr = r0 - kHaloR + i, gc = c0 - kHaloC + j;
      // F % 4 == 0 and gc % 4 == 0: a chunk is all in or all out
      const bool ok = gr >= 0 && gr < f && gc >= 0 && gc < f;
      const size_t g = ok ? static_cast<size_t>(gr) * f + gc : 0;
      cp_async<4>(s_img + i * kPitch + j, img + g, ok);
      cp_async<4>(s_back + i * kPitch + j, back + g, ok);
    }
  } else if (tid < kRowItems) {
    const int j = tid % kInC, gc = c0 - kHaloC + j;
    const bool col_ok = gc >= 0 && gc < f;
    for (int i = tid / kInC; i < kInR; i += kRowGroups) {
      const int gr = r0 - kHaloR + i;
      const bool ok = col_ok && gr >= 0 && gr < f;
      const size_t g = ok ? static_cast<size_t>(gr) * f + gc : 0;
      cp_async<1>(s_img + i * kPitch + j, img + g, ok);
      cp_async<1>(s_back + i * kPitch + j, back + g, ok);
    }
  }
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_group 0;\n" ::);
}

__device__ __forceinline__ float fore(const float* s_img, const float* s_back, int i) {
  return __fsub_rn(s_img[i], s_back[i]);
}

// n consecutive floats from 16-byte aligned shared memory
template <int n>
__device__ __forceinline__ void load(const float* p, float* v) {
#pragma unroll
  for (int q = 0; q < n / 4; ++q) {
    const float4 x = reinterpret_cast<const float4*>(p)[q];
    v[4 * q] = x.x;
    v[4 * q + 1] = x.y;
    v[4 * q + 2] = x.z;
    v[4 * q + 3] = x.w;
  }
}

template <bool kSep, int kVec>
__global__ void __launch_bounds__(kThreads, 4)
matched_filter_kernel(const float* __restrict__ img, const float* __restrict__ back,
                      const float* __restrict__ threshold, const Taps taps,
                      float* __restrict__ filt, uint8_t* __restrict__ mask, int f) {
  __shared__ __align__(16) float s_img[kInR * kPitch];
  __shared__ __align__(16) float s_back[kInR * kPitch];
  __shared__ __align__(16) float s_tmp[kTileR * kPitch];  // tile row r, window column j

  const int tid = threadIdx.x;
  const int c0 = blockIdx.x * kTileC, r0 = blockIdx.y * kTileR;
  const float thr = __ldg(threshold);
  stage<kVec>(s_img, s_back, img, back, f, r0, c0);
  __syncthreads();

  if (kSep) {
    // down the rows with wy: tile row e from window rows e .. e + 6
    if (tid < kRowItems) {
      const int c = tid % kInC, e0 = (tid / kInC) * kRowSeg;
      float v[kRowSeg + 6];
#pragma unroll
      for (int q = 0; q < kRowSeg + 6; ++q)
        v[q] = (e0 + q < kInR) ? fore(s_img, s_back, (e0 + q) * kPitch + c) : 0.f;
#pragma unroll
      for (int q = 0; q < kRowSeg; ++q) {
        if (e0 + q < kTileR) {
          float a = 0.f;
#pragma unroll
          for (int dy = 0; dy < 7; ++dy) a = __fadd_rn(a, __fmul_rn(taps.w[dy], v[q + dy]));
          s_tmp[(e0 + q) * kPitch + c] = a;
        }
      }
    }
    __syncthreads();
  }

  // this thread: tile row er, groups of columns b .. b + 3 at b = 4 q and
  // 4 q + 32; output column c reads window / tmp columns c + 1 .. c + 7
  const int er = tid / kLanesRow, q4 = (tid % kLanesRow) * kGroup;
  const int gr = r0 + er;
  if (gr >= f) return;
  const size_t row = static_cast<size_t>(gr) * f;
#pragma unroll
  for (int g = 0; g < 2; ++g) {
    const int b = q4 + g * kGroupGap;
    float out[kGroup];
    if (kSep) {
      float v[12];
      load<12>(s_tmp + er * kPitch + b, v);
#pragma unroll
      for (int m = 0; m < kGroup; ++m) {
        float a = 0.f;
#pragma unroll
        for (int dx = 0; dx < 7; ++dx) a = __fadd_rn(a, __fmul_rn(taps.w[7 + dx], v[m + 1 + dx]));
        out[m] = a;
      }
    } else {
#pragma unroll
      for (int m = 0; m < kGroup; ++m) out[m] = 0.f;
#pragma unroll
      for (int dy = 0; dy < 7; ++dy) {
        const int off = (er + dy) * kPitch + b;
        float vi[12], vb[12];
        load<12>(s_img + off, vi);
        load<12>(s_back + off, vb);
#pragma unroll
        for (int k = 1; k < 11; ++k) vi[k] = __fsub_rn(vi[k], vb[k]);
#pragma unroll
        for (int m = 0; m < kGroup; ++m)
#pragma unroll
          for (int dx = 0; dx < 7; ++dx)
            out[m] = __fadd_rn(out[m], __fmul_rn(taps.w[dy * 7 + dx], vi[m + 1 + dx]));
      }
    }
    const int gc = c0 + b;
    if (kVec == 4) {
      // F % 4 == 0 and gc % 4 == 0: the group is all in or all out
      if (gc < f) {
        *reinterpret_cast<float4*>(filt + row + gc) = make_float4(out[0], out[1], out[2], out[3]);
        const uint32_t bits = static_cast<uint32_t>(out[0] > thr) | static_cast<uint32_t>(out[1] > thr) << 8 |
                              static_cast<uint32_t>(out[2] > thr) << 16 |
                              static_cast<uint32_t>(out[3] > thr) << 24;
        *reinterpret_cast<uint32_t*>(mask + row + gc) = bits;
      }
    } else {
#pragma unroll
      for (int m = 0; m < kGroup; ++m) {
        if (gc + m < f) {
          filt[row + gc + m] = out[m];
          mask[row + gc + m] = out[m] > thr ? 1 : 0;
        }
      }
    }
  }
}

template <bool kSep, int kVec>
int launch(const float* img, const float* back, const float* threshold, const Taps& taps,
           float* filt, uint8_t* mask, int f, cudaStream_t stream) {
  const dim3 grid((f + kTileC - 1) / kTileC, (f + kTileR - 1) / kTileR);
  matched_filter_kernel<kSep, kVec><<<grid, kThreads, 0, stream>>>(img, back, threshold, taps, filt,
                                                                  mask, f);
  return static_cast<int>(cudaGetLastError());
}

bool aligned(const void* p, uintptr_t bytes) { return (reinterpret_cast<uintptr_t>(p) & (bytes - 1)) == 0; }

}  // namespace

// img, back, filt: (f, f) float32 contiguous on the device; mask: (f, f)
// bytes (0 or 1) on the device; threshold: one float32 on the device;
// taps in host memory: wy[7] then wx[7] when separable, else the 7x7
// filter row-major (passed to the kernel by value).  Returns the
// cudaError_t of the launch.
extern "C" int dvt_matched_filter(const float* img, const float* back, const float* threshold,
                                  const float* taps, float* filt, uint8_t* mask, int f,
                                  int separable, void* stream) {
  if (f <= 0) return 0;
  if ((f + kTileR - 1) / kTileR > 65535) return static_cast<int>(cudaErrorInvalidValue);
  Taps w{};
  for (int i = 0; i < (separable ? 14 : 49); ++i) w.w[i] = taps[i];
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool vec = f % 4 == 0 && aligned(img, 16) && aligned(back, 16) && aligned(filt, 16) &&
                   aligned(mask, 4);
  if (separable) {
    return vec ? launch<true, 4>(img, back, threshold, w, filt, mask, f, st)
               : launch<true, 1>(img, back, threshold, w, filt, mask, f, st);
  }
  return vec ? launch<false, 4>(img, back, threshold, w, filt, mask, f, st)
             : launch<false, 1>(img, back, threshold, w, filt, mask, f, st);
}
