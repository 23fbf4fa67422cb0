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
// about 60 operations a pixel.  The first design (a 32x32 tile a block,
// every operand a shared-memory load, 43 of them a pixel, scalar stores)
// spent its time issuing instructions, so this one counts them:
// - The taps are a kernel parameter (constant bank), so each is an operand
//   of its multiply, not a load; the branch is a template parameter.
// - One block of 256 threads owns a 32 x 64 output tile (grid: column
//   tiles, row tiles, fields; no division).  The tile's 40 x 72 window of
//   image and background (3 pixels of filter halo and 1 of race halo) is
//   staged with cp.async; outside the field the copy zero-fills (source
//   size 0): 0 - 0 = +0.0, the plain version's padded fore.  With F % 4 ==
//   0 and 16-byte aligned pointers the copies are 16 bytes (the window's
//   left edge, c0 - 4, is a multiple of 4); other F take the instance with
//   4-byte copies and scalar stores.  45 KB of shared memory and at most
//   64 registers a thread let four blocks share an SM, whose warps hide
//   each other's latency (persistent double-buffered blocks measured
//   slower on the card).
// - Register blocking: in the row pass (separable) a thread owns a column
//   of 12 ring rows and slides a 7-value window down it (18 loads for 12
//   outputs).  In the column pass and the race a thread owns two groups of
//   4 outputs of a row, 32 columns apart, and reads each group's inputs
//   as 16-byte loads; the 49-tap branch reads 7 such rows of image and
//   background.  Eight threads span a row, so a warp's 16-byte stores of
//   filt, dir_code and parent cover whole 128-byte lines.
// - The race compares values and codes only: neighbour indices rise with
//   the code, so the index tie-break needs no index.
// - The race ring (one pixel round the tile, 196 values) is filtered by a
//   pass of its own, so the tile's 2,048 outputs keep the blocking above.
// - Shared rows have a pitch of 76 floats (304 bytes, a multiple of 16
//   for the copies).
// Each output keeps the plain version's accumulation: from +0.0 in tap
// order, each product and sum rounded on its own (-fmad=false and _rn
// intrinsics), so filt is bit-identical to it.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kTileR = 32;                       // output rows a tile
constexpr int kTileC = 64;                       // output columns a tile
constexpr int kHalo = 4;                         // 3 filter + 1 race
constexpr int kInR = kTileR + 2 * kHalo;         // 40 window rows
constexpr int kInC = kTileC + 2 * kHalo;         // 72 window columns
constexpr int kExtR = kTileR + 2;                // 34: tile rows + race ring
constexpr int kPitch = 76;                       // floats a shared row
constexpr int kThreads = 256;
constexpr int kLanesRow = 8;                     // threads a tile row
constexpr int kGroup = 4;                        // outputs a group
constexpr int kGroupGap = kTileC / 2;            // 32: a thread's two groups apart
constexpr int kRowSeg = 12;                      // row pass: ring rows a thread
constexpr int kRowGroups = (kExtR + kRowSeg - 1) / kRowSeg;  // 3
constexpr int kRowItems = kInC * kRowGroups;     // 216
constexpr int kRing = 2 * (kTileC + 2) + 2 * kTileR;         // 196

static_assert(kThreads == kLanesRow * kTileR, "eight threads a tile row");
static_assert(kLanesRow * kGroup * 2 == kTileC, "two groups of 4 a thread span the row");
static_assert(kRowItems <= kThreads && kRing <= kThreads, "one pass item a thread");
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
// is field pixel (r0 - 4 + i, c0 - 4 + j), 0 outside the field.
template <int kVec>
__device__ __forceinline__ void stage(float* s_img, float* s_back, const float* img,
                                      const float* back, int f, int r0, int c0) {
  const int tid = threadIdx.x;
  if (kVec == 4) {
    constexpr int kPerRow = kInC / 4;
    for (int idx = tid; idx < kInR * kPerRow; idx += kThreads) {
      const int i = idx / kPerRow, j = (idx % kPerRow) * 4;
      const int gr = r0 - kHalo + i, gc = c0 - kHalo + j;
      // F % 4 == 0 and gc % 4 == 0: a chunk is all in or all out
      const bool ok = gr >= 0 && gr < f && gc >= 0 && gc < f;
      const size_t g = ok ? static_cast<size_t>(gr) * f + gc : 0;
      cp_async<4>(s_img + i * kPitch + j, img + g, ok);
      cp_async<4>(s_back + i * kPitch + j, back + g, ok);
    }
  } else if (tid < kInC * kRowGroups) {
    const int j = tid % kInC, gc = c0 - kHalo + j;
    const bool col_ok = gc >= 0 && gc < f;
    for (int i = tid / kInC; i < kInR; i += kRowGroups) {
      const int gr = r0 - kHalo + i;
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

__device__ __forceinline__ void store4(float* p, const float* v) {
  *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
}
__device__ __forceinline__ void store4(int32_t* p, const int32_t* v) {
  *reinterpret_cast<int4*>(p) = make_int4(v[0], v[1], v[2], v[3]);
}

// 4 consecutive values to a field row from column gc on: one 16-byte store
// with kVec 4 (F % 4 == 0, gc % 4 == 0), else scalar stores.
template <int kVec, typename T>
__device__ __forceinline__ void store_group(T* row, int gc, int f, const T* v) {
  if (kVec == 4) {
    if (gc < f) store4(row + gc, v);
  } else {
#pragma unroll
    for (int m = 0; m < kGroup; ++m)
      if (gc + m < f) row[gc + m] = v[m];
  }
}

template <bool kSep, int kVec>
__global__ void __launch_bounds__(kThreads, 4)
detect_fused_kernel(const float* __restrict__ img, const float* __restrict__ back,
                    const float* __restrict__ thresholds, const Taps taps,
                    float* __restrict__ filt, int32_t* __restrict__ dir,
                    int32_t* __restrict__ parent, int f) {
  __shared__ __align__(16) float s_img[kInR * kPitch];
  __shared__ __align__(16) float s_back[kInR * kPitch];
  __shared__ __align__(16) float s_tmp[kExtR * kPitch];   // ring row e (tile row e - 1), window column j
  __shared__ __align__(16) float s_mval[kExtR * kPitch];  // ring row e, tile column c at c + 4

  const int tid = threadIdx.x;
  const int c0 = blockIdx.x * kTileC, r0 = blockIdx.y * kTileR;
  const size_t plane = static_cast<size_t>(blockIdx.z) * f * f;
  const float thr = __ldg(thresholds + blockIdx.z);
  stage<kVec>(s_img, s_back, img + plane, back + plane, f, r0, c0);
  __syncthreads();

  if (kSep) {
    // down the rows with wy: ring row e from window rows e .. e + 6
    if (tid < kRowItems) {
      const int c = tid % kInC, e0 = (tid / kInC) * kRowSeg;
      float v[kRowSeg + 6];
#pragma unroll
      for (int q = 0; q < kRowSeg + 6; ++q)
        v[q] = (e0 + q < kInR) ? fore(s_img, s_back, (e0 + q) * kPitch + c) : 0.f;
#pragma unroll
      for (int q = 0; q < kRowSeg; ++q) {
        if (e0 + q < kExtR) {
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
  const size_t row = plane + static_cast<size_t>(gr) * f;
#pragma unroll
  for (int g = 0; g < 2; ++g) {
    const int b = q4 + g * kGroupGap;
    float out[kGroup];
    if (kSep) {
      float v[12];
      load<12>(s_tmp + (er + 1) * kPitch + b, v);
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
        const int off = (er + 1 + dy) * kPitch + b;
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
    if (gr < f) store_group<kVec>(filt + row, gc, f, out);
    float mv[kGroup];
#pragma unroll
    for (int m = 0; m < kGroup; ++m) mv[m] = (gr < f && gc + m < f && out[m] > thr) ? out[m] : -INFINITY;
    *reinterpret_cast<float4*>(s_mval + (er + 1) * kPitch + b + 4) = make_float4(mv[0], mv[1], mv[2], mv[3]);
  }

  // the race ring: tile rows -1 and 32 (columns -1 .. 64), columns -1
  // and 64 (rows 0 .. 31)
  if (tid < kRing) {
    int rr, cc;
    if (tid < kTileC + 2) {
      rr = -1;
      cc = tid - 1;
    } else if (tid < 2 * (kTileC + 2)) {
      rr = kTileR;
      cc = tid - (kTileC + 2) - 1;
    } else if (tid < 2 * (kTileC + 2) + kTileR) {
      rr = tid - 2 * (kTileC + 2);
      cc = -1;
    } else {
      rr = tid - 2 * (kTileC + 2) - kTileR;
      cc = kTileC;
    }
    float a = 0.f;
    if (kSep) {
      const float* tr = s_tmp + (rr + 1) * kPitch + cc + 1;
#pragma unroll
      for (int dx = 0; dx < 7; ++dx) a = __fadd_rn(a, __fmul_rn(taps.w[7 + dx], tr[dx]));
    } else {
#pragma unroll
      for (int dy = 0; dy < 7; ++dy) {
        const int off = (rr + 1 + dy) * kPitch + cc + 1;
#pragma unroll
        for (int dx = 0; dx < 7; ++dx)
          a = __fadd_rn(a, __fmul_rn(taps.w[dy * 7 + dx], fore(s_img, s_back, off + dx)));
      }
    }
    const int grr = r0 + rr, gcc = c0 + cc;
    const bool inside = grr >= 0 && grr < f && gcc >= 0 && gcc < f;
    s_mval[(rr + 1) * kPitch + cc + 4] = (inside && a > thr) ? a : -INFINITY;
  }
  __syncthreads();
  if (gr >= f) return;

  // the race, a group at a time: rows er - 1 .. er + 1, columns b - 1 ..
  // b + 4 (shared columns b + 3 .. b + 8, read as b .. b + 11)
#pragma unroll
  for (int g = 0; g < 2; ++g) {
    const int b = q4 + g * kGroupGap;
    float nb[3][12];
#pragma unroll
    for (int k = 0; k < 3; ++k) load<12>(s_mval + (er + k) * kPitch + b, nb[k]);
    int32_t dcode[kGroup], par[kGroup];
#pragma unroll
    for (int m = 0; m < kGroup; ++m) {
      // Neighbour indices rise with the code (row-major), so a tie with
      // codes 0..3 (below the centre) wins only against the centre and a
      // tie with codes 5..8 never wins.  A neighbour outside the field is
      // -inf and cannot win once the centre is masked (else the outputs
      // are 4 and 0 anyway), so no index is compared.
      const float center = nb[1][m + 4];
      float best_v = center;
      int32_t best_c = 4;
#pragma unroll
      for (int code = 0; code < 9; ++code) {
        if (code == 4) continue;
        const float nv = nb[code / 3][m + 3 + code % 3];
        if (nv > best_v || (code < 4 && nv == best_v && best_c == 4)) {
          best_v = nv;
          best_c = code;
        }
      }
      const bool masked = center > -INFINITY;
      dcode[m] = masked ? best_c : 4;
      par[m] = masked ? (gr + best_c / 3 - 1) * f + c0 + b + m + best_c % 3 - 1 : 0;
    }
    store_group<kVec>(dir + row, c0 + b, f, dcode);
    store_group<kVec>(parent + row, c0 + b, f, par);
  }
}

template <bool kSep, int kVec>
int launch(const float* img, const float* back, const float* thresholds, const Taps& taps,
           float* filt, int32_t* dir, int32_t* parent, int t, int f, cudaStream_t stream) {
  const dim3 grid((f + kTileC - 1) / kTileC, (f + kTileR - 1) / kTileR, t);
  detect_fused_kernel<kSep, kVec><<<grid, kThreads, 0, stream>>>(img, back, thresholds, taps,
                                                                 filt, dir, parent, f);
  return static_cast<int>(cudaGetLastError());
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

}  // namespace

// img, back, filt, dir, parent: (t, f, f) contiguous on the device;
// thresholds (t,) on the device; taps in host memory: wy[7] then wx[7]
// when separable, else the 7x7 filter row-major (passed to the kernel by
// value).  Returns the cudaError_t of the launch.
extern "C" int dvt_detect_fused(const float* img, const float* back, const float* thresholds,
                                const float* taps, float* filt, int32_t* dir, int32_t* parent,
                                int t, int f, int separable, void* stream) {
  if (t <= 0 || f <= 0) return 0;
  if (t > 65535 || (f + kTileR - 1) / kTileR > 65535) return static_cast<int>(cudaErrorInvalidValue);
  Taps w{};
  for (int i = 0; i < (separable ? 14 : 49); ++i) w.w[i] = taps[i];
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool vec = f % 4 == 0 && aligned16(img) && aligned16(back) && aligned16(filt) &&
                   aligned16(dir) && aligned16(parent);
  if (separable) {
    return vec ? launch<true, 4>(img, back, thresholds, w, filt, dir, parent, t, f, st)
               : launch<true, 1>(img, back, thresholds, w, filt, dir, parent, t, f, st);
  }
  return vec ? launch<false, 4>(img, back, thresholds, w, filt, dir, parent, t, f, st)
             : launch<false, 1>(img, back, thresholds, w, filt, dir, parent, t, f, st);
}
