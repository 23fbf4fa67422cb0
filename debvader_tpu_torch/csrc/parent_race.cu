// Steepest-ascent parent race of the detection chain.
//
// The chain of ops/detection._detect_core filters a field on its own (the
// stand-alone matched filter or F.conv2d) and then races; the JAX package
// computes the race in XLA (debvader_tpu/ops/detection.py _detect_core),
// the port's plain version is kernels/detect_fused.py parent_race.  For
// filtered fields (T, F, F) and thresholds (T,):
//   mask[p]   = filt[p] > threshold[t];
//   parent[p] = the best of p and its 8 neighbours in (value, -index)
//               order, neighbours in (dy, dx) row-major order, masked and
//               out-of-field pixels at -inf; dir_code = its position
//               (dy+1)*3 + (dx+1), 4 = self.  Unmasked pixels carry
//               dir_code 4 and parent 0 (the per-field flat index).
//
// Bound on the H100: bytes.  filt is read once and dir_code and parent are
// written once (12 bytes a pixel) against about 20 comparisons a pixel.
// Design: the race phase of csrc/detect_fused.cu on its own.  One block of
// 256 threads owns a 32 x 64 tile (grid: column tiles, row tiles, fields);
// it loads the tile and a one-pixel ring of filt (16-byte loads when F % 4
// == 0 and the pointers are 16-byte aligned), thresholds it into a shared
// array of values (-inf where masked out or outside the field), then each
// thread races two groups of 4 outputs of a row, 32 columns apart, so a
// warp's 16-byte stores of dir_code and parent cover whole 128-byte lines.
// The race compares values and codes only: neighbour indices rise with the
// code, so the index tie-break needs no index.  Comparisons only, so the
// outputs are bit-identical to the plain version.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kTileR = 32;                // output rows a tile
constexpr int kTileC = 64;                // output columns a tile
constexpr int kExtR = kTileR + 2;         // 34: tile rows + ring
constexpr int kExtC = kTileC + 2;         // 66
constexpr int kPitch = 76;                // floats a shared row; tile column c at c + 4
constexpr int kThreads = 256;
constexpr int kLanesRow = 8;              // threads a tile row
constexpr int kGroup = 4;                 // outputs a group
constexpr int kGroupGap = kTileC / 2;     // 32: a thread's two groups apart

static_assert(kThreads == kLanesRow * kTileR, "eight threads a tile row");
static_assert(kLanesRow * kGroup * 2 == kTileC, "two groups of 4 a thread span the row");

__device__ __forceinline__ float masked(float x, float thr) { return x > thr ? x : -INFINITY; }

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

// 4 consecutive values to a field row from column gc on: one 16-byte store
// with kVec 4 (F % 4 == 0, gc % 4 == 0), else scalar stores.
template <int kVec>
__device__ __forceinline__ void store_group(int32_t* row, int gc, int f, const int32_t* v) {
  if (kVec == 4) {
    if (gc < f) *reinterpret_cast<int4*>(row + gc) = make_int4(v[0], v[1], v[2], v[3]);
  } else {
#pragma unroll
    for (int m = 0; m < kGroup; ++m)
      if (gc + m < f) row[gc + m] = v[m];
  }
}

template <int kVec>
__global__ void __launch_bounds__(kThreads)
parent_race_kernel(const float* __restrict__ filt, const float* __restrict__ thresholds,
                   int32_t* __restrict__ dir, int32_t* __restrict__ parent, int f) {
  __shared__ __align__(16) float s_mval[kExtR * kPitch];  // ring row e is tile row e - 1

  const int tid = threadIdx.x;
  const int c0 = blockIdx.x * kTileC, r0 = blockIdx.y * kTileR;
  const size_t plane = static_cast<size_t>(blockIdx.z) * f * f;
  const float thr = __ldg(thresholds + blockIdx.z);
  const float* src = filt + plane;

  if (kVec == 4) {
    // the tile's 64 columns of the 34 ring rows, 4 at a time (F % 4 == 0
    // and c0 % 4 == 0: a chunk is all in or all out)
    for (int i = tid; i < kExtR * (kTileC / 4); i += kThreads) {
      const int e = i / (kTileC / 4), q = (i % (kTileC / 4)) * 4;
      const int gr = r0 - 1 + e, gc = c0 + q;
      float4 x = make_float4(-INFINITY, -INFINITY, -INFINITY, -INFINITY);
      if (gr >= 0 && gr < f && gc < f) {
        x = __ldg(reinterpret_cast<const float4*>(src + static_cast<size_t>(gr) * f + gc));
        x = make_float4(masked(x.x, thr), masked(x.y, thr), masked(x.z, thr), masked(x.w, thr));
      }
      *reinterpret_cast<float4*>(s_mval + e * kPitch + q + 4) = x;
    }
    // columns -1 and 64
    for (int i = tid; i < kExtR * 2; i += kThreads) {
      const int e = i >> 1, j = (i & 1) ? kTileC : -1;
      const int gr = r0 - 1 + e, gc = c0 + j;
      const bool ok = gr >= 0 && gr < f && gc >= 0 && gc < f;
      s_mval[e * kPitch + j + 4] = ok ? masked(__ldg(src + static_cast<size_t>(gr) * f + gc), thr) : -INFINITY;
    }
  } else {
    for (int i = tid; i < kExtR * kExtC; i += kThreads) {
      const int e = i / kExtC, j = i % kExtC;
      const int gr = r0 - 1 + e, gc = c0 - 1 + j;
      const bool ok = gr >= 0 && gr < f && gc >= 0 && gc < f;
      s_mval[e * kPitch + j + 3] = ok ? masked(__ldg(src + static_cast<size_t>(gr) * f + gc), thr) : -INFINITY;
    }
  }
  __syncthreads();

  // this thread: tile row er, groups of columns b .. b + 3 at b = 4 q and
  // 4 q + 32; rows er - 1 .. er + 1 and columns b - 1 .. b + 4 are shared
  // rows er .. er + 2 and columns b + 3 .. b + 8 (read as b .. b + 11)
  const int er = tid / kLanesRow, q4 = (tid % kLanesRow) * kGroup;
  const int gr = r0 + er;
  if (gr >= f) return;
  const size_t row = plane + static_cast<size_t>(gr) * f;
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
      const bool is_masked = center > -INFINITY;
      dcode[m] = is_masked ? best_c : 4;
      par[m] = is_masked ? (gr + best_c / 3 - 1) * f + c0 + b + m + best_c % 3 - 1 : 0;
    }
    store_group<kVec>(dir + row, c0 + b, f, dcode);
    store_group<kVec>(parent + row, c0 + b, f, par);
  }
}

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15u) == 0; }

}  // namespace

// filt, dir, parent: (t, f, f) contiguous on the device; thresholds (t,)
// on the device.  Returns the cudaError_t of the launch.
extern "C" int dvt_parent_race(const float* filt, const float* thresholds, int32_t* dir,
                               int32_t* parent, int t, int f, void* stream) {
  if (t <= 0 || f <= 0) return 0;
  if (t > 65535 || (f + kTileR - 1) / kTileR > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid((f + kTileC - 1) / kTileC, (f + kTileR - 1) / kTileR, t);
  if (f % 4 == 0 && aligned16(filt) && aligned16(dir) && aligned16(parent)) {
    parent_race_kernel<4><<<grid, kThreads, 0, st>>>(filt, thresholds, dir, parent, f);
  } else {
    parent_race_kernel<1><<<grid, kThreads, 0, st>>>(filt, thresholds, dir, parent, f);
  }
  return static_cast<int>(cudaGetLastError());
}
